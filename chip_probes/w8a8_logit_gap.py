"""Where the w8a8 first-token logit gap between the glue kernels and the plain
chain comes from, at full width and 2 ViT + 2 LLM layers on random weights:
static vs dynamic fc1 scales, fc1 scales calibrated on the request itself,
w8a8 vs bf16, bf16 kernels vs plain (max |Δ| / max |logit| for each pair).
Needs one NVIDIA GPU:

    python3 chip_probes/w8a8_logit_gap.py
"""
import dataclasses, json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from omchat_torch import api
from omchat_torch.config import OmChatConfig
from omchat_torch.models.intern_vit import calibrate_fc1_scales
from omchat_torch.runtime.generate import OmChatEngine

full = OmChatConfig()
cfg = dataclasses.replace(full, vision=dataclasses.replace(full.vision, num_hidden_layers=2),
                          text=dataclasses.replace(full.text, num_hidden_layers=2))
cfg8, p8 = api.quantize_model(cfg, cs.build_model(cfg, 0), w8a8=True)
ids, tiles = cs.make_request(cfg, 0)
pv = torch.as_tensor(tiles, device="cuda").to(torch.bfloat16)


def logits(params, impl, c=cfg8):
    eng = OmChatEngine(c, params, attn_impl=impl, image_cache_size=0)
    lg, _ = eng.prefill(eng.plan([ids]), eng.encode_images(tiles), 32)
    return lg


def rel(a, b):
    return round(float((a - b).abs().max() / b.abs().max()), 5)


dyn = dict(p8)
dyn["vision_tower"] = dict(p8["vision_tower"])
dyn["vision_tower"]["layers"] = dict(p8["vision_tower"]["layers"])
dyn["vision_tower"]["layers"]["mlp"] = {k: v for k, v in p8["vision_tower"]["layers"]["mlp"].items()
                                        if k != "fc1_out_scale"}
own = dict(p8)
own["vision_tower"] = calibrate_fc1_scales(dyn["vision_tower"], cfg8.vision, pv)
L = {"kernels_static": logits(p8, None), "kernels_dynamic": logits(dyn, None), "kernels_own_calib": logits(own, None),
     "plain": logits(p8, "plain")}
bfp = cs.build_model(cfg, 0)
L["bf16_kernels"] = logits(bfp, None, cfg)
L["bf16_plain"] = logits(bfp, "plain", cfg)
out = {f"{a} vs {b}": rel(L[a], L[b]) for a, b in [("kernels_static", "plain"), ("kernels_dynamic", "plain"),
                                                   ("kernels_own_calib", "plain"), ("kernels_static", "kernels_dynamic"),
                                                   ("plain", "bf16_plain"), ("kernels_dynamic", "bf16_kernels"),
                                                   ("bf16_kernels", "bf16_plain")]}
out["fc1_out_scale noise calib"] = p8["vision_tower"]["layers"]["mlp"]["fc1_out_scale"].tolist()
out["fc1_out_scale own calib"] = own["vision_tower"]["layers"]["mlp"]["fc1_out_scale"].tolist()
out["max_logit"] = float(L["plain"].abs().max())
print(json.dumps(out, indent=1))
