"""Checkpoint parity runbook — PyTorch port of ``omchat_tpu/eval/parity.py``.

The acceptance criterion of BASELINE.json is argmax-exact greedy decode
against the reference stack on a real checkpoint.  This module runs the
reference twin (the transformers model of the checkpoint's bundle, fp32) and
the port's engine side by side on the same inputs and reports:

- per-step argmax-match rate, first-divergence step,
- per-step max |Δlogit| (teacher-forced on the twin's tokens, so the
  comparison stays aligned past a divergence),
- the engine's own end-to-end greedy tokens (the serving path),
- optional per-module deltas (tower features, projector output).

The twin is the checkpoint's own ``trust_remote_code`` bundle where its
``config.json`` names one; a checkpoint without code files falls back to the
port's copy of the bundle code (``omchat_torch/export/hf_code``) fed the
engine's weights through :func:`~omchat_torch.checkpoint.save.
flatten_to_hf_state`.  ``transformers`` is imported inside the functions
that need it.  The twin runs on the card unless asked for the CPU; the
engine runs where it was loaded.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from omchat_torch.utils.device import resolve_device


def load_torch_twin(model_path: str, params: Optional[dict] = None, device=None):
    """Return (twin in fp32, eval mode, on ``device``; source), where source
    is "remote_code" (the checkpoint's own code bundle through
    ``AutoModel``) or "in-repo-twin" (the port's bundle code loaded with
    ``params``, the engine's weights)."""
    dev = resolve_device(device)
    with open(os.path.join(model_path, "config.json")) as f:
        cfg_json = json.load(f)
    if "auto_map" in cfg_json and any("AutoModel" in k for k in cfg_json["auto_map"]):
        from transformers import AutoModel

        model = AutoModel.from_pretrained(model_path, trust_remote_code=True, dtype=torch.float32)
        return model.to(dev).eval(), "remote_code"

    from omchat_torch.checkpoint.save import flatten_to_hf_state
    from omchat_torch.config import OmChatConfig
    from omchat_torch.export.hf_code.configuration_omchat import OmChatConfig as TwinConfig
    from omchat_torch.export.hf_code.modeling_omchat import OmChatForConditionalGeneration

    if params is None:
        raise ValueError("repo-native checkpoint parity needs the engine's params")
    if "vision_config" in cfg_json:
        cfg = OmChatConfig.from_hf_dict(cfg_json)
    else:
        from omchat_torch.checkpoint.loader import load_omchat_checkpoint

        cfg, _ = load_omchat_checkpoint(model_path, torch.float32, device="cpu")
    hf = cfg.to_hf_dict()
    twin_cfg = TwinConfig(
        vision_config=hf["vision_config"],
        text_config=hf["text_config"],
        mm_projector_type=hf["mm_projector_type"],
        image_grid_pinpoints=hf["image_grid_pinpoints"],
        vision_feature_layer=hf["vision_feature_layer"],
        vision_feature_select_strategy=hf["vision_feature_select_strategy"],
        tokenizer_model_max_length=hf.get("tokenizer_model_max_length"),
    )
    model = OmChatForConditionalGeneration(twin_cfg)
    state = {k: v.float() for k, v in flatten_to_hf_state(params).items()}
    missing, unexpected = model.load_state_dict(state, strict=False)
    real_missing = [k for k in missing if "rotary" not in k]
    if real_missing or unexpected:
        raise ValueError(f"twin load mismatch: missing={real_missing} unexpected={unexpected}")
    return model.float().to(dev).eval(), "in-repo-twin"


def torch_greedy_with_logits(torch_model, input_ids, images, n_new: int):
    """Step the twin greedily on its device, returning (tokens [n], logits
    [n, V] fp32 numpy)."""
    dev = next(torch_model.parameters()).device
    ids = torch.as_tensor(np.asarray(input_ids, dtype=np.int64), device=dev)[None]
    imgs = torch.as_tensor(np.asarray(images, dtype=np.float32), device=dev) if images is not None else None
    tokens: List[int] = []
    logits_steps: List[np.ndarray] = []
    with torch.no_grad():
        out = torch_model(input_ids=ids, images=imgs, use_cache=True)
        for _ in range(n_new):
            step_logits = out.logits[0, -1].float().cpu().numpy()
            logits_steps.append(step_logits)
            nxt = int(step_logits.argmax())
            tokens.append(nxt)
            out = torch_model(input_ids=torch.tensor([[nxt]], dtype=torch.long, device=dev),
                              past_key_values=out.past_key_values, use_cache=True)
    return tokens, np.stack(logits_steps)


@torch.no_grad()
def teacher_forced_logits(model, input_ids: List[int], images, gen_tokens: List[int]):
    """The port's engine over prompt + ``gen_tokens`` in one cacheless pass
    (its weights, attention route and device); returns (step_logits [n, V]
    fp32 numpy — the logits predicting each generated token — and the
    prompt's last logits [V])."""
    from omchat_torch.models.decoder import decoder_forward
    from omchat_torch.models.omchat import fuse_embeddings, plan_multimodal_merge
    from omchat_torch.models.qwen2 import lm_head

    engine = model.engine
    cfg, params, dev = engine.cfg, engine.params, engine.device
    full = list(input_ids) + [int(t) for t in gen_tokens]
    plan = plan_multimodal_merge([full], cfg.image_seq_len, bucket=8)
    feats = None
    if images is not None:
        feats = engine.encode_tiles(np.asarray(images, np.float32))
        feats = feats.reshape(-1, feats.shape[-1])
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    embeds = fuse_embeddings(params, t(plan.token_ids), t(plan.is_image), t(plan.image_index), feats)
    hidden, _ = decoder_forward(params["language_model"], cfg.text, embeds, t(plan.positions),
                                attn_impl=engine.attn_impl)
    logits = lm_head(params["language_model"], cfg.text, hidden)[0].float().cpu().numpy()
    merged_len = int(plan.lengths[0])
    prompt_end = merged_len - len(gen_tokens)  # the merged prompt's length
    return logits[prompt_end - 1 : merged_len - 1], logits[prompt_end - 1]


@torch.no_grad()
def per_module_report(model, torch_model, images) -> dict:
    """Max |Δ| between the engine and the twin at each module boundary on
    the prompt's image tiles: tower features (after feature select) and the
    projector's output."""
    from omchat_torch.models.intern_vit import feature_select, intern_vit_forward
    from omchat_torch.models.projector import projector_forward

    engine = model.engine
    cfg, params = engine.cfg, engine.params
    pv = torch.as_tensor(np.asarray(images, np.float32), device=engine.device)
    hidden = intern_vit_forward(params["vision_tower"], cfg.vision, pv, feature_layer=cfg.vision_feature_layer,
                                attn_impl=engine.attn_impl)
    feats = feature_select(hidden, cfg.vision_feature_select_strategy)
    feats_e = feats.float().cpu().numpy()
    proj_e = projector_forward(params["projector"], cfg.projector, feats).float().cpu().numpy()

    dev = next(torch_model.parameters()).device
    hidden_t = torch_model.vision_tower(pv.float().to(dev), feature_layer=cfg.vision_feature_layer)
    if cfg.vision_feature_select_strategy in ("default", "patch"):
        hidden_t = hidden_t[:, 1:]
    feats_t = hidden_t.float().cpu().numpy()
    proj_t = torch_model.multi_modal_projector(hidden_t).float().cpu().numpy()

    def delta(a, b):
        d = np.abs(a - b)
        scale = np.maximum(np.abs(b), 1e-6)
        return {"max_abs": float(d.max()), "max_rel": float((d / scale).max()), "mean_abs": float(d.mean())}

    return {"tower_features": delta(feats_e, feats_t), "projector": delta(proj_e, proj_t)}


def run_parity(model, torch_model, input_ids: List[int], images, *, max_new_tokens: int = 32,
               per_module: bool = False) -> dict:
    """The full report, with the JAX runbook's keys.  ``model`` is the port's
    ``OmChatModel``; ``torch_model`` the fp32 twin."""
    from omchat_torch.config import GenerationConfig

    torch_tokens, torch_logits = torch_greedy_with_logits(torch_model, np.asarray(input_ids), images, max_new_tokens)
    steps, _ = teacher_forced_logits(model, input_ids, images, torch_tokens)

    n = len(torch_tokens)
    argmax_match = [int(steps[i].argmax()) == torch_tokens[i] for i in range(n)]
    max_dlogit = [float(np.abs(steps[i] - torch_logits[i]).max()) for i in range(n)]
    first_div = next((i for i, m in enumerate(argmax_match) if not m), None)

    engine_out = model.engine.generate([list(input_ids)], images,
                                       GenerationConfig(max_new_tokens=max_new_tokens, eos_token_id=-1))
    engine_tokens = [int(t) for t in engine_out.token_ids[0]]

    report = {
        "steps": n,
        "argmax_match_rate": float(np.mean(argmax_match)) if n else 1.0,
        "first_divergence_step": first_div,
        "max_logit_diff": float(np.max(max_dlogit)) if n else 0.0,
        "mean_logit_diff": float(np.mean(max_dlogit)) if n else 0.0,
        "per_step_max_logit_diff": [round(v, 6) for v in max_dlogit],
        "torch_tokens": torch_tokens,
        "engine_tokens": engine_tokens,
        "engine_matches_torch": engine_tokens[:n] == torch_tokens[: len(engine_tokens)],
    }
    if per_module and images is not None:
        report["per_module"] = per_module_report(model, torch_model, images)
    return report
