"""The readings behind phase 35's limit (``chip_smoke.py``): the packed
forward at full depth (Qwen2-7B trunk, random bf16 weights of seed 0) on the
phase's 4096-row pack of five documents, over several token seeds, on three
attention routes: the kernels (``attn_impl=None``: K2's segment-ids entry,
and K2 on the documents one at a time), ``"plain"`` (fp32 softmax, one bf16
rounding) and ``"vjp"`` (K16a, the training forward, same mainloop).  For
each: the packed loss against the documents run one at a time, and the max
|logit| gap over the labelled rows; and after one layer, the max |hidden|
gap of each route's packed rows from the plain route's.  Needs one NVIDIA
GPU:

    python3 chip_probes/packed_forward_gaps.py [--seeds 0,1,2,3]
"""
import argparse
import json
import subprocess
import sys

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from omchat_torch.ops import kernel_lib  # noqa: E402

import torch  # noqa: E402

from omchat_torch.config import OmChatConfig  # noqa: E402
from omchat_torch.models import qwen2  # noqa: E402
from omchat_torch.models.omchat import fuse_embeddings  # noqa: E402
from omchat_torch.training.train_step import loss_fn, shift_labels  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--seeds", default="0,1,2,3")
seeds = [int(s) for s in ap.parse_args().seeds.split(",")]

cs.CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
cs.log(cs.CARD)
kernel_lib.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
cfg = OmChatConfig()
params = {"language_model": qwen2.init_params(cfg.text, torch.Generator(device="cuda").manual_seed(0),
                                              torch.bfloat16)}
lm = params["language_model"]


def first_layers(tree, n):
    return {k: first_layers(v, n) if isinstance(v, dict) else v[:n] for k, v in tree.items()}


lm1 = {**lm, "layers": first_layers(lm["layers"], 1)}
ROUTES = {"kernels": None, "plain": "plain", "vjp": "vjp"}


def logits_and_loss(p, batch, impl):
    embeds = fuse_embeddings(p, batch["token_ids"], batch["is_image"], batch["image_index"], None)
    hidden, _ = qwen2.qwen2_forward(p["language_model"], cfg.text, embeds, batch["positions"], attn_impl=impl,
                                    segment_ids=batch.get("segment_ids"))
    return qwen2.lm_head(p["language_model"], cfg.text, hidden)[0], hidden[0]


out = []
with torch.no_grad():
    for seed in seeds:
        batch = cs.packed_batch(cfg, seed)
        labelled = (shift_labels(batch["labels"])[0] >= 0)
        row = {"seed": seed}
        layer1 = {}
        for route, impl in ROUTES.items():
            loss, n = loss_fn(params, cfg, batch, attn_impl=impl, remat=False)
            packed_logits, _ = logits_and_loss(params, batch, impl)
            total, count, dlogit = 0.0, 0, 0.0
            for s, e in cs.SEG_DOCS:
                single = {k: v[:, s:e] for k, v in batch.items() if k != "segment_ids"}
                one, m = loss_fn(params, cfg, single, attn_impl=impl, remat=False)
                total += float(one) * int(m)
                count += int(m)
                lg, _ = logits_and_loss(params, single, impl)
                rows = labelled[s:e]
                dlogit = max(dlogit, float((lg[rows] - packed_logits[s:e][rows]).abs().max()))
            row[route] = {"packed": float(loss), "one_at_a_time": total / count,
                          "loss_gap": abs(float(loss) - total / count), "max_logit_gap": dlogit}
            _, h1 = logits_and_loss({"language_model": lm1}, batch, impl)
            layer1[route] = h1
            del packed_logits
        valid = batch["segment_ids"][0] >= 0
        row["layer1_max_gap_from_plain"] = {r: float((layer1[r][valid].float() - layer1["plain"][valid].float())
                                                     .abs().max()) for r in ROUTES if r != "plain"}
        row["layer1_max_abs"] = float(layer1["plain"][valid].float().abs().max())
        row["kernels_vs_plain_packed_loss"] = abs(row["kernels"]["packed"] - row["plain"]["packed"])
        cs.log("packed forward gaps: " + json.dumps(row))
        out.append(row)
cs.log("packed forward gaps, all seeds (" + cs.CARD + "): " + json.dumps(
    {r: [x[r]["loss_gap"] for x in out] for r in ROUTES}))
