"""The paged engine's speculative verify against its decode route at full
depth, fed the same tokens from the same pools (chip_smoke.py phase 28 (b)'s
comparison, spelled out): the verify (K2 over the gathered pages) and the
decode steps (K12) on the kernels, on the kernels' plain versions (each CUDA
kernel's function in PyTorch, on the card) and on ``attn_impl="plain"``;
every pair's max |logit| gap, overall and by row, and each slot's.  What
``SPEC_PLAIN_GAP`` in chip_smoke.py was read from.  Needs one NVIDIA GPU:

    python3 chip_probes/paged_verify_gaps.py
"""
import json
import subprocess
import sys

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from omchat_torch.ops import kernel_lib  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from omchat_torch.runtime import paged_engine as pe  # noqa: E402

cs.CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
cs.log(cs.CARD)
kernel_lib.build_all()
model = cs.surface_model(*cs.full_model(0))
cfg, params = model.config, model.engine.params
t = cs.SPEC_DRAFT_LEN + 1
eng = pe.PagedBatchEngine(cfg, params, image_cache_size=0, device="cuda", max_slots=cs.SPEC_SLOTS, num_pages=48,
                          page_size=128, max_len=1024, decode_roll=1, decode_graphs=False)
work = [w for w in cs.serving_workload(cfg) if w[1] is None][: cs.SPEC_SLOTS]
snap, steps, toks = cs.verify_snapshot(eng, work, t + 1)
feed = np.zeros((cs.SPEC_SLOTS, t), np.int32)
for s, tk in zip(np.nonzero(snap["active"])[0], toks):
    feed[s] = tk[:t]
live = torch.as_tensor(snap["active"], device="cuda")
routes = {"verify, kernels": cs.verify_logits(eng, snap, feed),
          "verify, kernels' plain versions": cs.verify_logits(eng, snap, feed, plain_k2=True),
          "verify, attn_impl plain": cs.verify_logits(eng, snap, feed, impl=cs.PLAIN_IMPL),
          "decode, kernels": cs.decode_logits(eng, snap, feed),
          "decode, kernels' plain versions": cs.decode_logits(eng, snap, feed, plain_k12=True),
          "decode, attn_impl plain": cs.decode_logits(eng, snap, feed, impl=cs.PLAIN_IMPL)}
res = {"card": cs.CARD, "slots": int(live.sum()), "rows": t,
       "engine's own decode vs the decode fed its tokens (0 expected)":
           float((torch.stack(steps[:t], 1) - routes["decode, kernels"])[live].abs().max()),
       "max_abs_logit": float(routes["decode, attn_impl plain"][live].abs().max()), "gaps": {}}
names = list(routes)
for i, a in enumerate(names):
    for b in names[i + 1:]:
        d = (routes[a] - routes[b])[live].abs().amax(-1)  # [slots, rows]
        res["gaps"][f"{a} | {b}"] = {"max": float(d.max()), "by_row": d.amax(0).tolist(),
                                     "by_slot": d.amax(1).tolist()}
cs.log("paged verify vs decode, same tokens, full depth: " + json.dumps(res))
