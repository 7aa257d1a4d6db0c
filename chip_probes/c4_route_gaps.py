"""C4 alone: the max |logit| gaps between the verify (9 rows), decode (1 row)
and one-shot prefill routes of the same tokens, at full width and depth on
random bf16 weights (seed 0), on the kernels and on ``attn_impl="plain"``
(``chip_smoke.c4_route_gaps``, which phase 26 of ``chip_smoke.py`` runs).
Needs one NVIDIA GPU:

    python3 chip_probes/c4_route_gaps.py
"""
import subprocess
import sys

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from omchat_torch.ops import kernel_lib  # noqa: E402

cs.CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
cs.log(cs.CARD)
kernel_lib.build_all()
model = cs.surface_model(*cs.full_model(0))
ids, tiles = cs.make_request(model.config, 0)
cs.c4_route_gaps(model, ids, tiles)

# the two planted verify faults of phase 26 on the same tokens: max |gap| of
# their verify logits from the decode route's
import json  # noqa: E402

import torch  # noqa: E402

from omchat_torch.config import GenerationConfig  # noqa: E402
from omchat_torch.runtime import speculative as sp  # noqa: E402

eng = model.engine
toks = eng.generate([ids], tiles, GenerationConfig(max_new_tokens=1 + cs.SPEC_DRAFT, eos_token_id=-1)).token_ids[0]
feats = eng.encode_images(tiles)
decode = cs.route_logits(eng, ids, feats, toks)["decode"]
plan = eng.plan([ids])
gaps = {}
for fault, faulty in cs.verify_faults(sp.verify_step).items():
    _, cache = eng.prefill(plan, feats, len(toks) + 1)
    lg = faulty(eng, torch.tensor([toks], dtype=torch.int32, device="cuda"),
                torch.tensor([int(plan.lengths[0])], dtype=torch.int32, device="cuda"), cache)[0]
    gaps[fault] = float((lg.float() - decode).abs().max())
cs.log("C4 faults at full depth, verify vs decode max |gap|: " + json.dumps(gaps))
