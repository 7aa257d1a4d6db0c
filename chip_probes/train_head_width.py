"""Phase 44 of ``chip_smoke.py`` alone: training at head width 64 on the
Qwen2-0.5B-width trunk behind InternViT-300M (phase 43's model, full width and
depth, random bf16 weights from seed 0): stage-1, LoRA, stage-2 and the packed
steps, K16a / b / c at D 64 at the shapes those runs handed them and at D 72 and
16 at phase 13's, phase 16's rule at 2 + 2 layers, the train CLI's default on
the card; its kernel rows as the JSON line ``chip_smoke.py`` prints.  Needs one
NVIDIA GPU:

    python3 chip_probes/train_head_width.py
"""
import json
import subprocess
import sys
import time

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from omchat_torch.config import OmChatConfig  # noqa: E402
from omchat_torch.ops import kernel_lib  # noqa: E402

import torch  # noqa: E402

cs.CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
cs.log(cs.CARD)
cs.log(f"kernel build: {kernel_lib.build_all():.1f} s")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
phase13_shapes = cs.train_kernel_shapes(OmChatConfig(), cs.training_batch(OmChatConfig(), 0))
t0 = time.perf_counter()
rows, launches = cs.head64_training(gen, 0, cs.head64_model(0), phase13_shapes)
cs.log(f"phase 44: {time.perf_counter() - t0:.1f} s")
cs.log(json.dumps({"kernels": [{**{k: r[k] for k in ("name", "source", "replaces", "max_abs_err", "ms", "plain_ms",
                                                     "bound_ms", "bound_by", "library_ms")},
                                "launches": launches[r["name"]]} for r in rows]}))
