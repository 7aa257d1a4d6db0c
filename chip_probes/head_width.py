"""Phase 43 of ``chip_smoke.py`` alone: the Qwen2-0.5B-width trunk (head
width 64, 14 / 2 heads) behind InternViT-300M at full width and depth on
random bf16 weights (seed 0) through the three engines, the decode and paged
kernels at head widths 64, 72 and 16, and the 2 + 2 layer checks; its
kernel rows as the JSON line ``chip_smoke.py`` prints.  Needs one NVIDIA GPU:

    python3 chip_probes/head_width.py
"""
import json
import subprocess
import sys
import time

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from omchat_torch.ops import kernel_lib  # noqa: E402

import torch  # noqa: E402

cs.CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
cs.log(cs.CARD)
cs.log(f"kernel build: {kernel_lib.build_all():.1f} s")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
t0 = time.perf_counter()
rows, launches = cs.head_width_64(gen, 0, cs.main_path_shapes(0))
cs.log(f"phase 43: {time.perf_counter() - t0:.1f} s")
cs.log(json.dumps({"kernels": [{**{k: r[k] for k in ("name", "source", "replaces", "max_abs_err", "ms", "plain_ms",
                                                     "bound_ms", "bound_by", "library_ms")},
                                "launches": launches[r["name"]]} for r in rows]}))
