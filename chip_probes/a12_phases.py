"""Phases 34-37 of ``chip_smoke.py`` alone: K2's segment-ids entry at the
packed forward's shape, the packed forward at full depth, the HF export round
trip and the parity runbook against the bundle's own twin, on random bf16
weights (seed 0).  Needs one NVIDIA GPU:

    python3 chip_probes/a12_phases.py
"""
import subprocess
import sys
import tempfile

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
failed = []
for phase, run in (("34", lambda: cs.segment_kernel_rows(gen)), ("35", lambda: cs.packed_forward(0))):
    try:
        run()
    except AssertionError as e:
        failed.append(f"phase {phase}: {e}")
    torch.cuda.empty_cache()
with tempfile.TemporaryDirectory(prefix="omchat_export_") as d:
    try:
        exported = cs.export_round_trip(0, d)
        cs.parity_on_the_card(exported)
    except AssertionError as e:
        failed.append(f"phases 36-37: {e}")
if failed:
    sys.exit(" | ".join(failed))
