"""Phases 29 and 30 of ``chip_smoke.py`` alone (the slot engine with its
e4m3 rerun, late joiner, 2+2-layer parity and LoRA bank, the native tile
pipeline and its three kernel rows; then the eval entry point) at full width
and depth on random bf16 weights (seed 0).  Needs one NVIDIA GPU:

    python3 chip_probes/slot_engine_eval.py [--phases 29,30] [--repeat N]

``--repeat N`` runs the phases N times over the one model, each time on
engines built anew (each captures its graphs anew); a failing run is
printed and counted, and the later runs go on.
"""
import argparse
import subprocess
import sys

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from omchat_torch.ops import kernel_lib  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--phases", default="29,30")
ap.add_argument("--repeat", type=int, default=1)
args = ap.parse_args()
phases = set(args.phases.split(","))

import torch  # noqa: E402

cs.CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
cs.log(cs.CARD)
cs.log(f"kernel build: {kernel_lib.build_all():.1f} s")
model = cs.surface_model(*cs.full_model(0))
small = cs.small_surface(model.config, 0)
gen = torch.Generator(device="cuda").manual_seed(0)
failed = []
for n in range(args.repeat):
    for phase, run in (("29", lambda: cs.slot_engine_on_the_card(gen, model, small, 0)),
                       ("30", lambda: cs.eval_on_the_card(model, small, 0))):
        if phase in phases:
            try:
                run()
            except Exception as e:  # noqa: BLE001 - a lost capture raises RuntimeError; count it and go on
                failed.append(f"run {n + 1}, phase {phase}: {type(e).__name__}: {e}")
                cs.log(failed[-1])
            torch.cuda.empty_cache()
cs.log(f"runs: {args.repeat}, failed: {len(failed)}")
if failed:
    sys.exit(" | ".join(failed))
