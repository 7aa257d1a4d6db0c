"""Phases 31-33 of ``chip_smoke.py`` alone: the CLIP / SigLIP /
InternViT-300M towers with K2 at head widths 64 and 72, the four OmChat
variants through ``OmChatModel.chat`` and the Qwen1.5-MoE-A2.7B trunk in the
three engines, at full width and depth on random bf16 weights (seed 0).
Needs one NVIDIA GPU:

    python3 chip_probes/towers_moe.py [--phases 31,32,33]
"""
import argparse
import subprocess
import sys

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from omchat_torch.ops import kernel_lib  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--phases", default="31,32,33")
phases = set(ap.parse_args().phases.split(","))

import torch  # noqa: E402

cs.CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
cs.log(cs.CARD)
cs.log(f"kernel build: {kernel_lib.build_all():.1f} s")
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
shapes = cs.main_path_shapes(0)
failed = []
full = cs.full_model(0) if phases & {"32", "33"} else None
for phase, run in (("31", lambda: cs.towers_on_the_card(gen, 0)),
                   ("32", lambda: cs.variants_on_the_card(full, 0))):
    if phase in phases:
        try:
            run()
        except AssertionError as e:
            failed.append(f"phase {phase}: {e}")
        torch.cuda.empty_cache()
if "33" in phases:
    vit6b = full[1]["vision_tower"]
    del full
    try:
        cs.moe_on_the_card(gen, vit6b, 0, shapes)
    except AssertionError as e:
        failed.append(f"phase 33: {e}")
if failed:
    sys.exit(" | ".join(failed))
