"""Phase 39 of ``chip_smoke.py`` alone: tensor-parallel serving on two ranks
sharing the card (2+2-layer parity, launches and planted faults; the full
model's request and serving workload at tp 2).  World 1's phase 3 / 5
numbers are not run here (printed as null).  Needs one NVIDIA GPU:

    python3 chip_probes/serving_tp.py [--seed 0]
"""
import argparse
import subprocess
import sys

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    seed = ap.parse_args().seed

    import torch

    from omchat_torch.ops import kernel_lib

    cs.CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
    cs.log(cs.CARD)
    cs.log(f"torch {torch.__version__}; kernel build: {kernel_lib.build_all():.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.serving_tp(seed, {}, {})
