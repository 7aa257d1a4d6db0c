"""Phase 40 of ``chip_smoke.py`` alone: the rest of tensor-parallel serving
on ranks sharing the card (w8a8, a LoRA bank and the MoE trunk at tp 2 in a
world of their own, Qwen2-7B's kv heads replicated at tp 8), each against
the same engines on world 1 at full width and 2+2 layers.  Needs one NVIDIA
GPU:

    python3 chip_probes/serving_tp_remainder.py [--seed 0]
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
    cs.serving_tp_remainder(seed)
