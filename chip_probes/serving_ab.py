"""The serving workload of ``chip_smoke.py`` (phase 5's 16 requests through
``PagedBatchEngine`` at full width and depth, random weights) run again and
again in one process, the decode on K12 (``decode_kernel="auto"``) and on
K13 (``"manual"``) in turns, from the ``omchat_torch`` package under
``--root``: so that two trees (a parent commit unpacked with ``git
archive``, and this one) are read on one card in one call, in turns.

    python3 chip_probes/serving_ab.py --root _chip/parent --label parent
    python3 chip_probes/serving_ab.py --root . --label change

Each run is ``chip_smoke.timed_serving``'s (a warm-up at 4 new tokens, then
64): generated tokens/s, the decode-step wall ms with all 16 slots decoding
(CUDA events around the host's dispatch of a roll, host launch gaps
included) and the sum of the rolls' spans.  Prints one JSON line: the card,
the label and, per kernel, every run's numbers and their medians.  Needs one
NVIDIA GPU.
"""
import argparse
import gc
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="directory holding the omchat_torch package to time")
    ap.add_argument("--label", required=True)
    ap.add_argument("--runs", type=int, default=4, help="runs of each decode kernel")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import chip_smoke as cs

    from omchat_torch.config import OmChatConfig
    from omchat_torch.ops import paged_attention as pa
    from omchat_torch.runtime import paged_engine as pe

    if not torch.cuda.is_available():
        print("serving_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    cfg = OmChatConfig()
    params = cs.build_model(cfg, 0)
    work = cs.serving_workload(cfg)
    got = {"auto": [], "manual": []}
    for i in range(args.runs):
        for kernel in (("auto", "manual") if i % 2 == 0 else ("manual", "auto")):
            eng = pe.PagedBatchEngine(cfg, params, image_cache_size=0, device=cs.DEVICE, decode_kernel=kernel,
                                      **cs.SERVING)
            rec, undo = cs.record_dispatches(eng)
            counts = {n: c for n, c in cs.paged_counters().items() if n != "paged_flash_decode"}
            counts["decode"] = pa.DECODE_KERNELS[kernel]
            try:
                res = cs.timed_serving(eng, work, rec, counts, f"{args.label} serving (decode_kernel={kernel})")
            finally:
                undo()
            got[kernel].append({"tokens_per_s": res["tokens_per_s"],
                                "decode_step_wall_ms_16_slots": res["decode_step_wall_ms_16_slots"],
                                "roll_span_ms": res["span_ms"]["roll"]})
            del eng
            gc.collect()

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip(), "label": args.label, "runs": got,
                      "median": {k: {m: median([r[m] for r in runs]) for m in runs[0]} for k, runs in got.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
