"""K4 (the row commit, ``ops.paged_attention.commit_rows``) at the shapes its
paths give it, timed from the ``omchat_torch`` package under ``--root``, so
that two trees (a parent commit unpacked with ``git archive``, and this one)
are read on one card in one call, in turns: parent, change, change, parent.

    python3 chip_probes/commit_rows_ab.py --root _chip/parent --label parent
    python3 chip_probes/commit_rows_ab.py --root . --label change

Cases: "decode" (the single request's step: 28 rows of 4 x 128 bf16 into the
stacked cache [28, 1, 4, 3328, 128] seen as 28 pages) and "serve" (a 16-slot
roll step: 448 rows into a 28-layer pool of 193 pages of 128 rows, at
distinct random (page, offset)), each into a bf16 and an e4m3 pool.  A call
takes the card a microsecond or two and the host tens, so each is read as
graphed device time: ``GRAPH_CALLS`` calls captured in a CUDA graph, the
median of 5 readings of 30 replays, in turns with the other cases, divided
by the calls, beside one call issued eagerly ("... eager").  Beside them:
``index_put_`` of the same rows into the bf16 pool ("... index_put_",
graphed), and, for trees that have it, the launch floor, a kernel that does
nothing on K4's grid (``omchat_commit_rows_floor``, "... floor", graphed).

Each case's pools after one launch are hashed (SHA-256), so two trees' lines
show whether their kernels write the same bits.  Prints one JSON line: the
card, the label, {case: median ms}, the readings, {case: bytes bound ms} and
{case: sha256}.  Needs one NVIDIA GPU.
"""
import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

READINGS, LAUNCHES = 5, 30
# name: (rows, pool pages, page rows)
SHAPES = {"decode": (28, 28, 3328), "serve": (448, 28 * 193, 128)}
KVH, D = 4, 128


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="directory holding the omchat_torch package to time")
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import GRAPH_CALLS, PEAK_BYTES, graphed

    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from omchat_torch.ops import kernel_lib
    from omchat_torch.ops import paged_attention as pa

    if not torch.cuda.is_available():
        print("commit_rows_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    kernel_lib.build_all(["commit_rows.cu"])
    lib = kernel_lib.library("commit_rows.cu")
    has_floor = hasattr(lib, "omchat_commit_rows_floor")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def sha256(*ts):
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for t in ts:
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return digest.hexdigest()

    cases, outputs, bounds = {}, {}, {}
    for i, (shape, (n, pages_total, page_rows)) in enumerate(SHAPES.items()):
        gen.manual_seed(i)
        slots = torch.randperm(pages_total * page_rows, generator=gen, device="cuda")[:n]
        pages, offs = (slots // page_rows).int(), (slots % page_rows).int()
        if shape == "decode":
            pages, offs = torch.arange(n, dtype=torch.int32, device="cuda"), torch.full_like(pages, 3187)
        k_rows = (torch.randn(n, KVH, D, generator=gen, device="cuda") * 4).to(bf)
        v_rows = (torch.randn(n, KVH, D, generator=gen, device="cuda") * 4).to(bf)
        for dtype in (bf, torch.float8_e4m3fn):
            name = f"{shape} {'bf16' if dtype == bf else 'e4m3'}"
            kp, vp = (torch.zeros(pages_total, KVH, page_rows, D, dtype=dtype, device="cuda") for _ in range(2))

            def k4(kp=kp, vp=vp, pages=pages, offs=offs, k_rows=k_rows, v_rows=v_rows):
                return pa.commit_rows(kp, vp, pages, offs, k_rows, v_rows)

            k4()
            outputs[name] = sha256(kp[pages.long(), :, offs.long()], vp[pages.long(), :, offs.long()])
            cases[name] = graphed(k4, GRAPH_CALLS)
            cases[f"{name} eager"] = k4
            bounds[name] = (2 * n * KVH * D * (2 + kp.element_size()) + 2 * n * 4) / PEAK_BYTES * 1e3
            if dtype == bf:
                idx = (pages.long()[:, None], torch.arange(KVH, device="cuda")[None, :], offs.long()[:, None])

                def index_put(kp=kp, vp=vp, idx=idx, k_rows=k_rows, v_rows=v_rows):
                    kp.index_put_(idx, k_rows)
                    vp.index_put_(idx, v_rows)

                cases[f"{name} index_put_"] = graphed(index_put, GRAPH_CALLS)
        if has_floor:
            fargs = [ctypes.c_int] * 3 + [ctypes.c_void_p]

            def floor(n=n):
                kernel_lib.launch("commit_rows.cu", "omchat_commit_rows_floor", fargs, n, KVH, D,
                                  kernel_lib.stream_ptr())

            cases[f"{shape} floor"] = graphed(floor, GRAPH_CALLS)

    def time_ms(fn):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LAUNCHES):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / LAUNCHES

    readings = {case: [] for case in cases}
    for _ in range(READINGS):
        for case, fn in cases.items():
            readings[case].append(time_ms(fn) / (1 if case.endswith("eager") else GRAPH_CALLS))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    ms = {k: sorted(r)[len(r) // 2] for k, r in readings.items()}
    print(json.dumps({"card": smi.stdout.strip(), "label": args.label, "ms": ms,
                      "readings": {k: [round(x, 6) for x in r] for k, r in readings.items()},
                      "bound_ms": bounds, "sha256": outputs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
