"""K11 (the w8a8 attention-proj glue) at its two PERF.md section-6 shapes,
the ViT proj (3096 x 3200², bias and LayerScale) and the Qwen2 o_proj
(3200 x 3584², neither), timed from the ``omchat_torch`` package under
``--root``, so that two trees (a parent commit unpacked with ``git archive``,
and this one) are read on one card in one call, in turns: parent, change,
change, parent.

    python3 chip_probes/quant_ab.py --root _chip/parent --label parent
    python3 chip_probes/quant_ab.py --root . --label change

Each case is the median of 5 readings of 30 launches through the public
wrapper, the cases read in turns, on inputs drawn as chip_smoke.py's phase
11 draws them (unit-normal activations, int8 weights quantized from normal(0,
0.02)).  ``torch._int_mm`` on the same product ("... _int_mm", the GEMM
alone, no glue) is read beside.  Prints one JSON line: the card, the label
and {case: median ms}.  Needs one NVIDIA GPU.
"""
import argparse
import json
import os
import subprocess
import sys

READINGS, LAUNCHES = 5, 30
SHAPES = {"K11 vit": (3096, 3200, True), "K11 llm": (3200, 3584, False)}  # M, N = K, bias and LayerScale


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="directory holding the omchat_torch package to time")
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from omchat_torch.ops import kernel_lib
    from omchat_torch.ops import linear as lin
    from omchat_torch.ops import quant_matmul as qm

    if not torch.cuda.is_available():
        print("quant_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    kernel_lib.build_all(["proj_glue_quant.cu"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, off=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale + off).to(bf)

    cases = {}
    for name, (M, N, vit) in SHAPES.items():
        a, x, gamma = randn(M, N, scale=0.5), randn(M, N), randn(N, scale=0.1, off=1.0)
        p = lin.quantize_linear({"kernel": randn(N, N, scale=0.02)})
        ls = randn(N, scale=0.02, off=0.1) if vit else None
        if vit:
            p["bias"] = randn(N, scale=0.05)
        aq, _ = lin.quantize_activations(a)
        cases[name] = lambda a=a, x=x, p=p, ls=ls, gamma=gamma: qm.attn_proj_glue_quant(a, x, p, ls, gamma)
        cases[f"{name} _int_mm"] = lambda aq=aq, w=p["kernel_q"]: torch._int_mm(aq, w.t())

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
            readings[case].append(time_ms(fn))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip(), "label": args.label,
                      "ms": {k: sorted(r)[len(r) // 2] for k, r in readings.items()},
                      "readings": {k: [round(x, 4) for x in r] for k, r in readings.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
