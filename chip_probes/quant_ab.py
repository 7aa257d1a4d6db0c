"""The w8a8 GEMM kernels at their PERF.md section-6 shapes, timed from the
``omchat_torch`` package under ``--root``, so that two trees (a parent
commit unpacked with ``git archive``, and this one) are read on one card in
one call, in turns: parent, change, change, parent.

    python3 chip_probes/quant_ab.py --root _chip/parent --label parent
    python3 chip_probes/quant_ab.py --root . --label change

Cases: K9 (the ViT fc1, 3096 x 3200 -> 12800, with bias), K10 (the Qwen2
gate / up + SwiGLU, 3200 x 3584 -> 18944 at the prefill and 1024 rows at
the serving run's most launched shape) and K11 (the ViT proj, 3096 x 3200²
with bias and LayerScale, and the Qwen2 o_proj, 3200 x 3584², neither).
Each is the median of 5 readings of 30 launches through the public wrapper,
the cases read in turns, on inputs drawn as chip_smoke.py's phase 11 draws
them, from a seed of each case's own (unit-normal activations, int8 weights
quantized from normal(0, 0.02), K9's bias and K9's / K10's static scales as
a calibration would set them).  ``torch._int_mm`` on the same products
("... _int_mm", the GEMMs alone, no epilogue) is read beside.

The outputs of one launch of each case are hashed (SHA-256 over the bytes
of every output tensor), so two trees' lines show whether their kernels
give the same bits on the same inputs.  Prints one JSON line: the card, the
label, {case: median ms}, the readings and {case: sha256}.  Needs one NVIDIA
GPU.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys

READINGS, LAUNCHES = 5, 30
# name: (kernel, M, K, N, ViT); K11's K == N
SHAPES = {"K9 vit": ("K9", 3096, 3200, 12800, True),
          "K10 llm": ("K10", 3200, 3584, 18944, False),
          "K10 serve": ("K10", 1024, 3584, 18944, False),
          "K11 vit": ("K11", 3096, 3200, 3200, True),
          "K11 llm": ("K11", 3200, 3584, 3584, False)}


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
    kernel_lib.build_all(["fc1_gelu_quant.cu", "swiglu_quant.cu", "proj_glue_quant.cu"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, off=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale + off).to(bf)

    def qlinear(n, k):
        return lin.quantize_linear({"kernel": randn(k, n, scale=0.02)})

    cases, outputs = {}, {}
    for i, (name, (kernel, M, K, N, vit)) in enumerate(SHAPES.items()):
        gen.manual_seed(i)
        if kernel == "K9":
            xq, rs = lin.quantize_activations(randn(M, K))
            p = qlinear(N, K)
            h = lin.int8_matmul(xq, p["kernel_q"].t()).float() * rs * p["scale"].float()
            p["bias"] = randn(N, scale=float(h.std()))
            os_ = lin.div127(lin.gelu_tanh(h + p["bias"].float()).abs().amax())
            del h
            cases[name] = lambda xq=xq, rs=rs, p=p, os_=os_: qm.fc1_gelu_quant(xq, rs, p, os_)
            cases[f"{name} _int_mm"] = lambda xq=xq, w=p["kernel_q"]: torch._int_mm(xq, w.t())
        elif kernel == "K10":
            xq, rs = lin.quantize_activations(randn(M, K))
            gp, up = qlinear(N, K), qlinear(N, K)
            g = lin.int8_matmul(xq, gp["kernel_q"].t()).float() * rs * gp["scale"].float()
            u = lin.int8_matmul(xq, up["kernel_q"].t()).float() * rs * up["scale"].float()
            os_ = lin.div127((lin.silu(g) * u).abs().amax())
            del g, u
            cases[name] = lambda xq=xq, rs=rs, gp=gp, up=up, os_=os_: qm.swiglu_quant(xq, rs, gp, up, os_)
            cases[f"{name} _int_mm"] = lambda xq=xq, wg=gp["kernel_q"], wu=up["kernel_q"]: (
                torch._int_mm(xq, wg.t()), torch._int_mm(xq, wu.t()))
        else:
            a, x, gamma = randn(M, N, scale=0.5), randn(M, N), randn(N, scale=0.1, off=1.0)
            p = qlinear(N, N)
            ls = randn(N, scale=0.02, off=0.1) if vit else None
            if vit:
                p["bias"] = randn(N, scale=0.05)
            aq, _ = lin.quantize_activations(a)
            cases[name] = lambda a=a, x=x, p=p, ls=ls, gamma=gamma: qm.attn_proj_glue_quant(a, x, p, ls, gamma)
            cases[f"{name} _int_mm"] = lambda aq=aq, w=p["kernel_q"]: torch._int_mm(aq, w.t())
        out = cases[name]()
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for t in out if isinstance(out, tuple) else (out,):
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        outputs[name] = digest.hexdigest()
        del out

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
                      "readings": {k: [round(x, 4) for x in r] for k, r in readings.items()},
                      "sha256": outputs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
