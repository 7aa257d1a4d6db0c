"""The w8a8 kernels and K15 at their PERF.md section-6 shapes, timed from the
``omchat_torch`` package under ``--root``, so that two trees (a parent
commit unpacked with ``git archive``, and this one) are read on one card in
one call, in turns: parent, change, change, parent.

    python3 chip_probes/quant_ab.py --root _chip/parent --label parent
    python3 chip_probes/quant_ab.py --root . --label change

GEMM cases: K9 (the ViT fc1, 3096 x 3200 -> 12800, with bias), K10 (the
Qwen2 gate / up + SwiGLU, 3200 x 3584 -> 18944 at the prefill and 1024 rows
at the serving run's most launched shape) and K11 (the ViT proj, 3096 x
3200² with bias and LayerScale, and the Qwen2 o_proj, 3200 x 3584²,
neither).  Each is the median of 5 readings of 30 launches through the
public wrapper, the cases read in turns, on inputs drawn as chip_smoke.py's
phase 11 draws them, from a seed of each case's own (unit-normal
activations, int8 weights quantized from normal(0, 0.02), K9's bias and
K9's / K10's static scales as a calibration would set them).
``torch._int_mm`` on the same products ("... _int_mm", the GEMMs alone, no
epilogue) is read beside.

Row cases: K7 (RMSNorm + int8 row quantize: the Qwen2 prefill's 3200 x 3584
and the serving run's most launched 1024 x 3584) and K8 (residual +
LayerScale + RMSNorm + quantize: the ViT's 3096 x 3200 with LayerScale and
without (``ls=None``), and the serving run's batched encode of 8 tiles,
8256 x 3200).  A call takes the card less time than the host takes to issue
it, and one call's input fits in the 50 MB L2, so each is read as graphed
device time from HBM: ``GRAPH_CALLS`` calls captured in a CUDA graph, cycling
over enough input sets that a set has left the L2 before it comes round
again; the median of 5 readings of 30 replays, in turns with the other
cases, divided by the calls, beside one call issued eagerly ("... eager").
K15 (the whole-page commit of the serving run's largest prefill, 896 pages
of a strided 28 x 8 x 4 x 512 x 128 scratch cache, into a bf16 and an e4m3
pool, at random distinct pages) is read the same way; its SHA-256 is over the
pages it wrote.  Their bound (bytes: each input read once, each output
written once, at 3.35 TB/s) and share of it are printed.

The outputs of one launch of each case are hashed (SHA-256 over the bytes
of every output tensor), so two trees' lines show whether their kernels
give the same bits on the same inputs.  Prints one JSON line: the card, the
label, {case: median ms}, the readings, {case: bound ms} and {case:
sha256}.  Needs one NVIDIA GPU.
"""
import argparse
import functools
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
# K15, the serving run's largest page commit: the scratch cache [L, B, KVH,
# T, D] (28 x 8 x 4 x 512 x 128) seen as M = 896 pages into a 28-layer pool of
# 193 pages a layer, bf16 and e4m3; seeded after the row cases
K15_CACHE, K15_LAYER_PAGES = (28, 8, 4, 512, 128), 193
# name: (kernel, rows, D, LayerScale); seeded after the GEMM cases
ROW_SHAPES = {"K7 llm": ("K7", 3200, 3584, False),
              "K7 serve": ("K7", 1024, 3584, False),
              "K8 vit": ("K8", 3096, 3200, True),
              "K8 vit no-ls": ("K8", 3096, 3200, False),
              "K8 serve": ("K8", 8256, 3200, True)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="directory holding the omchat_torch package to time")
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    # this tree's timing helpers, imported before --root's tree (which may hold
    # an older chip_smoke.py) comes first on the path for omchat_torch
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import GRAPH_CALLS, PEAK_BYTES, cycling, graphed, hbm_set_count

    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from omchat_torch.ops import kernel_lib
    from omchat_torch.ops import linear as lin
    from omchat_torch.ops import norms
    from omchat_torch.ops import paged_attention as pa
    from omchat_torch.ops import quant_matmul as qm

    if not torch.cuda.is_available():
        print("quant_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    kernel_lib.build_all(["norm_quant.cu", "fc1_gelu_quant.cu", "swiglu_quant.cu", "proj_glue_quant.cu",
                          "commit_pages.cu"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, off=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale + off).to(bf)

    def qlinear(n, k):
        return lin.quantize_linear({"kernel": randn(k, n, scale=0.02)})

    def sha256(out):
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for t in out if isinstance(out, tuple) else (out,):
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return digest.hexdigest()

    cases, outputs, calls, bounds = {}, {}, {}, {}
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
        outputs[name] = sha256(cases[name]())

    for i, (name, (kernel, M, D, with_ls)) in enumerate(ROW_SHAPES.items(), start=len(SHAPES)):
        gen.manual_seed(i)
        gamma = randn(D, scale=0.1, off=1.0)
        if kernel == "K7":
            nbytes = M * D * 3 + D * 2 + M * 4

            def call(x, gamma=gamma):
                return norms.rmsnorm_quant(x, gamma)
        else:
            ls = randn(D, scale=0.02, off=0.1) if with_ls else None
            nbytes = M * D * 7 + D * 2 * (2 if with_ls else 1) + M * 4

            def call(x, delta, ls=ls, gamma=gamma):
                return norms.add_rmsnorm_quant(x, delta, ls, gamma)
        sets = [tuple(randn(M, D) for _ in range(1 if kernel == "K7" else 2)) for _ in range(hbm_set_count(nbytes))]
        outputs[name] = sha256(call(*sets[0]))
        eager = cycling(call, sets)
        cases[name], calls[name] = graphed(eager, GRAPH_CALLS), GRAPH_CALLS
        cases[f"{name} eager"] = eager
        bounds[name] = nbytes / PEAK_BYTES * 1e3

    L, B, KVH, T, D = K15_CACHE
    CH, PS = T // 128, 128
    for i, dtype in enumerate((torch.bfloat16, torch.float8_e4m3fn), start=len(SHAPES) + len(ROW_SHAPES)):
        name = "K15 bf16" if dtype == torch.bfloat16 else "K15 e4m3"
        gen.manual_seed(i)
        pools = [torch.zeros(L * K15_LAYER_PAGES, KVH, PS, D, dtype=dtype, device="cuda") for _ in range(2)]
        pages = torch.randperm(L * K15_LAYER_PAGES, generator=gen, device="cuda")[:L * B * CH].int()
        M, page_bytes = L * B * CH, KVH * PS * D
        nbytes = 2 * M * page_bytes * (2 + pools[0].element_size()) + M * 4
        sets = [tuple(randn(L * B, KVH, CH, PS, D).transpose(1, 2) for _ in range(2))
                for _ in range(hbm_set_count(nbytes))]
        commit = functools.partial(pa.commit_pages, *pools, pages)
        outputs[name] = sha256(tuple(p[pages.long()] for p in commit(*sets[0])))
        eager = cycling(commit, sets)
        cases[name], calls[name] = graphed(eager, GRAPH_CALLS), GRAPH_CALLS
        cases[f"{name} eager"] = eager
        bounds[name] = nbytes / PEAK_BYTES * 1e3

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
            readings[case].append(time_ms(fn) / calls.get(case, 1))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    ms = {k: sorted(r)[len(r) // 2] for k, r in readings.items()}
    print(json.dumps({"card": smi.stdout.strip(), "label": args.label, "ms": ms,
                      "readings": {k: [round(x, 5) for x in r] for k, r in readings.items()},
                      "bound_ms": bounds, "share_of_bound": {k: b / ms[k] for k, b in bounds.items()},
                      "sha256": outputs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
