"""The w8a8 kernels' first call on the card: build K7/K8/K9/K11 with
``-Xptxas -v``, hold each against its plain version at the single-image
path's shapes and at small edge shapes, time them, and try the operand
layouts and row counts ``torch._int_mm`` accepts.  Needs one NVIDIA GPU:

    python3 chip_probes/w8a8_kernels_first_call.py
"""
import json
import subprocess
import sys
import time

sys.path.insert(0, ".")
import torch

from omchat_torch.ops import kernel_lib
from omchat_torch.ops import linear as lin
from omchat_torch.ops import norms
from omchat_torch.ops import quant_matmul as qm

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip())
print(sys.version, torch.__version__, torch.version.cuda)
t0 = time.time()
kernel_lib.build_all(["norm_quant.cu", "fc1_gelu_quant.cu", "proj_glue_quant.cu"], verbose=True)
print("build", time.time() - t0)
dev = "cuda"
g = torch.Generator(device=dev).manual_seed(0)


def rn(*s, scale=1.0, off=0.0):
    return (torch.randn(s, generator=g, device=dev) * scale + off).bfloat16()


def t_ms(fn, it=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(it):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / it


def codes_cmp(a, b):
    d = (a.int() - b.int()).abs()
    return int(d.max()), float((d == 0).float().mean())


def ulp_cmp(a, b):
    a, b = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp(min=1e-30))) - 7)
    return float(((a - b).abs() <= ulp).float().mean()), float((a - b).abs().max())


res = {}
for M, D in ((3200, 3584), (3096, 3200), (5, 3584)):
    x, gm = rn(M, D), rn(D, scale=0.1, off=1.0)
    x[0] = 0
    q, rs = norms.rmsnorm_quant(x, gm)
    torch.cuda.synchronize()
    qp, rp = norms.rmsnorm_quant_plain(x, gm)
    res[f"K7 {M}x{D}"] = dict(codes=codes_cmp(q, qp), rs_rel=float(((rs - rp).abs() / rp).max()),
                              ms=t_ms(lambda: norms.rmsnorm_quant(x, gm)), zero_row_scale=float(rs[0, 0]))
    d, ls = rn(M, D), rn(D, scale=0.1)
    xn, q, rs = norms.add_rmsnorm_quant(x, d, ls, gm)
    torch.cuda.synchronize()
    xp, qp, rp = norms.add_rmsnorm_quant_plain(x, d, ls, gm)
    res[f"K8 {M}x{D}"] = dict(x=ulp_cmp(xn, xp), codes=codes_cmp(q, qp), rs_rel=float(((rs - rp).abs() / rp).max()),
                              ms=t_ms(lambda: norms.add_rmsnorm_quant(x, d, ls, gm)))
print(json.dumps(res, indent=1), flush=True)

res = {}
for M, K, N in ((3096, 3200, 12800), (13, 256, 384), (300, 256, 384)):
    xq = torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
    rs = torch.rand((M, 1), generator=g, device=dev) * 0.01 + 1e-3
    p = {"kernel_q": torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int8),
         "scale": (torch.rand(N, generator=g, device=dev) * 4e-4 + 1e-4).bfloat16(),
         "bias": rn(N, scale=0.01)}
    # out scale so the codes span the int8 range: amax of gelu(h)/127
    hp = lin.gelu_tanh(lin.int8_matmul(xq, p["kernel_q"].t()).float() * rs * p["scale"].float() + p["bias"].float())
    os_ = (hp.abs().amax() / 127).reshape(())
    out = qm.dense_prequant_gelu_quant_cuda(xq, rs, p, os_)
    torch.cuda.synchronize()
    ref = qm.dense_prequant_gelu_quant_plain(xq, rs, p, os_)
    r = dict(codes=codes_cmp(out, ref), ms=t_ms(lambda: qm.dense_prequant_gelu_quant_cuda(xq, rs, p, os_)),
             codes_mean_abs=float(ref.float().abs().mean()))
    if M > 1000:
        wt = p["kernel_q"].t()
        wkn = wt.contiguous()
        r["int_mm_ms_wT_view"] = t_ms(lambda: torch._int_mm(xq, wt))
        try:
            r["int_mm_ms_KN_contig"] = t_ms(lambda: torch._int_mm(xq, wkn))
            r["int_mm_same"] = bool(torch.equal(torch._int_mm(xq, wt), torch._int_mm(xq, wkn)))
        except Exception as e:  # noqa: BLE001
            r["int_mm_KN_contig_error"] = str(e)[:200]
        try:
            r["int_mm_M2050"] = list(torch._int_mm(xq[:2050], wt).shape)
        except Exception as e:  # noqa: BLE001
            r["int_mm_M2050_error"] = str(e)[:200]
        for m in (16, 17):
            try:
                torch._int_mm(xq[:m], wt)
                r[f"int_mm_M{m}"] = "ok"
            except Exception as e:  # noqa: BLE001
                r[f"int_mm_M{m}"] = str(e)[:120]
    res[f"K9 {M}x{K}x{N}"] = r
print(json.dumps(res, indent=1), flush=True)

res = {}
for M, K, ls_on in ((3096, 3200, True), (3200, 3584, False), (7, 256, True), (70, 384, True)):
    a, x = rn(M, K, scale=0.5), rn(M, K)
    a[1] = 0
    p = {"kernel_q": torch.randint(-127, 128, (K, K), generator=g, device=dev, dtype=torch.int8),
         "scale": (torch.rand(K, generator=g, device=dev) * 4e-4 + 1e-4).bfloat16()}
    if ls_on:
        p["bias"] = rn(K, scale=0.01)
    ls = rn(K, scale=0.1, off=0.05) if ls_on else None
    gm = rn(K, scale=0.1, off=1.0)
    xn, q, rs = qm.attn_proj_glue_quant(a, x, p, ls, gm)
    torch.cuda.synchronize()
    xp, qp, rp = qm.attn_proj_glue_quant_plain(a, x, p, ls, gm)
    res[f"K11 {M}x{K}"] = dict(x=ulp_cmp(xn, xp), codes=codes_cmp(q, qp), rs_rel=float(((rs - rp).abs() / rp).max()),
                               ms=t_ms(lambda: qm.attn_proj_glue_quant(a, x, p, ls, gm)),
                               int_mm_ms=t_ms(lambda: torch._int_mm(q.view(M, K) if M > 16 else q, p["kernel_q"].t()))
                               if M > 16 else None)
print(json.dumps(res, indent=1), flush=True)
