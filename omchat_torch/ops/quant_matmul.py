"""int8 matmuls with fused epilogues, the w8a8 hot ops — PyTorch port of
``omchat_tpu/ops/quant_matmul.py``.

- K9 :func:`dense_prequant_gelu_quant_cuda` (dispatched by
  :func:`fc1_gelu_quant`): the ViT fc1.  int8 x int8 → int32, × row scale ×
  column scale, + bias, tanh-GELU, × 1/out_scale, round half to even, clip
  → int8 codes; only the codes are written (``omchat_torch/csrc/
  fc1_gelu_quant.cu``).
- K10 :func:`dense_prequant_swiglu_quant_cuda` (dispatched by
  :func:`swiglu_quant`): the Qwen2 MLP's gate and up with a calibrated
  ``swiglu_out_scale``.  Two int8 products, each × row scale × its column
  scale in fp32, silu(g) · u, × 1/out_scale, round half to even, clip → int8
  codes for down_proj (``omchat_torch/csrc/swiglu_quant.cu``).
- K11 :func:`attn_proj_glue_quant`: the attention output projection fused
  with the glue after it.  Dynamic row quantization of the attention output,
  the int8 product with the square proj / o_proj weight, dequant + bias in the
  activation dtype, x' = x + y·ls rounded once, RMSNorm·γ of x', int8 codes
  and row scales (``omchat_torch/csrc/proj_glue_quant.cu``: a row prepass,
  the product on the TMA + wgmma int8 mainloop ``csrc/s8_gemm_sm90.cuh`` with
  the glue in its epilogue, a row finish).

K9's and K10's products run on K11's TMA + wgmma int8 mainloop with their
epilogues from the accumulators; their TMA maps need xq and the weights
contiguous with 16-byte-aligned bases, so the wrappers copy an operand that
is not (:func:`_tma_operand`).

Each has a plain version (``*_plain``) and a launch counter
(``<wrapper>.launches``); a CPU tensor runs the plain version, a CUDA tensor
launches the kernel or raises.  Weights are int8 [N, K] (``kernel_q``, see
:mod:`omchat_torch.ops.linear`).

K9 and K10 multiply by ``1 / out_scale`` as the Pallas kernels do
(``quant_matmul.py:58``, ``:127``); the XLA chains
(:func:`~omchat_torch.ops.linear.dense_prequant_gelu_quant`,
:func:`~omchat_torch.ops.linear.dense_prequant_swiglu_quant`) divide, and
the two agree to ±1 code.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from omchat_torch.ops import kernel_lib
from omchat_torch.ops.linear import (
    dense_prequant_gelu_quant,
    dense_prequant_swiglu_quant,
    div127,
    gelu_tanh,
    int8_matmul,
    silu,
)
from omchat_torch.ops.norms import norm_quant_rows

# C signatures: xq, w, row_scale, col_scale, bias, out_scale, out, M, N, K, stream /
# xq, w_gate, w_up, row_scale, col_scale_gate, col_scale_up, out_scale, out, M, N, K, stream /
# a, x, w, col_scale, bias, ls, gamma, x_new, codes, row_scale, aq, sa, partial, M, N, eps, stream
_K9_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_K10_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_K11_ARGS = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
PROJ_GLUE_TILE = 128  # K11's GEMM tiles x' in PROJ_GLUE_TILE x PROJ_GLUE_TILE blocks


def pallas_supported(k: int, n: int) -> bool:
    """Geometry gate of the fused fc1 and SwiGLU epilogues (the JAX
    package's, which the CUDA kernels share: their K stages are 128 deep,
    their output tiles 128 or 64 wide)."""
    return k % 128 == 0 and n % 128 == 0


def proj_glue_supported(k: int, n: int) -> bool:
    """Geometry gate of the fused proj + glue kernel: a square weight with a
    128-multiple side up to 4096 (InternViT-6B proj 3200², Qwen2-7B o_proj
    3584²).  The JAX gate, which the TPU kernel's VMEM-resident weight sets;
    the CUDA kernel shares it, so both packages fuse the same layers (its
    128 x 128 tiles need only the 128-multiple side)."""
    return k == n and k % 128 == 0 and k * n <= 4096 * 4096


def _tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a TMA map reads it: contiguous, its base 16-byte aligned (a
    copy where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _bf16_cuda(name: str, *tensors: Optional[torch.Tensor]) -> None:
    for t in tensors:
        if t is not None and (t.device.type != "cuda" or t.dtype != torch.bfloat16):
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16 CUDA tensors, got {t.dtype} on {t.device}")


# ---------------------------------------------------------------------------
# K9: fc1 int8 GEMM + tanh-GELU + static-scale quantize
# ---------------------------------------------------------------------------


def dense_prequant_gelu_quant_plain(xq: torch.Tensor, row_scale: torch.Tensor, p: dict, out_scale) -> torch.Tensor:
    """K9's function, untiled, in the Pallas kernel's order: h = acc × rs ×
    cs + bias (fp32), tanh-GELU, codes = clip(round(h × (1 / out_scale)))."""
    k = xq.shape[-1]
    acc = int8_matmul(xq.reshape(-1, k), p["kernel_q"].t())
    h = acc.float() * row_scale.float().reshape(-1, 1) * p["scale"].float()
    if "bias" in p:
        h = h + p["bias"].float()
    inv = 1.0 / torch.as_tensor(out_scale, dtype=torch.float32, device=h.device)
    codes = torch.round(gelu_tanh(h) * inv).clamp(-127, 127).to(torch.int8)
    return codes.reshape(*xq.shape[:-1], -1)


def dense_prequant_gelu_quant_cuda(xq: torch.Tensor, row_scale: torch.Tensor, p: dict, out_scale) -> torch.Tensor:
    """K9: xq int8 [..., K]; row_scale fp32 [..., 1]; ``p["kernel_q"]`` int8
    [N, K], ``p["scale"]`` [N] (and ``p["bias"]`` [N]) bf16; out_scale a
    scalar fp32 tensor.  Returns int8 codes [..., N]."""
    if xq.device.type == "cpu":
        return dense_prequant_gelu_quant_plain(xq, row_scale, p, out_scale)
    w = p["kernel_q"]
    n, k = w.shape
    bias = p.get("bias")
    _bf16_cuda("fc1_gelu_quant", p["scale"], bias)
    if xq.dtype != torch.int8 or w.dtype != torch.int8 or xq.shape[-1] != k or not pallas_supported(k, n):
        raise ValueError(f"fc1_gelu_quant: unsupported operands {tuple(xq.shape)} {xq.dtype} x {tuple(w.shape)} "
                         f"{w.dtype}")
    a = _tma_operand(xq.reshape(-1, k))
    m = a.shape[0]
    rs = row_scale.to(torch.float32).reshape(m).contiguous()
    os_ = torch.as_tensor(out_scale, dtype=torch.float32, device=xq.device).reshape(1).contiguous()
    wc, cs = _tma_operand(w), p["scale"].contiguous()
    bc = bias.contiguous() if bias is not None else None
    out = torch.empty((m, n), dtype=torch.int8, device=xq.device)
    if m:
        kernel_lib.launch("fc1_gelu_quant.cu", "omchat_fc1_gelu_quant", _K9_ARGS,
                          *map(kernel_lib.ptr, (a, wc, rs, cs)), None if bc is None else kernel_lib.ptr(bc),
                          kernel_lib.ptr(os_), kernel_lib.ptr(out), m, n, k, kernel_lib.stream_ptr(xq.device))
        dense_prequant_gelu_quant_cuda.launches += 1
    return out.reshape(*xq.shape[:-1], n)


dense_prequant_gelu_quant_cuda.launches = 0


def fc1_gelu_quant(xq: torch.Tensor, row_scale: torch.Tensor, p: dict, out_scale) -> torch.Tensor:
    """The static-scale quantizing fc1 epilogue: K9 where its geometry gate
    holds (``pallas_supported``), else the unfused chain, as the JAX
    dispatcher chooses."""
    n, k = p["kernel_q"].shape
    if pallas_supported(k, n):
        return dense_prequant_gelu_quant_cuda(xq, row_scale, p, out_scale)
    return dense_prequant_gelu_quant(xq, row_scale, p, out_scale)


# ---------------------------------------------------------------------------
# K10: gate and up int8 GEMMs + silu * up + static-scale quantize
# ---------------------------------------------------------------------------


def dense_prequant_swiglu_quant_plain(xq: torch.Tensor, row_scale: torch.Tensor, gate_p: dict, up_p: dict,
                                      out_scale) -> torch.Tensor:
    """K10's function, untiled, in the Pallas kernel's order: g = acc_g ×
    rs × cs_g and u = acc_u × rs × cs_u (fp32), codes = clip(round(silu(g) ×
    u × (1 / out_scale)))."""
    k = xq.shape[-1]
    a = xq.reshape(-1, k)
    rs = row_scale.float().reshape(-1, 1)
    g = int8_matmul(a, gate_p["kernel_q"].t()).float() * rs * gate_p["scale"].float()
    u = int8_matmul(a, up_p["kernel_q"].t()).float() * rs * up_p["scale"].float()
    inv = 1.0 / torch.as_tensor(out_scale, dtype=torch.float32, device=g.device)
    codes = torch.round(silu(g) * u * inv).clamp(-127, 127).to(torch.int8)
    return codes.reshape(*xq.shape[:-1], -1)


def dense_prequant_swiglu_quant_cuda(xq: torch.Tensor, row_scale: torch.Tensor, gate_p: dict, up_p: dict,
                                     out_scale) -> torch.Tensor:
    """K10: xq int8 [..., K]; row_scale fp32 [..., 1]; ``gate_p`` /
    ``up_p``: ``kernel_q`` int8 [N, K], ``scale`` [N] bf16; out_scale a
    scalar fp32 tensor.  Returns int8 codes [..., N]."""
    if xq.device.type == "cpu":
        return dense_prequant_swiglu_quant_plain(xq, row_scale, gate_p, up_p, out_scale)
    wg, wu = gate_p["kernel_q"], up_p["kernel_q"]
    n, k = wg.shape
    _bf16_cuda("swiglu_quant", gate_p["scale"], up_p["scale"])
    if (xq.dtype != torch.int8 or wg.dtype != torch.int8 or wu.dtype != torch.int8 or wu.shape != wg.shape
            or xq.shape[-1] != k or not pallas_supported(k, n)):
        raise ValueError(f"swiglu_quant: unsupported operands {tuple(xq.shape)} {xq.dtype} x {tuple(wg.shape)} "
                         f"{wg.dtype} / {tuple(wu.shape)} {wu.dtype}")
    a = _tma_operand(xq.reshape(-1, k))
    m = a.shape[0]
    rs = row_scale.to(torch.float32).reshape(m).contiguous()
    os_ = torch.as_tensor(out_scale, dtype=torch.float32, device=xq.device).reshape(1).contiguous()
    gc, uc = _tma_operand(wg), _tma_operand(wu)
    sg, su = gate_p["scale"].contiguous(), up_p["scale"].contiguous()
    out = torch.empty((m, n), dtype=torch.int8, device=xq.device)
    if m:
        kernel_lib.launch("swiglu_quant.cu", "omchat_swiglu_quant", _K10_ARGS,
                          *map(kernel_lib.ptr, (a, gc, uc, rs, sg, su, os_, out)), m, n, k,
                          kernel_lib.stream_ptr(xq.device))
        dense_prequant_swiglu_quant_cuda.launches += 1
    return out.reshape(*xq.shape[:-1], n)


dense_prequant_swiglu_quant_cuda.launches = 0


def swiglu_quant(xq: torch.Tensor, row_scale: torch.Tensor, gate_p: dict, up_p: dict, out_scale) -> torch.Tensor:
    """The static-scale quantizing SwiGLU epilogue: K10 where its geometry
    gate holds (``pallas_supported``), else the unfused chain, as the JAX
    dispatcher chooses."""
    n, k = gate_p["kernel_q"].shape
    if pallas_supported(k, n):
        return dense_prequant_swiglu_quant_cuda(xq, row_scale, gate_p, up_p, out_scale)
    return dense_prequant_swiglu_quant(xq, row_scale, gate_p, up_p, out_scale)


# ---------------------------------------------------------------------------
# K11: attention proj + residual + RMSNorm + quantize
# ---------------------------------------------------------------------------


def attn_proj_glue_quant_plain(attn_out: torch.Tensor, x: torch.Tensor, p: dict, ls: Optional[torch.Tensor],
                               gamma: torch.Tensor, eps: float = 1e-6):
    """K11's function, untiled, in the Pallas kernel's order: sa =
    max(amax |a|, 1e-6) / 127 per row, aq = clip(round(a / sa)); y =
    dtype(acc × sa × cs), y = y + bias in the activation dtype; x' = dtype(x +
    y × ls) (ls None: a plain residual); codes and row scales of RMSNorm·γ of
    x'.  Returns (x', codes int8, row_scale fp32 [..., 1])."""
    w = p["kernel_q"]
    n, k = w.shape
    a = attn_out.reshape(-1, k).float()
    sa = div127(a.abs().amax(dim=-1, keepdim=True).clamp(min=1e-6))
    aq = torch.round(a / sa).clamp(-127, 127).to(torch.int8)
    y = (int8_matmul(aq, w.t()).float() * sa * p["scale"].float()).to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    d = y.float() if ls is None else y.float() * ls.float()
    xn = (x.reshape(-1, n).float() + d).to(x.dtype)
    codes, rs = norm_quant_rows(xn.float(), gamma, eps)
    lead = x.shape[:-1]
    return xn.reshape(*lead, n), codes.reshape(*lead, n), rs.reshape(*lead, 1)


def proj_glue_scratch(m: int, n: int) -> dict:
    """The shapes and dtypes of K11's scratch for m rows of width n (K == n):
    the codes of the attention output and their row scales (the prepass's
    output, the GEMM's A operand), and each row's sum of x'² over each
    ``PROJ_GLUE_TILE``-column tile of the GEMM (the finish sums them in tile
    order)."""
    return {"aq": ((m, n), torch.int8), "sa": ((m,), torch.float32),
            "partial": ((m, n // PROJ_GLUE_TILE), torch.float32)}


def attn_proj_glue_quant(attn_out: torch.Tensor, x: torch.Tensor, p: dict, ls: Optional[torch.Tensor],
                         gamma: torch.Tensor, eps: float = 1e-6):
    """Fused ``dense(attn_out, p, a8=True)`` + ``add_rmsnorm_quant``: only x'
    (activation dtype), codes (int8) and row scales reach device memory.

    attn_out [..., K], x [..., N] bf16; ``p["kernel_q"]`` int8 [N, K] with
    K == N; ls [N] LayerScale or None; gamma [N] of the next norm.  Returns
    (x' [..., N], codes int8 [..., N], row_scale fp32 [..., 1])."""
    if x.device.type == "cpu":
        return attn_proj_glue_quant_plain(attn_out, x, p, ls, gamma, eps)
    w = p["kernel_q"]
    n, k = w.shape
    bias = p.get("bias")
    _bf16_cuda("attn_proj_glue_quant", attn_out, x, p["scale"], bias, ls, gamma)
    if w.dtype != torch.int8 or not proj_glue_supported(k, n) or attn_out.shape[-1] != k or x.shape[-1] != n:
        raise ValueError(f"attn_proj_glue_quant: unsupported operands {tuple(attn_out.shape)} x {tuple(w.shape)}")
    a2, x2 = attn_out.reshape(-1, k).contiguous(), x.reshape(-1, n).contiguous()
    m = a2.shape[0]
    if x2.shape[0] != m:
        raise ValueError("attn_proj_glue_quant: attn_out and x must have the same rows")
    wc, cs, gc = w.contiguous(), p["scale"].contiguous(), gamma.contiguous()
    if wc.data_ptr() % 16:
        raise ValueError("attn_proj_glue_quant: the weight's base address is not 16-byte aligned, as TMA needs")
    bc = bias.contiguous() if bias is not None else None
    lc = ls.contiguous() if ls is not None else None
    xn = torch.empty_like(x2)
    codes = torch.empty((m, n), dtype=torch.int8, device=x.device)
    rs = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m:
        scratch = [torch.empty(shape, dtype=dt, device=x.device) for shape, dt in proj_glue_scratch(m, n).values()]
        kernel_lib.launch("proj_glue_quant.cu", "omchat_proj_glue_quant", _K11_ARGS,
                          *map(kernel_lib.ptr, (a2, x2, wc, cs)), *(None if t is None else kernel_lib.ptr(t)
                                                                    for t in (bc, lc)),
                          *map(kernel_lib.ptr, (gc, xn, codes, rs, *scratch)), m, n, float(eps),
                          kernel_lib.stream_ptr(x.device))
        attn_proj_glue_quant.launches += 1
    lead = x.shape[:-1]
    return xn.reshape(*lead, n), codes.reshape(*lead, n), rs.reshape(*lead, 1)


attn_proj_glue_quant.launches = 0
