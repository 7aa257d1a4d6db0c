"""int8 matmuls with fused epilogues, the w8a8 hot ops — PyTorch port of
``omchat_tpu/ops/quant_matmul.py``.

- K9 :func:`dense_prequant_gelu_quant_cuda` (dispatched by
  :func:`fc1_gelu_quant`): the ViT fc1.  int8 x int8 → int32, × row scale ×
  column scale, + bias, tanh-GELU, × 1/out_scale, round half to even, clip
  → int8 codes; only the codes are written (``omchat_torch/csrc/
  fc1_gelu_quant.cu``).
- K11 :func:`attn_proj_glue_quant`: the attention output projection fused
  with the glue after it.  Dynamic row quantization of the attention output,
  the int8 product with the square proj / o_proj weight, dequant + bias in the
  activation dtype, x' = x + y·ls rounded once, RMSNorm·γ of x', int8 codes
  and row scales (``omchat_torch/csrc/proj_glue_quant.cu``).

Each has a plain version (``*_plain``) and a launch counter
(``<wrapper>.launches``); a CPU tensor runs the plain version, a CUDA tensor
launches the kernel or raises.  Weights are int8 [N, K] (``kernel_q``, see
:mod:`omchat_torch.ops.linear`).

K9 multiplies by ``1 / out_scale`` as the Pallas kernel does
(``quant_matmul.py:58``); the XLA chain :func:`~omchat_torch.ops.linear.
dense_prequant_gelu_quant` divides, and the two agree to ±1 code.

K10 (the quantizing SwiGLU epilogue) is not ported yet: it runs only once
``swiglu_out_scale`` is calibrated, which no load path does.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from omchat_torch.ops import kernel_lib
from omchat_torch.ops.linear import dense_prequant_gelu_quant, div127, gelu_tanh, int8_matmul
from omchat_torch.ops.norms import norm_quant_rows

# C signatures: xq, w, row_scale, col_scale, bias, out_scale, out, M, N, K, stream /
# a, x, w, col_scale, bias, ls, gamma, x_new, codes, row_scale, M, N, eps, stream
_K9_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_K11_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]


def pallas_supported(k: int, n: int) -> bool:
    """Geometry gate of the fused fc1 epilogue (the JAX package's, which the
    CUDA kernel shares: its tiles are 64 deep and 128 wide)."""
    return k % 128 == 0 and n % 128 == 0


def proj_glue_supported(k: int, n: int) -> bool:
    """Geometry gate of the fused proj + glue kernel: a square weight with a
    128-multiple side up to 4096 (the JAX gate; InternViT-6B proj 3200²,
    Qwen2-7B o_proj 3584²).  The CUDA kernel keeps a block's quantized rows
    of the attention output in shared memory, which bounds K."""
    return k == n and k % 128 == 0 and k * n <= 4096 * 4096


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
    a = xq.reshape(-1, k).contiguous()
    m = a.shape[0]
    rs = row_scale.to(torch.float32).reshape(m).contiguous()
    os_ = torch.as_tensor(out_scale, dtype=torch.float32, device=xq.device).reshape(1).contiguous()
    wc, cs = w.contiguous(), p["scale"].contiguous()
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


def swiglu_quant(xq, row_scale, gate_p: dict, up_p: dict, out_scale):
    """The static-scale quantizing SwiGLU epilogue (K10)."""
    raise NotImplementedError("K10 waits for a later slice (it needs calibrate_swiglu_scales, which no load path runs)")


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
    bc = bias.contiguous() if bias is not None else None
    lc = ls.contiguous() if ls is not None else None
    xn = torch.empty_like(x2)
    codes = torch.empty((m, n), dtype=torch.int8, device=x.device)
    rs = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m:
        kernel_lib.launch("proj_glue_quant.cu", "omchat_proj_glue_quant", _K11_ARGS,
                          *map(kernel_lib.ptr, (a2, x2, wc, cs)), *(None if t is None else kernel_lib.ptr(t)
                                                                    for t in (bc, lc)),
                          *map(kernel_lib.ptr, (gc, xn, codes, rs)), m, n, float(eps),
                          kernel_lib.stream_ptr(x.device))
        attn_proj_glue_quant.launches += 1
    lead = x.shape[:-1]
    return xn.reshape(*lead, n), codes.reshape(*lead, n), rs.reshape(*lead, 1)


attn_proj_glue_quant.launches = 0
