"""Normalization ops (PyTorch port of ``omchat_tpu/ops/norms.py``).

Statistics in float32, output cast back to the input dtype (reference:
modeling_intern_vit.py:33-44 InternRMSNorm, HF Qwen2RMSNorm).

The w8a8 glue kernels, each as a wrapper (a CPU tensor runs the plain
version, a CUDA tensor launches the kernel of ``omchat_torch/csrc/
norm_quant.cu`` or raises), a plain version and a launch counter
(``<wrapper>.launches``):

- K7 :func:`rmsnorm_quant` — RMSNorm·γ → per-row int8 codes + row scales;
- K8 :func:`add_rmsnorm_quant` — x' = x + δ·ls rounded once to x's dtype,
  then RMSNorm·γ of x' → codes + row scales.

Both quantize the fp32 normalized value directly, as the Pallas kernel
bodies do (``norms.py:68-71, 89-91``): the unfused chain would round the norm
output to bf16 first, which moves a few percent of codes by ±1.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from omchat_torch.ops import kernel_lib
from omchat_torch.ops.linear import div127


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis; fp32 statistics, output in x.dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (scale.float() * xf).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis; fp32 statistics (InternViT-300M norm_type)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * scale.float() + bias.float()).to(x.dtype)


def apply_norm(x: torch.Tensor, params: dict, eps: float = 1e-6) -> torch.Tensor:
    """Dispatch on the param dict: {'scale'} → RMSNorm, {'scale','bias'} → LayerNorm."""
    if "bias" in params:
        return layer_norm(x, params["scale"], params["bias"], eps)
    return rms_norm(x, params["scale"], eps)


# ---------------------------------------------------------------------------
# K7 / K8: RMSNorm + per-row int8 quantize (w8a8 glue)
# ---------------------------------------------------------------------------

# C signatures: x, gamma, codes, row_scale, rows, D, eps, stream /
# x, delta, ls, gamma, x_new, codes, row_scale, rows, D, eps, stream
_K7_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
_K8_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]


def norm_quant_rows(xf: torch.Tensor, gamma: torch.Tensor, eps: float):
    """RMSNorm·γ of fp32 rows and its per-row int8 quantization, in the
    Pallas kernels' order: n = (x * (1 / sqrt(mean(x²) + eps))) * γ, row scale =
    max(amax |n|, 1e-6) / 127, codes = clip(round_half_even(n / scale)).
    Returns (codes int8, row_scale fp32 [..., 1])."""
    var = (xf * xf).mean(dim=-1, keepdim=True)
    n = xf * (1.0 / torch.sqrt(var + eps)) * gamma.float()  # IEEE, as the kernels (CUDA's rsqrt is approximate)
    rs = div127(n.abs().amax(dim=-1, keepdim=True).clamp(min=1e-6))
    return torch.round(n / rs).clamp(-127, 127).to(torch.int8), rs


def rmsnorm_quant_plain(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    """K7's function, untiled: (codes int8 [..., D], row_scale fp32 [..., 1])."""
    return norm_quant_rows(x.float(), gamma, eps)


def add_rmsnorm_quant_plain(x: torch.Tensor, delta: torch.Tensor, ls: Optional[torch.Tensor],
                            gamma: torch.Tensor, eps: float = 1e-6):
    """K8's function, untiled: x' = x + δ·ls in fp32, rounded once to x's
    dtype; codes and row scales of RMSNorm·γ of x' (ls None: a plain
    residual).  Returns (x' [..., D], codes int8, row_scale fp32 [..., 1])."""
    d = delta.float() if ls is None else delta.float() * ls.float()
    xn = (x.float() + d).to(x.dtype)
    return (xn, *norm_quant_rows(xn.float(), gamma, eps))


def _check_rows(name: str, x: torch.Tensor, *vectors: Optional[torch.Tensor]) -> None:
    for t in (x, *(v for v in vectors if v is not None)):
        if t.device.type != "cuda" or t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16 CUDA tensors, got {t.dtype} on {t.device}")
    d = x.shape[-1]
    if d % 8 or d > 16384:
        raise ValueError(f"{name}: row width {d} unsupported (a multiple of 8 up to 16384)")
    for v in vectors:
        if v is not None and v.shape != (d,):
            raise ValueError(f"{name}: expected a [{d}] vector, got {tuple(v.shape)}")


def rmsnorm_quant(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    """``codes = int8(rms_norm(x, gamma))`` in one pass over x: only the int8
    codes and the fp32 row scales are written.  Returns (codes [..., D] int8,
    row_scale [..., 1] fp32), matching ``quantize_activations(rms_norm(x,
    gamma))`` up to ±1 code (the bf16 rounding of the norm is skipped)."""
    if x.device.type == "cpu":
        return rmsnorm_quant_plain(x, gamma, eps)
    _check_rows("rmsnorm_quant", x, gamma)
    d = x.shape[-1]
    xc, gc = x.contiguous(), gamma.contiguous()
    rows = xc.numel() // d
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    rs = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    if rows:
        kernel_lib.launch("norm_quant.cu", "omchat_rmsnorm_quant", _K7_ARGS,
                          *map(kernel_lib.ptr, (xc, gc, codes, rs)), rows, d, float(eps),
                          kernel_lib.stream_ptr(x.device))
        rmsnorm_quant.launches += 1
    return codes, rs


rmsnorm_quant.launches = 0


def add_rmsnorm_quant(x: torch.Tensor, delta: torch.Tensor, ls: Optional[torch.Tensor], gamma: torch.Tensor,
                      eps: float = 1e-6):
    """Fused ``x' = x + delta*ls; codes = int8(rms_norm(x')*gamma)``.

    x, delta [..., D] (same shape and dtype); ls [D] LayerScale (None: a
    plain residual); gamma [D] of the NEXT norm.  Returns (x' [..., D],
    codes [..., D] int8, row_scale [..., 1] fp32)."""
    if x.device.type == "cpu":
        return add_rmsnorm_quant_plain(x, delta, ls, gamma, eps)
    _check_rows("add_rmsnorm_quant", x, ls, gamma)
    if delta.shape != x.shape or delta.dtype != x.dtype or delta.device != x.device:
        raise ValueError("add_rmsnorm_quant: delta must match x in shape, dtype and device")
    d = x.shape[-1]
    xc, dc, gc = x.contiguous(), delta.contiguous(), gamma.contiguous()
    lc = ls.contiguous() if ls is not None else None
    rows = xc.numel() // d
    xn = torch.empty_like(xc)
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    rs = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    if rows:
        kernel_lib.launch("norm_quant.cu", "omchat_add_rmsnorm_quant", _K8_ARGS,
                          kernel_lib.ptr(xc), kernel_lib.ptr(dc), None if lc is None else kernel_lib.ptr(lc),
                          *map(kernel_lib.ptr, (gc, xn, codes, rs)), rows, d, float(eps),
                          kernel_lib.stream_ptr(x.device))
        add_rmsnorm_quant.launches += 1
    return xn, codes, rs


add_rmsnorm_quant.launches = 0
