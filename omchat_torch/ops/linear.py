"""Linear layers with int8 weight-only and weight + activation (w8a8)
quantization — PyTorch port of ``omchat_tpu/ops/linear.py``.

A param dict is either
  {"kernel": [in, out], "bias"?}                           — dense
  {"kernel_q": int8 [out, in], "scale": [out], "bias"?}    — quantized

The dense kernel keeps the JAX package's [in, out] layout.  The int8 kernel
is stored TRANSPOSED, [out, in] (stacked: [L, out, in]): the int8 tensor-core
product (``mma.sync ... .s8.s8`` in the port's CUDA kernels, and cuBLASLt
behind ``torch._int_mm``) wants the contraction axis contiguous for both
operands, and the transpose is paid once, at quantization or conversion,
instead of in every launch.  Codes and scales are the JAX package's.

- weight-only int8 (``dense`` without ``a8``): the codes are converted to the
  activation dtype and multiplied in it, then rescaled per output channel;
- w8a8 (``a8=True``, :func:`dense_prequant`): activations are quantized per
  token (symmetric, dynamic amax) and the product runs int8 x int8 → int32
  through :func:`int8_matmul`; the dequantization rounds as in JAX: int32 →
  fp32 × row scale × column scale → activation dtype → bias added in that
  dtype.
"""

from __future__ import annotations

import torch


def int8_matmul(a: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] → int32 [M, N] (``torch._int_mm``).

    ``w_t`` is the transposed view of an [N, K] kernel.  On CUDA
    ``_int_mm`` takes only M > 16, so fewer rows are padded with zeros and the
    pad rows dropped again."""
    m = a.shape[0]
    if a.device.type == "cuda" and m <= 16:
        a = torch.cat([a, a.new_zeros((17 - m, a.shape[1]))])
        return torch._int_mm(a, w_t)[:m]
    return torch._int_mm(a, w_t)


def div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as an IEEE division, as JAX and the kernels divide (PyTorch on
    CUDA divides by a Python number as a multiply by its reciprocal, which
    can be one ulp off)."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def quantize_activations(x: torch.Tensor):
    """Dynamic symmetric per-token (last-axis) int8 quantization.

    Returns (x_q int8, row_scale fp32 [..., 1]) with x ≈ x_q * row_scale."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    row_scale = div127(amax.clamp(min=1e-6))
    xq = torch.round(xf / row_scale).clamp(-127, 127).to(torch.int8)
    return xq, row_scale


def _int8_product(xq: torch.Tensor, p: dict) -> torch.Tensor:
    """int32 [..., out] of int8 activations xq [..., in] and ``p["kernel_q"]``."""
    lead = xq.shape[:-1]
    w = p["kernel_q"]
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), w.t())
    return acc.reshape(*lead, w.shape[0])


def dense_prequant(xq: torch.Tensor, row_scale, p: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """w8a8 matmul over activations already quantized elsewhere (the glue
    kernels): y = (xq @ Wq) * row_scale * w_scale, cast to ``dtype``, + bias.

    xq int8 [..., in]; row_scale fp32 [..., 1] or a scalar (a static scale)."""
    acc = _int8_product(xq, p)
    y = (acc.float() * row_scale * p["scale"].float()).to(dtype)
    if "bias" in p:
        y = y + p["bias"]
    return y


def gelu_tanh(h: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU in the JAX package's arithmetic order
    (``jax.nn.gelu(approximate=True)``), its constants rounded to h's dtype
    as JAX rounds them."""
    c = {v: float(torch.tensor(v, dtype=h.dtype)) for v in (0.5, 0.7978845608028654, 0.044715)}
    return h * (c[0.5] * (1.0 + torch.tanh(c[0.7978845608028654] * (h + c[0.044715] * (h * h * h)))))


def dense_prequant_gelu_quant(xq: torch.Tensor, row_scale, p: dict, out_scale) -> torch.Tensor:
    """fc1 int8 matmul + tanh-GELU + static-scale int8 re-quantization, all
    epilogue math in fp32 (the XLA chain; ``h / out_scale`` is a true
    division).  Returns int8 codes; feed them to :func:`dense_prequant` with
    ``out_scale``.  The fused kernel is :func:`omchat_torch.ops.quant_matmul.
    fc1_gelu_quant` (K9)."""
    acc = _int8_product(xq, p)
    h = acc.float() * row_scale * p["scale"].float()
    if "bias" in p:
        h = h + p["bias"].float()
    return torch.round(gelu_tanh(h) / out_scale).clamp(-127, 127).to(torch.int8)


def _dense_w8a8(x: torch.Tensor, p: dict) -> torch.Tensor:
    xq, row_scale = quantize_activations(x)
    return dense_prequant(xq, row_scale, p, dtype=x.dtype)


def dense(x: torch.Tensor, p: dict, *, a8: bool = False) -> torch.Tensor:
    """y = x @ W (+ bias), dequantizing int8 weights.

    ``a8=True`` also quantizes the activations per token and runs the int8
    product (a no-op for unquantized params)."""
    if "kernel_q" in p:
        if a8:
            return _dense_w8a8(x, p)
        y = (x @ p["kernel_q"].to(x.dtype).t()) * p["scale"].to(x.dtype)
    else:
        y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def quantize_linear(p: dict) -> dict:
    """Per-output-channel symmetric int8 quantization of a linear param dict
    (kernel [..., in, out] → kernel_q [..., out, in] and scale [..., out]
    bf16); stacked [L, in, out] kernels get per-(layer, out) scales.  Stacked
    kernels are quantized one layer at a time, so no fp32 copy of a whole
    stack is ever held."""
    if "kernel" not in p:
        return p
    w = p["kernel"]
    if w.dim() == 3:
        n_layers, d_in, d_out = w.shape
        out = {"kernel_q": torch.empty((n_layers, d_out, d_in), dtype=torch.int8, device=w.device),
               "scale": torch.empty((n_layers, d_out), dtype=torch.bfloat16, device=w.device)}
        for i in range(n_layers):
            part = quantize_linear({"kernel": w[i]})
            out["kernel_q"][i], out["scale"][i] = part["kernel_q"], part["scale"]
    else:
        wf = w.float()
        scale = div127(wf.abs().amax(dim=-2)).clamp(min=1e-8)  # [out]
        q = torch.round(wf / scale[None, :]).clamp(-127, 127).to(torch.int8)
        out = {"kernel_q": q.t().contiguous(), "scale": scale.to(torch.bfloat16)}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def quantize_tree(params):
    """Quantize every linear param dict in a tree (dicts holding a 2-D or
    3-D 'kernel'; the 4-D patch conv stays)."""
    if isinstance(params, dict):
        if "kernel" in params and getattr(params["kernel"], "ndim", 0) in (2, 3):
            return quantize_linear(params)
        return {k: quantize_tree(v) for k, v in params.items()}
    return params
