"""Trainable flash attention (K16): forward with the row log-sum-exp, and the
backward as two kernels, dQ and dK/dV — PyTorch port of
``omchat_tpu/ops/flash_attention_bwd.py``.

    di = rowsum(dO * O)
    P  = exp(S - lse)
    dV = P^T dO
    dS = P * (dO V^T - di)
    dQ = dS K * scale,    dK = dS^T (Q * scale)

GQA: the q heads sharing a kv head run in neighbouring blocks (forward and
dQ), and dK/dV are summed over the group inside the kernel.
``segment_ids`` (multi-document packing, ``--pack``) isolate documents; tiles
whose segments cannot meet are skipped.  As in JAX, every kernel takes q
multiplied by ``D**-0.5`` in q's dtype (:func:`_prescaled`); the backward
computes that product once and hands it to the dQ and dK/dV kernels.

The CUDA kernels take bfloat16 at every head width of
:func:`omchat_torch.ops.flash_attention.head_dim_supported` (a multiple of 8
from 8 to 128), causal or not, with or without segment ids.

Each kernel comes as a wrapper (:func:`flash_fwd`, :func:`flash_bwd_dq`,
:func:`flash_bwd_dkv`) that takes the plain PyTorch version (``*_plain``) for a
CPU tensor and launches the hand-written CUDA kernel
(``omchat_torch/csrc/flash_attention_bwd.cu``) for a CUDA tensor, or raises;
and a launch counter, ``<wrapper>.launches``.  :class:`FlashAttentionTrainable`
is the autograd function over them; :func:`flash_attention_trainable` its
entry point.

A row with no valid column (a padding row of a packed batch) gets lse = -inf,
output 0 and zero gradient.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from omchat_torch.ops import kernel_lib
from omchat_torch.ops.flash_attention import head_dim_supported

SOURCE = "flash_attention_bwd.cu"
# C signatures (every size an int; every kernel takes q prescaled, dQ also
# the softmax scale as a float, by which it multiplies dQ):
#   q, k, v, seg, out, lse, B, S, H, KVH, D, causal, stream
#   q, k, v, dout, lse, di, seg, dq, B, S, H, KVH, D, causal, scale, stream
#   q, k, v, dout, lse, di, seg, dk, dv, B, S, H, KVH, D, causal, stream
_SIZES = [ctypes.c_int] * 6
_FWD_ARGS = [ctypes.c_void_p] * 6 + _SIZES + [ctypes.c_void_p]
_DQ_ARGS = [ctypes.c_void_p] * 8 + _SIZES + [ctypes.c_float, ctypes.c_void_p]
_DKV_ARGS = [ctypes.c_void_p] * 9 + _SIZES + [ctypes.c_void_p]


def softmax_scale(q: torch.Tensor) -> torch.Tensor:
    """D^-0.5 rounded to q's dtype: the TPU kernels receive q * scale in q's
    dtype (flash_attention_bwd.py:332)."""
    return torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype, device=q.device)


def _scale_value(q: torch.Tensor) -> float:
    """:func:`softmax_scale`'s value, rounded to q's dtype on the host."""
    return float(torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype))


def attention_mask(s: int, causal: bool, segment_ids: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    """[B or 1, S, S] bool, True where row i may attend column j: j <= i when
    causal, and the same non-negative segment id with ``segment_ids``."""
    mask = None
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=device).tril()[None]
    if segment_ids is not None:
        seg = segment_ids
        same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] >= 0)
        mask = same if mask is None else mask & same
    return mask


def _grouped(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """[B, S, H, D] → [B, KVH, G, S, D] fp32."""
    b, s, h, d = x.shape
    return x.float().reshape(b, s, kvh, h // kvh, d).permute(0, 2, 3, 1, 4)


def _scores(q, k, causal, segment_ids):
    """(q * scale) k^T in fp32, [B, KVH, G, S, T], and the mask [B|1, 1, 1, S, T]."""
    qs = q * softmax_scale(q)
    s = torch.einsum("bngsd,btnd->bngst", _grouped(qs, k.shape[2]), k.float())
    mask = attention_mask(q.shape[1], causal, segment_ids, q.device)
    return qs, s, (None if mask is None else mask[:, None, None])


def _probs(s, mask, lse, kvh):
    """P = exp(S - lse) where the column is valid and the row's lse finite."""
    b, h, n = lse.shape
    lg = lse.reshape(b, kvh, h // kvh, n)[..., None]
    ok = torch.isfinite(lg) if mask is None else mask & torch.isfinite(lg)
    return torch.where(ok, torch.exp(s - torch.where(torch.isfinite(lg), lg, 0.0)), 0.0)


def _ungroup(x: torch.Tensor) -> torch.Tensor:
    """[B, KVH, G, S, D] → [B, S, H, D]."""
    b, n, g, s, d = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(b, s, n * g, d)


def flash_fwd_plain(q, k, v, causal: bool, segment_ids=None):
    """K16a's function, untiled: (out [B, S, H, D] in q's dtype, lse [B, H, S]
    fp32).  p is rounded to v's dtype for the PV product."""
    kvh = k.shape[2]
    _, s, mask = _scores(q, k, causal, segment_ids)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bngst,btnd->bngsd", p.to(v.dtype).float(), v.float()) / torch.where(l > 0, l, 1.0)
    lse = torch.where(l > 0, m + torch.log(l), float("-inf"))[..., 0]
    b, _, _, n = lse.shape
    return _ungroup(o).to(q.dtype), lse.reshape(b, -1, n)


def flash_di(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """di = rowsum(dO * O) in fp32, [B, H, S] (outside the kernels, as in JAX
    flash_attention_bwd.py:430)."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_bwd_dq_plain(q, k, v, dout, lse, di, causal: bool, segment_ids=None):
    """K16b's function, untiled: dS = P * (dO V^T - di) with dS rounded to k's
    dtype, dQ = dS K * scale."""
    kvh = k.shape[2]
    _, s, mask = _scores(q, k, causal, segment_ids)
    p = _probs(s, mask, lse, kvh)
    dp = torch.einsum("bngsd,btnd->bngst", _grouped(dout, kvh), v.float())
    b, h, n = di.shape
    ds = p * (dp - di.reshape(b, kvh, h // kvh, n)[..., None])
    dq = torch.einsum("bngst,btnd->bngsd", ds.to(k.dtype).float(), k.float())
    return (_ungroup(dq) * softmax_scale(q).float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, dout, lse, di, causal: bool, segment_ids=None):
    """K16c's function, untiled: dV = P^T dO and dK = dS^T (q * scale), each
    summed over the q heads of a kv head's GQA group.  Returns (dk, dv)."""
    kvh = k.shape[2]
    qs, s, mask = _scores(q, k, causal, segment_ids)
    p = _probs(s, mask, lse, kvh)
    do = _grouped(dout, kvh)
    dp = torch.einsum("bngsd,btnd->bngst", do, v.float())
    b, h, n = di.shape
    ds = p * (dp - di.reshape(b, kvh, h // kvh, n)[..., None])
    dv = torch.einsum("bngst,bngsd->btnd", p.to(dout.dtype).float(), do)
    dk = torch.einsum("bngst,bngsd->btnd", ds.to(q.dtype).float(), _grouped(qs, kvh))
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _on_cuda(name: str, tensors) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")


def _check(name: str, q, k, v, *tensors) -> None:
    """Raise, naming the wrapper and the shape, unless the CUDA kernel takes
    these operands: bfloat16 on the card, a width of
    :func:`~omchat_torch.ops.flash_attention.head_dim_supported`, whole GQA
    groups, k and v of one shape over q's rows."""
    _on_cuda(name, (q, k, v, *tensors))
    for t in (q, k, v, *tensors):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got {t.dtype} (q {tuple(q.shape)})")
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if not head_dim_supported(d):
        raise ValueError(f"{name}: head width {d} (q {tuple(q.shape)}) is not taken by the CUDA kernel, which takes "
                         f"a multiple of 8 from 8 to 128")
    if h % kvh != 0 or k.shape != (b, s, kvh, d) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} / k {tuple(k.shape)} / v {tuple(v.shape)} unsupported by the "
                         f"CUDA kernel (whole GQA groups, self-attention)")


def _aligned(entry: str, **operands) -> None:
    """Raise, naming the C entry and the operand, unless every operand's
    base is 16-byte aligned, as the kernels' TMA maps need."""
    for what, t in operands.items():
        if t.data_ptr() % 16:
            raise RuntimeError(f"{entry}: {what} {tuple(t.shape)} has a base address not 16-byte aligned, as TMA "
                               f"needs; nothing launched")


def _seg_arg(segment_ids, q):
    if segment_ids is None:
        return None, ctypes.c_void_p(None)
    if segment_ids.shape != q.shape[:2]:
        raise ValueError(f"segment_ids {tuple(segment_ids.shape)} must be [B, S] = {tuple(q.shape[:2])}")
    seg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    return seg, kernel_lib.ptr(seg)


def _dims(q, k, causal):
    b, s, h, d = q.shape
    return b, s, h, k.shape[2], d, int(causal)


def _prescaled(q: torch.Tensor) -> torch.Tensor:
    """q * D^-0.5 in q's dtype, as JAX hands q to its forward and backward
    pallas_calls (flash_attention_bwd.py:331, :432)."""
    return (q * softmax_scale(q)).contiguous()


def flash_fwd(q, k, v, causal: bool, segment_ids=None):
    """K16a: (out [B, S, H, D], lse [B, H, S] fp32).  q [B, S, H, D]; k/v
    [B, S, KVH, D]."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, segment_ids)
    _check("flash_fwd", q, k, v)
    qs, k, v = _prescaled(q), k.contiguous(), v.contiguous()
    _aligned("omchat_flash_attention_fwd", k=k, v=v)
    seg, seg_p = _seg_arg(segment_ids, q)
    out = torch.empty_like(qs)
    b, s, h = q.shape[:3]
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    kernel_lib.launch(SOURCE, "omchat_flash_attention_fwd", _FWD_ARGS,
                      *map(kernel_lib.ptr, (qs, k, v)), seg_p, kernel_lib.ptr(out), kernel_lib.ptr(lse),
                      *_dims(q, k, causal), kernel_lib.stream_ptr(q.device))
    flash_fwd.launches += 1
    return out, lse


def _q_arg(q, q_scaled):
    """The kernels' q: ``q_scaled`` (the caller's :func:`_prescaled` of q),
    or that product computed here."""
    if q_scaled is None:
        return _prescaled(q)
    if q_scaled.shape != q.shape or q_scaled.dtype != q.dtype or q_scaled.device != q.device:
        raise ValueError(f"q_scaled {tuple(q_scaled.shape)} {q_scaled.dtype} must be q * D^-0.5 in q's shape and dtype")
    return q_scaled.contiguous()


def flash_bwd_dq(q, k, v, dout, lse, di, causal: bool, segment_ids=None, *, q_scaled=None):
    """K16b: dQ [B, S, H, D].  ``q_scaled``: :func:`_prescaled` of q where the
    caller has it (the backward computes it once for K16b and K16c); the CPU
    route ignores it."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, dout, lse, di, causal, segment_ids)
    _check("flash_bwd_dq", q, k, v, dout)
    qs, k, v, dout = _q_arg(q, q_scaled), k.contiguous(), v.contiguous(), dout.contiguous()
    _aligned("omchat_flash_attention_bwd_dq", q_scaled=qs, k=k, v=v, dout=dout)
    lse, di = lse.float().contiguous(), di.float().contiguous()
    seg, seg_p = _seg_arg(segment_ids, q)
    dq = torch.empty_like(qs)
    kernel_lib.launch(SOURCE, "omchat_flash_attention_bwd_dq", _DQ_ARGS,
                      *map(kernel_lib.ptr, (qs, k, v, dout, lse, di)), seg_p, kernel_lib.ptr(dq),
                      *_dims(q, k, causal), ctypes.c_float(_scale_value(q)), kernel_lib.stream_ptr(q.device))
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, di, causal: bool, segment_ids=None, *, q_scaled=None):
    """K16c: (dK, dV) [B, S, KVH, D], summed over each kv head's GQA group.
    ``q_scaled`` as :func:`flash_bwd_dq`'s."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, dout, lse, di, causal, segment_ids)
    _check("flash_bwd_dkv", q, k, v, dout)
    qs, k, v, dout = _q_arg(q, q_scaled), k.contiguous(), v.contiguous(), dout.contiguous()
    _aligned("omchat_flash_attention_bwd_dkv", q_scaled=qs, k=k, v=v, dout=dout)
    lse, di = lse.float().contiguous(), di.float().contiguous()
    seg, seg_p = _seg_arg(segment_ids, q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    kernel_lib.launch(SOURCE, "omchat_flash_attention_bwd_dkv", _DKV_ARGS,
                      *map(kernel_lib.ptr, (qs, k, v, dout, lse, di)), seg_p, kernel_lib.ptr(dk), kernel_lib.ptr(dv),
                      *_dims(q, k, causal), kernel_lib.stream_ptr(q.device))
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


class FlashAttentionTrainable(torch.autograd.Function):
    """Attention whose forward is K16a and whose backward is K16b + K16c; it
    saves q, k, v, out and lse (the JAX custom VJP's residuals)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, segment_ids):
        out, lse = flash_fwd(q, k, v, causal, segment_ids)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        dout = dout.contiguous()
        di = flash_di(dout, out)
        qs = _prescaled(q)  # once, for both kernels
        dq = flash_bwd_dq(q, k, v, dout, lse, di, ctx.causal, segment_ids, q_scaled=qs)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, di, ctx.causal, segment_ids, q_scaled=qs)
        return dq, dk, dv, None, None


def flash_attention_trainable(q, k, v, causal: bool = True, segment_ids: Optional[torch.Tensor] = None):
    """Differentiable flash attention over the whole sequence (the training
    path: no cache, no offsets).  q [B, S, H, D]; k/v [B, S, KVH, D];
    ``segment_ids`` [B, S] int (negative = padding) isolates packed
    documents.  Returns [B, S, H, D] in q's dtype; padding rows output 0."""
    return FlashAttentionTrainable.apply(q, k, v, causal, segment_ids)
