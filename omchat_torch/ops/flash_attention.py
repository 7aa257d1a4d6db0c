"""Flash attention forward: the ViT's packed qk-norm attention (K1) and the
causal GQA prefill attention (K2).

PyTorch port of ``omchat_tpu/ops/flash_attention.py``.  Each kernel comes as

- a wrapper (:func:`packed_qkv_norm_attention`, :func:`flash_attention`): a
  CPU tensor goes to the plain PyTorch version, a CUDA tensor launches the
  hand-written CUDA kernel (``omchat_torch/csrc/``) or raises — there is no
  fallback from the kernel to the plain version;
- the plain version (``*_plain``), which computes the kernel's function
  without tiling: the CPU tests run it and ``chip_smoke.py`` holds the kernel
  against it;
- a launch counter, ``<wrapper>.launches``, raised by one at every kernel
  launch and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from omchat_torch.ops import kernel_lib
from omchat_torch.ops.attention import per_batch

LOG2E = 1.4426950408889634
# The JAX kernels' finite mask value (-0.7 * float32 max): a fully masked
# row never produces inf - inf.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# C signatures: qkv, rq, rk, gq, gk, out, B, SP, H, D, valid_len, stream /
# q, k, v, out, q_offset, kv_len, B, S, H, KVH, T, D, causal, stream
_K1_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_K2_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _require_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got {t.dtype}")


# ---------------------------------------------------------------------------
# K1: qk-RMSNorm + packed non-causal attention (InternViT-6B)
# ---------------------------------------------------------------------------


def packed_seq_supported(head_dim: int) -> bool:
    """Whether the ViT takes the pad-once packed path (head width 128, the
    kernel's).  The TPU kernel also capped the sequence at its VMEM budget
    (1600); the CUDA kernel tiles the kv axis, so the length does not matter."""
    return head_dim == 128


def packed_prescale(head_dim: int) -> float:
    """Fold into the q gamma: the softmax scale and the exp→exp2 change."""
    return head_dim**-0.5 * LOG2E


def packed_qkv_norm_attention_plain(qkv, rq, rk, gq, gk, *, num_heads: int, valid_len: int):
    """The kernel's function, untiled: q/k normalised as (x * rstd) * gamma
    in fp32 and rounded to the input dtype, full-row exp2 softmax with columns
    >= valid_len masked, p rounded to the input dtype for the PV product."""
    B, SP, HD3 = qkv.shape
    HD = HD3 // 3
    D = HD // num_heads
    dt = qkv.dtype
    q = (qkv[..., :HD].float() * rq[..., None] * gq).to(dt).reshape(B, SP, num_heads, D)
    k = (qkv[..., HD : 2 * HD].float() * rk[..., None] * gk).to(dt).reshape(B, SP, num_heads, D)
    v = qkv[..., 2 * HD :].reshape(B, SP, num_heads, D)
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float())
    if valid_len < SP:
        s[..., valid_len:] = float("-inf")
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l_inv = 1.0 / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhst,bthd->bhsd", p.to(dt).float(), v.float()) * l_inv
    return o.transpose(1, 2).reshape(B, SP, HD).to(dt)


def qk_norm_stats(qkv: torch.Tensor, q_gamma, k_gamma, eps: float):
    """Per-token rstd over the flattened H*D axis ([B, SP] fp32) and fp32
    gammas — outside the kernel, as in JAX (flash_attention.py:594-597)."""
    HD = qkv.shape[-1] // 3
    qf = qkv[..., :HD].float()
    kf = qkv[..., HD : 2 * HD].float()
    rq = torch.rsqrt(qf.square().mean(dim=-1) + eps).contiguous()
    rk = torch.rsqrt(kf.square().mean(dim=-1) + eps).contiguous()
    return rq, rk, q_gamma.float().contiguous(), k_gamma.float().contiguous()


def packed_qkv_norm_attention(
    qkv: torch.Tensor,
    *,
    num_heads: int,
    q_gamma: torch.Tensor,
    k_gamma: torch.Tensor,
    eps: float,
    valid_len: Optional[int] = None,
) -> torch.Tensor:
    """qk-RMSNorm + packed non-causal self-attention over unsplit qkv.

    qkv: [B, SP, 3*H*D] as the fused qkv matmul writes it; q_gamma must
    already include ``packed_prescale(D)``.  Returns [B, SP, H*D]; rows >=
    valid_len are garbage."""
    B, SP, HD3 = qkv.shape
    HD = HD3 // 3
    D = HD // num_heads
    valid_len = SP if valid_len is None else int(valid_len)
    rq, rk, gq, gk = qk_norm_stats(qkv, q_gamma, k_gamma, eps)
    if qkv.device.type == "cpu":
        return packed_qkv_norm_attention_plain(qkv, rq, rk, gq, gk, num_heads=num_heads, valid_len=valid_len)
    _require_cuda("packed_qkv_norm_attention", qkv)
    if D != 128 or not 1 <= valid_len <= SP:
        raise ValueError(f"packed_qkv_norm_attention: head_dim {D} / valid_len {valid_len} unsupported")
    qkv = qkv.contiguous()
    out = torch.empty((B, SP, HD), dtype=qkv.dtype, device=qkv.device)
    kernel_lib.launch(
        "packed_qkv_norm_attention.cu", "omchat_packed_qkv_norm_attention", _K1_ARGS,
        *map(kernel_lib.ptr, (qkv, rq, rk, gq, gk, out)), B, SP, num_heads, D, valid_len,
        kernel_lib.stream_ptr(qkv.device),
    )
    packed_qkv_norm_attention.launches += 1
    return out


packed_qkv_norm_attention.launches = 0


# ---------------------------------------------------------------------------
# K2: causal / non-causal GQA flash attention
# ---------------------------------------------------------------------------


def _prescale_q(q: torch.Tensor) -> torch.Tensor:
    """q * D^-0.5 * log2(e) in q's own dtype (flash_attention.py:450); without
    this bf16 rounding the result drifts from the JAX path."""
    return q * torch.tensor(q.shape[-1] ** -0.5 * LOG2E, dtype=q.dtype, device=q.device)


def flash_attention_plain(q, k, v, *, causal: bool, q_offset, kv_len, segment_ids=None):
    """The kernel's function, untiled.  q: [B, S, H, D]; k/v [B, KVH, T, D].

    q pre-scaled in its dtype, fp32 scores in the exp2 domain, the finite
    mask value, p rounded to v's dtype for the PV product; a row with no
    valid column outputs zeros."""
    B, S, H, D = q.shape
    KVH, T = k.shape[1], k.shape[2]
    G = H // KVH
    dev = q.device
    q_off = per_batch(q_offset, B, T - S, dev)
    kvl = per_batch(kv_len, B, T, dev)
    qg = _prescale_q(q).reshape(B, S, KVH, G, D).permute(0, 2, 3, 1, 4)  # [B, KVH, G, S, D]
    s = torch.einsum("bngsd,bntd->bngst", qg.float(), k.float())
    col = torch.arange(T, device=dev)
    mask = (col[None, None, :] < kvl[:, None, None]).expand(B, S, T)
    if causal:
        row = torch.arange(S, device=dev)[None, :, None] + q_off[:, None, None]
        mask = mask & (col[None, None, :] <= row)
    if segment_ids is not None:
        mask = mask & (segment_ids[:, :, None] == segment_ids[:, None, :])
    s = torch.where(mask[:, None, None], s, torch.tensor(DEFAULT_MASK_VALUE, device=dev))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bngst,bntd->bngsd", p.to(v.dtype).float(), v.float()) / l
    o = torch.where(mask.any(dim=-1)[:, None, None, :, None], o, torch.zeros((), device=dev))
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    q_offset=None,
    kv_len=None,
    kv_format: str = "btnd",
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention forward.  q: [B, S, H, D]; k/v: [B, T, KVH, D]
    ("btnd") or [B, KVH, T, D] ("bntd", the cache layout the kernel reads).
    Returns [B, S, H, D] in q.dtype; semantics of ``attention_reference``."""
    if kv_format == "btnd":
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    elif kv_format != "bntd":
        raise ValueError(f"unknown kv_format {kv_format!r}")
    B, S, H, D = q.shape
    KVH, T = k.shape[1], k.shape[2]
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len, segment_ids=segment_ids)
    _require_cuda("flash_attention", q, k, v)
    if segment_ids is not None:
        raise NotImplementedError("flash_attention: segment_ids packing has no CUDA kernel yet")
    if D != 128 or H % KVH != 0 or H // KVH > 8:
        raise ValueError(f"flash_attention: head_dim {D}, heads {H}/{KVH} unsupported by the CUDA kernel")
    qs = _prescale_q(q).contiguous()
    k, v = k.contiguous(), v.contiguous()
    q_off = per_batch(q_offset, B, T - S, q.device)
    kvl = per_batch(kv_len, B, T, q.device)
    out = torch.empty_like(qs)
    kernel_lib.launch(
        "flash_attention.cu", "omchat_flash_attention", _K2_ARGS,
        *map(kernel_lib.ptr, (qs, k, v, out, q_off, kvl)), B, S, H, KVH, T, D, int(causal),
        kernel_lib.stream_ptr(q.device),
    )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
