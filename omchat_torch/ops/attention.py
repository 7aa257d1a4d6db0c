"""Attention dispatcher and the plain references (PyTorch port of
``omchat_tpu/ops/attention.py``).

- :func:`attention` — prefill / ViT attention.  ``impl=None`` goes through the
  flash-attention wrapper (:mod:`omchat_torch.ops.flash_attention`): on a CUDA
  tensor it launches the hand-written kernel, on a CPU tensor it runs that
  kernel's plain PyTorch version.  ``impl="plain"`` is the counterpart of the
  JAX package's ``impl="xla"``: :func:`attention_reference` (differentiable by
  autograd), chosen only explicitly.  ``impl="vjp"``, the counterpart of
  ``"pallas_vjp"``, is the training route: the differentiable flash attention
  of :mod:`omchat_torch.ops.flash_attention_bwd` (K16, forward and backward
  kernels).
- :func:`decode_attention` — one decode token against the stacked cache with a
  self column (K3 of :mod:`omchat_torch.ops.decode_attention`, or the plain
  :func:`self_column_reference`), or against a per-layer cache that holds the
  token (K6, or the plain :func:`attention_reference`).

The references are the independent oracles (einsum + fp32 softmax with a
-1e30 mask), as ``_xla_attention`` and ``self_column_reference`` are in JAX.
The plain routes take an e4m3 (fp8) cache widened to q's dtype, which is
exact; the decode route rounds the self column to the cache's dtype first, as
the JAX package's XLA decode does (its ``self_column_reference`` concatenates
``k_new.astype(k_cache.dtype)``).
"""

from __future__ import annotations

from typing import Optional

import torch

from omchat_torch.ops.fp8 import cast_to

PLAIN = "plain"
VJP = "vjp"


def per_batch(x, b: int, default: int, device) -> torch.Tensor:
    """A scalar or [B] int argument (None: ``default``) as a contiguous [B] int32 tensor."""
    if x is None:
        return torch.full((b,), default, dtype=torch.int32, device=device)
    x = torch.as_tensor(x, dtype=torch.int32, device=device)
    return (x.expand(b) if x.dim() == 0 else x).contiguous()


def _repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """[B, T, KVH, D] → [B, T, H, D] by repeating each kv head H/KVH times."""
    kvh = k.shape[2]
    if kvh == num_q_heads:
        return k
    return k.repeat_interleave(num_q_heads // kvh, dim=2)


def attention_reference(q, k, v, *, causal, q_offset, kv_len, segment_ids=None):
    """≙ ``_xla_attention``: q [B, S, H, D], k/v [B, T, KVH, D] ("btnd")."""
    B, S, H, D = q.shape
    T = k.shape[1]
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    scores = torch.einsum("bshd,bthd->bhst", q.float() * D**-0.5, k.float())
    mask = None
    if causal:
        offset = per_batch(q_offset, B, T - S, q.device)
        q_pos = torch.arange(S, dtype=torch.int32, device=q.device)[None, :, None] + offset[:, None, None]
        kv_pos = torch.arange(T, dtype=torch.int32, device=q.device)[None, None, :]
        mask = kv_pos <= q_pos
    if kv_len is not None:
        valid = torch.arange(T, device=q.device)[None, None, :] < per_batch(kv_len, B, T, q.device)[:, None, None]
        mask = valid if mask is None else (mask & valid)
    if segment_ids is not None:
        seg = segment_ids[:, :, None] == segment_ids[:, None, :]
        mask = seg if mask is None else (mask & seg)
    if mask is not None:
        scores = torch.where(mask[:, None], scores, torch.tensor(-1e30, dtype=torch.float32, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(q.dtype)


def self_column_reference(q, k_cache, v_cache, cache_len, k_new, v_new):
    """Decode attention with the in-flight token as a self column:
    k/v_cache [B, KVH, T, D] hold ``cache_len`` valid rows; k_new/v_new
    [B, KVH, D] are appended as one always-valid column."""
    k = torch.cat([k_cache, k_new.to(k_cache.dtype)[:, :, None, :]], dim=2)
    v = torch.cat([v_cache, v_new.to(v_cache.dtype)[:, :, None, :]], dim=2)
    B, _, H, D = q.shape
    t = k.shape[2]
    kr = _repeat_kv(k.transpose(1, 2), H).transpose(1, 2)
    vr = _repeat_kv(v.transpose(1, 2), H).transpose(1, 2)
    idx = torch.arange(t, device=q.device)[None, :]
    valid = (idx < per_batch(cache_len, B, t, q.device)[:, None]) | (idx == t - 1)
    scores = torch.einsum("bshd,bhtd->bhst", q.float() * D**-0.5, kr.float())
    scores = torch.where(valid[:, None, None, :], scores, torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bhtd->bshd", probs, vr.float())
    return out.to(q.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    q_offset=None,
    kv_len=None,
    impl: Optional[str] = None,
    kv_format: str = "btnd",
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head (optionally grouped-query) attention.

    q: [B, S, H, D]; k, v: [B, T, KVH, D] ("btnd") or [B, KVH, T, D] ("bntd").
    Causal masking lets query i see kv j iff ``j <= i + q_offset`` (q_offset
    defaults to T - S); kv positions >= kv_len are masked.  Returns
    [B, S, H, D] in q.dtype."""
    if impl == PLAIN:
        if kv_format == "bntd":
            k, v = k.transpose(1, 2), v.transpose(1, 2)
        return attention_reference(q, k.to(q.dtype), v.to(q.dtype), causal=causal, q_offset=q_offset, kv_len=kv_len,
                                   segment_ids=segment_ids)
    if impl == VJP:
        if q_offset is not None or kv_len is not None or kv_format != "btnd" or q.shape[1] != k.shape[1]:
            raise ValueError("attention impl 'vjp' is full-sequence self-attention: no cache, offsets or kv_len")
        from omchat_torch.ops.flash_attention_bwd import flash_attention_trainable

        return flash_attention_trainable(q, k, v, causal, segment_ids)
    if impl is not None:
        raise ValueError(f"unknown attention impl {impl!r} (None, 'vjp' or 'plain')")
    from omchat_torch.ops.flash_attention import flash_attention

    return flash_attention(
        q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len, kv_format=kv_format, segment_ids=segment_ids
    )


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    *,
    impl: Optional[str] = None,
    layer: Optional[int] = None,
    k_new: Optional[torch.Tensor] = None,
    v_new: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-step decode attention.  q [B, 1, H, D]; returns [B, 1, H, D].

    - A per-layer cache [B, KVH, T, D] already holds the new token and
      ``cache_len`` [B] INCLUDES it (K6).
    - One layer ``layer`` of the stacked, read-only cache [L, B, KVH, T, D]:
      ``cache_len`` [B] EXCLUDES the in-flight token, whose K/V (k_new/v_new
      [B, KVH, D]) fold in as a self column (K3)."""
    if impl not in (None, PLAIN):
        raise ValueError(f"unknown attention impl {impl!r} (None or 'plain')")
    if k_cache.dim() == 4:
        if k_new is not None or layer is not None:
            raise ValueError("decode_attention: a per-layer cache holds the new token (no layer, no self column)")
        if impl == PLAIN:
            return attention_reference(q, k_cache.transpose(1, 2).to(q.dtype), v_cache.transpose(1, 2).to(q.dtype),
                                       causal=False, q_offset=None, kv_len=cache_len)
        from omchat_torch.ops.decode_attention import flash_decode

        return flash_decode(q, k_cache, v_cache, cache_len)
    if layer is None or k_new is None or v_new is None:
        raise ValueError("decode_attention: the stacked cache needs `layer` and the self column k_new / v_new")
    if impl == PLAIN:
        kc, vc = k_cache[layer], v_cache[layer]
        return self_column_reference(q, kc.to(q.dtype), vc.to(q.dtype), cache_len,
                                     cast_to(k_new, kc.dtype).to(q.dtype), cast_to(v_new, vc.dtype).to(q.dtype))
    from omchat_torch.ops.decode_attention import flash_decode_stacked

    return flash_decode_stacked(q, k_cache, v_cache, cache_len, layer, k_new, v_new)
