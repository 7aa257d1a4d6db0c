"""Tensor-parallel attention: the kernels on each rank's heads — PyTorch
port of ``omchat_tpu/parallel/tp_attention.py``.

The JAX package cannot hand GSPMD an opaque ``pallas_call``, so it runs the
flash kernel per shard under ``shard_map`` (``attn_impl=("pallas_tp",
mesh)``).  Here every rank already holds only its q / k / v heads (its
shard of q_proj / k_proj / v_proj, its slice of the cache), so attention
over the mesh is the flash-attention wrapper (K2 on a CUDA tensor) on the
local heads: no collective, no head gather, and the same ``q_offset`` /
``kv_len`` defaults as the unsharded call.
"""

from __future__ import annotations

import torch


def tp_shardable(mesh, num_heads: int, num_kv_heads: int) -> bool:
    """JAX's rule: a pure tensor-parallel mesh (every other axis of size 1)
    of more than one rank over whose ``model`` axis both head counts divide,
    so that every rank keeps whole GQA groups."""
    if mesh is None:
        return False
    tp = mesh.axis_size("model")
    pure_tp = all(size == 1 for name, size in mesh.shape.items() if name != "model")
    return pure_tp and tp > 1 and num_heads % tp == 0 and num_kv_heads % tp == 0


def tp_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *, causal: bool = False,
                       q_offset=None, kv_len=None, kv_format: str = "btnd") -> torch.Tensor:
    """Flash attention on this rank's heads: q [B, S, H/tp, D], k / v the
    rank's kv heads in ``kv_format``; the semantics of
    :func:`omchat_torch.ops.flash_attention.flash_attention` (``q_offset``
    defaults to T - S, ``kv_len`` to T).  Returns the rank's heads of the
    output [B, S, H/tp, D]."""
    from omchat_torch.ops.flash_attention import flash_attention

    tp = mesh.axis_size("model")
    kvh = k.shape[2] if kv_format == "btnd" else k.shape[1]
    if not tp_shardable(mesh, q.shape[2] * tp, kvh * tp):
        raise ValueError(f"tp_flash_attention: {q.shape[2]} q / {kvh} kv heads a rank on {mesh} are not whole GQA "
                         "groups of a pure tensor-parallel mesh")

    return flash_attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len, kv_format=kv_format)
