"""Tensor-parallel attention: the kernels on each rank's heads — PyTorch
port of ``omchat_tpu/parallel/tp_attention.py``.

The JAX package cannot hand GSPMD an opaque ``pallas_call``, so it runs the
flash kernel per shard under ``shard_map`` (``attn_impl=("pallas_tp",
mesh)``) where tp divides both head counts (:func:`tp_shardable`), and
attention unsharded per head otherwise, GSPMD padding the heads.  Here every
rank already holds only its q heads (its shard of q_proj, whole heads,
unevenly where tp does not divide them), so attention over the mesh is the
attention kernels on the local heads, with no collective and no head gather:

- where tp divides the kv heads, each rank holds its kv heads too (its
  shard of k_proj / v_proj and of the cache) and its q heads are whole GQA
  groups over them: one call as on one device (:func:`tp_flash_attention`);
- else every rank holds every kv head (k_proj / v_proj whole, the cache
  replicated over kv heads, JAX's ``kv_cache_specs``), and a rank's q heads
  may span two kv heads (Qwen2-7B at tp 8: 28 q heads as 4 / 3 a rank over
  4 kv heads of 7, so rank 1 holds heads 4-7 over kv heads 0 and 1):
  attention runs once per run of the rank's q heads that share a kv head
  (:func:`head_runs`, :func:`by_runs`), each on that kv head's slice of the
  cache or pool (:func:`one_head`).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from omchat_torch.parallel.sharding import block_range


def tp_shardable(mesh, num_heads: int, num_kv_heads: int) -> bool:
    """JAX's rule: a pure tensor-parallel mesh (every other axis of size 1)
    of more than one rank over whose ``model`` axis both head counts divide,
    so that every rank keeps whole GQA groups over its own kv heads."""
    if mesh is None:
        return False
    tp = mesh.axis_size("model")
    pure_tp = all(size == 1 for name, size in mesh.shape.items() if name != "model")
    return pure_tp and tp > 1 and num_heads % tp == 0 and num_kv_heads % tp == 0


def _kv_head(q_head: int, num_heads: int, num_kv_heads: int) -> int:
    """The kv head a q head reads (GQA: consecutive groups of H / KVH)."""
    return q_head // (num_heads // num_kv_heads)


def head_runs(cfg, mesh) -> Optional[List[Tuple[int, int, int]]]:
    """This rank's q heads as runs that share a kv head: [(lo, hi, kv)],
    ``lo:hi`` local q heads reading kv head ``kv`` of the replicated cache.
    None where the rank's kv heads are its q heads' own (no mesh, one rank,
    or a tp that divides the kv heads): one attention call as on one
    device."""
    if mesh is None or mesh.axis_size("model") == 1:
        return None
    tp = mesh.axis_size("model")
    h, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
    if kvh % tp == 0:
        return None
    lo, hi = block_range(h, tp, mesh.axis_index("model"))
    runs: List[Tuple[int, int, int]] = []
    for j in range(lo, hi):
        kv = _kv_head(j, h, kvh)
        if runs and runs[-1][2] == kv:
            runs[-1] = (runs[-1][0], j - lo + 1, kv)
        else:
            runs.append((j - lo, j - lo + 1, kv))
    return runs


def one_head(x: torch.Tensor, kv: Optional[int], dim: int, copy: bool = True) -> torch.Tensor:
    """Kv head ``kv`` of a cache, pool or row tensor along ``dim`` (kept as
    a dimension of 1), copied contiguous for the kernels that need a whole
    contiguous operand (``copy``; K2 reads a strided slice in place); ``x``
    itself for ``kv`` None."""
    if kv is None:
        return x
    part = x.narrow(dim, kv, 1)
    return part.contiguous() if copy else part


def by_runs(runs, q: torch.Tensor, fn: Callable[[torch.Tensor, Optional[int]], torch.Tensor]) -> torch.Tensor:
    """Attention over this rank's q heads (q [B, S, H_rank, D]): ``fn(q,
    None)`` without runs; else ``fn(q_run, kv)`` for each run, the outputs
    concatenated over the head axis in order."""
    if runs is None:
        return fn(q, None)
    return torch.cat([fn(q[:, :, lo:hi], kv) for lo, hi, kv in runs], dim=2)


def tp_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *, causal: bool = False,
                       q_offset=None, kv_len=None, kv_format: str = "btnd") -> torch.Tensor:
    """Flash attention on this rank's heads: q [B, S, H/tp, D], k / v the
    rank's kv heads in ``kv_format``; the semantics of
    :func:`omchat_torch.ops.flash_attention.flash_attention` (``q_offset``
    defaults to T - S, ``kv_len`` to T).  Returns the rank's heads of the
    output [B, S, H/tp, D].  Whole GQA groups only (:func:`tp_shardable`);
    the engines take :func:`head_runs` where the kv heads do not split."""
    from omchat_torch.ops.flash_attention import flash_attention

    tp = mesh.axis_size("model")
    kvh = k.shape[2] if kv_format == "btnd" else k.shape[1]
    if not tp_shardable(mesh, q.shape[2] * tp, kvh * tp):
        raise ValueError(f"tp_flash_attention: {q.shape[2]} q / {kvh} kv heads a rank on {mesh} are not whole GQA "
                         "groups of a pure tensor-parallel mesh")

    return flash_attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len, kv_format=kv_format)
