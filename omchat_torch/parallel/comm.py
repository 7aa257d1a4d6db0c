"""The collectives that GSPMD and ``shard_map`` insert implicitly in the JAX
package, written out on ``torch.distributed`` with their gradients.

- Megatron's pair, over the ``model`` axis (:func:`copy_to_axis`,
  :func:`reduce_from_axis`): a replicated activation enters a tensor-parallel
  region through *copy* (identity forward, all-reduce of the gradient
  backward) and a row-parallel product leaves it through *reduce*
  (all-reduce forward, identity backward).  Each rank then holds the
  gradient of the one replicated loss for its own shard, and the whole
  gradient of every replicated leaf.
- :func:`all_gather_dim` (all-gather forward, reduce-scatter backward) and
  its reverse :func:`reduce_scatter_dim`: FSDP's layer-by-layer weight
  gather, the data-parallel gather of image features, and the contrastive
  loss's gather of features across ranks.
- :func:`sum_over_axis`: an all-reduce in both directions, for a sum that
  every rank then uses in its own partial computation (the qk-norm's sum of
  squares over heads split across ranks).
- :func:`row_parallel_dense`: a row-parallel linear, its partial sums
  reduced before the replicated bias (``dense`` without a mesh); in w8a8
  (:func:`row_parallel_int8`) each rank quantizes its slice of the row at
  the whole row's scale and the int32 partial products are summed, so the
  codes and the accumulator are bitwise one device's.
- :func:`all_gather_blocks`: blocks of unequal widths gathered in rank
  order (the serving head's vocabulary blocks).

Every function is the identity when ``mesh`` is None or the axis has one
rank, so the single-device path runs no collective.

Backends: the collectives are ``all_reduce``, ``all_gather_into_tensor`` and
``reduce_scatter_tensor``, which both torch 2.11 and 2.13 have (2.13 warns
that the last two are deprecated for ``*_single`` names that 2.11 lacks; the
warning is silenced here).  Gloo runs all of them on CUDA tensors, so ranks
that share one card (NCCL refuses two ranks on one device) need no host
staging; with one card per rank the backend is NCCL.

:data:`CALLS` counts the collectives each process issued, by name.  Inside
:func:`timing` (a measurement, never the training path) :data:`SECONDS`
also holds the host time of each, from a card that has finished the work
queued before it to one that has finished the collective, so a caller can
read the share of a step spent in collectives; outside it this module
adds no wait for the card.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from collections import Counter
from typing import Optional

import torch
import torch.distributed as dist

from omchat_torch.ops.linear import _int8_product, dense, div127
from omchat_torch.parallel.sharding import block_range

CALLS: Counter = Counter()
SECONDS: Counter = Counter()
_TIMING = False


def reset_counts() -> None:
    CALLS.clear()
    SECONDS.clear()


@contextlib.contextmanager
def timing():
    """Time every collective issued inside: each waits for the card before
    and after it, so no compute overlaps it."""
    global _TIMING
    _TIMING = True
    try:
        yield
    finally:
        _TIMING = False


def _group(mesh, axis: str):
    """The process group to reduce over, or None when there is nothing to do."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return None
    return mesh.group(axis)


def issue(name: str, fn, *args, **kw):
    """Run one collective, counted (and timed inside :func:`timing`)."""
    CALLS[name] += 1
    cuda = _TIMING and any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        fn(*args, **kw)
    if cuda:
        torch.cuda.synchronize()
    if _TIMING:
        SECONDS[name] += time.perf_counter() - t0


def all_reduce_(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce of ``x`` (no autograd) over ``group``."""
    if group is not None:
        issue("all_reduce", dist.all_reduce, x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
               group=group)
    return x


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    issue("all_gather", dist.all_gather_into_tensor, out, x, group=group)
    return out.movedim(0, dim)


def _scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    if x.shape[0] % n:
        raise ValueError(f"reduce-scatter of {x.shape[0]} rows over {n} ranks")
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    issue("reduce_scatter", dist.reduce_scatter_tensor, out, x, group=group)
    return out.movedim(0, dim)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.group, ctx.dim), None, None


class _ScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


def copy_to_axis(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Identity forward, all-reduce of the gradient backward."""
    group = _group(mesh, axis)
    return x if group is None else _Copy.apply(x, group)


def reduce_from_axis(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """All-reduce (sum) forward, identity backward."""
    group = _group(mesh, axis)
    return x if group is None else _Reduce.apply(x, group)


def sum_over_axis(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """All-reduce (sum) forward and backward."""
    group = _group(mesh, axis)
    return x if group is None else _Sum.apply(x, group)


def all_gather_dim(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' equal shards concatenated along ``dim`` in axis order;
    backward, the gradient's sum over the ranks, each keeping its shard."""
    group = _group(mesh, axis)
    return x if group is None else _GatherDim.apply(x, group, dim % x.dim())


def reduce_scatter_dim(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The sum over the ranks, each keeping its shard along ``dim``;
    backward, the gradient's all-gather."""
    group = _group(mesh, axis)
    return x if group is None else _ScatterDim.apply(x, group, dim % x.dim())


def row_parallel_int8(x: torch.Tensor, p: dict, mesh):
    """The w8a8 product of a row-parallel layer: x [..., in/tp] is this
    rank's slice of each row and ``p["kernel_q"]`` [out, in/tp] its columns
    of the codes.  Each rank takes the amax of its slice, the max over
    ``model`` is the whole row's, each quantizes its slice at that scale
    (so its codes are exactly its slice of one device's), and the int32
    partial products are summed over ``model``.  Returns (codes, row scales
    [..., 1] fp32, the int32 accumulator [..., out]), those of
    ``quantize_activations`` and the int8 product on one device."""
    xf = x.float()
    row_scale = div127(max_over_axis(xf.abs().amax(dim=-1, keepdim=True), mesh).clamp(min=1e-6))
    xq = torch.round(xf / row_scale).clamp(-127, 127).to(torch.int8)
    return xq, row_scale, sum_value(_int8_product(xq, p), mesh, "model")


def row_parallel_dense(x: torch.Tensor, p: dict, mesh, *, a8: bool = False,
                       partial: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ W on this rank's rows of W, the partial sums reduced over
    ``model``, then the replicated bias once; ``dense(x, p, a8=a8)`` without
    a mesh.  ``partial``: a term that is itself this rank's partial sum of
    the output (the LoRA delta over the rank's input rows), added before the
    reduce (after the bias without a mesh, as one device adds it).  w8a8
    over int8 weights reduces the int32 accumulator
    (:func:`row_parallel_int8`) and dequantizes once; ``partial`` is then
    reduced on its own."""
    if mesh is None:
        y = dense(x, p, a8=a8)
        return y if partial is None else y + partial
    if a8 and "kernel_q" in p:
        _, row_scale, acc = row_parallel_int8(x, p, mesh)
        y = (acc.float() * row_scale * p["scale"].float()).to(x.dtype)
        y = y + p["bias"] if "bias" in p else y
        return y if partial is None else y + reduce_from_axis(partial, mesh)
    y = dense(x, {k: v for k, v in p.items() if k != "bias"})
    y = reduce_from_axis(y if partial is None else y + partial, mesh)
    return y + p["bias"] if "bias" in p else y


def all_gather_blocks(x: torch.Tensor, mesh, axis: str, sizes, dim: int = -1) -> torch.Tensor:
    """The ranks' blocks of ``dim`` (rank i's ``sizes[i]`` wide, unequal
    allowed) concatenated in axis order, on every rank; no gradient.  Each
    block is padded to the widest for the one all-gather, then cut back."""
    group = _group(mesh, axis)
    if group is None:
        return x
    w = max(sizes)
    x = x.detach().movedim(dim, 0)
    if x.shape[0] < w:
        x = torch.cat([x, x.new_zeros((w - x.shape[0], *x.shape[1:]))])
    out = _gather(x, group, 0)
    return torch.cat([out[i * w: i * w + n] for i, n in enumerate(sizes)]).movedim(0, dim)


def max_over_axis(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """All-reduce (max) of a tensor that takes no gradient."""
    return all_reduce_(x.detach().contiguous().clone(), _group(mesh, axis), op="max")


def sum_value(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """All-reduce (sum) of a tensor that takes no gradient."""
    return all_reduce_(x.detach().contiguous().clone(), _group(mesh, axis))


def axis_index(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.axis_index(axis)


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.axis_size(axis)


def model_slice(n: int, mesh, units: Optional[int] = None) -> slice:
    """This rank's block of an ``n``-wide dimension split over ``model``
    (``units`` whole units, ceil-sized blocks first; see
    :func:`omchat_torch.parallel.sharding.split_sizes`)."""
    lo, hi = block_range(n, axis_size(mesh, "model"), axis_index(mesh, "model"), units)
    return slice(lo, hi)


def gather_layer(layer: dict, mesh, dims: Optional[dict]) -> dict:
    """One layer's leaves with their FSDP shards all-gathered over ``data``:
    ``dims`` is a tree over the layer's leaves of the dimension each is
    split on (None: whole).  The layer as it is without ``dims``."""
    if mesh is None or not dims:
        return layer

    def walk(node, d):
        if isinstance(node, dict):
            return {k: walk(v, d.get(k) if isinstance(d, dict) else None) for k, v in node.items()}
        return node if d is None else _fsdp_gather(node, mesh, d)

    return walk(layer, dims)


def _fsdp_gather(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    return all_gather_dim(x, mesh, "data", dim)
