"""Flash decode: one query token's GQA attention against a KV cache.

PyTorch port of ``omchat_tpu/ops/decode_attention.py``, two kernels in one
CUDA source (``omchat_torch/csrc/flash_decode_stacked.cu``):

- K3 :func:`flash_decode_stacked` (``:109 flash_decode_stacked``): one layer
  of the stacked, read-only cache plus the in-flight token as a self column
  (the decode loop's);
- K6 :func:`flash_decode` (``:198 flash_decode``): a per-layer cache that
  already holds the new token, no self column.

Both kernels split the cache's rows over blocks (split-KV): the wrapper cuts
the T rows into :func:`decode_splits` chunks on the host, and one call
launches a kernel that attends each chunk and a second that merges the
chunks' softmax states, at every head width that
:func:`~omchat_torch.ops.flash_attention.head_dim_supported` takes.  Each
wrapper sends a CPU tensor to its plain version (``*_plain``) and launches
its kernels on a CUDA tensor, or raises; ``<wrapper>.launches`` counts the
calls that launched them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from omchat_torch.ops import kernel_lib
from omchat_torch.ops.flash_attention import _require_cuda, require_head_dim

# C signatures: q, k_cache, v_cache, cache_len, layer, k_new, v_new, out, scratch, B, KVH, T, D, group, splits,
# rows, stream / q, k_cache, v_cache, cache_len, out, scratch, B, KVH, T, D, group, splits, rows, stream
_K3_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_K6_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
SPLIT_ROWS = 64  # a split's rows are a multiple of this (the kernel's tile)


def decode_splits(B: int, KVH: int, T: int, num_sms: int, tile: int = SPLIT_ROWS) -> tuple:
    """How a split-KV decode kernel cuts a cache of capacity ``T`` rows:
    ``(splits, rows)``, ``splits`` chunks of ``rows`` rows (a multiple of
    ``tile``; the last chunk may be shorter) covering rows 0..T-1 once each.
    A chunk is as few tiles as still give the grid of B x KVH x splits blocks
    one block for each of ``num_sms`` (all of T in one chunk when the batch's
    kv heads alone fill them, or T is one tile).  K3 and K6 take the default
    64-row tile and the card's SM count; K12 and K13
    (``ops.paged_attention.paged_splits``) take 128-row tiles, so that a
    chunk starts on a page boundary at every page size, and the blocks the
    card holds at once.
    It reads only the capacity, never the lengths, which live on the card."""
    tiles = max(1, -(-T // tile))
    rows = min(tiles, max(1, tiles * B * KVH // num_sms)) * tile
    return max(1, -(-T // rows)), rows


@functools.lru_cache(maxsize=None)
def num_sms(index: int) -> int:
    """The SM count of CUDA device ``index`` (asked once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def scratch_floats(B: int, H: int, splits: int, D: int) -> int:
    """The fp32 values of a split-KV decode call's scratch (K3, K6, K12,
    K13): each of the B x H x ``splits`` partial states holds acc [D] and
    its m and l, at the true head width D."""
    return B * H * splits * (D + 2)


def _split_args(q, B, KVH, T, D):
    """(scratch, splits, rows) for one call: the fp32 partial states
    [B, KVH, splits, group] x (D + 2) that the merge reads."""
    splits, rows = decode_splits(B, KVH, T, num_sms(q.device.index))
    scratch = torch.empty(scratch_floats(B, q.shape[2], splits, D), dtype=torch.float32, device=q.device)
    return scratch, splits, rows


def flash_decode_stacked_plain(q, k_cache, v_cache, cache_len, layer: int, k_new, v_new):
    """The kernel's function: layer ``layer`` of the cache, read in q's dtype
    (an e4m3 cache widened, as the TPU kernel's ``astype(q.dtype)``), columns
    below ``cache_len`` plus the in-flight token as one always-valid column in
    q's dtype; natural-exp softmax with scale D^-0.5, p rounded to q's dtype
    for the PV product.  q [B, 1, H, D] → [B, 1, H, D]."""
    B, _, H, D = q.shape
    kc, vc = k_cache[layer].to(q.dtype), v_cache[layer].to(q.dtype)  # [B, KVH, T, D]
    KVH, T = kc.shape[1], kc.shape[2]
    G = H // KVH
    qg = q[:, 0].reshape(B, KVH, G, D).float()
    k = torch.cat([kc, k_new.to(q.dtype)[:, :, None]], dim=2).float()
    v = torch.cat([vc, v_new.to(q.dtype)[:, :, None]], dim=2)
    s = torch.einsum("bngd,bntd->bngt", qg, k) * D**-0.5
    idx = torch.arange(T + 1, device=q.device)
    lens = torch.as_tensor(cache_len, dtype=torch.int64, device=q.device).expand(B)
    valid = (idx[None, :] < lens[:, None]) | (idx[None, :] == T)
    s = torch.where(valid[:, None, None, :], s, torch.tensor(float("-inf"), device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bngt,bntd->bngd", p.to(v.dtype).float(), v.float()) * (1.0 / l)
    return o.reshape(B, 1, H, D).to(q.dtype)


def flash_decode_stacked(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    layer: int,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
) -> torch.Tensor:
    """Decode attention against layer ``layer`` of a stacked READ-ONLY cache.

    q [B, 1, H, D]; k/v_cache [L, B, KVH, T, D] (the whole stack — the kernel
    reaches the layer by pointer offset, nothing is sliced or copied; bfloat16
    or e4m3 on CUDA);
    cache_len [B] int32 valid cached rows EXCLUDING the new token; k_new/v_new
    [B, KVH, D].  Returns [B, 1, H, D]."""
    if q.device.type == "cpu":
        return flash_decode_stacked_plain(q, k_cache, v_cache, cache_len, layer, k_new, v_new)
    L, B, KVH, T, D = k_cache.shape
    H = q.shape[2]
    suffix = _require_cuda("flash_decode_stacked", q, k_new, v_new, cache=(k_cache, v_cache))
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("flash_decode_stacked: the stacked cache must be contiguous")
    require_head_dim("flash_decode_stacked", D, bool(suffix))
    if q.shape[1] != 1 or H % KVH or H // KVH > 8 or q.shape[3] != D or not 0 <= layer < L:
        raise ValueError(f"flash_decode_stacked: unsupported shape q={tuple(q.shape)} cache={tuple(k_cache.shape)}")
    qc = q.contiguous()
    kn, vn = k_new.contiguous(), v_new.contiguous()
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device).expand(B).contiguous()
    out = torch.empty_like(qc)
    scratch, splits, rows = _split_args(q, B, KVH, T, D)
    kernel_lib.launch(
        "flash_decode_stacked.cu", "omchat_flash_decode_stacked" + suffix, _K3_ARGS,
        *map(kernel_lib.ptr, (qc, k_cache, v_cache, lens)), int(layer),
        *map(kernel_lib.ptr, (kn, vn, out, scratch)), B, KVH, T, D, H // KVH, splits, rows,
        kernel_lib.stream_ptr(q.device),
    )
    flash_decode_stacked.launches += 1
    return out


flash_decode_stacked.launches = 0


# ---------------------------------------------------------------------------
# K6: decode over a per-layer cache that holds the new token
# ---------------------------------------------------------------------------


def flash_decode_plain(q, k_cache, v_cache, cache_len):
    """K6's function: the cache read in q's dtype (an e4m3 cache widened, as
    the TPU kernel's ``astype(q.dtype)``), columns below ``cache_len``;
    natural-exp softmax with scale D^-0.5, p rounded to q's dtype for the PV
    product, the output scaled by 1 / l of the fp32 row sums; a request of
    length 0 outputs zeros.  q [B, 1, H, D] → [B, 1, H, D]."""
    B, _, H, D = q.shape
    kc, vc = k_cache.to(q.dtype), v_cache.to(q.dtype)  # [B, KVH, T, D]
    KVH, T = kc.shape[1], kc.shape[2]
    qg = q[:, 0].reshape(B, KVH, H // KVH, D).float()
    s = torch.einsum("bngd,bntd->bngt", qg, kc.float()) * D**-0.5
    lens = torch.as_tensor(cache_len, dtype=torch.int64, device=q.device).expand(B)
    valid = torch.arange(T, device=q.device)[None, :] < lens[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.tensor(float("-inf"), device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isinf(m), torch.zeros_like(m), m))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bngt,bntd->bngd", p.to(q.dtype).float(), vc.float()) * (1.0 / torch.where(l == 0, 1.0, l))
    return o.reshape(B, 1, H, D).to(q.dtype)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, cache_len: torch.Tensor) -> torch.Tensor:
    """Decode attention against a per-layer cache.

    q [B, 1, H, D]; k/v_cache [B, KVH, T, D] (bfloat16 or e4m3 on CUDA), the
    new token already written at row ``cache_len - 1``; cache_len [B] int32
    valid rows INCLUDING the new token.  Returns [B, 1, H, D]."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, cache_len)
    B, KVH, T, D = k_cache.shape
    H = q.shape[2]
    suffix = _require_cuda("flash_decode", q, cache=(k_cache, v_cache))
    require_head_dim("flash_decode", D, bool(suffix))
    if q.shape[1] != 1 or H % KVH or H // KVH > 8 or q.shape[3] != D or v_cache.shape != k_cache.shape:
        raise ValueError(f"flash_decode: unsupported shape q={tuple(q.shape)} cache={tuple(k_cache.shape)}")
    qc, kc, vc = q.contiguous(), k_cache.contiguous(), v_cache.contiguous()
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device).expand(B).contiguous()
    out = torch.empty_like(qc)
    scratch, splits, rows = _split_args(q, B, KVH, T, D)
    kernel_lib.launch(
        "flash_decode_stacked.cu", "omchat_flash_decode" + suffix, _K6_ARGS,
        *map(kernel_lib.ptr, (qc, kc, vc, lens, out, scratch)), B, KVH, T, D, H // KVH, splits, rows,
        kernel_lib.stream_ptr(q.device),
    )
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
