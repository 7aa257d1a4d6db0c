"""Paged KV: the page allocator, paged decode / chunked-prefill attention, and
the in-place row and page commits.

PyTorch port of ``omchat_tpu/ops/paged_attention.py``.  K/V live in a shared
page-major pool ``[P, KVH, page_size, D]`` (one page holds every kv head's
slice), in bfloat16 or e4m3 (the fp8 pool: every store rounds with
:func:`omchat_torch.ops.fp8.to_e4m3`, every read widens to q's dtype); each
request maps logical blocks to physical pages through a page table.  Five
kernels:

- K12 :func:`paged_flash_decode` — one query token per request through its
  page table, with the in-flight token folded in as a self column,
  split-KV (a block per chunk of a request's rows, then a merge), its pages
  copied by 16-byte ``cp.async`` (``omchat_torch/csrc/paged_flash_decode.cu``);
- K13 :func:`paged_flash_decode_manual` — K12's function, chunks and
  arithmetic (``omchat_torch/csrc/paged_decode_split.cuh``) with the pages
  streamed through a ring of bulk asynchronous copies
  (``omchat_torch/csrc/paged_flash_decode_manual.cu``): the two compute the
  same bits;
- K14 :func:`paged_flash_prefill` — a causal prefill chunk attending through
  the page tables (``omchat_torch/csrc/paged_flash_prefill.cu``);
- K4 :func:`commit_rows` — single-token rows written in place
  (``omchat_torch/csrc/commit_rows.cu``);
- K15 :func:`commit_pages` — whole pages written in place
  (``omchat_torch/csrc/commit_pages.cu``).

Each wrapper sends CPU tensors to its plain PyTorch version (``*_plain``) and
launches its CUDA kernel on CUDA tensors, or raises; ``<wrapper>.launches``
counts the kernel launches.  The attention kernels K12, K13 and K14 are built
for the page sizes in :data:`PAGE_SIZES` and take the head widths of
:func:`~omchat_torch.ops.flash_attention.head_dim_supported`; K4 and K15
take any page size.  :func:`paged_decode_attention` and
:func:`paged_prefill_attention` are the dispatchers the serving engine calls.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import torch

from omchat_torch.ops import kernel_lib
from omchat_torch.ops.attention import PLAIN, attention_reference, per_batch, self_column_reference
from omchat_torch.ops.decode_attention import decode_splits, num_sms, scratch_floats
from omchat_torch.ops.flash_attention import LOG2E, _prescale_q, _require_cuda, flash_attention_plain, require_head_dim
from omchat_torch.ops.fp8 import cast_to

# C signatures:
# K4  k_pool, v_pool, pages, offsets, k_rows, v_rows, N, KVH, PS, D, stream
# K12, K13 q, k_pages, v_pages, lengths, tables, k_new, v_new, out, scratch,
#     B, H, KVH, PS, D, table_stride, width, page_offset, splits, rows, stream
# K14 q, k_pages, v_pages, out, q_offset, kv_len, tables,
#     B, C, H, KVH, PS, D, table_stride, width, stream
# K15 k_pool, v_pool, pages, k_src, v_src, M, C, stride_g, stride_c, stride_h, KVH, PS, D, stream
_K4_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SPLIT_DECODE_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_K14_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_K15_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# The page sizes the CUDA attention kernels (K12, K13, K14) are built for.
PAGE_SIZES = (16, 32, 64, 128)
# K12 and K13 cut a request's capacity into chunks of a multiple of this many
# rows (the largest page size, so a chunk starts on a page boundary at every
# page size), aiming at SPLIT_BLOCKS_PER_SM blocks an SM (two rings of ~100
# KiB share an SM's shared memory) and at most SPLIT_MAX_ROWS rows a chunk: a
# block's 64-row stages wait one after another on the copies (~4-6 us each on
# the H100, PERF.md), so a chunk of more stages sets the time.
SPLIT_TILE_ROWS = 128
SPLIT_BLOCKS_PER_SM = 2
SPLIT_MAX_ROWS = 256


class PageAllocator:
    """Host-side free-list allocator for the shared page pool."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self.free: List[int] = list(range(num_pages - 1, -1, -1))

    def alloc(self, n: int = 1) -> List[int]:
        if len(self.free) < n:
            raise MemoryError(f"page pool exhausted (need {n}, have {len(self.free)})")
        return [self.free.pop() for _ in range(n)]

    def release(self, pages: List[int]) -> None:
        self.free.extend(pages)

    @property
    def available(self) -> int:
        return len(self.free)


def _gather_pages(k_pages, v_pages, page_tables):
    """[P, KVH, ps, D] pools + [B, W] tables → contiguous [B, KVH, W*ps, D]."""
    b, w = page_tables.shape
    _, kvh, ps, d = k_pages.shape
    idx = page_tables.reshape(-1).long()
    k = k_pages.index_select(0, idx).view(b, w, kvh, ps, d).transpose(1, 2).reshape(b, kvh, w * ps, d)
    v = v_pages.index_select(0, idx).view(b, w, kvh, ps, d).transpose(1, 2).reshape(b, kvh, w * ps, d)
    return k, v


def _int32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def _table_arg(page_tables: torch.Tensor, device) -> torch.Tensor:
    """Page tables as int32 rows with unit inner stride (a column slice of a
    wider table keeps its row stride, which the kernels take as an argument)."""
    t = _int32(page_tables, device)
    return t if t.stride(1) == 1 else t.contiguous()


# ---------------------------------------------------------------------------
# K12: paged decode with a self column
# ---------------------------------------------------------------------------


def paged_flash_decode_plain(q, k_pages, v_pages, lengths, page_tables, k_new=None, v_new=None, *,
                             page_offset: int = 0):
    """The kernel's function, untiled: columns below ``lengths[b]`` of the
    pages ``page_tables[b] + page_offset`` (at most the table's width), read
    in q's dtype (an e4m3 pool widened, as the TPU kernel's
    ``astype(q.dtype)``), plus the in-flight token as one always-valid column
    in q's dtype when ``k_new`` is given.  fp32 scores in the exp2 domain
    (scale D^-0.5 * log2 e), p rounded to q's dtype for the PV product, l
    summing the fp32 p; a request with no valid column outputs zeros.
    q [B, 1, H, D] → [B, 1, H, D]."""
    B, _, H, D = q.shape
    _, KVH, PS, _ = k_pages.shape
    G = H // KVH
    dev = q.device
    k, v = _gather_pages(k_pages, v_pages, _int32(page_tables, dev) + page_offset)  # [B, KVH, T, D]
    k, v = k.to(q.dtype), v.to(q.dtype)
    T = k.shape[2]
    qg = q[:, 0].reshape(B, KVH, G, D).float()
    s = torch.einsum("bngd,bntd->bngt", qg, k.float()) * (D**-0.5 * LOG2E)
    valid = torch.arange(T, device=dev)[None, :] < per_batch(lengths, B, 0, dev)[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.tensor(float("-inf"), device=dev))
    if k_new is not None:
        s_self = torch.einsum("bngd,bnd->bng", qg, k_new.to(q.dtype).float()) * (D**-0.5 * LOG2E)
        s = torch.cat([s, s_self[..., None]], dim=-1)
        v = torch.cat([v, v_new.to(q.dtype)[:, :, None]], dim=2)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - torch.where(torch.isinf(m), torch.zeros_like(m), m))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bngt,bntd->bngd", p.to(v.dtype).float(), v.float())
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(B, 1, H, D).to(q.dtype)


def _paged_decode_operands(name, q, k_pages, v_pages, lengths, page_tables, k_new, v_new):
    """Check the operands of K12 or K13 (one contract); returns the C entry's
    suffix for the pool's dtype and the operands as the kernels take them:
    (suffix, q, tables, lengths, k_new, v_new, out)."""
    B, S, H, D = q.shape
    _, KVH, PS, _ = k_pages.shape
    self_col = k_new is not None
    suffix = _require_cuda(name, q, *((k_new, v_new) if self_col else ()), cache=(k_pages, v_pages))
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()) or k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: the pools must be contiguous and of one shape")
    require_head_dim(name, D, bool(suffix))
    if S != 1 or k_pages.shape[3] != D or PS not in PAGE_SIZES or H % KVH or H // KVH > 16:
        raise ValueError(f"{name}: unsupported shape q={tuple(q.shape)} pool={tuple(k_pages.shape)}")
    if self_col and not (k_new.shape == v_new.shape == (B, KVH, D)):
        raise ValueError(f"{name}: the self column must be [B, KVH, D], got {tuple(k_new.shape)}")
    qc = q.contiguous()
    tables = _table_arg(page_tables, q.device)
    lens = _int32(lengths, q.device).expand(B).contiguous()
    kn, vn = (k_new.contiguous(), v_new.contiguous()) if self_col else (None, None)
    return suffix, qc, tables, lens, kn, vn, torch.empty_like(qc)


def _opt_ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0) if t is None else kernel_lib.ptr(t)


def paged_splits(B: int, KVH: int, capacity: int, num_sms: int) -> tuple:
    """How K12 and K13 cut a request's ``capacity`` rows (the table width
    times the page size): ``(splits, rows)``, the rows of
    :func:`decode_splits` with ``SPLIT_TILE_ROWS``-row tiles and the blocks
    the card holds at once, at most ``SPLIT_MAX_ROWS``.  The one cut of both
    kernels, so that they compute the same bits.  Never reads the lengths,
    which live on the card."""
    rows = min(decode_splits(B, KVH, capacity, num_sms * SPLIT_BLOCKS_PER_SM, tile=SPLIT_TILE_ROWS)[1],
               SPLIT_MAX_ROWS)
    return -(-capacity // rows), rows


# the C entry of each split-KV paged decode kernel, by wrapper name
_SPLIT_DECODE = {"paged_flash_decode": ("paged_flash_decode.cu", "omchat_paged_flash_decode"),
                 "paged_flash_decode_manual": ("paged_flash_decode_manual.cu", "omchat_paged_flash_decode_manual")}


def _launch_split_decode(name, q, k_pages, v_pages, lengths, page_tables, k_new, v_new, page_offset):
    """Launch K12 or K13 (``name``, a key of ``_SPLIT_DECODE``): the
    :func:`paged_splits` cut of the table's capacity, the fp32 scratch of
    the chunks' partial states, one C entry that launches the split kernel
    and the merge.  Returns [B, 1, H, D]."""
    source, entry = _SPLIT_DECODE[name]
    B, _, H, D = q.shape
    KVH, PS = k_pages.shape[1:3]
    suffix, qc, tables, lens, kn, vn, out = _paged_decode_operands(name, q, k_pages, v_pages, lengths, page_tables,
                                                                   k_new, v_new)
    splits, rows = paged_splits(B, KVH, tables.shape[1] * PS, num_sms(q.device.index))
    scratch = torch.empty(scratch_floats(B, H, splits, D), dtype=torch.float32, device=q.device)
    kernel_lib.launch(
        source, entry + suffix, _SPLIT_DECODE_ARGS,
        *map(kernel_lib.ptr, (qc, k_pages, v_pages, lens, tables)), _opt_ptr(kn), _opt_ptr(vn),
        kernel_lib.ptr(out), kernel_lib.ptr(scratch), B, H, KVH, PS, D, tables.stride(0), tables.shape[1],
        int(page_offset), splits, rows, kernel_lib.stream_ptr(q.device),
    )
    return out


def paged_flash_decode(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_tables: torch.Tensor,
    k_new: Optional[torch.Tensor] = None,
    v_new: Optional[torch.Tensor] = None,
    *,
    page_offset: int = 0,
) -> torch.Tensor:
    """Decode attention over paged KV.

    q [B, 1, H, D]; k/v_pages [NP, KVH, page_size, D] (page-major, e.g. the
    flat ``[L*(P+1), ...]`` view of a layered pool; bfloat16 or e4m3 on
    CUDA); lengths [B] int32 valid rows; page_tables [B, W] int32, offset by
    ``page_offset`` (the layer's first page in a flat pool).
    ``k_new``/``v_new`` [B, KVH, D]: the in-flight token's K/V as a self
    column (``lengths`` then EXCLUDES it).  Only the pages below
    ``ceil(length / page_size)`` are read.  On CUDA, split-KV: each
    request's capacity is cut into :func:`paged_splits` chunks on the host; a
    block per (chunk, kv head, request) has a producer warp copy the chunk's
    rows by 16-byte ``cp.async`` into a ring while consumer warps run the
    online softmax, and writes its fp32 softmax state to a scratch; a second
    kernel, launched from the same C entry, merges the chunks and folds the
    self column in.  Returns [B, 1, H, D]."""
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k_pages, v_pages, lengths, page_tables, k_new, v_new,
                                        page_offset=page_offset)
    out = _launch_split_decode("paged_flash_decode", q, k_pages, v_pages, lengths, page_tables, k_new, v_new,
                               page_offset)
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0


# ---------------------------------------------------------------------------
# K13: the same function, pages streamed through a ring of bulk copies
# ---------------------------------------------------------------------------


def paged_flash_decode_manual_plain(q, k_pages, v_pages, lengths, page_tables, k_new=None, v_new=None, *,
                                    page_offset: int = 0):
    """K13's function, which is K12's (:func:`paged_flash_decode_plain`): the
    TPU kernels differ only in how the pages reach VMEM."""
    return paged_flash_decode_plain(q, k_pages, v_pages, lengths, page_tables, k_new, v_new, page_offset=page_offset)


def paged_flash_decode_manual(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_tables: torch.Tensor,
    k_new: Optional[torch.Tensor] = None,
    v_new: Optional[torch.Tensor] = None,
    *,
    page_offset: int = 0,
) -> torch.Tensor:
    """:func:`paged_flash_decode`'s contract, chunks and arithmetic on the
    manual-copy kernel: the producer warp streams each chunk's rows through
    a ring of ``cp.async.bulk`` copies completing on mbarriers (the
    counterpart of the TPU kernel's NBUF ring of async copies).  Gives K12's
    bits.  Returns [B, 1, H, D]."""
    if q.device.type == "cpu":
        return paged_flash_decode_manual_plain(q, k_pages, v_pages, lengths, page_tables, k_new, v_new,
                                               page_offset=page_offset)
    out = _launch_split_decode("paged_flash_decode_manual", q, k_pages, v_pages, lengths, page_tables, k_new, v_new,
                               page_offset)
    paged_flash_decode_manual.launches += 1
    return out


paged_flash_decode_manual.launches = 0

DECODE_KERNELS = {"auto": paged_flash_decode, "manual": paged_flash_decode_manual}


def paged_decode_attention(q, k_pages, v_pages, lengths, page_tables, *, impl: Optional[str] = None,
                           k_new=None, v_new=None, page_offset: int = 0, kernel: str = "auto"):
    """Dispatcher: for ``impl=None`` the kernel ``kernel`` names, K12
    (:func:`paged_flash_decode`, "auto") or K13
    (:func:`paged_flash_decode_manual`, "manual"); for "plain", the gathered
    pages in q's dtype through the plain reference attention (the
    counterpart of the JAX package's XLA route, which ignores ``kernel``).

    ``k_new``/``v_new`` [B, KVH, D]: self-column mode — the in-flight token's
    K/V fold into the softmax instead of being read back from the pool, and
    ``lengths`` EXCLUDES that token."""
    if kernel not in DECODE_KERNELS:
        raise ValueError(f"unknown decode kernel {kernel!r} (auto or manual)")
    if impl is None:
        return DECODE_KERNELS[kernel](q, k_pages, v_pages, lengths, page_tables, k_new, v_new,
                                      page_offset=page_offset)
    if impl != PLAIN:
        raise ValueError(f"unknown paged attention impl {impl!r} (None or 'plain')")
    k, v = _gather_pages(k_pages, v_pages, _int32(page_tables, q.device) + page_offset)
    k, v = k.to(q.dtype), v.to(q.dtype)
    if k_new is not None:
        return self_column_reference(q, k, v, lengths, k_new, v_new)
    return attention_reference(q, k.transpose(1, 2), v.transpose(1, 2), causal=False, q_offset=None, kv_len=lengths)


# ---------------------------------------------------------------------------
# K14: chunked-prefill attention walking the page tables
# ---------------------------------------------------------------------------


def paged_flash_prefill_plain(q, k_pages, v_pages, kv_len, page_tables, q_offset):
    """The kernel's function: the page-mapped K/V gathered contiguous in q's
    dtype (an e4m3 pool widened, as the TPU kernel's ``astype(q.dtype)``, so
    p is rounded to q's dtype), then K2's plain causal attention (the kernel
    shares K2's arithmetic)."""
    k, v = _gather_pages(k_pages, v_pages, _int32(page_tables, q.device))
    return flash_attention_plain(q, k.to(q.dtype), v.to(q.dtype), causal=True, q_offset=q_offset, kv_len=kv_len)


def paged_flash_prefill(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    kv_len: torch.Tensor,
    page_tables: torch.Tensor,
    q_offset: torch.Tensor,
) -> torch.Tensor:
    """Causal chunk attention through the page tables: query row i of
    request b sits at position ``q_offset[b] + i`` and sees the columns
    ``<= q_offset[b] + i`` and ``< kv_len[b]`` of its page-mapped sequence.

    q [B, C, H, D]; k/v_pages [P, KVH, page_size, D] (one layer's pool,
    bfloat16 or e4m3 on CUDA);
    kv_len, q_offset [B] or scalar; page_tables [B, W] int32.  Returns
    [B, C, H, D]; rows past a request's chunk length are padding."""
    if q.device.type == "cpu":
        return paged_flash_prefill_plain(q, k_pages, v_pages, kv_len, page_tables, q_offset)
    B, C, H, D = q.shape
    _, KVH, PS, _ = k_pages.shape
    suffix = _require_cuda("paged_flash_prefill", q, cache=(k_pages, v_pages))
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()) or k_pages.shape != v_pages.shape:
        raise ValueError("paged_flash_prefill: the pools must be contiguous and of one shape")
    require_head_dim("paged_flash_prefill", D, bool(suffix))
    if k_pages.shape[3] != D or PS not in PAGE_SIZES or H % KVH:
        raise ValueError(f"paged_flash_prefill: unsupported shape q={tuple(q.shape)} pool={tuple(k_pages.shape)}")
    qs = _prescale_q(q).contiguous()
    tables = _table_arg(page_tables, q.device)
    q_off = per_batch(q_offset, B, 0, q.device)
    kvl = per_batch(kv_len, B, 0, q.device)
    out = torch.empty_like(qs)
    kernel_lib.launch(
        "paged_flash_prefill.cu", "omchat_paged_flash_prefill" + suffix, _K14_ARGS,
        *map(kernel_lib.ptr, (qs, k_pages, v_pages, out, q_off, kvl, tables)),
        B, C, H, KVH, PS, D, tables.stride(0), tables.shape[1], k_pages.shape[0], kernel_lib.stream_ptr(q.device),
    )
    paged_flash_prefill.launches += 1
    return out


paged_flash_prefill.launches = 0


def paged_prefill_attention(q, k_pages, v_pages, kv_len, page_tables, q_offset, *, impl: Optional[str] = None):
    """Chunked-prefill attention over paged KV (one chunk of queries whose
    K/V are already in the request's pages; causal at absolute positions).

    ``impl=None``: K14 (:func:`paged_flash_prefill`), walking the page
    tables; ``"plain"``: the gathered pages through the plain reference
    attention.  q [B, C, H, D] → [B, C, H, D]."""
    if impl is None:
        return paged_flash_prefill(q, k_pages, v_pages, kv_len, page_tables, q_offset)
    if impl != PLAIN:
        raise ValueError(f"unknown paged attention impl {impl!r} (None or 'plain')")
    k, v = _gather_pages(k_pages, v_pages, _int32(page_tables, q.device))
    return attention_reference(q, k.transpose(1, 2).to(q.dtype), v.transpose(1, 2).to(q.dtype), causal=True,
                               q_offset=q_offset, kv_len=kv_len)


# ---------------------------------------------------------------------------
# K4: in-place row commit
# ---------------------------------------------------------------------------


def commit_rows_plain(k_pool, v_pool, pages, offsets, k_rows, v_rows):
    """``pool[pages[i], :, offsets[i]] = rows[i]`` in place, rounded to the
    pool's dtype (:func:`~omchat_torch.ops.fp8.cast_to`)."""
    pages = torch.as_tensor(pages, dtype=torch.long, device=k_pool.device)
    offsets = torch.as_tensor(offsets, dtype=torch.long, device=k_pool.device)
    k_pool[pages, :, offsets] = cast_to(k_rows, k_pool.dtype)
    v_pool[pages, :, offsets] = cast_to(v_rows, v_pool.dtype)
    return k_pool, v_pool


def commit_rows(
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    pages: torch.Tensor,
    offsets: torch.Tensor,
    k_rows: torch.Tensor,
    v_rows: torch.Tensor,
):
    """Write N single-token K/V rows into the pools IN PLACE.

    k/v_pool [P, KVH, PS, D]; pages, offsets [N] int32; k/v_rows [N, KVH, D]
    (on CUDA: bfloat16 rows into a bfloat16 or e4m3 pool, rounded in the
    kernel as :func:`~omchat_torch.ops.fp8.to_e4m3` rounds).  The pools are
    updated in place — PyTorch's counterpart of the TPU call's
    ``input_output_aliases`` — and returned.  Only the N target rows change;
    every other byte of the pools is left as it was.  Rows sharing a
    (page, offset) race; only the parking page receives such rows.  On CUDA a
    thread moves one 16-byte vector of a row (two rows a block, K and V in
    separate blocks); a head width D that is not a
    multiple of 8, or a pointer a vector cannot take, moves one value a
    thread."""
    if k_pool.device.type == "cpu":
        return commit_rows_plain(k_pool, v_pool, pages, offsets, k_rows, v_rows)
    suffix = _require_cuda("commit_rows", k_rows, v_rows, cache=(k_pool, v_pool))
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()) or k_pool.shape != v_pool.shape:
        raise ValueError("commit_rows: the pools must be contiguous and of one shape")
    P, KVH, PS, D = k_pool.shape
    n = int(pages.shape[0])
    kr = k_rows.reshape(n, KVH, D).contiguous()
    vr = v_rows.reshape(n, KVH, D).contiguous()
    pg = _int32(pages, k_pool.device).contiguous()
    of = _int32(offsets, k_pool.device).contiguous()
    kernel_lib.launch(
        "commit_rows.cu", "omchat_commit_rows" + suffix, _K4_ARGS,
        *map(kernel_lib.ptr, (k_pool, v_pool, pg, of, kr, vr)), n, KVH, PS, D,
        kernel_lib.stream_ptr(k_pool.device),
    )
    commit_rows.launches += 1
    return k_pool, v_pool


commit_rows.launches = 0


# ---------------------------------------------------------------------------
# K15: in-place whole-page commit
# ---------------------------------------------------------------------------


def _chunk_groups(chunks: torch.Tensor) -> torch.Tensor:
    """[M, KVH, ps, D] or [G, C, KVH, ps, D] → the 5-D view [G, C, KVH, ps, D]."""
    if chunks.dim() == 4:
        return chunks[None]
    if chunks.dim() != 5:
        raise ValueError(f"commit_pages: chunks must be [M, KVH, ps, D] or [G, C, KVH, ps, D], got {tuple(chunks.shape)}")
    return chunks


def commit_pages_plain(k_pool, v_pool, pages, k_chunks, v_chunks):
    """``pool[pages[m]] = chunks[m]`` in place (chunks flattened to
    [M, KVH, ps, D] in row-major order of their leading dims), rounded to the
    pool's dtype (:func:`~omchat_torch.ops.fp8.cast_to`)."""
    pages = torch.as_tensor(pages, dtype=torch.long, device=k_pool.device)
    shape = k_pool.shape[1:]
    k_pool[pages] = cast_to(k_chunks.reshape(-1, *shape), k_pool.dtype)
    v_pool[pages] = cast_to(v_chunks.reshape(-1, *shape), v_pool.dtype)
    return k_pool, v_pool


def commit_pages(
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    pages: torch.Tensor,
    k_chunks: torch.Tensor,
    v_chunks: torch.Tensor,
):
    """Write M whole pages into the pool IN PLACE — the prefill page commit.

    k/v_pool [NP, KVH, ps, D] (contiguous, e.g. the flat view of a layered
    pool); pages [M] int32 destination pages; k/v_chunks [M, KVH, ps, D], or
    a strided view [G, C, KVH, ps, D] with M = G*C whose page rows are
    contiguous per head — the engine passes the scratch cache
    [L*B, KVH, T, D] seen as [L*B, C, KVH, ps, D] without copying it.  On
    CUDA the chunks are bfloat16 and the pool bfloat16 or e4m3 (rounded in the
    kernel as :func:`~omchat_torch.ops.fp8.to_e4m3` rounds).
    Duplicate destinations (the parking page) write garbage over garbage in
    no defined order; nothing asserts uniqueness."""
    if k_pool.device.type == "cpu":
        return commit_pages_plain(k_pool, v_pool, pages, k_chunks, v_chunks)
    suffix = _require_cuda("commit_pages", k_chunks, v_chunks, cache=(k_pool, v_pool))
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()) or k_pool.shape != v_pool.shape:
        raise ValueError("commit_pages: the pools must be contiguous and of one shape")
    _, KVH, PS, D = k_pool.shape
    kc, vc = _chunk_groups(k_chunks), _chunk_groups(v_chunks)
    G, C = kc.shape[:2]
    if kc.shape != (G, C, KVH, PS, D) or vc.shape != kc.shape or kc.stride() != vc.stride():
        raise ValueError(f"commit_pages: chunks {tuple(kc.shape)} do not match the pool's pages {(KVH, PS, D)}")
    # the kernel reads 16-byte vectors of 8 source values and writes each as 8
    # pool values (16 bytes in bf16, 8 in e4m3)
    sg, sc, sh, sr, sd = kc.stride()
    if sd != 1 or sr != D or any(s % 8 for s in (sg, sc, sh)) or any(t.data_ptr() % 16 for t in (kc, vc)):
        raise ValueError("commit_pages: each chunk's page rows must be contiguous and 16-byte aligned")
    if (PS * D) % 8 or any(t.data_ptr() % (8 * t.element_size()) for t in (k_pool, v_pool)):
        raise ValueError("commit_pages: the pool's pages must hold whole 8-value vectors, aligned")
    pg = _int32(pages, k_pool.device).contiguous()
    if pg.numel() != G * C:
        raise ValueError(f"commit_pages: {pg.numel()} pages for {G * C} chunks")
    if G * C == 0:
        return k_pool, v_pool
    kernel_lib.launch(
        "commit_pages.cu", "omchat_commit_pages" + suffix, _K15_ARGS,
        *map(kernel_lib.ptr, (k_pool, v_pool, pg, kc, vc)), G * C, C, sg, sc, sh, KVH, PS, D,
        kernel_lib.stream_ptr(k_pool.device),
    )
    commit_pages.launches += 1
    return k_pool, v_pool


commit_pages.launches = 0
