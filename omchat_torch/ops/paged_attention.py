"""Paged KV: the page allocator, paged decode / chunked-prefill attention, and
the in-place row and page commits.

PyTorch port of ``omchat_tpu/ops/paged_attention.py``.  K/V live in a shared
page-major pool ``[P, KVH, page_size, D]`` (one page holds every kv head's
slice); each request maps logical blocks to physical pages through a page
table.  Four kernels:

- K12 :func:`paged_flash_decode` — one query token per request through its
  page table, with the in-flight token folded in as a self column
  (``omchat_torch/csrc/paged_flash_decode.cu``);
- K14 :func:`paged_flash_prefill` — a causal prefill chunk attending through
  the page tables (``omchat_torch/csrc/paged_flash_prefill.cu``);
- K4 :func:`commit_rows` — single-token rows written in place
  (``omchat_torch/csrc/commit_rows.cu``);
- K15 :func:`commit_pages` — whole pages written in place
  (``omchat_torch/csrc/commit_pages.cu``).

Each wrapper sends CPU tensors to its plain PyTorch version (``*_plain``) and
launches its CUDA kernel on CUDA tensors, or raises; ``<wrapper>.launches``
counts the kernel launches.  :func:`paged_decode_attention` and
:func:`paged_prefill_attention` are the dispatchers the serving engine calls.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import torch

from omchat_torch.ops import kernel_lib
from omchat_torch.ops.attention import PLAIN, attention_reference, per_batch, self_column_reference
from omchat_torch.ops.flash_attention import LOG2E, _prescale_q, _require_cuda, flash_attention_plain

# C signatures:
# K4  k_pool, v_pool, pages, offsets, k_rows, v_rows, N, KVH, PS, D, stream
# K12 q, k_pages, v_pages, lengths, tables, k_new, v_new, out,
#     B, H, KVH, PS, D, table_stride, width, page_offset, stream
# K14 q, k_pages, v_pages, out, q_offset, kv_len, tables,
#     B, C, H, KVH, PS, D, table_stride, width, stream
# K15 k_pool, v_pool, pages, k_src, v_src, M, C, stride_g, stride_c, stride_h, KVH, PS, D, stream
_K4_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_K12_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_K14_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_K15_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


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
    pages ``page_tables[b] + page_offset`` (at most the table's width), plus
    the in-flight token as one always-valid column when ``k_new`` is given.
    fp32 scores in the exp2 domain (scale D^-0.5 * log2 e), p rounded to the
    pool dtype for the PV product, l summing the fp32 p; a request with no
    valid column outputs zeros.  q [B, 1, H, D] → [B, 1, H, D]."""
    B, _, H, D = q.shape
    _, KVH, PS, _ = k_pages.shape
    G = H // KVH
    dev = q.device
    k, v = _gather_pages(k_pages, v_pages, _int32(page_tables, dev) + page_offset)  # [B, KVH, T, D]
    T = k.shape[2]
    qg = q[:, 0].reshape(B, KVH, G, D).float()
    s = torch.einsum("bngd,bntd->bngt", qg, k.float()) * (D**-0.5 * LOG2E)
    valid = torch.arange(T, device=dev)[None, :] < per_batch(lengths, B, 0, dev)[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.tensor(float("-inf"), device=dev))
    if k_new is not None:
        s_self = torch.einsum("bngd,bnd->bng", qg, k_new.to(k_pages.dtype).float()) * (D**-0.5 * LOG2E)
        s = torch.cat([s, s_self[..., None]], dim=-1)
        v = torch.cat([v, v_new.to(v_pages.dtype)[:, :, None]], dim=2)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - torch.where(torch.isinf(m), torch.zeros_like(m), m))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bngt,bntd->bngd", p.to(v.dtype).float(), v.float())
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(B, 1, H, D).to(q.dtype)


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
    flat ``[L*(P+1), ...]`` view of a layered pool); lengths [B] int32 valid
    rows; page_tables [B, W] int32, offset by ``page_offset`` (the layer's
    first page in a flat pool).  ``k_new``/``v_new`` [B, KVH, D]: the in-flight
    token's K/V as a self column (``lengths`` then EXCLUDES it).  Only the
    pages below ``ceil(length / page_size)`` are read.  Returns [B, 1, H, D]."""
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k_pages, v_pages, lengths, page_tables, k_new, v_new,
                                        page_offset=page_offset)
    B, S, H, D = q.shape
    _, KVH, PS, _ = k_pages.shape
    self_col = k_new is not None
    _require_cuda("paged_flash_decode", q, k_pages, v_pages, *((k_new, v_new) if self_col else ()))
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()) or k_pages.shape != v_pages.shape:
        raise ValueError("paged_flash_decode: the pools must be contiguous and of one shape")
    if S != 1 or D != 128 or PS != 128 or H % KVH or H // KVH > 16:
        raise ValueError(f"paged_flash_decode: unsupported shape q={tuple(q.shape)} pool={tuple(k_pages.shape)}")
    if self_col and not (k_new.shape == v_new.shape == (B, KVH, D)):
        raise ValueError(f"paged_flash_decode: the self column must be [B, KVH, D], got {tuple(k_new.shape)}")
    qc = q.contiguous()
    tables = _table_arg(page_tables, q.device)
    lens = _int32(lengths, q.device).expand(B).contiguous()
    kn = k_new.contiguous() if self_col else None
    vn = v_new.contiguous() if self_col else None
    out = torch.empty_like(qc)
    null = ctypes.c_void_p(0)
    kernel_lib.launch(
        "paged_flash_decode.cu", "omchat_paged_flash_decode", _K12_ARGS,
        *map(kernel_lib.ptr, (qc, k_pages, v_pages, lens, tables)),
        kernel_lib.ptr(kn) if self_col else null, kernel_lib.ptr(vn) if self_col else null, kernel_lib.ptr(out),
        B, H, KVH, PS, D, tables.stride(0), tables.shape[1], int(page_offset), kernel_lib.stream_ptr(q.device),
    )
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0


def paged_decode_attention(q, k_pages, v_pages, lengths, page_tables, *, impl: Optional[str] = None,
                           k_new=None, v_new=None, page_offset: int = 0):
    """Dispatcher: K12 (:func:`paged_flash_decode`) for ``impl=None``; for
    "plain", the gathered pages through the plain reference
    attention (the counterpart of the JAX package's XLA route).

    ``k_new``/``v_new`` [B, KVH, D]: self-column mode — the in-flight token's
    K/V fold into the softmax instead of being read back from the pool, and
    ``lengths`` EXCLUDES that token."""
    if impl is None:
        return paged_flash_decode(q, k_pages, v_pages, lengths, page_tables, k_new, v_new, page_offset=page_offset)
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
    """The kernel's function: the page-mapped K/V gathered contiguous, then
    K2's plain causal attention (the kernel shares K2's arithmetic)."""
    k, v = _gather_pages(k_pages, v_pages, _int32(page_tables, q.device))
    return flash_attention_plain(q, k, v, causal=True, q_offset=q_offset, kv_len=kv_len)


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

    q [B, C, H, D]; k/v_pages [P, KVH, page_size, D] (one layer's pool);
    kv_len, q_offset [B] or scalar; page_tables [B, W] int32.  Returns
    [B, C, H, D]; rows past a request's chunk length are padding."""
    if q.device.type == "cpu":
        return paged_flash_prefill_plain(q, k_pages, v_pages, kv_len, page_tables, q_offset)
    B, C, H, D = q.shape
    _, KVH, PS, _ = k_pages.shape
    _require_cuda("paged_flash_prefill", q, k_pages, v_pages)
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()) or k_pages.shape != v_pages.shape:
        raise ValueError("paged_flash_prefill: the pools must be contiguous and of one shape")
    if D != 128 or PS % 64 or H % KVH or H // KVH > 8:
        raise ValueError(f"paged_flash_prefill: unsupported shape q={tuple(q.shape)} pool={tuple(k_pages.shape)}")
    qs = _prescale_q(q).contiguous()
    tables = _table_arg(page_tables, q.device)
    q_off = per_batch(q_offset, B, 0, q.device)
    kvl = per_batch(kv_len, B, 0, q.device)
    out = torch.empty_like(qs)
    kernel_lib.launch(
        "paged_flash_prefill.cu", "omchat_paged_flash_prefill", _K14_ARGS,
        *map(kernel_lib.ptr, (qs, k_pages, v_pages, out, q_off, kvl, tables)),
        B, C, H, KVH, PS, D, tables.stride(0), tables.shape[1], kernel_lib.stream_ptr(q.device),
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
    """``pool[pages[i], :, offsets[i]] = rows[i]`` in place."""
    pages = torch.as_tensor(pages, dtype=torch.long, device=k_pool.device)
    offsets = torch.as_tensor(offsets, dtype=torch.long, device=k_pool.device)
    k_pool[pages, :, offsets] = k_rows.to(k_pool.dtype)
    v_pool[pages, :, offsets] = v_rows.to(v_pool.dtype)
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

    k/v_pool [P, KVH, PS, D]; pages, offsets [N] int32; k/v_rows [N, KVH, D].
    The pools are updated in place — PyTorch's counterpart of the TPU call's
    ``input_output_aliases`` — and returned.  Only the N target rows change;
    every other byte of the pools is left as it was.  Rows sharing a
    (page, offset) race; only the parking page receives such rows."""
    if k_pool.device.type == "cpu":
        return commit_rows_plain(k_pool, v_pool, pages, offsets, k_rows, v_rows)
    for t in (k_pool, v_pool, k_rows, v_rows):
        if t.device.type != "cuda":
            raise ValueError(f"commit_rows: expected CUDA tensors, got {t.device}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()) or k_pool.shape != v_pool.shape:
        raise ValueError("commit_rows: the pools must be contiguous and of one shape")
    if k_pool.dtype != torch.bfloat16 or v_pool.dtype != torch.bfloat16:
        raise TypeError(f"commit_rows: the CUDA kernel takes a bfloat16 cache, got {k_pool.dtype}")
    P, KVH, PS, D = k_pool.shape
    n = int(pages.shape[0])
    kr = k_rows.to(k_pool.dtype).reshape(n, KVH, D).contiguous()
    vr = v_rows.to(v_pool.dtype).reshape(n, KVH, D).contiguous()
    pg = _int32(pages, k_pool.device).contiguous()
    of = _int32(offsets, k_pool.device).contiguous()
    kernel_lib.launch(
        "commit_rows.cu", "omchat_commit_rows", _K4_ARGS,
        *map(kernel_lib.ptr, (k_pool, v_pool, pg, of, kr, vr)), n, KVH, PS, D, kernel_lib.stream_ptr(k_pool.device),
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
    [M, KVH, ps, D] in row-major order of their leading dims)."""
    pages = torch.as_tensor(pages, dtype=torch.long, device=k_pool.device)
    shape = k_pool.shape[1:]
    k_pool[pages] = k_chunks.reshape(-1, *shape).to(k_pool.dtype)
    v_pool[pages] = v_chunks.reshape(-1, *shape).to(v_pool.dtype)
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
    [L*B, KVH, T, D] seen as [L*B, C, KVH, ps, D] without copying it.
    Duplicate destinations (the parking page) write garbage over garbage in
    no defined order; nothing asserts uniqueness."""
    if k_pool.device.type == "cpu":
        return commit_pages_plain(k_pool, v_pool, pages, k_chunks, v_chunks)
    _require_cuda("commit_pages", k_pool, v_pool, k_chunks, v_chunks)
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()) or k_pool.shape != v_pool.shape:
        raise ValueError("commit_pages: the pools must be contiguous and of one shape")
    _, KVH, PS, D = k_pool.shape
    kc, vc = _chunk_groups(k_chunks), _chunk_groups(v_chunks)
    G, C = kc.shape[:2]
    if kc.shape != (G, C, KVH, PS, D) or vc.shape != kc.shape or kc.stride() != vc.stride():
        raise ValueError(f"commit_pages: chunks {tuple(kc.shape)} do not match the pool's pages {(KVH, PS, D)}")
    sg, sc, sh, sr, sd = kc.stride()
    if sd != 1 or sr != D or any(s % 8 for s in (sg, sc, sh)) or any(t.data_ptr() % 16 for t in (kc, vc)):
        raise ValueError("commit_pages: each chunk's page rows must be contiguous and 16-byte aligned")
    pg = _int32(pages, k_pool.device).contiguous()
    if pg.numel() != G * C:
        raise ValueError(f"commit_pages: {pg.numel()} pages for {G * C} chunks")
    if G * C == 0:
        return k_pool, v_pool
    kernel_lib.launch(
        "commit_pages.cu", "omchat_commit_pages", _K15_ARGS,
        *map(kernel_lib.ptr, (k_pool, v_pool, pg, kc, vc)), G * C, C, sg, sc, sh, KVH, PS, D,
        kernel_lib.stream_ptr(k_pool.device),
    )
    commit_pages.launches += 1
    return k_pool, v_pool


commit_pages.launches = 0
