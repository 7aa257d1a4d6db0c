"""Paged continuous-batching engine — PyTorch port of
``omchat_tpu/runtime/paged_engine.py``.

KV lives in a shared page pool ([L, P+1, KVH, page, D], page-major; the last
page of every layer is the parking page that no request owns) and each
request maps logical blocks to physical pages through its row of a page
table.  One :meth:`PagedBatchEngine.step` (a scheduler tick):

1. encodes every pending image in one padded ViT dispatch (K1);
2. admits queued requests onto free slots, allocating pages for
   prompt + max_new_tokens + roll headroom up front;
3. runs every pending prefill — short text prompts batched by length bucket
   through one contiguous prefill (K2) into a scratch cache and one
   whole-page commit (K15, :func:`_commit_pages`); a lone short prompt the
   same way; longer or image prompts one fixed-width chunk per tick
   (:func:`_paged_prefill_chunk`: the chunk's K/V written into the request's
   pages, attention walking the page tables, K14), requests at the same chunk
   width together;
4. runs one decode roll over every decoding slot
   (:func:`_paged_decode_roll`): each step runs every layer with the pool
   read-only (K12, or with ``decode_kernel="manual"`` K13, with the in-flight
   token as a self column) and commits all layers' new rows once (K4); the
   tokens come back to the host once per roll.  A roll runs ``decode_roll``
   steps, or ``streaming_roll`` while any decoding request was submitted with
   ``streaming=True`` (an SSE client is attached).  The roll reads its tokens,
   lengths, active flags, per-slot pick parameters (do_sample, top_k,
   temperature, top_p) and page tables from one static buffer of
   ``max_slots`` rows that the host fills before each roll.  A roll's pick
   mode is (any slot samples, any slot wants log-probs), the JAX engine's
   four program variants: sampled slots draw from the engine's generator,
   greedy slots take the argmax, and with log-probs the roll also returns
   each slot's chosen log-prob and top ``LOGPROBS_K`` of the raw logits.
   On a CUDA engine a roll is one replay of a CUDA graph of the roll
   (:class:`~omchat_torch.runtime.cuda_graphs.GraphedStep`), one graph per
   table width bucket (4, 8, 16, 32 pages, capped at the table's width),
   pick mode and roll length, in one graph pool, a sampled graph drawing
   from the engine's generator registered with it;
   :meth:`PagedBatchEngine.precompile` captures them ahead of traffic, else
   a roll captures at its first use: the counterpart of the JAX engine's one
   ``_paged_decode_roll_jit`` dispatch.  CPU engines, ``attn_impl="plain"``
   and ``decode_graphs=False`` run the same bodies eagerly;
   ``latency_stats()`` counts ``rolls_graphed`` and ``rolls_eager``.  A
   request's first token's log-probs come from its prefill's last row, on
   every prefill route.

The routes beside the plain roll, each the JAX engine's:

- ``prefix_cache``: prompt pages are published under a digest chain
  (:mod:`omchat_torch.runtime.prefix_cache`, image-aware) when a prefill
  completes; a later request whose prompt starts with published pages maps
  them and resumes its prefill past them on the chunked route (K14 reading
  pages another request wrote).  Refcount-0 pages are evicted under
  pressure.
- ``speculative``: while no decoding request samples or wants log-probs,
  each slot proposes up to ``draft_len`` tokens (prompt lookup over its
  prompt and generation, or ``draft_fn``) and one verify dispatch
  (:func:`_paged_verify`: the slot's live pages gathered, K2 over them with
  the in-flight rows spliced in, one K4 for all L·S·T rows) scores them all;
  an acceptance EMA sends the engine back to rolls when drafts stop
  accepting.  On a CUDA engine the verify is one replay of a CUDA graph per
  table width (``verifies_graphed`` / ``verifies_eager``).
- ``pipeline_rolls``: while nothing would change the decoding set, the next
  roll is dispatched from the in-flight roll's tokens on the device before
  the host reads that roll back, so the host's readback and bookkeeping
  overlap the card's work.
- ``prefill_priority``: no roll while an admitted slot is mid-prefill.

A roll or verify may write past a finished request's budget: each request
holds ``_max_roll - 1`` positions of headroom (the largest of
``decode_roll``, ``streaming_roll`` and ``draft_len + 1``, doubled under
``pipeline_rolls``), and the table is widened by as much.

``cache_dtype=torch.float8_e4m3fn`` keeps the pool in e4m3 (half the bytes a
page): short prompts still prefill into a scratch cache of the weights' dtype
and K15 rounds their pages on commit; a chunk's K/V are rounded as they are
written into its pages, which K14 then reads; decode folds the in-flight token
in unrounded and K4 rounds it on commit; the verify widens the gathered pages
to the activations' dtype, so it runs K2's bf16 entry.  Every rounding is
:func:`omchat_torch.ops.fp8.to_e4m3`'s, the JAX package's ``astype``.

Under w8a8 (``cfg.w8a8`` with int8 params) the short prefills, the chunks and
the verify run the glue layer of :func:`~omchat_torch.models.qwen2.decoder_layer`
(K7, K11) and the ViT its glue scan; decode rolls stay weight-only int8.

The pools are updated in place (the counterpart of the JAX package's buffer
donation).  ``attn_impl``: None runs the hand-written kernels on CUDA tensors
(their plain versions on CPU tensors); ``"plain"`` the plain reference
attention and plain commits everywhere.  A CUDA engine takes the page sizes
the paged attention kernels are built for (``ops.paged_attention.PAGE_SIZES``:
16, 32, 64, 128) and refuses any other before it allocates; a CPU engine takes
any page size.

An MoE trunk (``cfg.text.is_moe``) serves through the same layer body with
its block as the MLP; ``moe_impl`` picks the experts' route in the chunked
prefill, the rolls and the verify ("dense", which the graphs capture, or
"gmm", eager only), and the contiguous prefill of the single-request engine
takes the dense route, as in the JAX engine.

``mesh`` (a pure tensor-parallel :class:`~omchat_torch.parallel.mesh.Mesh`;
:mod:`omchat_torch.parallel.serving`): ``params`` is this rank's shard, the
pools hold this rank's kv heads ([L, P+1, KVH/tp, page, D], or every kv
head, [L, P+1, KVH, page, D], where tp does not divide them, and then K12 /
K13 and K14 run once per run of q heads that share a kv head), K12 / K13,
K14, K15 and K4 run on them, w8a8 prefills run the unfused chain, the MoE
trunk its experts' block a rank (either ``moe_impl``), the logits are gathered over the vocabulary,
and the host allocator, page tables and prefix cache, fed the same calls,
stay the same on every rank.  Rolls and verifies run eagerly there (a gloo
collective cannot be captured).  Presence / frequency penalties raise
``NotImplementedError``: the JAX paged engine has none either.  Prefill runs
eagerly, so :meth:`PagedBatchEngine.precompile` captures the decode rolls and
the verify only.
"""

from __future__ import annotations

import itertools
import math
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from omchat_torch.config import OmChatConfig
from omchat_torch.models.omchat import fuse_embeddings
from omchat_torch.models.qwen2 import decoder_layer, embed_tokens, full_logits, quant_glue_ok
from omchat_torch.models.qwen2_moe import MOE_IMPLS, moe_mlp
from omchat_torch.ops.attention import PLAIN, attention
from omchat_torch.ops.fp8 import cast_to
from omchat_torch.ops.norms import rms_norm
from omchat_torch.ops.paged_attention import (
    DECODE_KERNELS,
    PAGE_SIZES,
    PageAllocator,
    _gather_pages,
    commit_pages,
    commit_pages_plain,
    commit_rows,
    commit_rows_plain,
    paged_decode_attention,
    paged_prefill_attention,
)
from omchat_torch.ops.rope import rope_cos_sin
from omchat_torch.ops.sampling import greedy, sample, sample_batch
from omchat_torch.parallel.serving import check_serving_mesh, replicated
from omchat_torch.parallel.sharding import local_kv_shape
from omchat_torch.parallel.tp_attention import by_runs, head_runs, one_head
from omchat_torch.runtime.cuda_graphs import GraphedStep
from omchat_torch.runtime.feature_cache import pixel_digest
from omchat_torch.runtime.generate import OmChatEngine
from omchat_torch.runtime.prefix_cache import PrefixPageCache, page_hashes
from omchat_torch.runtime.speculative import propose_draft
from omchat_torch.utils.device import resolve_device
from omchat_torch.utils.tree import layer_slice

ROLL_WIDTHS = (4, 8, 16, 32)  # the page-table width buckets of a decode roll (pages), as the JAX engine's
LOGPROBS_K = 5  # OpenAI caps top_logprobs at 5; a roll with log-probs returns this many, the host slices
# A roll's pick mode: (any slot samples, any slot wants log-probs), the JAX
# engine's four (any_sampled, logprobs) variants; one CUDA graph each a width
PICK_MODES = ((False, False), (True, False), (False, True), (True, True))
# the roll buffer's columns before the page table: token, length, active,
# do_sample, top_k, then temperature and top_p as fp32 bits
_ROLL_COLS = 7


def commit_page_ids(tables: np.ndarray, n_pages: np.ndarray, n_layers: int, n_chunks: int,
                    pages_per_layer: int) -> np.ndarray:
    """The flat pool page [L*B*n_chunks] (int32) of every page-sized chunk of
    a contiguous [L, B, KVH, n_chunks*page, D] cache: chunk c of row b in
    layer li goes to ``li*pages_per_layer + tables[b, c]`` while c is below
    n_pages[b] and the table's width, else to the layer's parking page (its
    last).  tables [B, max_pages] and n_pages [B] are host arrays."""
    b, max_pages = tables.shape
    idx = np.broadcast_to(np.arange(n_chunks, dtype=np.int32), (b, n_chunks))
    valid = (idx < np.asarray(n_pages)[:, None]) & (idx < max_pages)
    pages = np.where(valid, np.take_along_axis(tables, np.minimum(idx, max_pages - 1), axis=1), pages_per_layer - 1)
    return (np.arange(n_layers, dtype=np.int32)[:, None, None] * pages_per_layer + pages[None]).reshape(-1)


def _commit_pages(slot_k, slot_v, k_pool, v_pool, tables: np.ndarray, n_pages: np.ndarray, page_size: int,
                  attn_impl: Optional[str] = None):
    """Commit B requests' contiguous K/V ([L, B, KVH, T, D], T a multiple of
    page_size) into their pages with one whole-page commit (K15), in place.

    Chunks past a request's valid page count land on the parking page
    (:func:`commit_page_ids`): never attended, so the undefined pick among
    duplicate writes there is harmless.  The scratch cache is handed to the
    kernel as a strided view [L*B, C, KVH, page, D]; nothing is transposed or
    copied first."""
    l, b, kvh, t, d = slot_k.shape
    c = t // page_size
    p_total = k_pool.shape[1]
    flat = commit_page_ids(tables, n_pages, l, c, p_total)
    chunks_k = slot_k.view(l * b, kvh, c, page_size, d).transpose(1, 2)
    chunks_v = slot_v.view(l * b, kvh, c, page_size, d).transpose(1, 2)
    commit = commit_pages_plain if attn_impl == PLAIN else commit_pages
    commit(k_pool.view(l * p_total, kvh, page_size, d), v_pool.view(l * p_total, kvh, page_size, d),
           torch.as_tensor(flat, device=k_pool.device), chunks_k, chunks_v)


def _mlp_fn(tc, moe_impl: str):
    """The layers' MLP: None (the dense SwiGLU) or, on an MoE trunk, its
    block with the ``moe_impl`` experts route."""
    return moe_mlp(tc, moe_impl) if tc.is_moe else None


def _decode_step_core(params, cfg: OmChatConfig, tokens, lengths, active, tables, k_pool, v_pool, page_size: int,
                      attn_impl: Optional[str] = None, *, decode_kernel: str = "auto",
                      sampling: Optional[dict] = None, generator: Optional[torch.Generator] = None,
                      logprobs: bool = False, moe_impl: str = "dense", mesh=None):
    """One decode step over every slot against the page pool; returns the
    next tokens [S] (int32) and commits the step's K/V rows in place.  With
    ``logprobs`` it returns (tokens, chosen [S] fp32, top values [S, K]
    fp32, top ids [S, K] int64): the log-probs of the raw fp32 logits, before
    temperature and any sampling filter, the chosen token's and the top
    ``LOGPROBS_K``.

    tokens, lengths (valid rows already in pages), active [S]; tables [S, W]
    (parked rows for inactive slots), all on the pools' device.  The layer
    body is the shared :func:`~omchat_torch.models.qwen2.decoder_layer`; only
    ``attend`` differs: K12 (``decode_kernel="manual"``: K13) over the flat
    pool ``[L*(P+1), KVH, page, D]`` (layer li's pages at ``li*(P+1) +
    page``), READ-ONLY through the layer loop, with the in-flight token as a
    self column.  Each layer hands back
    its new K/V rows, and one row commit (K4) writes all layers' rows after
    the loop.  ``sampling``: per-slot do_sample / temperature / top_k / top_p
    tensors, drawn with ``generator``; None decodes greedily.  ``mesh``:
    the params and the pools are this rank's shards; where the kv heads
    replicate, each run of q heads that share a kv head decodes over a
    contiguous copy of that head of the layer's pool, and the commit writes
    every kv head."""
    tc = cfg.text
    lm = params["language_model"]
    n_layers, n_slots = k_pool.shape[0], k_pool.shape[1]  # P+1 incl. parking
    kflat = k_pool.view(n_layers * n_slots, *k_pool.shape[2:])
    vflat = v_pool.view(n_layers * n_slots, *v_pool.shape[2:])
    x = embed_tokens(lm, tokens[:, None], mesh, tc.vocab_size)  # [S, 1, D]
    cos, sin = rope_cos_sin(
        lengths[:, None], tc.attn_head_dim, theta=tc.rope_theta, scaling=tc.rope_scaling,
        max_position_embeddings=tc.max_position_embeddings, dtype=x.dtype,
    )
    # inactive slots hold parked tables, so their writes land on the parking page
    col = torch.clamp(lengths // page_size, max=tables.shape[1] - 1).long()
    page_idx = tables.gather(1, col[:, None])[:, 0]
    offsets = lengths % page_size
    attn_lengths = torch.where(active, lengths, torch.zeros_like(lengths))
    k_rows: List[torch.Tensor] = []
    v_rows: List[torch.Tensor] = []
    runs = head_runs(tc, mesh)
    for li in range(n_layers):
        def attend(q, k, v, li=li):
            k_rows.append(k[:, 0])
            v_rows.append(v[:, 0])
            if runs is None:
                return paged_decode_attention(q, kflat, vflat, attn_lengths, tables, impl=attn_impl,
                                              k_new=k[:, 0], v_new=v[:, 0], page_offset=li * n_slots,
                                              kernel=decode_kernel)
            # a run's kv head of layer li's pool, copied contiguous for K12 / K13
            return by_runs(runs, q, lambda qr, h: paged_decode_attention(
                qr, one_head(k_pool[li], h, 1), one_head(v_pool[li], h, 1), attn_lengths, tables, impl=attn_impl,
                k_new=one_head(k[:, 0], h, 1), v_new=one_head(v[:, 0], h, 1), kernel=decode_kernel))

        x = decoder_layer(tc, x, layer_slice(lm["layers"], li), cos, sin, attend, mlp_fn=_mlp_fn(tc, moe_impl),
                          mesh=mesh)
    flat_pages = (torch.arange(n_layers, dtype=torch.int32, device=tokens.device)[:, None] * n_slots
                  + page_idx[None, :]).reshape(-1)
    commit = commit_rows_plain if attn_impl == PLAIN else commit_rows
    s = tokens.shape[0]
    commit(kflat, vflat, flat_pages, offsets.repeat(n_layers),
           torch.stack(k_rows).reshape(n_layers * s, *k_rows[0].shape[1:]),
           torch.stack(v_rows).reshape(n_layers * s, *v_rows[0].shape[1:]))
    logits = full_logits(lm, tc, rms_norm(x, lm["norm"]["scale"], tc.rms_norm_eps), mesh)[:, 0]
    return _roll_pick(logits, sampling, generator, logprobs)


def _roll_pick(logits, sampling: Optional[dict], generator: Optional[torch.Generator], logprobs: bool):
    """A roll step's pick from its [S, V] fp32 logits: the argmax, or with
    ``sampling`` :func:`~omchat_torch.ops.sampling.sample_batch` (greedy
    slots still take the argmax); with ``logprobs`` also the chosen token's
    log-prob and the top ``LOGPROBS_K`` of log_softmax of the raw logits."""
    nxt = greedy(logits) if sampling is None else sample_batch(logits, generator, **sampling)
    if not logprobs:
        return nxt
    lp = torch.log_softmax(logits.float(), dim=-1)
    top = torch.topk(lp, LOGPROBS_K, dim=-1)
    return nxt, lp.gather(1, nxt[:, None].long())[:, 0], top.values, top.indices


def _paged_decode_roll(params, cfg: OmChatConfig, tokens, lengths, active, tables, k_pool, v_pool, page_size: int,
                       attn_impl: Optional[str], steps: int, *, decode_kernel: str = "auto",
                       sampling: Optional[dict] = None, generator: Optional[torch.Generator] = None,
                       logprobs: bool = False, moe_impl: str = "dense", mesh=None):
    """``steps`` decode iterations issued back to back on the device; returns
    the [steps, S] tokens without reading them back (with ``logprobs`` the
    tuple of :func:`_decode_step_core`'s outputs, each stacked over the
    steps).  Requests that hit EOS or their budget mid-roll keep decoding
    into their own headroom pages (the engine allocates ``_max_roll - 1``
    extra positions); the host discards the surplus tokens."""
    out = []
    for _ in range(steps):
        step = _decode_step_core(params, cfg, tokens, lengths, active, tables, k_pool, v_pool, page_size,
                                 attn_impl, decode_kernel=decode_kernel, sampling=sampling, generator=generator,
                                 logprobs=logprobs, moe_impl=moe_impl, mesh=mesh)
        out.append(step)
        tokens = step[0] if logprobs else step
        lengths = torch.where(active, lengths + 1, lengths)
    if logprobs:
        return tuple(torch.stack(parts) for parts in zip(*out))
    return torch.stack(out)


def _paged_prefill_chunk(params, cfg: OmChatConfig, token_ids, is_image, image_index, image_features, positions,
                         chunk_start: np.ndarray, chunk_len: np.ndarray, tables: np.ndarray, k_pool, v_pool,
                         page_size: int, attn_impl: Optional[str] = None, moe_impl: str = "dense",
                         mesh=None) -> torch.Tensor:
    """One chunk of a paged prefill for B requests at once: each row's K/V go
    into its own pages (a plain indexed write, in place, rounded to the pool's
    dtype) and the chunk attends to everything cached so far through the page
    tables; returns each row's last-valid-position logits [B, V].

    token_ids, is_image, image_index, positions [B, C] (C a multiple of
    page_size); chunk_start (page-aligned), chunk_len [B] and tables
    [B, max_pages] are host arrays.  Rows whose chunk runs past the table
    write to the parking page (clamping onto the table's last entry would
    overwrite a full-allocation request's real last page); padded tail rows
    land in decode headroom or on the parking page and are never attended."""
    tc = cfg.text
    lm = params["language_model"]
    dev = k_pool.device
    b, c = token_ids.shape
    n_chunk = c // page_size
    max_pages = tables.shape[1]
    kvh, hd = k_pool.shape[2], tc.attn_head_dim  # this rank's kv heads under a mesh
    parked = k_pool.shape[1] - 1

    x = fuse_embeddings(params, token_ids, is_image, image_index, image_features, mesh, tc.vocab_size)  # [B, C, D]
    cos, sin = rope_cos_sin(
        positions, hd, theta=tc.rope_theta, scaling=tc.rope_scaling,
        max_position_embeddings=tc.max_position_embeddings, dtype=x.dtype,
    )
    idx = (chunk_start // page_size)[:, None] + np.arange(n_chunk)[None, :]
    pages = np.where(idx < max_pages, np.take_along_axis(tables, np.minimum(idx, max_pages - 1), axis=1), parked)
    pages = torch.as_tensor(pages.reshape(-1), dtype=torch.long, device=dev)
    kv_len = torch.as_tensor(chunk_start + chunk_len, dtype=torch.int32, device=dev)
    q_off = torch.as_tensor(chunk_start, dtype=torch.int32, device=dev)
    tab = torch.as_tensor(tables, dtype=torch.int32, device=dev)
    runs = head_runs(tc, mesh)
    for li in range(k_pool.shape[0]):
        kp, vp = k_pool[li], v_pool[li]

        def attend(q, k, v, kp=kp, vp=vp):
            kp[pages] = cast_to(k.reshape(b * n_chunk, page_size, kvh, hd).transpose(1, 2), kp.dtype)
            vp[pages] = cast_to(v.reshape(b * n_chunk, page_size, kvh, hd).transpose(1, 2), vp.dtype)
            return by_runs(runs, q, lambda qr, h: paged_prefill_attention(
                qr, one_head(kp, h, 1), one_head(vp, h, 1), kv_len, tab, q_off, impl=attn_impl))

        x = decoder_layer(tc, x, layer_slice(lm["layers"], li), cos, sin, attend, quant_glue=quant_glue_ok(attn_impl),
                          mlp_fn=_mlp_fn(tc, moe_impl), mesh=mesh)
    last_idx = torch.as_tensor(np.maximum(chunk_len - 1, 0), dtype=torch.long, device=dev)
    last = x[torch.arange(b, device=dev), last_idx]  # [B, D]
    return full_logits(lm, tc, rms_norm(last, lm["norm"]["scale"], tc.rms_norm_eps), mesh)


def _paged_verify(params, cfg: OmChatConfig, tokens, lengths, active, tables, k_pool, v_pool, page_size: int,
                  attn_impl: Optional[str] = None, moe_impl: str = "dense", mesh=None) -> torch.Tensor:
    """Speculative verify: T candidate rows a slot in one forward against the
    page pool; returns the logits of every row [S, T, V] (fp32) and commits
    the rows' K/V in place.

    tokens [S, T] (each slot's last token, then its draft), lengths (valid
    rows already in pages), active [S]; tables [S, W] (parked rows for
    inactive slots), all on the pools' device.  The decode step's memory
    structure: the pools stay READ-ONLY through the layer loop; each layer
    gathers the slots' live pages to a contiguous [S, KVH, W*ps, D] block,
    widens it to q's dtype (an e4m3 pool's pages included, so K2 runs its
    bf16 entry and does not round p), splices the in-flight rows in at their
    absolute positions and runs causal attention over it (K2 at per-slot
    ``q_offset = lengths`` and ``kv_len = lengths + T``; inactive slots attend
    to nothing), and hands back its T new rows; one row commit (K4) writes all
    L*S*T rows after the loop, inactive slots' onto the parking page.
    Rejected rows stay beyond the accepted length, where the next dispatch
    writes again before anything reads them."""
    tc = cfg.text
    lm = params["language_model"]
    s, t = tokens.shape
    dev = tokens.device
    max_pages = tables.shape[1]
    n_layers, n_slots = k_pool.shape[0], k_pool.shape[1]  # P+1 incl. parking
    kflat = k_pool.view(n_layers * n_slots, *k_pool.shape[2:])
    vflat = v_pool.view(n_layers * n_slots, *v_pool.shape[2:])
    x = embed_tokens(lm, tokens, mesh, tc.vocab_size)  # [S, T, D]
    positions = lengths[:, None] + torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    cos, sin = rope_cos_sin(
        positions, tc.attn_head_dim, theta=tc.rope_theta, scaling=tc.rope_scaling,
        max_position_embeddings=tc.max_position_embeddings, dtype=x.dtype,
    )
    col = (positions // page_size).long()
    page_rows = torch.where(col < max_pages, tables.gather(1, col.clamp(max=max_pages - 1)), n_slots - 1)  # [S, T]
    offsets = positions % page_size
    kv_len = torch.where(active, lengths + t, torch.zeros_like(lengths))
    q_off = torch.where(active, lengths, torch.zeros_like(lengths))
    b_idx = torch.arange(s, device=dev)[:, None]
    rows = positions.long()
    k_rows: List[torch.Tensor] = []
    v_rows: List[torch.Tensor] = []
    runs = head_runs(tc, mesh)
    for li in range(n_layers):
        def attend(q, k, v, li=li):
            k_rows.append(k)
            v_rows.append(v)
            kg, vg = _gather_pages(kflat, vflat, tables + li * n_slots)
            kg, vg = kg.to(q.dtype), vg.to(q.dtype)
            kg[b_idx, :, rows] = k
            vg[b_idx, :, rows] = v
            return by_runs(runs, q, lambda qr, h: attention(
                qr, one_head(kg, h, 1, copy=False), one_head(vg, h, 1, copy=False), causal=True, q_offset=q_off,
                kv_len=kv_len, impl=attn_impl, kv_format="bntd"))

        x = decoder_layer(tc, x, layer_slice(lm["layers"], li), cos, sin, attend, quant_glue=quant_glue_ok(attn_impl),
                          mlp_fn=_mlp_fn(tc, moe_impl), mesh=mesh)
    flat_pages = (torch.arange(n_layers, dtype=torch.int32, device=dev)[:, None, None] * n_slots
                  + page_rows[None]).reshape(-1)
    commit = commit_rows_plain if attn_impl == PLAIN else commit_rows
    commit(kflat, vflat, flat_pages, offsets[None].expand(n_layers, s, t).reshape(-1),
           torch.stack(k_rows).reshape(n_layers * s * t, *k_rows[0].shape[2:]),
           torch.stack(v_rows).reshape(n_layers * s * t, *v_rows[0].shape[2:]))
    return full_logits(lm, tc, rms_norm(x, lm["norm"]["scale"], tc.rms_norm_eps), mesh)


@dataclass
class _PagedRequest:
    request_id: int
    input_ids: List[int]
    image_features: Optional[torch.Tensor]
    max_new_tokens: int
    eos_token_id: int
    generation: Optional[object] = None
    pages: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    plan: Optional[object] = None
    prefilled: bool = False
    generated: List[int] = field(default_factory=list)
    done: bool = False
    last_token: Optional[int] = None
    prompt_len: int = 0
    n_pages_needed: int = 0
    chunk_pos: int = 0  # next chunk start of an in-progress paged prefill
    page_hashes: List[bytes] = field(default_factory=list)  # prefix-cache digests of the prompt's pages
    cache_refs: List[int] = field(default_factory=list)  # pages held through the prefix cache
    cancelled: bool = False  # cooperative: swept by the scheduler at tick start
    pending_pixels: Optional[np.ndarray] = None  # tiles awaiting the batched ViT tick
    image_cache_key: Optional[str] = None
    submit_t: float = 0.0  # perf_counter at submit (latency accounting)
    ttft: Optional[float] = None  # first-token latency (s)
    token_times: List[float] = field(default_factory=list)  # observation time per token
    logprobs: bool = False  # OpenAI logprobs: the chosen token's log-prob a token
    top_logprobs: int = 0  # 0..LOGPROBS_K alternatives a token
    lp_list: List[float] = field(default_factory=list)  # aligned with generated
    top_list: List[list] = field(default_factory=list)  # [(token id, log-prob), ...] a token, LOGPROBS_K of them
    streaming: bool = False  # an SSE client is attached: rolls shrink to streaming_roll
    lookup_base: List[int] = field(default_factory=list)  # the true prompt ids, for prompt-lookup drafts

    @property
    def samples(self) -> bool:
        return self.generation is not None and self.generation.do_sample


def _pow2_at_least(n: int, start: int = 1) -> int:
    w = start
    while w < n:
        w *= 2
    return w


class PagedBatchEngine:
    """Continuous batching over a shared page pool."""

    # ViT dispatch tile buckets (the JAX engine's ladder; padding waste <= 1/3)
    _TILE_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)

    def __init__(
        self,
        cfg: OmChatConfig,
        params: dict,
        *,
        max_slots: int = 4,
        num_pages: int = 256,
        page_size: int = 128,
        attn_impl: Optional[str] = None,
        prompt_bucket: int = 128,
        rng_seed: int = 0,
        max_len: int = 8192,
        decode_roll: int = 1,
        prefill_chunk: int = 1024,
        prefill_batch_tokens: int = 8192,
        image_cache_size: int = 8,
        device=None,
        mesh=None,
        prefix_cache: bool = False,
        cache_dtype: Optional[torch.dtype] = None,
        decode_kernel: str = "auto",
        streaming_roll: Optional[int] = None,
        speculative: bool = False,
        draft_len: int = 4,
        draft_ngram: int = 2,
        draft_fn=None,
        pipeline_rolls: bool = False,
        prefill_priority: bool = False,
        decode_graphs: bool = True,
        moe_impl: str = "dense",
    ):
        """``max_len`` caps one request's prompt + generation (it sets the
        page-table width); ``decode_roll`` decode steps run per dispatch, with
        one host readback per roll; prompts longer than ``prefill_chunk``
        advance one chunk per tick, decode rolls in between;
        ``prefill_batch_tokens`` caps B x width of a batched prefill's scratch
        cache.  ``cache_dtype``: the pool's storage dtype, default the
        weights'; ``torch.float8_e4m3fn`` halves a page's bytes.
        ``decode_kernel``: "auto" decodes with K12, "manual" with K13 (the
        same function; the plain route ignores it, as the JAX engine does off
        the TPU).  ``decode_graphs``: a CUDA engine on the kernels replays a
        CUDA graph for each roll and verify (False: each eagerly).
        ``params`` already live on ``device`` (default CUDA; raises without
        it).

        As in the JAX engine: ``prefix_cache`` publishes prompt pages under
        their digests and lets a later request with the same prefix skip them;
        ``streaming_roll`` is the roll while any decoding request streams;
        ``speculative`` verifies ``draft_len`` drafted tokens a slot in one
        dispatch (prompt lookup of ``draft_ngram``-grams, or
        ``draft_fn(context) -> ids``); ``pipeline_rolls`` dispatches the next
        roll from the device's tokens before reading the last one back;
        ``prefill_priority`` holds the roll while an admitted slot is
        mid-prefill.  ``mesh``: tensor-parallel serving over this rank's
        shard (see the module docstring)."""
        if page_size not in PAGE_SIZES and torch.device(device or "cuda").type == "cuda":
            raise ValueError(f"PagedBatchEngine: page_size {page_size} has no CUDA kernel; the paged attention kernels "
                             f"take page sizes {PAGE_SIZES}")
        dtype = params["language_model"]["embed_tokens"].dtype
        check_serving_mesh(cfg, mesh, what="PagedBatchEngine")
        self.mesh = mesh
        if moe_impl not in MOE_IMPLS:
            raise ValueError(f"unknown moe_impl {moe_impl!r} (one of {MOE_IMPLS})")
        if decode_kernel not in DECODE_KERNELS:
            raise ValueError(f"unknown decode_kernel {decode_kernel!r} (auto or manual)")
        if attn_impl not in (None, PLAIN):
            raise ValueError(f"unknown attn_impl {attn_impl!r} (None or 'plain')")
        if prompt_bucket % page_size or prefill_chunk % page_size:
            raise ValueError("prompt buckets and prefill chunks must align to pages")
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.page_size = page_size
        self.max_slots = max_slots
        self.max_len = max_len
        self.attn_impl = attn_impl
        self.decode_kernel = decode_kernel
        self.prefill_chunk = prefill_chunk
        self.prefill_batch_tokens = prefill_batch_tokens
        self._prompt_bucket = prompt_bucket
        self._chunk_bucket = math.lcm(prompt_bucket, page_size)
        self.decode_roll = max(1, int(decode_roll))
        self.streaming_roll = max(1, int(streaming_roll)) if streaming_roll else None
        self.speculative = bool(speculative)
        self.draft_len = max(1, int(draft_len))
        self.draft_ngram = max(1, int(draft_ngram))
        self.draft_fn = draft_fn
        self.pipeline_rolls = bool(pipeline_rolls)
        self.prefill_priority = bool(prefill_priority)
        self._inflight: Optional[dict] = None  # a dispatched roll not yet read back (pipeline_rolls)
        # the positions a dispatch may write past a request's budget: the
        # longest roll or verify chunk, twice that when a successor roll may
        # be dispatched before the host sees the request finish
        self._max_roll = max(self.decode_roll, self.streaming_roll or 1,
                             self.draft_len + 1 if self.speculative else 1) * (2 if self.pipeline_rolls else 1)
        # contiguous prefills and the ViT go through the single-request engine,
        # whose scratch cache keeps the weights' dtype (K15 rounds on commit)
        self._prefiller = OmChatEngine(
            cfg, params, attn_impl=attn_impl, prompt_bucket=prompt_bucket,
            image_cache_size=image_cache_size, device=self.device, mesh=mesh,
        )
        shape = local_kv_shape(cfg.text, mesh, num_pages + 1, page_size, pool=True)
        self.k_pool = torch.zeros(shape, dtype=cache_dtype or dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=cache_dtype or dtype, device=self.device)
        self.allocator = PageAllocator(num_pages)
        self._parking = num_pages
        self.prefix_cache: Optional[PrefixPageCache] = PrefixPageCache() if prefix_cache else None
        # pages one request may map: the table width, widened by the roll
        # headroom so the rolls do not shrink the prompt+generation cap
        self.max_pages = -(-(max_len + self._max_roll - 1) // page_size)
        self._ids = itertools.count()
        self.queue: List[_PagedRequest] = []
        self.slots: List[Optional[_PagedRequest]] = [None] * max_slots
        self.requests: Dict[int, _PagedRequest] = {}
        self._ttfts: "deque[float]" = deque(maxlen=1024)
        self._gaps: "deque[float]" = deque(maxlen=8192)
        self._tokens = np.zeros(max_slots, np.int32)
        self._lengths = np.zeros(max_slots, np.int32)
        self._tables = np.full((max_slots, self.max_pages), self._parking, np.int32)
        self.rng_seed = rng_seed
        self._generator = torch.Generator(device=self.device).manual_seed(rng_seed)
        # a roll's inputs, one row a slot: token, length, active, the pick's
        # parameters, then the page table; a verify's: its draft_len + 1
        # tokens, length, active, then the page table
        cuda = self.device.type == "cuda"
        self._roll_host = torch.zeros((max_slots, _ROLL_COLS + self.max_pages), dtype=torch.int32, pin_memory=cuda)
        self._roll_dev = self._roll_host.to(self.device) if cuda else self._roll_host
        self._roll_staged: Optional[torch.cuda.Event] = None  # the last copy out of _roll_host
        t_chunk = self.draft_len + 1
        self._verify_host = torch.zeros((max_slots, t_chunk + 2 + self.max_pages), dtype=torch.int32, pin_memory=cuda)
        self._verify_dev = self._verify_host.to(self.device) if cuda else self._verify_host
        self.decode_graphs = decode_graphs
        self.moe_impl = moe_impl
        if cfg.text.is_moe and moe_impl == "gmm" and self.graphed():
            raise ValueError("PagedBatchEngine: moe_impl='gmm' sizes its expert groups on the host, which a CUDA graph "
                             "cannot capture; pass decode_graphs=False with it")
        # (table width, pick mode, roll) -> the roll's GraphedStep, or its body run eagerly
        self._rolls: dict = {}
        self._verifies: dict = {}  # table width -> the verify's GraphedStep, or its body
        # host copies of the rolls' outputs, two a shape used in turn: a roll's
        # outputs are copied out right after it, and at most two rolls (one in
        # flight, its successor) are unread at once
        self._host_outs: dict = {}
        self._graph_pool = torch.cuda.graph_pool_handle() if self.graphed() else None
        self.rolls_graphed = self.rolls_eager = 0
        self.verifies_graphed = self.verifies_eager = 0
        # speculative accounting: verify dispatches and the tokens they gave;
        # an EMA of the accepted drafts a slot gates the verify (it replaces a
        # whole roll, so it pays only while drafts accept), starting
        # optimistic and probing again every 32nd draft-bearing tick
        self.spec_dispatches = self.spec_tokens = 0
        self._spec_ema = float(self.draft_len)
        self._spec_probe = 0

    # -- client API ---------------------------------------------------------

    @replicated
    def submit(
        self,
        input_ids: Sequence[int],
        images: Optional[np.ndarray] = None,
        max_new_tokens: int = 256,
        eos_token_id: int = 151645,
        generation=None,
        image_cache_key: Optional[str] = None,
        logprobs: bool = False,
        top_logprobs: int = 0,
        streaming: bool = False,
    ) -> int:
        """Queue one request (ids with ``-200`` sentinels, its tiles
        [N, 3, H, W] in sentinel order); returns its id.  ``logprobs`` /
        ``top_logprobs`` (at most ``LOGPROBS_K``): each generated token's
        log-prob and the top alternatives, read with
        :meth:`request_logprobs`.  ``streaming``: a client reads the tokens
        as they come, so rolls shrink to ``streaming_roll`` while it decodes.
        Raises before any work when no allocation could ever hold it."""
        if generation is not None and (generation.presence_penalty or generation.frequency_penalty):
            raise NotImplementedError("PagedBatchEngine: presence / frequency penalties wait for a later slice")
        req = _PagedRequest(next(self._ids), list(input_ids), None, max_new_tokens, eos_token_id, generation)
        req.logprobs = bool(logprobs) or top_logprobs > 0
        req.top_logprobs = max(0, min(int(top_logprobs), LOGPROBS_K))
        req.streaming = bool(streaming)
        if self.speculative:
            req.lookup_base = [t for t in req.input_ids if t >= 0]
        req.submit_t = time.perf_counter()
        req.plan = self._prefiller.plan([req.input_ids])
        # _max_roll - 1 extra positions absorb a dispatch's writes past a finished budget
        need = self._n_pages_for(int(req.plan.lengths[0]) + max_new_tokens + self._max_roll - 1)
        if need > min(self.max_pages, self.allocator.num_pages):
            raise ValueError(
                f"request needs {need} pages (> cap {self.max_pages} / pool {self.allocator.num_pages}); "
                "raise max_len/num_pages or shorten the request"
            )
        req.n_pages_needed = need
        if images is not None and image_cache_key is None and isinstance(images, np.ndarray):
            # one identity for the feature LRU and the prefix pages' digests
            image_cache_key = pixel_digest(images)
        if self.prefix_cache is not None:
            plan = req.plan
            is_image = np.asarray(plan.is_image[0])
            req.page_hashes = page_hashes(
                np.asarray(plan.token_ids[0]), int(plan.lengths[0]), self.page_size,
                int(np.argmax(is_image)) if is_image.any() else None,
                image_key=image_cache_key if images is not None else None, is_image=is_image,
                image_index=np.asarray(plan.image_index[0]))
        if images is not None:
            # feature LRU: repeated images skip the ViT; misses defer to the
            # batched encode of the next tick
            cache = self._prefiller.image_cache
            feats = cache.peek(image_cache_key) if cache is not None else None
            if feats is not None:
                cache.get(image_cache_key)  # hit accounting
                req.image_features = feats
            else:
                req.pending_pixels = images
                req.image_cache_key = image_cache_key
        self.queue.append(req)
        self.requests[req.request_id] = req
        return req.request_id

    def finished(self, request_id: int) -> bool:
        return self.requests[request_id].done

    def result(self, request_id: int) -> List[int]:
        return list(self.requests[request_id].generated)

    def snapshot(self, request_id: int):
        """Progress view: (tokens generated so far, finished)."""
        req = self.requests[request_id]
        return list(req.generated), req.done

    @replicated
    def pop_result(self, request_id: int):
        req = self.requests.pop(request_id)
        return list(req.generated), req.prompt_len

    def request_logprobs(self, request_id: int):
        """(chosen-token log-probs, top alternatives), both aligned with the
        generated tokens; read before :meth:`pop_result`.  Top entries are
        ``[(token id, log-prob), ...]`` cut to the request's
        ``top_logprobs`` (None when it asked for none); (None, None) when
        the request asked for no log-probs."""
        req = self.requests[request_id]
        if not req.logprobs:
            return None, None
        tops = [t[: req.top_logprobs] for t in req.top_list] if req.top_logprobs else None
        return list(req.lp_list), tops

    @replicated
    def cancel(self, request_id: int) -> None:
        """Request early termination.  Only a flag is set here; the scheduler
        releases the slot and pages at the start of its next tick."""
        self.requests[request_id].cancelled = True

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots) or self._inflight is not None

    def stats(self) -> dict:
        """Scheduler gauges: slots, queue, pages, the speculative counts, the
        prefix and image caches, latency."""
        out = {
            "slots_busy": sum(r is not None for r in self.slots),
            "slots_total": self.max_slots,
            "queue_depth": len(self.queue),
            "pages_free": self.allocator.available,
            "pages_total": self.allocator.num_pages,
        }
        if self.speculative:
            out["spec_dispatches"] = self.spec_dispatches
            out["spec_tokens"] = self.spec_tokens
        if self.prefix_cache is not None:
            out.update({f"prefix_cache_{k}": v for k, v in self.prefix_cache.stats().items()})
        if self._prefiller.image_cache is not None:
            out.update({f"image_cache_{k}": v for k, v in self._prefiller.image_cache.stats().items()})
        out.update({k: round(v, 4) for k, v in self.latency_stats().items() if k != "requests_measured"})
        return out

    @replicated
    def reset_latency_stats(self) -> None:
        """Clear the rolling windows and the roll and verify counts (after a
        warm-up)."""
        self._ttfts.clear()
        self._gaps.clear()
        self.rolls_graphed = self.rolls_eager = 0
        self.verifies_graphed = self.verifies_eager = 0

    def latency_stats(self) -> dict:
        """TTFT p50/p99/max and inter-token p50/p99, seconds, over rolling
        windows, and the rolls and verifies replayed from a CUDA graph
        (``rolls_graphed``, ``verifies_graphed``) and issued eagerly
        (``rolls_eager``, ``verifies_eager``).  Inter-token gaps are
        observation gaps at roll granularity: a roll delivers its tokens
        together."""
        ttfts = list(self._ttfts)
        gaps = list(self._gaps)
        out: dict = {"requests_measured": len(ttfts), "rolls_graphed": self.rolls_graphed,
                     "rolls_eager": self.rolls_eager, "verifies_graphed": self.verifies_graphed,
                     "verifies_eager": self.verifies_eager}
        if ttfts:
            out["ttft_p50_s"] = float(np.percentile(ttfts, 50))
            out["ttft_p99_s"] = float(np.percentile(ttfts, 99))
            out["ttft_max_s"] = float(max(ttfts))
        if gaps:
            out["intertoken_p50_s"] = float(np.percentile(gaps, 50))
            out["intertoken_p99_s"] = float(np.percentile(gaps, 99))
        return out

    @replicated
    def run_to_completion(self, max_ticks: int = 100000) -> int:
        ticks = 0
        while self.has_work() and ticks < max_ticks:
            self.step()
            ticks += 1
        return ticks

    # -- scheduler ----------------------------------------------------------

    def _n_pages_for(self, total_tokens: int) -> int:
        return -(-total_tokens // self.page_size)

    def _table_width(self, max_need: int, cap: int) -> int:
        """The table width a dispatch reaching ``max_need`` rows slices: a
        power of two >= 4 pages, at most ``cap``."""
        return min(_pow2_at_least(self._n_pages_for(max_need), 4), cap)

    def _alloc(self, n: int) -> List[int]:
        """Allocate, reclaiming refcount-0 prefix-cache pages under pressure."""
        short = n - self.allocator.available
        if short > 0 and self.prefix_cache is not None:
            self.allocator.release(self.prefix_cache.evict(short))
        return self.allocator.alloc(n)

    def _tile_bucket(self, n: int) -> int:
        for b in self._TILE_BUCKETS:
            if n <= b:
                return b
        return -(-n // 8) * 8

    def _encode_pending(self):
        """Batch every waiting ViT encode into one padded dispatch: the tile
        stacks concatenate into [bucket, 3, H, W] (zero padding tiles, their
        features dropped), the result splits back per request, and each
        distinct image lands in the feature LRU."""
        pend = [r for r in itertools.chain(self.queue, (s for s in self.slots if s is not None))
                if r.pending_pixels is not None]
        if not pend:
            return
        cache = self._prefiller.image_cache
        entries = []  # (key, tiles, [reqs]): one encode per distinct image
        by_key: dict = {}
        for r in pend:
            key = r.image_cache_key
            if key is not None and key in by_key:
                by_key[key][2].append(r)  # the same image twice in one tick
                r.pending_pixels = None
                continue
            if cache is not None and key is not None:
                feats = cache.get(key)  # filled since submit (an earlier tick)
                if feats is not None:
                    r.image_features = feats
                    r.pending_pixels = None
                    continue
            e = (key, np.asarray(r.pending_pixels), [r])
            entries.append(e)
            if key is not None:
                by_key[key] = e
            r.pending_pixels = None
        if not entries:
            return
        counts = [int(e[1].shape[0]) for e in entries]
        total = sum(counts)
        bucket = self._tile_bucket(total)
        cat = np.concatenate([e[1] for e in entries], axis=0)
        if bucket > total:
            cat = np.concatenate([cat, np.zeros((bucket - total, *cat.shape[1:]), cat.dtype)], axis=0)
        feats = self._prefiller.encode_tiles(cat)  # [bucket, L, D]
        off = 0
        for (key, _, reqs), n in zip(entries, counts):
            f = feats[off: off + n].reshape(n * feats.shape[1], -1)
            off += n
            if cache is not None:
                cache.put(key, f)
            reqs[0].image_features = f
            for r in reqs[1:]:  # duplicates register as cache hits
                r.image_features = cache.get(key) if cache is not None and key is not None else f

    def _sweep_cancelled(self):
        for req in list(self.slots):
            if req is not None and req.cancelled and not req.done:
                self._release(req)
        if any(r.cancelled for r in self.queue):
            for req in self.queue:
                if req.cancelled:
                    req.done = True
            self.queue = [r for r in self.queue if not r.cancelled]

    def _admit(self):
        for i in range(self.max_slots):
            if self.slots[i] is not None or not self.queue:
                continue
            req = self.queue[0]
            hit: List[int] = []
            if self.prefix_cache is not None and req.page_hashes:
                # at least one prompt row is left to prefill: its logits pick the first token
                usable = (int(req.plan.lengths[0]) - 1) // self.page_size
                hit = self.prefix_cache.lookup(req.page_hashes[:usable])
            evictable = self.prefix_cache.evictable if self.prefix_cache is not None else 0
            if req.n_pages_needed - len(hit) > self.allocator.available + evictable:
                for p in hit:  # head-of-line waits for pages that decode progress frees
                    self.prefix_cache.unref(p)
                break
            self.queue.pop(0)
            req.cache_refs = hit
            req.chunk_pos = len(hit) * self.page_size
            req.pages = self._alloc(req.n_pages_needed - len(hit))
            req.slot = i
            self.slots[i] = req
            self._tables[i, :] = self._parking
            self._tables[i, : len(hit)] = hit
            self._tables[i, len(hit): len(hit) + len(req.pages)] = req.pages

    def _release(self, req: _PagedRequest):
        if self.prefix_cache is not None:
            for p in req.cache_refs:
                self.prefix_cache.unref(p)
            req.cache_refs = []
        self.allocator.release(req.pages)
        req.pages = []
        # park the slot's table so later decode writes never touch a freed page
        self._tables[req.slot, :] = self._parking
        self._lengths[req.slot] = 0
        self.slots[req.slot] = None
        req.slot = None
        req.done = True
        req.image_features = None

    def _prefill_tick(self, req: _PagedRequest):
        """Advance one request's prefill by at most one dispatch: a prompt of
        at most ``prefill_chunk`` rows runs the contiguous prefill + page
        commit; a longer one advances one fixed-width paged chunk.  Returns
        the final-position logits [1, V] once the prompt is in, else None."""
        plan = req.plan
        total = int(plan.lengths[0])
        req.prompt_len = total
        if total <= self.prefill_chunk and req.chunk_pos == 0:
            logits, cache = self._prefiller.prefill(plan, req.image_features, 0)
            # the scratch cache is a prompt-bucket multiple long (page-aligned)
            _commit_pages(cache.k, cache.v, self.k_pool, self.v_pool, self._tables[req.slot][None],
                          np.asarray([self._n_pages_for(total)], np.int32), self.page_size, self.attn_impl)
            return logits
        chunk = self._chunk_width(req)
        finished = self._run_chunk([req], chunk)
        return finished[0][1] if finished else None

    def _chunk_width(self, req) -> int:
        """The next paged-prefill chunk width: the remaining prompt rounded up
        to a multiple of the chunk bucket, at most ``prefill_chunk``."""
        remaining = max(1, int(req.plan.lengths[0]) - req.chunk_pos)
        return min(self.prefill_chunk, -(-remaining // self._chunk_bucket) * self._chunk_bucket)

    def _prefill_chunk_group(self, reqs):
        """Advance B chunked prefills of equal next-chunk width one chunk each
        in one batched dispatch (text and image rows mix).  The batch pads to a
        power of two with replica rows whose writes land on the parking page.
        Returns [(req, logits_row)] for rows whose prompt completed."""
        width = self._chunk_width(reqs[0])
        return self._run_chunk(reqs, width, pad_pow2=True)

    def _run_chunk(self, reqs, width: int, pad_pow2: bool = False):
        """One :func:`_paged_prefill_chunk` dispatch of ``width`` rows for
        ``reqs``.  Each request's features concatenate into one [R, D] matrix
        and its plan's image_index shifts by the rows before it."""
        bb = _pow2_at_least(len(reqs)) if pad_pow2 else len(reqs)
        rows = list(reqs) + [reqs[0]] * (bb - len(reqs))

        def cut(a, c0):
            part = a[:, c0: c0 + width]
            if part.shape[1] < width:
                part = np.pad(part, ((0, 0), (0, width - part.shape[1])))
            return part

        offsets, parts, off = {}, [], 0
        for r in reqs:
            if r.image_features is not None:
                offsets[r.request_id] = off
                parts.append(r.image_features)
                off += int(r.image_features.shape[0])
        tok, isi, idx, pos, starts, lens, tables = [], [], [], [], [], [], []
        for i, r in enumerate(rows):
            plan, c0 = r.plan, r.chunk_pos
            tok.append(cut(plan.token_ids, c0))
            isi.append(cut(plan.is_image, c0))
            idx.append(cut(plan.image_index, c0) + offsets.get(r.request_id, 0))
            pos.append(cut(plan.positions, c0))
            starts.append(c0)
            lens.append(min(int(plan.lengths[0]) - c0, width))
            # a replica pad row's table is parked: all its writes hit the parking page
            tables.append(self._tables[r.slot] if i < len(reqs) else np.full(self.max_pages, self._parking, np.int32))
        feats = torch.cat(parts, dim=0) if parts else None
        t = lambda a: torch.as_tensor(np.concatenate(a), device=self.device)  # noqa: E731
        logits = _paged_prefill_chunk(
            self.params, self.cfg, t(tok), t(isi), t(idx), feats, t(pos),
            np.asarray(starts, np.int32), np.asarray(lens, np.int32), np.stack(tables),
            self.k_pool, self.v_pool, self.page_size, self.attn_impl, self.moe_impl, self.mesh,
        )
        finished = []
        for i, r in enumerate(reqs):
            total = int(r.plan.lengths[0])
            r.prompt_len = total
            r.chunk_pos += width
            if r.chunk_pos >= total:
                finished.append((r, logits[i: i + 1]))
        return finished

    def _bucket_shorts(self, reqs):
        """Group pending short prompts by power-of-two length bucket
        (prompt bucket x 2^k, at most prefill_chunk), each group split so that
        B x width stays under ``prefill_batch_tokens``."""
        groups: dict = {}
        for r in reqs:
            width = _pow2_at_least(int(r.plan.lengths[0]), self._prompt_bucket)
            groups.setdefault(min(width, self.prefill_chunk), []).append(r)
        out = []
        for width in sorted(groups):
            g = groups[width]
            cap = max(1, self.prefill_batch_tokens // width)
            out.extend(g[i: i + cap] for i in range(0, len(g), cap))
        return out

    def _prefill_shorts(self, reqs):
        """One batched contiguous prefill + page commit for several short
        text-only prompts.  B pads to a power of two with replica rows
        committed to the parking page; the width is the group's power-of-two
        bucket.  Returns logits [B, V] (on the device)."""
        bb = _pow2_at_least(len(reqs))
        n_pad = bb - len(reqs)
        batch_ids = [r.input_ids for r in reqs] + [reqs[0].input_ids] * n_pad
        width = _pow2_at_least(max(int(r.plan.lengths[0]) for r in reqs), self._prompt_bucket)
        plan = self._prefiller.plan(batch_ids, pad_to=min(width, self.prefill_chunk))
        logits, cache = self._prefiller.prefill(plan, None, 0)
        tables = np.full((bb, self.max_pages), self._parking, np.int32)
        n_pages = np.zeros((bb,), np.int32)
        for i, r in enumerate(reqs):
            tables[i] = self._tables[r.slot]
            r.prompt_len = int(plan.lengths[i])
            n_pages[i] = self._n_pages_for(r.prompt_len)
        _commit_pages(cache.k, cache.v, self.k_pool, self.v_pool, tables, n_pages, self.page_size, self.attn_impl)
        return logits

    def _first_token(self, req: _PagedRequest, logits) -> int:
        if req.samples:
            return int(sample(logits, self._generator, req.generation)[0])
        return int(greedy(logits)[0])

    def _finish_prefill(self, req: _PagedRequest, logits):
        self._finish_with_token(req, self._first_token(req, logits), logits)

    def _publish_prefix_pages(self, req: _PagedRequest):
        """After a prefill, publish the prompt pages it wrote (those
        ``page_hashes`` addresses past the admission hit): a published page
        belongs to the cache, and the request holds a reference instead."""
        n_hit = len(req.cache_refs)
        moved = set()
        for j in range(n_hit, len(req.page_hashes)):
            p = req.pages[j - n_hit]
            if self.prefix_cache.publish(req.page_hashes[j], p):
                req.cache_refs.append(p)
                moved.add(j - n_hit)
        if moved:
            req.pages = [p for k, p in enumerate(req.pages) if k not in moved]

    def _finish_with_token(self, req: _PagedRequest, first: int, logits_row=None):
        """Record the first token (``logits_row``: the [1, V] logits it came
        from) and start decoding, or release at EOS / a one-token budget."""
        req.prefilled = True
        req.last_token = first
        now = time.perf_counter()
        req.ttft = now - req.submit_t
        self._ttfts.append(req.ttft)
        if self.prefix_cache is not None and req.page_hashes:
            self._publish_prefix_pages(req)
        self._lengths[req.slot] = req.prompt_len
        if first == req.eos_token_id:
            self._release(req)
            return
        req.generated.append(first)
        if req.logprobs and logits_row is not None:
            lp = torch.log_softmax(logits_row.float(), dim=-1)[0]
            top = torch.topk(lp, LOGPROBS_K)
            req.lp_list.append(float(lp[first]))
            req.top_list.append(list(zip(top.indices.tolist(), top.values.tolist())))
        req.token_times.append(now)
        if len(req.generated) >= req.max_new_tokens:
            self._release(req)

    @replicated
    @torch.no_grad()
    def step(self):
        """One scheduler tick: encode, admit, every pending prefill, one roll."""
        self._sweep_cancelled()
        self._encode_pending()
        self._admit()
        pending = [r for r in self.slots if r is not None and not r.prefilled]
        shorts = [r for r in pending
                  if r.image_features is None and r.chunk_pos == 0 and int(r.plan.lengths[0]) <= self.prefill_chunk]
        batches = []
        if len(shorts) >= 2:
            for group in self._bucket_shorts(shorts):
                batches.append((group, self._prefill_shorts(group)))
            pending = [r for r in pending if r not in shorts]
        finished_prefills = []
        # chunked prefills with the same next-chunk width advance together
        if len(pending) >= 2:
            groups: dict = {}
            for r in pending:
                groups.setdefault(self._chunk_width(r), []).append(r)
            taken = []
            for w in sorted(groups):
                g = groups[w]
                if len(g) < 2:
                    continue
                budget = self.prefill_batch_tokens
                if any(r.image_features is not None for r in g):
                    # image rows add the concatenated features and fatter
                    # fusion temporaries: cap them at one chunk's footprint
                    budget = min(budget, self.prefill_chunk)
                cap = max(1, budget // w)
                if cap < 2:
                    continue
                for i in range(0, len(g), cap):
                    sub = g[i: i + cap]
                    if len(sub) < 2:
                        continue  # a remainder row rides the per-request path
                    finished_prefills.extend(self._prefill_chunk_group(sub))
                    taken.extend(sub)
            pending = [r for r in pending if r not in taken]
        for req in pending:
            logits = self._prefill_tick(req)
            if logits is not None:
                finished_prefills.append((req, logits))
        # first-token readbacks after every prefill dispatch is queued
        for breqs, blogits in batches:
            greedy_toks = None
            for i, r in enumerate(breqs):
                if r.samples:
                    first = self._first_token(r, blogits[i: i + 1])
                else:
                    if greedy_toks is None:  # one readback for the whole batch
                        greedy_toks = greedy(blogits).cpu().numpy()
                    first = int(greedy_toks[i])
                self._finish_with_token(r, first, blogits[i: i + 1])
        for req, logits in finished_prefills:
            self._finish_prefill(req, logits)

        if self._inflight is not None:
            # pipelined rolls: dispatch the successor from the in-flight roll's
            # tokens on the device BEFORE reading that roll back, unless a
            # request is queued, mid-prefill or cancelled (``_can_extend``) or
            # every member will be at its budget after it; then just drain.
            # As in the JAX engine, a request whose prefill finished this tick
            # joins the rolls only when the chain ends.
            h, self._inflight = self._inflight, None
            nxt = None
            if (self._can_extend(h["decoding"]) and all(not r.done for r in h["decoding"])
                    and any(len(r.generated) + h["roll"] < r.max_new_tokens for r in h["decoding"])):
                nxt = self._extend_roll(h)
            self._process_roll(h)
            self._inflight = nxt
            return
        decoding = [r for r in self.slots if r is not None and r.prefilled and r.last_token is not None]
        if not decoding:
            return
        # throughput mode: roll only once every admitted request is in the
        # batch (queued ones wait on slots and pages that decoding frees)
        if self.prefill_priority and any(r is not None and not r.prefilled for r in self.slots):
            return
        # speculative verify, greedy slots only; a tick without a draft rolls
        if self.speculative and not any(r.samples or r.logprobs for r in decoding):
            if self._speculative_tick(decoding):
                return
        active = np.zeros(self.max_slots, bool)
        for r in decoding:
            self._tokens[r.slot] = r.last_token
            active[r.slot] = True
        # a slot mid-chunked-prefill has real pages in its table row: pass it
        # parked, or the roll would write over its committed chunks
        tables_dec = np.where(active[:, None], self._tables, self._parking)
        roll = self.streaming_roll if self.streaming_roll and any(r.streaming for r in decoding) else self.decode_roll
        # slice the table to the pages reachable in this dispatch (+ roll
        # covers the rows written during it)
        width = self._table_width(int(max(self._lengths[r.slot] for r in decoding)) + roll, tables_dec.shape[1])
        h = self._dispatch_roll(decoding, roll, active, tables_dec[:, :width])
        if self.pipeline_rolls and self._can_extend(decoding):
            self._inflight = h  # the next tick dispatches its successor before reading it
            return
        self._process_roll(h)

    # -- decode rolls ---------------------------------------------------------

    def graphed(self) -> bool:
        """Whether rolls and verifies replay CUDA graphs (a CUDA engine on
        the kernels with ``decode_graphs``, on one rank: under a mesh of tp
        > 1 they run eagerly)."""
        return (self.decode_graphs and self.device.type == "cuda" and self.attn_impl != PLAIN
                and (self.mesh is None or self.mesh.axis_size("model") == 1))

    @replicated
    def precompile(self, roll_widths: Sequence[int] = ROLL_WIDTHS,
                   variants: Sequence[tuple] = PICK_MODES) -> List[int]:
        """Capture the roll of every table width in ``roll_widths`` (capped
        at the table's width), every pick mode in ``variants`` ((any
        sampled, log-probs) pairs) and both roll lengths (``decode_roll``,
        ``streaming_roll``), and with ``speculative`` the verify of every
        width, ahead of traffic, as the JAX engine's ``precompile`` compiles
        its programs; returns the widths.  Each capture follows one dispatch
        over parked slots (nothing active, every table on the parking page),
        so it writes nothing but the parking page; the generator is seeded
        again afterwards, so that precompiling leaves the draws of the
        traffic after it unchanged.  Prefill runs eagerly and has nothing to
        capture.  On a CPU engine, or without graphs, each parked dispatch
        runs eagerly once."""
        widths = sorted({min(int(w), self.max_pages) for w in roll_widths})
        parked = np.full((self.max_slots, self.max_pages), self._parking, np.int32)
        zeros = np.zeros(self.max_slots, np.int32)
        rolls = sorted({self.decode_roll, self.streaming_roll or self.decode_roll})
        for w in widths:
            for roll in rolls:
                for mode in variants:
                    step = self._roll_step(w, tuple(mode), roll)
                    if isinstance(step, GraphedStep) and step.graph is not None:
                        continue
                    self._stage_roll(zeros, zeros, zeros, parked[:, :w], self._sampling_rows([]))
                    step()
            if self.speculative:
                step = self._verify_step(w)
                if not (isinstance(step, GraphedStep) and step.graph is not None):
                    self._stage_verify(np.zeros((self.max_slots, self.draft_len + 1), np.int32), zeros, zeros,
                                       parked[:, :w])
                    step()
        self._generator.manual_seed(self.rng_seed)
        return widths

    def capture_ms(self) -> float:
        """The wall time the roll and verify graphs' captures took, in
        milliseconds."""
        steps = itertools.chain(self._rolls.values(), self._verifies.values())
        return 1e3 * sum(step.capture_s for step in steps if isinstance(step, GraphedStep))

    def _sampling_rows(self, decoding) -> np.ndarray:
        """[S, 4] fp32 host rows of the roll's per-slot pick parameters:
        do_sample, top_k, temperature, top_p (neutral for greedy slots)."""
        rows = np.zeros((self.max_slots, 4), np.float32)
        rows[:, 2:] = 1.0
        for r in decoding:
            if r.samples:
                g = r.generation
                rows[r.slot] = (1.0, g.top_k, g.temperature, g.top_p)
        return rows

    def _stage_roll(self, tokens, lengths, active, tables, sampling: np.ndarray) -> None:
        """Copy a roll's host inputs ([S] tokens, lengths, active; [S, 4]
        sampling rows; [S, W] tables) into the static buffer the roll reads:
        one asynchronous copy from pinned memory on CUDA.  Under pipelined
        rolls the host stages a roll while the last one's copy may still be
        queued, so it first waits for that copy."""
        if self._roll_staged is not None:
            self._roll_staged.synchronize()
        h = self._roll_host.numpy()
        h[:, 0], h[:, 1], h[:, 2] = tokens, lengths, active
        h[:, 3], h[:, 4] = sampling[:, 0], sampling[:, 1]
        h[:, 5:7] = np.ascontiguousarray(sampling[:, 2:]).view(np.int32)
        h[:, _ROLL_COLS: _ROLL_COLS + tables.shape[1]] = tables
        if self._roll_dev is not self._roll_host:
            self._roll_dev.copy_(self._roll_host, non_blocking=True)
            self._roll_staged = torch.cuda.Event()
            self._roll_staged.record()

    def _roll_inputs(self, width: int) -> tuple:
        """(tokens, lengths, active, tables) of the staged roll: views of the
        static buffer, tables the first ``width`` pages."""
        b = self._roll_dev
        return b[:, 0], b[:, 1], b[:, 2] != 0, b[:, _ROLL_COLS: _ROLL_COLS + width]

    def _roll_sampling(self) -> dict:
        """The staged per-slot pick parameters, as ``sample_batch`` takes them."""
        b = self._roll_dev
        return {"do_sample": b[:, 3] != 0, "top_k": b[:, 4], "temperature": b[:, 5].view(torch.float32),
                "top_p": b[:, 6].view(torch.float32)}

    def _graphed_or_body(self, body, sampled: bool = False):
        if self.graphed():
            return GraphedStep(body, self._graph_pool, self.device, generators=(self._generator,) if sampled else ())
        return body

    def _roll_step(self, width: int, mode: tuple = PICK_MODES[0], roll: Optional[int] = None):
        """The roll of ``roll`` steps (default ``decode_roll``) at table
        width ``width`` and pick ``mode``: a GraphedStep on a graphed engine
        (a sampled mode registers the engine's generator with its graph),
        else its body; it writes the [roll, S] tokens (and with log-probs the
        chosen [roll, S] and top [roll, S, K] values and ids) into static
        buffers and returns them."""
        roll = self.decode_roll if roll is None else roll
        step = self._rolls.get((width, mode, roll))
        if step is None:
            sampled, logprobs = mode
            kw = dict(dtype=torch.int32, device=self.device)
            shape = (roll, self.max_slots)
            out = [torch.zeros(shape, **kw)]
            if logprobs:
                out += [torch.zeros(shape, dtype=torch.float32, device=self.device),
                        torch.zeros((*shape, LOGPROBS_K), dtype=torch.float32, device=self.device),
                        torch.zeros((*shape, LOGPROBS_K), dtype=torch.int64, device=self.device)]
            engine = weakref.ref(self)  # weak: a deleted engine is freed at once, not by the collector

            def body():
                eng = engine()
                got = _paged_decode_roll(eng.params, eng.cfg, *eng._roll_inputs(width), eng.k_pool, eng.v_pool,
                                         eng.page_size, eng.attn_impl, roll,
                                         decode_kernel=eng.decode_kernel,
                                         sampling=eng._roll_sampling() if sampled else None,
                                         generator=eng._generator, logprobs=logprobs, moe_impl=eng.moe_impl,
                                         mesh=eng.mesh)
                for o, g in zip(out, got if logprobs else (got,)):
                    o.copy_(g)
                return tuple(out)

            step = self._rolls[(width, mode, roll)] = self._graphed_or_body(body, sampled)
        return step

    def _dispatch_roll(self, decoding, roll, active, tables_dec, lengths=None, tokens=None):
        """Issue one decode roll without reading its tokens back: a replay of
        the graph of its width, pick mode and length, or its body run eagerly
        where graphs are off; its outputs are then copied to host buffers
        (asynchronously on CUDA).  ``lengths`` (default the host's) and
        ``tokens`` (a device row that replaces the staged tokens, queued
        after the staging copy) start a pipelined successor.  Returns the
        in-flight handle :meth:`_process_roll` reads."""
        lengths = np.array(self._lengths if lengths is None else lengths)
        self._stage_roll(self._tokens, lengths, active, tables_dec, self._sampling_rows(decoding))
        if tokens is not None:
            self._roll_dev[:, 0].copy_(tokens)
        mode = (any(r.samples for r in decoding), any(r.logprobs for r in decoding))
        step = self._roll_step(tables_dec.shape[1], mode, roll)
        out = step()
        if isinstance(step, GraphedStep):
            self.rolls_graphed += 1
        else:
            self.rolls_eager += 1
        host, ready = self._to_host(out)
        return {"decoding": list(decoding), "slots": [r.slot for r in decoding], "roll": roll, "active": active,
                "out": out, "host": host, "ready": ready, "lengths_next": lengths + roll * active.astype(np.int32)}

    def _to_host(self, out) -> tuple:
        """Copy a dispatch's outputs into the next of the two host sets of
        their shapes (pinned, asynchronously, on CUDA); returns the set and
        the event that marks the copy done (None on the CPU)."""
        cuda = self.device.type == "cuda"
        key = tuple((tuple(o.shape), o.dtype) for o in out)
        sets = self._host_outs.setdefault(key, [None, None, 0])
        turn = sets[2]
        sets[2] = 1 - turn
        if sets[turn] is None:
            sets[turn] = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=cuda) for o in out)
        for h, o in zip(sets[turn], out):
            h.copy_(o, non_blocking=cuda)
        ready = None
        if cuda:
            ready = torch.cuda.Event()
            ready.record()
        return sets[turn], ready

    def _can_extend(self, decoding) -> bool:
        """A roll may stay in flight (its successor dispatched from the
        device's tokens) only while nothing would change the decoding set: no
        queued admission, no slot mid-prefill, no cancel, no speculative
        drafts (which read the host's tokens)."""
        return (not self.queue and not any(r is not None and not r.prefilled for r in self.slots)
                and not any(r.cancelled for r in decoding) and not self.speculative)

    def _extend_roll(self, h) -> dict:
        """Dispatch the successor of the in-flight roll ``h`` from its last
        tokens on the device, at lengths advanced by the whole roll for every
        active slot (a request that finished inside ``h`` decodes on into its
        headroom; the host discards the surplus)."""
        lengths, active, roll = h["lengths_next"], h["active"], h["roll"]
        tables = np.where(active[:, None], self._tables, self._parking)
        width = self._table_width(int(max(lengths[s] for s in h["slots"])) + roll, tables.shape[1])
        return self._dispatch_roll(h["decoding"], roll, active, tables[:, :width], lengths=lengths,
                                   tokens=h["out"][0][-1])

    def _process_roll(self, h):
        """Read a roll's tokens (and log-probs) from its host copies and run
        the per-request bookkeeping: EOS / budget releases, the latency
        windows and the log-prob lists, kept aligned with the tokens.  Host
        lengths advance per consumed token; a request that finishes mid-roll
        is released, so its surplus positions stay in its freed headroom; a
        request released while the roll was in flight (a cancel) is skipped."""
        if h["ready"] is not None:
            h["ready"].synchronize()
        toks_np, *lp = (t.numpy() for t in h["host"])  # [roll, S], then [roll, S], [roll, S, K] x 2
        tick_now = time.perf_counter()  # tokens of a roll arrive together
        for r, slot in zip(h["decoding"], h["slots"]):
            if r.done:
                continue
            for i in range(toks_np.shape[0]):
                tok = int(toks_np[i, slot])
                self._lengths[slot] += 1
                r.last_token = tok
                if tok == r.eos_token_id:
                    self._release(r)
                    break
                r.generated.append(tok)
                if r.logprobs:
                    r.lp_list.append(float(lp[0][i, slot]))
                    r.top_list.append([(int(t), float(v)) for t, v in zip(lp[2][i, slot], lp[1][i, slot])])
                if r.token_times and tick_now > r.token_times[-1]:
                    self._gaps.append(tick_now - r.token_times[-1])
                r.token_times.append(tick_now)
                if len(r.generated) >= r.max_new_tokens:
                    self._release(r)
                    break

    # -- speculative verify ---------------------------------------------------

    def _stage_verify(self, tokens, lengths, active, tables) -> None:
        """Copy a verify's host inputs ([S, T] tokens; [S] lengths, active;
        [S, W] tables) into the static buffer the verify reads (its tokens
        come back before the host stages again)."""
        t = self.draft_len + 1
        h = self._verify_host.numpy()
        h[:, :t], h[:, t], h[:, t + 1] = tokens, lengths, active
        h[:, t + 2: t + 2 + tables.shape[1]] = tables
        if self._verify_dev is not self._verify_host:
            self._verify_dev.copy_(self._verify_host, non_blocking=True)

    def _verify_step(self, width: int):
        """The verify at table width ``width``: a GraphedStep on a graphed
        engine, else its body; it writes the greedy token after each of the
        [S, draft_len + 1] rows into a static [S, draft_len + 1] buffer and
        returns it."""
        step = self._verifies.get(width)
        if step is None:
            t = self.draft_len + 1
            out = torch.zeros((self.max_slots, t), dtype=torch.int32, device=self.device)
            engine = weakref.ref(self)

            def body():
                eng = engine()
                b = eng._verify_dev
                logits = _paged_verify(eng.params, eng.cfg, b[:, :t], b[:, t], b[:, t + 1] != 0,
                                       b[:, t + 2: t + 2 + width], eng.k_pool, eng.v_pool, eng.page_size,
                                       eng.attn_impl, eng.moe_impl, eng.mesh)
                out.copy_(torch.argmax(logits, dim=-1))
                return out

            step = self._verifies[width] = self._graphed_or_body(body)
        return step

    def _speculative_tick(self, decoding) -> bool:
        """One batched verify dispatch for the decoding slots; returns False
        (the caller rolls instead) when no slot proposes a draft, or while
        the acceptance EMA says drafts do not accept (but every 32nd
        draft-bearing tick, which probes again)."""
        t_chunk = self.draft_len + 1
        propose = self.draft_fn or (lambda ctx: propose_draft(ctx, ngram=self.draft_ngram, k=self.draft_len))
        drafts: Dict[int, List[int]] = {}
        for r in decoding:
            drafts[r.slot] = [int(x) for x in propose(r.lookup_base + r.generated)[: self.draft_len]]
        if not any(drafts.values()):
            return False
        self._spec_probe += 1
        if self._spec_ema < 0.5 and self._spec_probe % 32 != 0:
            return False
        toks = np.zeros((self.max_slots, t_chunk), np.int32)
        active = np.zeros(self.max_slots, bool)
        for r in decoding:
            d = drafts[r.slot]
            toks[r.slot, 0] = r.last_token
            toks[r.slot, 1: 1 + len(d)] = d
            active[r.slot] = True
        tables = np.where(active[:, None], self._tables, self._parking)
        width = self._table_width(int(max(self._lengths[r.slot] for r in decoding)) + t_chunk, tables.shape[1])
        self._stage_verify(toks, self._lengths, active, tables[:, :width])
        step = self._verify_step(width)
        out_np = step().cpu().numpy()  # [S, T]: the greedy token after each row
        if isinstance(step, GraphedStep):
            self.verifies_graphed += 1
        else:
            self.verifies_eager += 1
        tick_now = time.perf_counter()
        self.spec_dispatches += 1
        delivered_before = self.spec_tokens
        for r in decoding:
            g, d = out_np[r.slot], drafts[r.slot]
            n_acc = 0
            while n_acc < len(d) and d[n_acc] == int(g[n_acc]):
                n_acc += 1
            # the accepted draft, then the model's own token where it disagrees
            # (or after the whole draft)
            for tok in d[:n_acc] + [int(g[n_acc])]:
                self.spec_tokens += 1
                self._lengths[r.slot] += 1
                r.last_token = tok
                if tok == r.eos_token_id:
                    self._release(r)
                    break
                r.generated.append(tok)
                if r.token_times and tick_now > r.token_times[-1]:
                    self._gaps.append(tick_now - r.token_times[-1])
                r.token_times.append(tick_now)
                if len(r.generated) >= r.max_new_tokens:
                    self._release(r)
                    break
        a_mean = (self.spec_tokens - delivered_before) / max(len(decoding), 1) - 1.0
        self._spec_ema = 0.7 * self._spec_ema + 0.3 * a_mean
        return True
