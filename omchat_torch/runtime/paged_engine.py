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
4. runs one decode roll of ``decode_roll`` steps over every decoding slot
   (:func:`_paged_decode_roll`): each step runs every layer with the pool
   read-only (K12 with the in-flight token as a self column) and commits all
   layers' new rows once (K4); the tokens come back to the host once per roll.

Under w8a8 (``cfg.w8a8`` with int8 params) the short prefills and the
chunks run the glue layer of :func:`~omchat_torch.models.qwen2.decoder_layer`
(K7, K11) and the ViT its glue scan; decode rolls stay weight-only int8.

The pools are updated in place (the counterpart of the JAX package's buffer
donation).  ``attn_impl``: None runs the hand-written kernels on CUDA tensors
(their plain versions on CPU tensors); ``"plain"`` the plain reference
attention and plain commits everywhere.

Waiting for later slices, each raising ``NotImplementedError`` rather than
being ignored: the prefix cache, speculative verify, pipelined and streaming
rolls, logprobs, a pool dtype other than the weights' (fp8), the manual-copy
decode kernel (K13), a device mesh, the MoE trunk, and presence / frequency
penalties.  The JAX engine's ``precompile`` has no counterpart: PyTorch runs
eagerly, so there is no program menu to compile ahead of traffic.
"""

from __future__ import annotations

import itertools
import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from omchat_torch.config import OmChatConfig
from omchat_torch.models.omchat import fuse_embeddings
from omchat_torch.models.qwen2 import decoder_layer, embed_tokens, lm_head, quant_glue_ok
from omchat_torch.ops.attention import PLAIN
from omchat_torch.ops.norms import rms_norm
from omchat_torch.ops.paged_attention import (
    PageAllocator,
    commit_pages,
    commit_pages_plain,
    commit_rows,
    commit_rows_plain,
    paged_decode_attention,
    paged_prefill_attention,
)
from omchat_torch.ops.rope import rope_cos_sin
from omchat_torch.ops.sampling import greedy, sample, sample_batch
from omchat_torch.runtime.feature_cache import pixel_digest
from omchat_torch.runtime.generate import OmChatEngine
from omchat_torch.utils.device import resolve_device
from omchat_torch.utils.tree import layer_slice


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


def _decode_step_core(params, cfg: OmChatConfig, tokens, lengths, active, tables, k_pool, v_pool, page_size: int,
                      attn_impl: Optional[str] = None, *, sampling: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One decode step over every slot against the page pool; returns the
    next tokens [S] (int32) and commits the step's K/V rows in place.

    tokens, lengths (valid rows already in pages), active [S]; tables [S, W]
    (parked rows for inactive slots), all on the pools' device.  The layer
    body is the shared :func:`~omchat_torch.models.qwen2.decoder_layer`; only
    ``attend`` differs: K12 over the flat pool ``[L*(P+1), KVH, page, D]``
    (layer li's pages at ``li*(P+1) + page``), READ-ONLY through the layer
    loop, with the in-flight token as a self column.  Each layer hands back
    its new K/V rows, and one row commit (K4) writes all layers' rows after
    the loop.  ``sampling``: per-slot do_sample / temperature / top_k / top_p
    tensors, drawn with ``generator``; None decodes greedily."""
    tc = cfg.text
    lm = params["language_model"]
    n_layers, n_slots = k_pool.shape[0], k_pool.shape[1]  # P+1 incl. parking
    kflat = k_pool.view(n_layers * n_slots, *k_pool.shape[2:])
    vflat = v_pool.view(n_layers * n_slots, *v_pool.shape[2:])
    x = embed_tokens(lm, tokens[:, None])  # [S, 1, D]
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
    for li in range(n_layers):
        def attend(q, k, v, li=li):
            k_rows.append(k[:, 0])
            v_rows.append(v[:, 0])
            return paged_decode_attention(q, kflat, vflat, attn_lengths, tables, impl=attn_impl,
                                          k_new=k[:, 0], v_new=v[:, 0], page_offset=li * n_slots)

        x = decoder_layer(tc, x, layer_slice(lm["layers"], li), cos, sin, attend)
    flat_pages = (torch.arange(n_layers, dtype=torch.int32, device=tokens.device)[:, None] * n_slots
                  + page_idx[None, :]).reshape(-1)
    commit = commit_rows_plain if attn_impl == PLAIN else commit_rows
    s = tokens.shape[0]
    commit(kflat, vflat, flat_pages, offsets.repeat(n_layers),
           torch.stack(k_rows).reshape(n_layers * s, *k_rows[0].shape[1:]),
           torch.stack(v_rows).reshape(n_layers * s, *v_rows[0].shape[1:]))
    logits = lm_head(lm, tc, rms_norm(x, lm["norm"]["scale"], tc.rms_norm_eps))[:, 0]
    if sampling is None:
        return greedy(logits)
    return sample_batch(logits, generator, **sampling)


def _paged_decode_roll(params, cfg: OmChatConfig, tokens, lengths, active, tables, k_pool, v_pool, page_size: int,
                       attn_impl: Optional[str], steps: int, *, sampling: Optional[dict] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``steps`` decode iterations issued back to back on the device; returns
    the [steps, S] tokens without reading them back.  Requests that hit EOS
    or their budget mid-roll keep decoding into their own headroom pages (the
    engine allocates ``decode_roll - 1`` extra positions); the host discards
    the surplus tokens."""
    out = []
    for _ in range(steps):
        tokens = _decode_step_core(params, cfg, tokens, lengths, active, tables, k_pool, v_pool, page_size,
                                   attn_impl, sampling=sampling, generator=generator)
        out.append(tokens)
        lengths = torch.where(active, lengths + 1, lengths)
    return torch.stack(out)


def _paged_prefill_chunk(params, cfg: OmChatConfig, token_ids, is_image, image_index, image_features, positions,
                         chunk_start: np.ndarray, chunk_len: np.ndarray, tables: np.ndarray, k_pool, v_pool,
                         page_size: int, attn_impl: Optional[str] = None) -> torch.Tensor:
    """One chunk of a paged prefill for B requests at once: each row's K/V go
    into its own pages (a plain indexed write, in place) and the chunk attends
    to everything cached so far through the page tables; returns each row's
    last-valid-position logits [B, V].

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
    kvh, hd = tc.num_key_value_heads, tc.attn_head_dim
    parked = k_pool.shape[1] - 1

    x = fuse_embeddings(params, token_ids, is_image, image_index, image_features)  # [B, C, D]
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
    for li in range(k_pool.shape[0]):
        kp, vp = k_pool[li], v_pool[li]

        def attend(q, k, v, kp=kp, vp=vp):
            kp[pages] = k.reshape(b * n_chunk, page_size, kvh, hd).transpose(1, 2).to(kp.dtype)
            vp[pages] = v.reshape(b * n_chunk, page_size, kvh, hd).transpose(1, 2).to(vp.dtype)
            return paged_prefill_attention(q, kp, vp, kv_len, tab, q_off, impl=attn_impl)

        x = decoder_layer(tc, x, layer_slice(lm["layers"], li), cos, sin, attend, quant_glue=quant_glue_ok(attn_impl))
    last_idx = torch.as_tensor(np.maximum(chunk_len - 1, 0), dtype=torch.long, device=dev)
    last = x[torch.arange(b, device=dev), last_idx]  # [B, D]
    return lm_head(lm, tc, rms_norm(last, lm["norm"]["scale"], tc.rms_norm_eps))


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
    cancelled: bool = False  # cooperative: swept by the scheduler at tick start
    pending_pixels: Optional[np.ndarray] = None  # tiles awaiting the batched ViT tick
    image_cache_key: Optional[str] = None
    submit_t: float = 0.0  # perf_counter at submit (latency accounting)
    ttft: Optional[float] = None  # first-token latency (s)
    token_times: List[float] = field(default_factory=list)  # observation time per token

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
        pipeline_rolls: bool = False,
    ):
        """``max_len`` caps one request's prompt + generation (it sets the
        page-table width); ``decode_roll`` decode steps run per dispatch, with
        one host readback per roll; prompts longer than ``prefill_chunk``
        advance one chunk per tick, decode rolls in between;
        ``prefill_batch_tokens`` caps B x width of a batched prefill's scratch
        cache.  ``params`` already live on ``device`` (default CUDA; raises
        without it)."""
        dtype = params["language_model"]["embed_tokens"].dtype
        waiting = {
            "a device mesh (tensor-parallel serving)": mesh is not None,
            "the prefix cache": prefix_cache,
            "a pool dtype other than the weights' (fp8 pool)": cache_dtype not in (None, dtype),
            "decode_kernel='manual' (K13)": decode_kernel == "manual",
            "streaming rolls": streaming_roll is not None,
            "speculative verify": speculative,
            "pipelined rolls": pipeline_rolls,
            "the MoE trunk": cfg.text.is_moe,
        }
        for what, asked in waiting.items():
            if asked:
                raise NotImplementedError(f"PagedBatchEngine: {what} waits for a later slice of the port")
        if decode_kernel != "auto":
            raise ValueError(f"unknown decode_kernel {decode_kernel!r}")
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
        self.prefill_chunk = prefill_chunk
        self.prefill_batch_tokens = prefill_batch_tokens
        self._prompt_bucket = prompt_bucket
        self._chunk_bucket = math.lcm(prompt_bucket, page_size)
        self.decode_roll = max(1, int(decode_roll))
        # contiguous prefills and the ViT go through the single-request engine
        self._prefiller = OmChatEngine(
            cfg, params, attn_impl=attn_impl, prompt_bucket=prompt_bucket,
            image_cache_size=image_cache_size, device=self.device,
        )
        tc = cfg.text
        shape = (tc.num_hidden_layers, num_pages + 1, tc.num_key_value_heads, page_size, tc.attn_head_dim)
        self.k_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.allocator = PageAllocator(num_pages)
        self._parking = num_pages
        # pages one request may map: the table width, widened by the roll
        # headroom so decode_roll does not shrink the prompt+generation cap
        self.max_pages = -(-(max_len + self.decode_roll - 1) // page_size)
        self._ids = itertools.count()
        self.queue: List[_PagedRequest] = []
        self.slots: List[Optional[_PagedRequest]] = [None] * max_slots
        self.requests: Dict[int, _PagedRequest] = {}
        self._ttfts: "deque[float]" = deque(maxlen=1024)
        self._gaps: "deque[float]" = deque(maxlen=8192)
        self._tokens = np.zeros(max_slots, np.int32)
        self._lengths = np.zeros(max_slots, np.int32)
        self._tables = np.full((max_slots, self.max_pages), self._parking, np.int32)
        self._generator = torch.Generator(device=self.device).manual_seed(rng_seed)

    # -- client API ---------------------------------------------------------

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
    ) -> int:
        """Queue one request (ids with ``-200`` sentinels, its tiles
        [N, 3, H, W] in sentinel order); returns its id.  Raises before any
        work when no allocation could ever hold it."""
        if logprobs or top_logprobs:
            raise NotImplementedError("PagedBatchEngine: logprobs wait for a later slice of the port")
        if generation is not None and (generation.presence_penalty or generation.frequency_penalty):
            raise NotImplementedError("PagedBatchEngine: presence / frequency penalties wait for a later slice")
        req = _PagedRequest(next(self._ids), list(input_ids), None, max_new_tokens, eos_token_id, generation)
        req.submit_t = time.perf_counter()
        req.plan = self._prefiller.plan([req.input_ids])
        # roll - 1 extra positions absorb mid-roll writes past a finished budget
        need = self._n_pages_for(int(req.plan.lengths[0]) + max_new_tokens + self.decode_roll - 1)
        if need > min(self.max_pages, self.allocator.num_pages):
            raise ValueError(
                f"request needs {need} pages (> cap {self.max_pages} / pool {self.allocator.num_pages}); "
                "raise max_len/num_pages or shorten the request"
            )
        req.n_pages_needed = need
        if images is not None:
            if image_cache_key is None and isinstance(images, np.ndarray):
                image_cache_key = pixel_digest(images)
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

    def pop_result(self, request_id: int):
        req = self.requests.pop(request_id)
        return list(req.generated), req.prompt_len

    def cancel(self, request_id: int) -> None:
        """Request early termination.  Only a flag is set here; the scheduler
        releases the slot and pages at the start of its next tick."""
        self.requests[request_id].cancelled = True

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def stats(self) -> dict:
        """Scheduler gauges: slots, queue, pages, image cache, latency."""
        out = {
            "slots_busy": sum(r is not None for r in self.slots),
            "slots_total": self.max_slots,
            "queue_depth": len(self.queue),
            "pages_free": self.allocator.available,
            "pages_total": self.allocator.num_pages,
        }
        if self._prefiller.image_cache is not None:
            out.update({f"image_cache_{k}": v for k, v in self._prefiller.image_cache.stats().items()})
        out.update({k: round(v, 4) for k, v in self.latency_stats().items() if k != "requests_measured"})
        return out

    def reset_latency_stats(self) -> None:
        """Clear the rolling windows (after a warm-up)."""
        self._ttfts.clear()
        self._gaps.clear()

    def latency_stats(self) -> dict:
        """TTFT p50/p99/max and inter-token p50/p99, seconds, over rolling
        windows.  Inter-token gaps are observation gaps at roll granularity:
        a roll delivers its tokens together."""
        ttfts = list(self._ttfts)
        gaps = list(self._gaps)
        out: dict = {"requests_measured": len(ttfts)}
        if ttfts:
            out["ttft_p50_s"] = float(np.percentile(ttfts, 50))
            out["ttft_p99_s"] = float(np.percentile(ttfts, 99))
            out["ttft_max_s"] = float(max(ttfts))
        if gaps:
            out["intertoken_p50_s"] = float(np.percentile(gaps, 50))
            out["intertoken_p99_s"] = float(np.percentile(gaps, 99))
        return out

    def run_to_completion(self, max_ticks: int = 100000) -> int:
        ticks = 0
        while self.has_work() and ticks < max_ticks:
            self.step()
            ticks += 1
        return ticks

    # -- scheduler ----------------------------------------------------------

    def _n_pages_for(self, total_tokens: int) -> int:
        return -(-total_tokens // self.page_size)

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
            if req.n_pages_needed > self.allocator.available:
                break  # head-of-line waits for pages that decode progress frees
            self.queue.pop(0)
            req.pages = self.allocator.alloc(req.n_pages_needed)
            req.slot = i
            self.slots[i] = req
            self._tables[i, :] = self._parking
            self._tables[i, : len(req.pages)] = req.pages

    def _release(self, req: _PagedRequest):
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
            self.k_pool, self.v_pool, self.page_size, self.attn_impl,
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

    def _finish_with_token(self, req: _PagedRequest, first: int, logits_row=None):
        """Record the first token (``logits_row``: the [1, V] logits it came
        from) and start decoding, or release at EOS / a one-token budget."""
        req.prefilled = True
        req.last_token = first
        now = time.perf_counter()
        req.ttft = now - req.submit_t
        self._ttfts.append(req.ttft)
        self._lengths[req.slot] = req.prompt_len
        if first == req.eos_token_id:
            self._release(req)
            return
        req.generated.append(first)
        req.token_times.append(now)
        if len(req.generated) >= req.max_new_tokens:
            self._release(req)

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

        decoding = [r for r in self.slots if r is not None and r.prefilled and r.last_token is not None]
        if not decoding:
            return
        active = np.zeros(self.max_slots, bool)
        for r in decoding:
            self._tokens[r.slot] = r.last_token
            active[r.slot] = True
        # a slot mid-chunked-prefill has real pages in its table row: pass it
        # parked, or the roll would write over its committed chunks
        tables_dec = np.where(active[:, None], self._tables, self._parking)
        roll = self.decode_roll
        # slice the table to the pages reachable in this dispatch (a power of
        # two >= 4; + roll covers the rows written during it)
        need_pages = -(-(int(max(self._lengths[r.slot] for r in decoding)) + roll) // self.page_size)
        width = min(_pow2_at_least(need_pages, 4), tables_dec.shape[1])
        self._process_roll(self._dispatch_roll(decoding, roll, active, tables_dec[:, :width]))

    def _dispatch_roll(self, decoding, roll, active, tables_dec):
        """Issue one decode roll without reading its tokens back."""
        dev = self.device
        sampling = None
        if any(r.samples for r in decoding):
            do_sample = np.zeros(self.max_slots, bool)
            temperature = np.ones(self.max_slots, np.float32)
            top_k = np.zeros(self.max_slots, np.int32)
            top_p = np.ones(self.max_slots, np.float32)
            for r in decoding:
                if r.samples:
                    g = r.generation
                    do_sample[r.slot] = True
                    temperature[r.slot] = g.temperature
                    top_k[r.slot] = g.top_k
                    top_p[r.slot] = g.top_p
            sampling = {k: torch.as_tensor(v, device=dev) for k, v in
                        dict(do_sample=do_sample, temperature=temperature, top_k=top_k, top_p=top_p).items()}
        toks = _paged_decode_roll(
            self.params, self.cfg, torch.as_tensor(self._tokens, device=dev),
            torch.as_tensor(self._lengths, device=dev), torch.as_tensor(active, device=dev),
            torch.as_tensor(np.ascontiguousarray(tables_dec), device=dev), self.k_pool, self.v_pool,
            self.page_size, self.attn_impl, roll, sampling=sampling, generator=self._generator,
        )
        return {"decoding": list(decoding), "slots": [r.slot for r in decoding], "toks_dev": toks}

    def _process_roll(self, h):
        """Read a roll's tokens back (one readback) and run the per-request
        bookkeeping: EOS / budget releases and the latency windows.  Host
        lengths advance per consumed token; a request that finishes mid-roll
        is released, so its surplus positions stay in its freed headroom."""
        toks_np = h["toks_dev"].cpu().numpy()  # [roll, S]
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
                if r.token_times and tick_now > r.token_times[-1]:
                    self._gaps.append(tick_now - r.token_times[-1])
                r.token_times.append(tick_now)
                if len(r.generated) >= r.max_new_tokens:
                    self._release(r)
                    break
