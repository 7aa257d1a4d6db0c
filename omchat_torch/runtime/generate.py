"""Generation runtime: prefill, decode step, a host streaming loop and the
on-device decode loop — PyTorch port of the single-request path of
``omchat_tpu/runtime/generate.py``.

Prefill fills a cache of the bucketed prompt length plus the bucketed decode
budget and returns the first-token logits; each decode step runs the whole
trunk for one token against the read-only cache and commits the new rows
once.  Encoded images go through an LRU feature cache
(:mod:`omchat_torch.runtime.feature_cache`).  The paged serving engine
(:mod:`omchat_torch.runtime.paged_engine`) reuses :meth:`OmChatEngine.plan`
and :meth:`OmChatEngine.prefill` for its contiguous prefills.  On int8
params (``api.quantize_model``) with ``cfg.w8a8`` the encode and prefill run
the w8a8 glue kernels and decode stays weight-only int8.

``generate`` (a readback a token, as the JAX engine's per-token
``_decode_step_jit``) and ``generate_ondevice`` (the JAX ``_decode_loop_jit``:
no readback a token) decode greedily over a :class:`DecodeState`: the cache
and the step's token / length / done / output buffers, kept per (batch,
cache rows, cache dtype) in a small LRU.  On a CUDA engine each decode step
is one replay of a CUDA graph of the step
(:class:`~omchat_torch.runtime.cuda_graphs.GraphedStep`), the counterpart of
one jit dispatch; a CPU engine, and a CUDA engine built with
``decode_graphs=False``, run the same step body eagerly.  Sampling,
logprobs, penalties, constrained and speculative decoding and chunked
prefill come with later slices.
"""

from __future__ import annotations

import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from omchat_torch.config import GenerationConfig, OmChatConfig
from omchat_torch.models.decoder import decoder_forward
from omchat_torch.models.omchat import (
    MergePlan,
    encode_images,
    fuse_embeddings,
    plan_multimodal_merge,
    round_up_to_bucket,
)
from omchat_torch.models.qwen2 import KVCache, embed_tokens, init_kv_cache, lm_head
from omchat_torch.ops.attention import PLAIN
from omchat_torch.ops.sampling import greedy
from omchat_torch.runtime.cuda_graphs import GraphedStep
from omchat_torch.runtime.feature_cache import ImageFeatureCache, cached_encode
from omchat_torch.utils.device import resolve_device

PROMPT_BUCKET = 128  # merged prompts and the decode budget round up to multiples of this
DECODE_STATES = 4  # decode states (cache, buffers, graph) an engine keeps, least recently used dropped first
DONE_POLL = 8  # generate_ondevice reads ``done`` back once every this many steps


def make_stdout_streamer(tokenizer, window: int = 24):
    """Incremental token→stdout streamer with a bounded decode window."""
    printed = []

    def stream(token_id: int):
        printed.append(token_id)
        tail = printed[-window:]
        text = tokenizer.decode(tail, skip_special_tokens=True)
        prev = tokenizer.decode(tail[:-1], skip_special_tokens=True)
        print(text[len(prev):], end="", flush=True)

    return stream


class KeywordStopper:
    """Host-side keyword stopping (the reference's KeywordsStoppingCriteria,
    mm_utils.py:242-274) over a bounded tail of the generated ids."""

    def __init__(self, keywords: Sequence[str], tokenizer):
        self.keywords = list(keywords)
        self.tokenizer = tokenizer

    def should_stop(self, generated_ids: List[int]) -> bool:
        if not self.keywords:
            return False
        text = self.tokenizer.decode(generated_ids[-64:], skip_special_tokens=True)
        return any(k in text for k in self.keywords)


@dataclass
class GenerateOutput:
    token_ids: List[List[int]]  # generated tokens per sequence (eos excluded)
    prompt_len: np.ndarray


@dataclass
class DecodeState:
    """The static buffers of the decode loop for one (batch, cache rows,
    cache dtype): the cache prefill writes into and the step reads, and what
    the step reads and writes around it.  A step (``run``) feeds ``tokens``
    at ``kv_len``, picks the greedy next token of each row (eos where the row
    is ``done``), writes it into column ``step`` of ``out`` and into
    ``tokens``, marks rows that picked eos done, and advances ``kv_len`` and
    ``step``.  The buffers are only ever written in place: a CUDA graph of
    the step reads and writes these addresses."""

    cache: KVCache
    tokens: torch.Tensor  # [B] int32
    kv_len: torch.Tensor  # [B] int32, valid cache rows before the step's write
    done: torch.Tensor  # [B] bool
    eos: torch.Tensor  # [1] int32
    step: torch.Tensor  # [1] int64
    out: torch.Tensor  # [B, cache rows] int32: the first token, then a step's each
    logits: torch.Tensor  # [B, V] fp32, the last step's
    run: Union[GraphedStep, Callable[[], torch.Tensor], None] = None


class OmChatEngine:
    """The generation engine: prompts arrive as input_ids with ``-200`` sentinels
    plus a stack of image tiles (single_inference.py:43-62).

    ``params`` already live on ``device`` (default CUDA; raises without it).
    ``attn_impl=None`` runs the hand-written kernels on CUDA tensors (their
    plain versions on CPU tensors); ``"plain"`` runs the plain reference
    attention everywhere — chosen only explicitly.  ``prompt_bucket``: merged
    prompts pad to a multiple of it.  ``image_cache_size``: entries in the
    encoded-image LRU (0 disables it).  ``cache_dtype``: the KV cache's
    storage dtype, default the weights'; ``torch.float8_e4m3fn`` halves the
    cache's bytes (K/V rounded on write, widened on read by the kernels).

    ``decode_graphs`` (default True): on a CUDA engine with the kernels
    (``attn_impl=None``) each decode step replays one CUDA graph of the step,
    captured on the first step of each decode state; False runs the same
    step body eagerly, and so do CPU engines and ``attn_impl="plain"``
    (whose plain versions build host scalars).

    After :meth:`generate` or :meth:`generate_ondevice`, ``spans`` holds the
    stage times in seconds (``encode_images``, ``prefill``, ``ttft``,
    ``decode``: the decode steps, a capture excluded; ``capture``: the CUDA
    graph capture, on the request that captured), ``decode_steps`` and the
    ``cache_len`` in rows; on CUDA every stage ends in a synchronize."""

    def __init__(
        self,
        cfg: OmChatConfig,
        params: dict,
        *,
        attn_impl: Optional[str] = None,
        prompt_bucket: int = PROMPT_BUCKET,
        image_cache_size: int = 8,
        cache_dtype: Optional[torch.dtype] = None,
        device=None,
        decode_graphs: bool = True,
    ):
        self.cfg = cfg
        self.params = params
        self.attn_impl = attn_impl
        self.cache_dtype = cache_dtype
        self.prompt_bucket = prompt_bucket
        self.image_cache = ImageFeatureCache(image_cache_size) if image_cache_size else None
        self.device = resolve_device(device)
        self.decode_graphs = decode_graphs
        self.spans: dict = {}
        self._states: "OrderedDict[tuple, DecodeState]" = OrderedDict()
        self._graph_pool = torch.cuda.graph_pool_handle() if self.graphed() else None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- stages ------------------------------------------------------------

    @torch.no_grad()
    def encode_tiles(self, pixel_values) -> torch.Tensor:
        """[N, 3, H, W] tiles → [N, L, D] projected features (uncached)."""
        pv = torch.as_tensor(np.asarray(pixel_values), device=self.device)
        return encode_images(self.params, self.cfg, pv, attn_impl=self.attn_impl)

    def encode_images(self, pixel_values, cache_key=None) -> torch.Tensor:
        """[N, 3, H, W] tiles → flattened [N*L, D] projected features, through
        the feature LRU (``cache_key``: the caller's identity for the image,
        e.g. a hash of its compressed bytes; host arrays are content-hashed
        when it is absent)."""

        def encode(pv):
            feats = self.encode_tiles(pv)
            return feats.reshape(-1, feats.shape[-1])

        return cached_encode(self.image_cache, pixel_values, cache_key, encode)

    def plan(self, batch_input_ids, pad_to: Optional[int] = None) -> MergePlan:
        """The merged layout of a batch, padded to ``pad_to`` rows or else to
        the next multiple of the prompt bucket."""
        return plan_multimodal_merge(
            batch_input_ids, self.cfg.image_seq_len, pad_to=pad_to, bucket=self.prompt_bucket,
            max_length=self.cfg.tokenizer_model_max_length,
        )

    def cache_rows(self, plan: MergePlan, max_new_tokens: int) -> int:
        """The cache a prefill fills: ``plan.max_len`` rows plus the bucketed
        decode budget."""
        return plan.max_len + round_up_to_bucket(max_new_tokens, self.prompt_bucket)

    @torch.no_grad()
    def prefill(self, plan: MergePlan, image_features: Optional[torch.Tensor], max_new_tokens: int,
                cache: Optional[KVCache] = None):
        """Fuse embeddings, run the trunk over the merged prompt into a cache
        of ``plan.max_len`` rows plus the bucketed decode budget (with
        ``max_new_tokens=0`` exactly ``plan.max_len``): a fresh one, or
        ``cache`` (of that shape; a decode state's) zeroed first, so that it
        holds what a fresh one would; returns (last-valid-token logits [B, V]
        fp32, cache)."""
        lm = self.params["language_model"]
        dev = self.device
        cache_len = self.cache_rows(plan, max_new_tokens)
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        embeds = fuse_embeddings(self.params, t(plan.token_ids), t(plan.is_image), t(plan.image_index), image_features)
        b = embeds.shape[0]
        if cache is None:
            cache = init_kv_cache(self.cfg.text, b, cache_len, dtype=self.cache_dtype or embeds.dtype, device=dev)
        elif cache.k.shape[1] != b or cache.max_len != cache_len:
            raise ValueError(f"prefill: the cache holds {tuple(cache.k.shape)}, the plan needs B={b} x {cache_len}")
        else:
            cache.k.zero_()
            cache.v.zero_()
        lengths = t(plan.lengths)
        hidden, cache = decoder_forward(
            lm, self.cfg.text, embeds, t(plan.positions), cache,
            write_pos=torch.zeros((b,), dtype=torch.int32, device=dev), kv_len=lengths, attn_impl=self.attn_impl,
        )
        last = hidden[torch.arange(b, device=dev), (lengths - 1).clamp(min=0).long()]  # [B, D]
        return lm_head(lm, self.cfg.text, last), cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, kv_len: torch.Tensor, cache: KVCache):
        """One decode step.  tokens [B]; kv_len [B] current length (pre-write).
        The cache is updated in place."""
        lm = self.params["language_model"]
        embeds = embed_tokens(lm, tokens[:, None])
        hidden, cache = decoder_forward(
            lm, self.cfg.text, embeds, kv_len[:, None], cache,
            write_pos=kv_len, kv_len=kv_len + 1, attn_impl=self.attn_impl,
        )
        return lm_head(lm, self.cfg.text, hidden)[:, 0], cache

    # -- the decode state and its step ------------------------------------

    def graphed(self) -> bool:
        """Whether decode steps replay CUDA graphs (a CUDA engine on the
        kernels with ``decode_graphs``)."""
        return self.decode_graphs and self.device.type == "cuda" and self.attn_impl != PLAIN

    def decode_state(self, batch: int, cache_rows: int) -> DecodeState:
        """The decode state for ``batch`` rows over a cache of ``cache_rows``
        rows in the engine's cache dtype, from the LRU or made (its cache
        zeroed, its step not yet run or captured)."""
        lm = self.params["language_model"]
        dtype = self.cache_dtype or lm["embed_tokens"].dtype
        key = (batch, cache_rows, dtype)
        st = self._states.pop(key, None)
        if st is None:
            while len(self._states) >= DECODE_STATES:
                self._states.popitem(last=False)
            dev = self.device
            i32 = dict(dtype=torch.int32, device=dev)
            st = DecodeState(
                cache=init_kv_cache(self.cfg.text, batch, cache_rows, dtype=dtype, device=dev),
                tokens=torch.zeros(batch, **i32), kv_len=torch.zeros(batch, **i32),
                done=torch.zeros(batch, dtype=torch.bool, device=dev), eos=torch.zeros(1, **i32),
                step=torch.zeros(1, dtype=torch.int64, device=dev), out=torch.zeros(batch, cache_rows, **i32),
                logits=torch.zeros(batch, self.cfg.text.vocab_size, dtype=torch.float32, device=dev),
            )
            # The body holds its engine and state weakly: a state dropped from
            # the LRU, or an engine deleted, is freed at once, not at the
            # collector's next pass.
            engine, state = weakref.ref(self), weakref.ref(st)
            body = lambda: engine()._decode_body(state())  # noqa: E731
            st.run = GraphedStep(body, self._graph_pool, dev) if self.graphed() else body
        self._states[key] = st
        return st

    def release_decode_states(self) -> None:
        """Drop every kept decode state: its cache, buffers and graph (whose
        memory goes back to the allocator with the engine's last graph).  A
        long-running caller that has served requests of many shapes can call
        this to free them; the next request makes its state anew."""
        self._states.clear()

    def _decode_body(self, st: DecodeState) -> torch.Tensor:
        """One decode step on ``st``'s buffers, in place (the step a graph
        captures): :meth:`decode_step` (embed, the 28-layer ``decode_scan``
        with K3 in every layer and one K4 commit, lm_head), the greedy pick,
        eos for rows already done, as the JAX ``_decode_loop_jit`` body.
        Returns the logits buffer."""
        logits, _ = self.decode_step(st.tokens, st.kv_len, st.cache)
        nxt = torch.where(st.done, st.eos, greedy(logits))
        st.logits.copy_(logits)
        st.out.index_copy_(1, st.step, nxt[:, None])
        st.done.logical_or_(nxt == st.eos)
        st.tokens.copy_(nxt)
        st.kv_len.add_(1)
        st.step.add_(1)
        return st.logits

    def _start(self, st: DecodeState, first: torch.Tensor, lengths, eos: int) -> None:
        """Set ``st`` for a request: the first tokens [B] (picked from the
        prefill's logits) in ``tokens`` and ``out``'s column 0, eos in the rest
        of ``out``, the prompt lengths in ``kv_len``."""
        st.tokens.copy_(first)
        st.kv_len.copy_(torch.as_tensor(np.asarray(lengths, np.int32)))
        st.eos.fill_(eos)
        st.done.copy_(first == eos)
        st.step.fill_(1)
        st.out.fill_(eos)
        st.out[:, 0] = first

    def _prefill_into_state(self, batch_input_ids, images, gen: GenerationConfig, t0: float):
        """Encode, plan and prefill into the decode state of the request's
        shape; records the ``encode_images`` and ``prefill`` spans.  Returns
        (plan, state, first-token logits, first tokens)."""
        feats = self.encode_images(images) if images is not None else None
        self._sync()
        t1 = time.perf_counter()
        self.spans["encode_images"] = t1 - t0
        plan = self.plan(batch_input_ids)
        st = self.decode_state(plan.token_ids.shape[0], self.cache_rows(plan, gen.max_new_tokens))
        logits, _ = self.prefill(plan, feats, gen.max_new_tokens, cache=st.cache)
        first = greedy(logits)
        self._start(st, first, plan.lengths, gen.eos_token_id)
        self._sync()
        self.spans["prefill"] = time.perf_counter() - t1
        return plan, st, logits, first

    def _decode_spans(self, st: DecodeState, t_dec: float, graph_before, steps: int) -> None:
        """The ``decode`` span since ``t_dec`` and, when the state's step was
        captured since (its graph is no longer ``graph_before``), the
        ``capture`` span, taken out of ``decode``."""
        self._sync()
        wall = time.perf_counter() - t_dec
        if getattr(st.run, "graph", None) is not graph_before:
            self.spans["capture"] = st.run.capture_s
        self.spans["decode"] = wall - self.spans.get("capture", 0.0)
        self.spans["decode_steps"] = steps
        self.spans["cache_len"] = st.cache.max_len

    @staticmethod
    def _greedy(generation: Optional[GenerationConfig]) -> GenerationConfig:
        gen = generation or GenerationConfig()
        if gen.do_sample:
            raise NotImplementedError("sampled decode needs a generator a CUDA graph can replay; it waits for queue "
                                      "A item 17 (A17): the port decodes greedily")
        if gen.presence_penalty or gen.frequency_penalty:
            raise NotImplementedError("penalties wait for a later slice; the port decodes greedily")
        return gen

    # -- full generation ----------------------------------------------------

    @torch.no_grad()
    def generate(
        self,
        batch_input_ids: Sequence[Sequence[int]],
        images=None,
        generation: Optional[GenerationConfig] = None,
        *,
        stream_callback: Optional[Callable[[int], None]] = None,
        stop_keywords: Sequence[str] = (),
        tokenizer=None,
        logits_callback: Optional[Callable[[int, torch.Tensor], None]] = None,
    ) -> GenerateOutput:
        """Greedy decode with host streaming: one decode step (one graph
        replay on a CUDA engine) and one readback of its tokens a token.

        images: [N_total_tiles, 3, H, W] across the batch's sentinels, in
        sentinel order.  ``logits_callback(step, logits)`` sees each step's
        [B, V] fp32 logits before the token is picked (a copy of the decode
        state's buffer, which the next step overwrites)."""
        gen = self._greedy(generation)
        stopper = KeywordStopper(stop_keywords, tokenizer) if stop_keywords else None
        self.spans = {}
        t0 = time.perf_counter()
        plan, st, logits, tokens = self._prefill_into_state(batch_input_ids, images, gen, t0)
        graph_before = getattr(st.run, "graph", None)

        b = plan.token_ids.shape[0]
        generated: List[List[int]] = [[] for _ in range(b)]
        done = np.zeros(b, bool)
        steps = 0
        t_dec = time.perf_counter()
        for step in range(gen.max_new_tokens):
            if logits_callback is not None:
                logits_callback(step, logits.clone())
            toks = tokens.cpu().numpy()
            if step == 0:
                self.spans["ttft"] = time.perf_counter() - t0
                t_dec = time.perf_counter()
            for i in range(b):
                if done[i]:
                    continue
                if int(toks[i]) == gen.eos_token_id:
                    done[i] = True
                    continue
                generated[i].append(int(toks[i]))
                if stream_callback is not None and b == 1:
                    stream_callback(int(toks[i]))
                if stopper is not None and stopper.should_stop(generated[i]):
                    done[i] = True
            if done.all() or step == gen.max_new_tokens - 1:
                break
            logits = st.run()
            tokens = st.tokens
            steps += 1
        self._decode_spans(st, t_dec, graph_before, steps)
        return GenerateOutput(token_ids=generated, prompt_len=plan.lengths)

    @torch.no_grad()
    def generate_ondevice(
        self,
        batch_input_ids: Sequence[Sequence[int]],
        images=None,
        generation: Optional[GenerationConfig] = None,
    ) -> GenerateOutput:
        """Greedy decode with no readback a token (the JAX
        ``generate_ondevice`` over ``_decode_loop_jit``): the output starts as
        eos with the first token in column 0; each step writes ``next =
        where(done, eos, picked)`` and sets ``done |= next == eos``, for at
        most ``max_new_tokens - 1`` steps; the host reads ``done`` once every
        ``DONE_POLL`` steps to stop early.  Each row is cut at its first
        eos.  Sampling needs a generator that a CUDA graph can replay, which
        comes with queue A item 17 (A17): ``do_sample`` raises."""
        gen = self._greedy(generation)
        self.spans = {}
        t0 = time.perf_counter()
        plan, st, _, _ = self._prefill_into_state(batch_input_ids, images, gen, t0)
        self.spans["ttft"] = time.perf_counter() - t0
        graph_before = getattr(st.run, "graph", None)
        t_dec = time.perf_counter()
        steps = 0
        while steps < gen.max_new_tokens - 1 and not bool(st.done.all()):
            for _ in range(min(DONE_POLL, gen.max_new_tokens - 1 - steps)):
                st.run()
                steps += 1
        out = st.out[:, : gen.max_new_tokens].cpu().tolist()
        self._decode_spans(st, t_dec, graph_before, steps)
        eos = gen.eos_token_id
        return GenerateOutput(token_ids=[row[: row.index(eos)] if eos in row else row for row in out],
                              prompt_len=plan.lengths)
