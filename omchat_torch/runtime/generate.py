"""Generation runtime: prefill, chunked prefill, decode step, a host
streaming loop and the on-device decode loop — PyTorch port of the
single-request path of ``omchat_tpu/runtime/generate.py``.

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
no readback a token) decode over a :class:`DecodeState`: the cache and the
step's token / length / done / output buffers, and the buffers the pick
reads (an additive logit bias, the counts of generated tokens for the
presence / frequency penalties, the sampling parameters and a generator),
kept per (batch, cache rows, cache dtype) in a small LRU.  On a CUDA engine
each decode step is one replay of a CUDA graph of the step
(:class:`~omchat_torch.runtime.cuda_graphs.GraphedStep`), the counterpart of
one jit dispatch, one graph per pick mode (greedy or sampled, with or
without log-probs); a CPU engine, and a CUDA engine built with
``decode_graphs=False``, run the same step body eagerly.  The pick follows
the JAX ``generate``'s order: bias, then the penalties; an
``allowed_tokens_fn`` mask replaces both (it is added to the raw logits, as
in the JAX package); then greedy or sampled; log-probs of the biased /
masked logits, before temperature.

``OmChatEngine(lora_bank=)`` (``training.lora.build_lora_bank``) serves
per-request LoRA: ``generate(adapter_id=)`` picks each row's adapter (0: the
base model).  The ids reach the prefill, and the decode step through the
decode state's ``adapter_ids`` buffer, so one graph of the step serves every
adapter.
"""

from __future__ import annotations

import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

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
from omchat_torch.models.qwen2 import KVCache, embed_tokens, full_logits, init_kv_cache
from omchat_torch.models.qwen2_moe import check_lora_bank
from omchat_torch.models.spatial_merge import spatial_unpad_merge
from omchat_torch.ops.attention import PLAIN
from omchat_torch.ops.sampling import greedy, sample_from
from omchat_torch.parallel.serving import agreed, check_serving_mesh, replicated
from omchat_torch.parallel.sharding import shard_lora_bank
from omchat_torch.runtime.cuda_graphs import GraphedStep
from omchat_torch.runtime.feature_cache import ImageFeatureCache, cached_encode
from omchat_torch.utils.device import resolve_device

PROMPT_BUCKET = 128  # merged prompts and the decode budget round up to multiples of this
DECODE_STATES = 4  # decode states (cache, buffers, graph) an engine keeps, least recently used dropped first
DONE_POLL = 8  # generate_ondevice reads ``done`` back once every this many steps
TOP_LOGPROBS_MAX = 20  # top_logprobs a step can return (OpenAI's cap)

# A pick mode: (sampled, log-probs).  With log-probs a step writes the chosen
# token's and the top TOP_LOGPROBS_MAX; the host slices the k it was asked
# for.  Each mode is one step body, so a state has at most four.
PickMode = Tuple[bool, bool]
GREEDY: PickMode = (False, False)


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
    # per-token log p(token | prefix) for each sequence, aligned with
    # token_ids; only populated when generate(return_logprobs=True)
    logprobs: Optional[List[List[float]]] = None
    # per-token top-k alternatives [(token_id, logprob), ...] per sequence,
    # aligned with token_ids; populated when generate(top_logprobs=k > 0)
    top_logprobs: Optional[List[List[List[tuple]]]] = None


def seed_of(rng_key) -> int:
    """The seed a request's draws start from: ``rng_key`` itself when an int,
    one int64 drawn from it when a :class:`torch.Generator`, else 0 (the JAX
    package's default ``PRNGKey(0)``)."""
    if rng_key is None:
        return 0
    if isinstance(rng_key, torch.Generator):
        return int(torch.randint(0, 2**62, (1,), generator=rng_key, device=rng_key.device))
    if isinstance(rng_key, (int, np.integer)):
        return int(rng_key)
    raise TypeError(f"rng_key: a seed (int) or a torch.Generator, not {type(rng_key).__name__}")


@dataclass
class DecodeState:
    """The static buffers of the decode loop for one (batch, cache rows,
    cache dtype): the cache prefill writes into and the step reads, and what
    the step reads and writes around it (with a LoRA bank, each row's
    ``adapter_ids``).  A step feeds ``tokens`` at
    ``kv_len``, picks the next token of each row from its logits (eos where
    the row is ``done``), writes it into column ``step`` of ``out`` and into
    ``tokens``, counts it, marks rows that picked eos done, and advances
    ``kv_len`` and ``step``.  The pick reads ``bias`` (added to the logits),
    ``penalty`` and ``counts`` (subtracted: presence where a token was
    generated, frequency times its count), and for a sampled pick
    ``temperature``, ``top_k``, ``top_p`` and ``generator``; with log-probs
    it writes ``logprob`` and ``top_logprob`` / ``top_id``.  The buffers are
    only ever written in place: a CUDA graph of the step reads and writes
    these addresses, and the host rewrites ``bias`` between replays for a
    constrained decode.  ``runs`` holds one step callable a pick mode;
    ``run`` is the greedy one."""

    cache: KVCache
    tokens: torch.Tensor  # [B] int32
    kv_len: torch.Tensor  # [B] int32, valid cache rows before the step's write
    done: torch.Tensor  # [B] bool
    eos: torch.Tensor  # [1] int32
    step: torch.Tensor  # [1] int64
    out: torch.Tensor  # [B, cache rows] int32: the first token, then a step's each
    logits: torch.Tensor  # [B, V] fp32, the last step's (raw, before the pick's bias)
    bias: torch.Tensor  # [V] fp32 additive bias: logit_bias, or an allowed-token mask
    penalty: torch.Tensor  # [2] fp64: presence, frequency
    counts: torch.Tensor  # [B, V] int32: tokens generated so far (eos excluded)
    temperature: torch.Tensor  # [1] fp32
    top_k: torch.Tensor  # [1] int32, <= 0 keeps every token
    top_p: torch.Tensor  # [1] fp32, >= 1 keeps every token
    logprob: torch.Tensor  # [B] fp32, log p of the picked token
    top_logprob: torch.Tensor  # [B, TOP_LOGPROBS_MAX] fp32
    top_id: torch.Tensor  # [B, TOP_LOGPROBS_MAX] int64
    adapter_ids: torch.Tensor  # [B] int64 rows of the engine's LoRA bank (0: the base model)
    generator: torch.Generator
    runs: Dict[PickMode, Union[GraphedStep, Callable[[], torch.Tensor]]] = field(default_factory=dict)

    @property
    def run(self):
        return self.runs[GREEDY]


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
    captured on the first step of each decode state and pick mode; False
    runs the same step body eagerly, and so do CPU engines and
    ``attn_impl="plain"`` (whose plain versions build host scalars).

    ``lora_bank``: a stacked multi-adapter bank
    (:func:`~omchat_torch.training.lora.build_lora_bank`, on the params'
    device) for per-request LoRA; requests pick an adapter with
    ``generate(adapter_id=)``, id 0 being the base model.

    ``mesh`` (a pure tensor-parallel :class:`~omchat_torch.parallel.mesh.
    Mesh`): ``params`` is this rank's shard
    (:func:`~omchat_torch.parallel.sharding.shard_params`), the caches hold
    this rank's kv heads (all of them where tp does not divide them), every
    rank runs the same calls (:mod:`omchat_torch.parallel.serving`) and
    picks the same tokens from the gathered logits.  ``lora_bank`` is given
    whole and sharded here like its targets
    (:func:`~omchat_torch.parallel.sharding.shard_lora_bank`).  w8a8 and
    the MoE trunk serve there as on one device, w8a8 on its unfused chain.
    The steps run eagerly there (``graphed()`` is False: a gloo collective
    cannot be captured).

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
        lora_bank: Optional[dict] = None,
        mesh=None,
    ):
        check_lora_bank(cfg.text, lora_bank)
        check_serving_mesh(cfg, mesh, what="OmChatEngine")
        self.mesh = mesh
        self.cfg = cfg
        self.lora_bank = shard_lora_bank(cfg.text, lora_bank, mesh)
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
        return encode_images(self.params, self.cfg, pv, attn_impl=self.attn_impl, mesh=self.mesh)

    def encode_images(self, pixel_values, cache_key=None) -> torch.Tensor:
        """[N, 3, H, W] tiles → flattened [N*L, D] projected features, through
        the feature LRU (``cache_key``: the caller's identity for the image,
        e.g. a hash of its compressed bytes; host arrays are content-hashed
        when it is absent)."""

        def encode(pv):
            feats = self.encode_tiles(pv)
            return feats.reshape(-1, feats.shape[-1])

        return cached_encode(self.image_cache, pixel_values, cache_key, encode)

    def plan(self, batch_input_ids, pad_to: Optional[int] = None, tokens_per_sentinel=None) -> MergePlan:
        """The merged layout of a batch, padded to ``pad_to`` rows or else to
        the next multiple of the prompt bucket (``tokens_per_sentinel``: each
        sentinel's feature rows where they vary, the v1 spatial merge)."""
        return plan_multimodal_merge(
            batch_input_ids, self.cfg.image_seq_len, tokens_per_sentinel=tokens_per_sentinel, pad_to=pad_to,
            bucket=self.prompt_bucket, max_length=self.cfg.tokenizer_model_max_length,
        )

    def merge_spatial_features(self, feats: torch.Tensor, num_patches, image_sizes):
        """The OmChat-v1 fusion (``cfg.mm_patch_merge_type`` "spatial" /
        "spatial_unpad"): each image's projected tile features laid out on the
        anyres grid, the aspect padding cropped, the learned
        ``image_newline`` ending each row, the thumbnail first.

        feats: flattened [ΣN·L, D] tile features in sentinel order;
        num_patches: tiles per image; image_sizes: (width, height) of each
        original.  Returns (flat [ΣT, D] merged features, tokens per
        sentinel)."""
        newline = self.params.get("image_newline")
        if newline is None:
            raise ValueError("mm_patch_merge_type spatial needs the checkpoint's image_newline embedding")
        feats = feats.reshape(-1, self.cfg.image_seq_len, feats.shape[-1])  # [ΣN, L, D]
        outs, off = [], 0
        for n, size in zip(num_patches, image_sizes):
            outs.append(spatial_unpad_merge(feats[off : off + int(n)], tuple(size), self.cfg.image_grid_pinpoints,
                                            self.cfg.vision.image_size, newline,
                                            patch_merge_type=self.cfg.mm_patch_merge_type))
            off += int(n)
        return torch.cat(outs, dim=0), [int(m.shape[0]) for m in outs]

    def _adapter_ids(self, b: int, adapter_id) -> Optional[torch.Tensor]:
        """[B] bank rows for a batch of ``b`` (``adapter_id``: an int for
        the whole batch or one a row), or None without a bank.  An id
        outside the bank raises ``ValueError``, as does a nonzero id on an
        engine without a bank."""
        if self.lora_bank is None:
            if adapter_id is not None and np.any(np.asarray(adapter_id) != 0):
                raise ValueError(f"adapter_id {adapter_id}: this engine has no LoRA bank")
            return None
        if adapter_id is None or np.isscalar(adapter_id):
            ids = np.full((b,), adapter_id or 0, np.int64)
        else:
            ids = np.asarray(adapter_id, np.int64)
        leaf = next(iter(next(iter(self.lora_bank["layers"].values())).values()))["a"]
        n = leaf.shape[1]
        if ids.shape != (b,) or (ids < 0).any() or (ids >= n).any():
            raise ValueError(f"adapter ids {ids.tolist()} out of range for a bank of {n - 1} adapters")
        return torch.as_tensor(ids, device=self.device)

    def cache_rows(self, plan: MergePlan, max_new_tokens: int) -> int:
        """The cache a prefill fills: ``plan.max_len`` rows plus the bucketed
        decode budget."""
        return plan.max_len + round_up_to_bucket(max_new_tokens, self.prompt_bucket)

    @torch.no_grad()
    def prefill(self, plan: MergePlan, image_features: Optional[torch.Tensor], max_new_tokens: int,
                cache: Optional[KVCache] = None, adapter_ids: Optional[torch.Tensor] = None):
        """Fuse embeddings, run the trunk over the merged prompt into a cache
        of ``plan.max_len`` rows plus the bucketed decode budget (with
        ``max_new_tokens=0`` exactly ``plan.max_len``): a fresh one, or
        ``cache`` (of that shape; a decode state's) zeroed first, so that it
        holds what a fresh one would; returns (last-valid-token logits [B, V]
        fp32, cache).  ``adapter_ids`` [B]: each row's LoRA bank row."""
        lm = self.params["language_model"]
        dev = self.device
        cache_len = self.cache_rows(plan, max_new_tokens)
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        embeds = fuse_embeddings(self.params, t(plan.token_ids), t(plan.is_image), t(plan.image_index), image_features,
                                 self.mesh, self.cfg.text.vocab_size)
        b = embeds.shape[0]
        if cache is None:
            cache = init_kv_cache(self.cfg.text, b, cache_len, dtype=self.cache_dtype or embeds.dtype, device=dev,
                                  mesh=self.mesh)
        elif cache.k.shape[1] != b or cache.max_len != cache_len:
            raise ValueError(f"prefill: the cache holds {tuple(cache.k.shape)}, the plan needs B={b} x {cache_len}")
        else:
            cache.k.zero_()
            cache.v.zero_()
        lengths = t(plan.lengths)
        hidden, cache = decoder_forward(
            lm, self.cfg.text, embeds, t(plan.positions), cache,
            write_pos=torch.zeros((b,), dtype=torch.int32, device=dev), kv_len=lengths, attn_impl=self.attn_impl,
            lora_bank=self.lora_bank, adapter_ids=adapter_ids, mesh=self.mesh,
        )
        last = hidden[torch.arange(b, device=dev), (lengths - 1).clamp(min=0).long()]  # [B, D]
        return full_logits(lm, self.cfg.text, last, self.mesh), cache

    @torch.no_grad()
    def prefill_chunked(self, plan: MergePlan, image_features: Optional[torch.Tensor], max_new_tokens: int,
                        chunk_size: int = 1024):
        """Incremental prefill in fixed-size chunks against the cache (the
        JAX ``prefill_chunked`` over ``_prefill_chunk_jit``): chunk ``c0``
        writes its K/V at ``write_pos = c0`` and attends causally to every row
        cached so far (K2 at ``q_offset = c0``); the last chunk is padded to
        ``chunk_size``, so the cache covers the padded write extent plus the
        decode budget, bucketed.  Returns (last-token logits [B, V] fp32,
        cache)."""
        cfg = self.cfg
        lm = self.params["language_model"]
        dev = self.device
        b, m = plan.token_ids.shape
        padded_m = round_up_to_bucket(plan.max_len, chunk_size)
        cache_len = round_up_to_bucket(padded_m + max_new_tokens, self.prompt_bucket)
        cache = init_kv_cache(cfg.text, b, cache_len, dtype=self.cache_dtype or lm["embed_tokens"].dtype, device=dev,
                              mesh=self.mesh)
        final = torch.zeros((b, cfg.text.vocab_size), dtype=torch.float32, device=dev)
        lengths = plan.lengths
        for c0 in range(0, m, chunk_size):
            csize = min(chunk_size, m - c0)

            def cut(a):
                part = a[:, c0: c0 + csize]
                if csize < chunk_size:
                    part = np.pad(part, ((0, 0), (0, chunk_size - csize)))
                return torch.as_tensor(part, device=dev)

            chunk_lengths = np.clip(lengths - c0, 0, chunk_size).astype(np.int32)
            if (chunk_lengths == 0).all():
                break
            embeds = fuse_embeddings(self.params, cut(plan.token_ids), cut(plan.is_image), cut(plan.image_index),
                                     image_features, self.mesh, cfg.text.vocab_size)
            start = torch.full((b,), c0, dtype=torch.int32, device=dev)
            hidden, cache = decoder_forward(lm, cfg.text, embeds, cut(plan.positions), cache, write_pos=start,
                                            kv_len=start + torch.as_tensor(chunk_lengths, device=dev),
                                            attn_impl=self.attn_impl, mesh=self.mesh)
            ends = (lengths > c0) & (lengths <= c0 + chunk_size)  # rows whose last token is in this chunk
            if ends.any():
                idx = torch.as_tensor(np.maximum(chunk_lengths - 1, 0), device=dev).long()
                logits = full_logits(lm, cfg.text, hidden[torch.arange(b, device=dev), idx], self.mesh)
                final = torch.where(torch.as_tensor(ends, device=dev)[:, None], logits, final)
        return final, cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, kv_len: torch.Tensor, cache: KVCache,
                    adapter_ids: Optional[torch.Tensor] = None):
        """One decode step.  tokens [B]; kv_len [B] current length (pre-write);
        ``adapter_ids`` [B]: each row's LoRA bank row.  The cache is updated
        in place."""
        lm = self.params["language_model"]
        embeds = embed_tokens(lm, tokens[:, None], self.mesh, self.cfg.text.vocab_size)
        hidden, cache = decoder_forward(
            lm, self.cfg.text, embeds, kv_len[:, None], cache,
            write_pos=kv_len, kv_len=kv_len + 1, attn_impl=self.attn_impl,
            lora_bank=self.lora_bank, adapter_ids=adapter_ids, mesh=self.mesh,
        )
        return full_logits(lm, self.cfg.text, hidden, self.mesh)[:, 0], cache

    # -- the decode state and its step ------------------------------------

    def graphed(self) -> bool:
        """Whether decode steps replay CUDA graphs (a CUDA engine on the
        kernels with ``decode_graphs``, on one rank: under a mesh of tp > 1
        the steps run eagerly, since a gloo collective cannot be captured)."""
        return (self.decode_graphs and self.device.type == "cuda" and self.attn_impl != PLAIN
                and (self.mesh is None or self.mesh.axis_size("model") == 1))

    def decode_state(self, batch: int, cache_rows: int) -> DecodeState:
        """The decode state for ``batch`` rows over a cache of ``cache_rows``
        rows in the engine's cache dtype, from the LRU or made (its cache
        zeroed, its greedy step not yet run or captured)."""
        lm = self.params["language_model"]
        dtype = self.cache_dtype or lm["embed_tokens"].dtype
        key = (batch, cache_rows, dtype)
        st = self._states.pop(key, None)
        if st is None:
            while len(self._states) >= DECODE_STATES:
                self._states.popitem(last=False)
            dev = self.device
            v = self.cfg.text.vocab_size
            i32 = dict(dtype=torch.int32, device=dev)
            f32 = dict(dtype=torch.float32, device=dev)
            st = DecodeState(
                cache=init_kv_cache(self.cfg.text, batch, cache_rows, dtype=dtype, device=dev, mesh=self.mesh),
                tokens=torch.zeros(batch, **i32), kv_len=torch.zeros(batch, **i32),
                done=torch.zeros(batch, dtype=torch.bool, device=dev), eos=torch.zeros(1, **i32),
                step=torch.zeros(1, dtype=torch.int64, device=dev), out=torch.zeros(batch, cache_rows, **i32),
                logits=torch.zeros(batch, v, **f32), bias=torch.zeros(v, **f32),
                penalty=torch.zeros(2, dtype=torch.float64, device=dev), counts=torch.zeros(batch, v, **i32),
                temperature=torch.ones(1, **f32), top_k=torch.zeros(1, **i32), top_p=torch.ones(1, **f32),
                logprob=torch.zeros(batch, **f32), top_logprob=torch.zeros(batch, TOP_LOGPROBS_MAX, **f32),
                top_id=torch.zeros(batch, TOP_LOGPROBS_MAX, dtype=torch.int64, device=dev),
                adapter_ids=torch.zeros(batch, dtype=torch.int64, device=dev),
                generator=torch.Generator(device=dev),
            )
            self._runner(st, GREEDY)
        self._states[key] = st
        return st

    def _runner(self, st: DecodeState, mode: PickMode):
        """``st``'s step for pick ``mode``, made on first use: a
        :class:`GraphedStep` of the body on a graphed engine (a sampled mode
        registers the state's generator with its graph), else the body."""
        run = st.runs.get(mode)
        if run is None:
            # The body holds its engine and state weakly: a state dropped from
            # the LRU, or an engine deleted, is freed at once, not at the
            # collector's next pass.
            engine, state = weakref.ref(self), weakref.ref(st)
            body = lambda: engine()._decode_body(state(), mode)  # noqa: E731
            if self.graphed():
                run = GraphedStep(body, self._graph_pool, self.device, generators=(st.generator,) if mode[0] else ())
            else:
                run = body
            st.runs[mode] = run
        return run

    @replicated
    def release_decode_states(self) -> None:
        """Drop every kept decode state: its cache, buffers and graphs (whose
        memory goes back to the allocator with the engine's last graph).  A
        long-running caller that has served requests of many shapes can call
        this to free them; the next request makes its state anew, and its
        graph is captured into a new pool: the caching allocator refuses a
        capture into a pool whose every graph is gone while that pool still
        holds memory."""
        self._states.clear()
        if self._graph_pool is not None:
            self._graph_pool = torch.cuda.graph_pool_handle()

    def _decode_body(self, st: DecodeState, mode: PickMode = GREEDY) -> torch.Tensor:
        """One decode step on ``st``'s buffers, in place (the step a graph
        captures): :meth:`decode_step` (embed, the 28-layer ``decode_scan``
        with K3 in every layer and one K4 commit, lm_head), then
        :meth:`_pick`, as the JAX ``_decode_loop_jit`` body.  Returns the
        logits buffer."""
        logits, _ = self.decode_step(st.tokens, st.kv_len, st.cache,
                                     st.adapter_ids if self.lora_bank is not None else None)
        st.logits.copy_(logits)
        self._pick(st, logits, mode)
        st.kv_len.add_(1)
        return st.logits

    @staticmethod
    def _pick(st: DecodeState, logits: torch.Tensor, mode: PickMode) -> None:
        """Pick each row's next token from ``logits`` [B, V] per ``mode`` and
        the state's option buffers, in the JAX ``generate``'s order: + bias,
        - (presence where counted + frequency x count), computed in fp64 and
        rounded once as the JAX package's numpy penalty is; greedy, or
        sampled from ``generator``; eos for rows already done; the log-probs
        of the biased logits; then the token written, counted and fed."""
        sampled, with_logprobs = mode
        pen = torch.where(st.counts > 0, st.penalty[0] + st.penalty[1] * st.counts.double(), 0.0)
        step_logits = (logits + st.bias) - pen.float()
        if sampled:
            picked = sample_from(step_logits, st.generator, st.temperature, st.top_k, st.top_p)
        else:
            picked = greedy(step_logits)
        if with_logprobs:
            lp = torch.log_softmax(step_logits.float(), dim=-1)
            st.logprob.copy_(lp.gather(1, picked[:, None].long())[:, 0])
            k = min(TOP_LOGPROBS_MAX, lp.shape[-1])
            top = torch.topk(lp, k, dim=-1)
            st.top_logprob[:, :k].copy_(top.values)
            st.top_id[:, :k].copy_(top.indices)
        nxt = torch.where(st.done, st.eos, picked)
        st.out.index_copy_(1, st.step, nxt[:, None])
        st.counts.scatter_add_(1, nxt[:, None].long(), ((nxt != st.eos) & ~st.done).int()[:, None])
        st.done.logical_or_(nxt == st.eos)
        st.tokens.copy_(nxt)
        st.step.add_(1)

    def _start(self, st: DecodeState, lengths, gen: GenerationConfig, rng_key=None,
               logit_bias: Optional[dict] = None, adapter_ids: Optional[torch.Tensor] = None) -> None:
        """Set ``st`` for a request before its first pick: the prompt
        lengths in ``kv_len``, eos everywhere in ``out``, nothing done or
        counted, step 0; the request's bias (``logit_bias``: {token id: bias},
        out-of-vocabulary ids inert), penalties and sampling parameters, its
        generator seeded from ``rng_key`` (:func:`seed_of`) and its LoRA bank
        rows (``adapter_ids``, default 0)."""
        st.kv_len.copy_(torch.as_tensor(np.asarray(lengths, np.int32)))
        if adapter_ids is None:
            st.adapter_ids.zero_()
        else:
            st.adapter_ids.copy_(adapter_ids)
        st.eos.fill_(gen.eos_token_id)
        st.done.zero_()
        st.step.zero_()
        st.out.fill_(gen.eos_token_id)
        st.counts.zero_()
        bias = np.zeros(st.bias.shape[0], np.float32)
        for tid, bv in (logit_bias or {}).items():
            if 0 <= int(tid) < bias.shape[0]:
                bias[int(tid)] = float(bv)
        st.bias.copy_(torch.from_numpy(bias))
        st.penalty.copy_(torch.tensor([gen.presence_penalty, gen.frequency_penalty], dtype=torch.float64))
        st.temperature.fill_(max(gen.temperature, 1e-6))
        st.top_k.fill_(gen.top_k)
        st.top_p.fill_(gen.top_p)
        st.generator.manual_seed(seed_of(rng_key))

    @staticmethod
    def _mask(st: DecodeState, allowed) -> None:
        """The constrained decode's step bias: 0 on ``allowed``, -inf
        elsewhere, written into ``st.bias`` in place and the penalties
        zeroed, so the pick sees the raw logits plus the mask (the JAX
        package's ``logits + bias``: a mask replaces bias and penalties)."""
        st.bias.fill_(float("-inf"))
        st.bias[torch.as_tensor(np.asarray(allowed, np.int64), device=st.bias.device)] = 0.0
        st.penalty.zero_()

    def _prefill_into_state(self, batch_input_ids, images, gen: GenerationConfig, t0: float, rng_key=None,
                            logit_bias: Optional[dict] = None, adapter_id=None, num_patches=None,
                            image_sizes=None):
        """Encode, plan and prefill into the decode state of the request's
        shape and set it for the request (:meth:`_start`); records the
        ``encode_images`` span.  Returns (plan, state, first-token logits)."""
        ids = self._adapter_ids(len(batch_input_ids), adapter_id)
        feats = self.encode_images(images) if images is not None else None
        tokens_per_sentinel = None
        if feats is not None and self.cfg.mm_patch_merge_type.startswith("spatial"):
            if num_patches is None or image_sizes is None:
                raise ValueError("spatial patch merge needs num_patches and image_sizes per image")
            feats, tokens_per_sentinel = self.merge_spatial_features(feats, num_patches, image_sizes)
        self._sync()
        t1 = time.perf_counter()
        self.spans["encode_images"] = t1 - t0
        plan = self.plan(batch_input_ids, tokens_per_sentinel=tokens_per_sentinel)
        st = self.decode_state(plan.token_ids.shape[0], self.cache_rows(plan, gen.max_new_tokens))
        logits, _ = self.prefill(plan, feats, gen.max_new_tokens, cache=st.cache, adapter_ids=ids)
        self._start(st, plan.lengths, gen, rng_key, logit_bias, ids)
        return plan, st, logits

    def _decode_spans(self, run, t_dec: float, graph_before, steps: int, cache_len: int) -> None:
        """The ``decode`` span since ``t_dec`` and, when ``run`` was captured
        since (its graph is no longer ``graph_before``), the ``capture`` span,
        taken out of ``decode``."""
        self._sync()
        wall = time.perf_counter() - t_dec
        if getattr(run, "graph", None) is not graph_before:
            self.spans["capture"] = run.capture_s
        self.spans["decode"] = wall - self.spans.get("capture", 0.0)
        self.spans["decode_steps"] = steps
        self.spans["cache_len"] = cache_len

    # -- full generation ----------------------------------------------------

    @replicated
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
        rng_key=None,
        return_logprobs: bool = False,
        top_logprobs: int = 0,
        allowed_tokens_fn: Optional[Callable[[List[int]], Optional[List[int]]]] = None,
        logit_bias: Optional[dict] = None,
        adapter_id=None,
        logits_callback: Optional[Callable[[int, torch.Tensor], None]] = None,
        num_patches: Optional[Sequence[int]] = None,
        image_sizes: Optional[Sequence] = None,
    ) -> GenerateOutput:
        """Greedy / sampled decode with host streaming: one decode step (one
        graph replay on a CUDA engine) and one readback of its tokens a token.

        images: [N_total_tiles, 3, H, W] across the batch's sentinels, in
        sentinel order.  ``rng_key``: a seed or a ``torch.Generator`` (the
        seed of the request's draws, :func:`seed_of`).  ``logit_bias``:
        OpenAI-style {token_id: bias} added to every step's logits;
        presence / frequency penalties ride the generation config.
        ``return_logprobs`` / ``top_logprobs``: the chosen token's log-prob
        and the top-k (≤ 20) alternatives a step, of the biased / masked
        logits before temperature.  ``allowed_tokens_fn(generated) -> ids |
        None`` (single request): each step's pick is restricted to ``ids``
        added as a mask to the raw logits (bias and penalties do not apply
        then, as in the JAX package); None ends the generation.
        ``logits_callback(step, logits)`` sees each step's raw [B, V] fp32
        logits (a copy of the decode state's buffer).  ``adapter_id``: the
        LoRA bank row of the whole batch (an int) or of each row (a
        sequence), 0 the base model; ``ValueError`` outside the bank.
        ``num_patches`` / ``image_sizes``: needed when
        ``cfg.mm_patch_merge_type`` is "spatial" / "spatial_unpad" (the
        OmChat-v1 assembly): tiles per image and each original's (width,
        height); one sentinel an image then takes that image's merged
        tokens."""
        gen = generation or GenerationConfig()
        if allowed_tokens_fn is not None and len(batch_input_ids) != 1:
            raise ValueError("constrained decoding is single-request (b == 1)")
        if not 0 <= top_logprobs <= TOP_LOGPROBS_MAX:
            raise ValueError(f"top_logprobs must be in [0, {TOP_LOGPROBS_MAX}]")
        mode = (gen.do_sample, bool(return_logprobs or top_logprobs))
        # host decisions every rank of a mesh takes from its leader (serving.agreed)
        should_stop = agreed(self.mesh, KeywordStopper(stop_keywords, tokenizer).should_stop if stop_keywords else None)
        allowed_tokens_fn = agreed(self.mesh, allowed_tokens_fn)
        self.spans = {}
        t0 = time.perf_counter()
        plan, st, logits = self._prefill_into_state(batch_input_ids, images, gen, t0, rng_key, logit_bias,
                                                    adapter_id, num_patches, image_sizes)
        run = self._runner(st, mode)
        graph_before = getattr(run, "graph", None)

        b = plan.token_ids.shape[0]
        generated: List[List[int]] = [[] for _ in range(b)]
        logprobs: List[List[float]] = [[] for _ in range(b)]
        tops: List[List[List[tuple]]] = [[] for _ in range(b)]
        done = np.zeros(b, bool)
        steps = 0
        allowed = allowed_tokens_fn([]) if allowed_tokens_fn is not None else ()
        if allowed is not None:  # None: the empty output already completes the constraint
            if allowed_tokens_fn is not None:
                self._mask(st, allowed)
            self._pick(st, logits, mode)
        self._sync()
        self.spans["prefill"] = time.perf_counter() - t0 - self.spans["encode_images"]
        t_dec = time.perf_counter()
        for step in range(gen.max_new_tokens if allowed is not None else 0):
            if logits_callback is not None:
                logits_callback(step, logits.clone())
            toks = st.tokens.cpu().numpy()
            lps = st.logprob.cpu().numpy() if mode[1] else None
            top_lp = st.top_logprob[:, :top_logprobs].cpu().numpy() if top_logprobs else None
            top_id = st.top_id[:, :top_logprobs].cpu().numpy() if top_logprobs else None
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
                if lps is not None:
                    logprobs[i].append(float(lps[i]))
                if top_lp is not None:
                    tops[i].append([(int(t), float(lp)) for t, lp in zip(top_id[i], top_lp[i])])
                if stream_callback is not None and b == 1:
                    stream_callback(int(toks[i]))
                if should_stop is not None and should_stop(generated[i]):
                    done[i] = True
            if done.all() or step == gen.max_new_tokens - 1:
                break
            if allowed_tokens_fn is not None:
                allowed = allowed_tokens_fn(generated[0])
                if allowed is None:
                    break
                self._mask(st, allowed)
            logits = run()
            steps += 1
        self.spans.setdefault("ttft", time.perf_counter() - t0)
        self._decode_spans(run, t_dec, graph_before, steps, st.cache.max_len)
        return GenerateOutput(
            token_ids=generated, prompt_len=plan.lengths,
            logprobs=logprobs if return_logprobs else None,
            top_logprobs=tops if top_logprobs > 0 else None,
        )

    @replicated
    @torch.no_grad()
    def generate_ondevice(
        self,
        batch_input_ids: Sequence[Sequence[int]],
        images=None,
        generation: Optional[GenerationConfig] = None,
        rng_key=None,
    ) -> GenerateOutput:
        """Greedy or sampled decode with no readback a token (the JAX
        ``generate_ondevice`` over ``_decode_loop_jit``): the output starts as
        eos with the first token in column 0; each step writes ``next =
        where(done, eos, picked)`` and sets ``done |= next == eos``, for at
        most ``max_new_tokens - 1`` steps; the host reads ``done`` once every
        ``DONE_POLL`` steps to stop early.  Each row is cut at its first
        eos.  A sampled decode draws from the decode state's generator,
        seeded from ``rng_key`` (:func:`seed_of`): the first pick and every
        step (every graph replay) draw from advancing offsets."""
        gen = generation or GenerationConfig()
        mode = (gen.do_sample, False)
        self.spans = {}
        t0 = time.perf_counter()
        plan, st, logits = self._prefill_into_state(batch_input_ids, images, gen, t0, rng_key)
        self._pick(st, logits, mode)
        self._sync()
        self.spans["prefill"] = time.perf_counter() - t0 - self.spans["encode_images"]
        self.spans["ttft"] = time.perf_counter() - t0
        run = self._runner(st, mode)
        graph_before = getattr(run, "graph", None)
        t_dec = time.perf_counter()
        steps = 0
        while steps < gen.max_new_tokens - 1 and not bool(st.done.all()):
            for _ in range(min(DONE_POLL, gen.max_new_tokens - 1 - steps)):
                run()
                steps += 1
        out = st.out[:, : gen.max_new_tokens].cpu().tolist()
        self._decode_spans(run, t_dec, graph_before, steps, st.cache.max_len)
        eos = gen.eos_token_id
        return GenerateOutput(token_ids=[row[: row.index(eos)] if eos in row else row for row in out],
                              prompt_len=plan.lengths)

    @replicated
    def beam_search(self, input_ids: Sequence[int], images=None, **options) -> List[int]:
        """:func:`omchat_torch.runtime.beam_search.beam_search` on this
        engine (one replicated call under a serving mesh)."""
        from omchat_torch.runtime.beam_search import beam_search

        return beam_search(self, input_ids, images, **options)

    @replicated
    def generate_speculative(self, input_ids: Sequence[int], images=None, generation: Optional[GenerationConfig] = None,
                             **options):
        """:func:`omchat_torch.runtime.speculative.generate_speculative` on
        this engine (one replicated call under a serving mesh)."""
        from omchat_torch.runtime.speculative import generate_speculative

        return generate_speculative(self, input_ids, images, generation, **options)
