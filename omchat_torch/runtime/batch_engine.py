"""Continuous-batching serving engine over one shared contiguous cache —
PyTorch port of ``omchat_tpu/runtime/batch_engine.py``.

Slot-based scheduler: requests join a free slot through incremental
(chunked) prefill and leave on eos or their token budget, while the other
slots keep decoding.  The cache is [L, max_slots, KVH, max_len, D]
(:func:`~omchat_torch.models.qwen2.init_kv_cache`), slot-contiguous, in the
weights' dtype or e4m3 (``cache_dtype=torch.float8_e4m3fn``).  One
:meth:`BatchEngine.step` (a scheduler tick):

1. admits queued requests onto free slots;
2. advances the first slot still prefilling by one chunk of ``chunk_size``
   rows (:meth:`BatchEngine._prefill_chunk`, the JAX
   ``_slot_prefill_chunk_jit``): the trunk writes the chunk's K/V in place
   into the slot's rows of every layer (each ``cache.k[li, slot:slot+1]`` is
   a contiguous view) and attends causally to everything the slot has
   cached (kernel K2 at ``q_offset`` = the chunk's start); the last chunk
   picks the request's first token, greedy or sampled;
3. runs one decode step over every slot (:meth:`BatchEngine._decode_body`,
   the JAX ``_batch_decode_step_jit``): a slot that is not decoding (free or
   mid-prefill) parks its write at the cache's last row and attends to its
   own token alone (``kv_len`` 1), so it touches nothing another request
   reads; the step runs ``decode_scan`` (K3 with the self column in every
   layer, one K4 commit of the L x ``max_slots`` new rows), then the argmax
   or, when any decoding slot samples, ``ops.sampling.sample_batch`` with
   each slot's temperature, top-k and top-p, drawing from the engine's
   ``torch.Generator`` (seeded by ``rng_seed``).

The decode step reads its tokens, lengths, active flags, LoRA adapter ids and
sampling parameters from one static buffer of ``max_slots`` rows that the
host fills before each step, and writes the next tokens into a static
buffer.  On a CUDA engine each step is one replay of a CUDA graph of the step
(:class:`~omchat_torch.runtime.cuda_graphs.GraphedStep`), one graph for the
greedy step and one for a step with any sampled slot (whose graph registers
the engine's generator): the counterpart of the JAX engine's one jitted
program.  :meth:`BatchEngine.precompile` captures both ahead of traffic;
``decode_graphs=False``, ``attn_impl="plain"`` and CPU engines run the same
body eagerly.  ``steps_graphed`` / ``steps_eager`` count the steps each way.

``lora_bank`` (:func:`~omchat_torch.training.lora.build_lora_bank`) serves
per-request LoRA: ``submit(adapter_id=)`` picks the request's adapter (0 the
base model); the prefill chunk applies its adapter and the decode step each
slot's own.  Images are encoded at submit (kernel K1 on CUDA) through the
encoded-image LRU (``image_cache_size`` entries, 0 disables it).

An MoE trunk (``cfg.text.is_moe``) runs its block's dense expert route, as
the JAX slot engine does; its LoRA bank adapts attention only.

``mesh`` (a pure tensor-parallel :class:`~omchat_torch.parallel.mesh.Mesh`;
:mod:`omchat_torch.parallel.serving`): ``params`` is this rank's shard, the
shared cache holds this rank's kv heads (split per
``parallel.sharding.kv_cache_specs(batch=max_slots)``, all of them where
tp does not divide them), K2's chunks, K3 and K4 run on them (once per run
of q heads that share a kv head there), and the logits are gathered over
the vocabulary, so every rank picks the same tokens.  A LoRA bank is given
whole and sharded like its targets; w8a8 chunks run the unfused chain; the
MoE trunk runs its experts' block a rank.  The steps run eagerly there (a gloo
collective cannot be captured); every rank must make the same calls.
Presence / frequency penalties raise ``NotImplementedError``: the JAX slot
engine has none either.
"""

from __future__ import annotations

import itertools
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from omchat_torch.config import GenerationConfig, OmChatConfig
from omchat_torch.models.decoder import decoder_forward
from omchat_torch.models.qwen2_moe import check_lora_bank
from omchat_torch.models.omchat import encode_images, fuse_embeddings, plan_multimodal_merge
from omchat_torch.models.qwen2 import KVCache, embed_tokens, gather_vocab, init_kv_cache, lm_head
from omchat_torch.ops.attention import PLAIN
from omchat_torch.ops.sampling import greedy, sample, sample_batch
from omchat_torch.parallel.serving import check_serving_mesh, replicated
from omchat_torch.parallel.sharding import shard_lora_bank
from omchat_torch.runtime.cuda_graphs import GraphedStep
from omchat_torch.runtime.feature_cache import ImageFeatureCache, cached_encode
from omchat_torch.utils.device import resolve_device

# the step buffer's columns: token, length, active, adapter id, do_sample,
# top_k, then temperature and top_p as fp32 bits
_STEP_COLS = 8


@dataclass
class _Request:
    request_id: int
    input_ids: List[int]
    image_features: Optional[torch.Tensor]
    max_new_tokens: int
    eos_token_id: int
    generation: Optional[GenerationConfig] = None
    # runtime state
    slot: Optional[int] = None
    prefill_pos: int = 0
    plan: Optional[object] = None
    generated: List[int] = field(default_factory=list)
    done: bool = False
    last_token: Optional[int] = None
    cancelled: bool = False  # cooperative: swept by the scheduler at tick start
    adapter_id: int = 0  # multi-LoRA bank index (0 = base model)

    @property
    def samples(self) -> bool:
        return self.generation is not None and self.generation.do_sample


class BatchEngine:
    """Continuous batching over a fixed slot pool.

    Usage:
        be = BatchEngine(cfg, params, max_slots=4, max_len=4096)
        rid = be.submit(input_ids, images=tiles)
        while not be.finished(rid):
            be.step()
        tokens = be.result(rid)
    """

    def __init__(
        self,
        cfg: OmChatConfig,
        params: dict,
        *,
        max_slots: int = 4,
        max_len: int = 4096,
        chunk_size: int = 512,
        attn_impl: Optional[str] = None,
        rng_seed: int = 0,
        mesh=None,
        cache_dtype: Optional[torch.dtype] = None,
        image_cache_size: int = 8,
        lora_bank: Optional[dict] = None,
        device=None,
        decode_graphs: bool = True,
    ):
        """``params`` already live on ``device`` (default CUDA; raises
        without it).  ``attn_impl``: None runs the hand-written kernels on
        CUDA tensors (their plain versions on CPU tensors), ``"plain"`` the
        plain reference attention and commits everywhere.  ``cache_dtype``:
        the shared cache's storage dtype, default the weights';
        ``torch.float8_e4m3fn`` halves its bytes.  ``lora_bank``: a stacked
        multi-adapter bank on the params' device.  ``decode_graphs``: a CUDA
        engine on the kernels replays a CUDA graph for each decode step
        (False: eagerly).  ``mesh``: tensor-parallel serving over this
        rank's shard (see the module docstring)."""
        check_serving_mesh(cfg, mesh, what="BatchEngine")
        check_lora_bank(cfg.text, lora_bank)
        self.mesh = mesh
        if attn_impl not in (None, PLAIN):
            raise ValueError(f"unknown attn_impl {attn_impl!r} (None or 'plain')")
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.max_slots = max_slots
        self.max_len = max_len
        # plans bucket to chunk_size; a chunk larger than the cache would make
        # every request "exceed max_len"
        self.chunk_size = min(chunk_size, max_len)
        self.attn_impl = attn_impl
        dtype = params["language_model"]["embed_tokens"].dtype
        self.cache = init_kv_cache(cfg.text, max_slots, max_len, dtype=cache_dtype or dtype, device=self.device,
                                   mesh=mesh)
        self._ids = itertools.count()
        self.queue: List[_Request] = []
        self.slots: List[Optional[_Request]] = [None] * max_slots
        self.requests: Dict[int, _Request] = {}
        # per-slot decode state (host mirrors)
        self._tokens = np.zeros(max_slots, np.int32)
        self._lengths = np.zeros(max_slots, np.int32)
        self.rng_seed = rng_seed
        self._generator = torch.Generator(device=self.device).manual_seed(rng_seed)
        self.lora_bank = shard_lora_bank(cfg.text, lora_bank, mesh)
        self.n_adapters = 0
        if lora_bank is not None:
            leaf = next(iter(next(iter(lora_bank["layers"].values())).values()))
            self.n_adapters = int(leaf["a"].shape[1]) - 1
        self._adapter_ids = np.zeros(max_slots, np.int32)
        self.image_cache = ImageFeatureCache(image_cache_size) if image_cache_size else None
        # the decode step's inputs, one row a slot, and its output
        cuda = self.device.type == "cuda"
        self._step_host = torch.zeros((max_slots, _STEP_COLS), dtype=torch.int32, pin_memory=cuda)
        self._step_dev = self._step_host.to(self.device) if cuda else self._step_host
        self._next = torch.zeros(max_slots, dtype=torch.int32, device=self.device)
        self.decode_graphs = decode_graphs
        self._graph_pool = torch.cuda.graph_pool_handle() if self.graphed() else None
        self._steps: dict = {}  # any sampled -> the step's GraphedStep, or its body
        self.steps_graphed = self.steps_eager = 0

    # -- client API ---------------------------------------------------------

    @replicated
    @torch.no_grad()
    def submit(
        self,
        input_ids: Sequence[int],
        images: Optional[np.ndarray] = None,
        max_new_tokens: int = 256,
        eos_token_id: int = 151645,
        generation: Optional[GenerationConfig] = None,
        image_cache_key: Optional[str] = None,
        adapter_id: int = 0,
    ) -> int:
        """``generation`` carries per-request sampling knobs (temperature /
        top-k / top-p); None or do_sample=False decodes greedily.

        ``image_cache_key``: identity for the encoded-image LRU (e.g. a hash
        of the compressed image bytes); host numpy images are content-hashed
        when no key is given (feature_cache.py).

        ``adapter_id``: multi-LoRA bank index (0 = base); needs a bank."""
        if not 0 <= adapter_id <= self.n_adapters:
            raise ValueError(f"adapter_id {adapter_id} out of range (bank has {self.n_adapters} adapters)")
        if generation is not None and (generation.presence_penalty or generation.frequency_penalty):
            raise NotImplementedError("BatchEngine: presence / frequency penalties wait for a later slice")
        feats = None
        if images is not None:
            feats = cached_encode(self.image_cache, images, image_cache_key, self._encode)
        req = _Request(next(self._ids), list(input_ids), feats, max_new_tokens, eos_token_id, generation,
                       adapter_id=adapter_id)
        plan = plan_multimodal_merge([req.input_ids], self.cfg.image_seq_len, bucket=self.chunk_size)
        # prefill writes cover the chunk-padded plan length; decode extends to
        # true_len + max_new — both extents must fit the slot cache
        if max(plan.max_len, int(plan.lengths[0]) + max_new_tokens) > self.max_len:
            raise ValueError("request exceeds max_len")
        req.plan = plan
        self.queue.append(req)
        self.requests[req.request_id] = req
        return req.request_id

    def _encode(self, pixel_values) -> torch.Tensor:
        """[N, 3, H, W] tiles → flattened [N*L, D] projected features."""
        pv = torch.as_tensor(np.asarray(pixel_values), device=self.device)
        feats = encode_images(self.params, self.cfg, pv, attn_impl=self.attn_impl, mesh=self.mesh)
        return feats.reshape(-1, feats.shape[-1])

    def finished(self, request_id: int) -> bool:
        return self.requests[request_id].done

    def result(self, request_id: int) -> List[int]:
        return list(self.requests[request_id].generated)

    def snapshot(self, request_id: int):
        """Thread-safe progress view: (tokens generated so far, finished)."""
        req = self.requests[request_id]
        return list(req.generated), req.done

    @replicated
    def pop_result(self, request_id: int):
        """Return (generated_ids, merged_prompt_len) and evict the request —
        long-running servers must evict or per-request state accumulates."""
        req = self.requests.pop(request_id)
        return list(req.generated), int(req.plan.lengths[0])

    @replicated
    def cancel(self, request_id: int) -> None:
        """Request early termination.  Only a flag is set here; the scheduler
        releases the slot at the start of its next tick."""
        self.requests[request_id].cancelled = True

    def _sweep_cancelled(self):
        for req in list(self.slots):
            if req is not None and req.cancelled and not req.done:
                self._release(req)
        if any(r.cancelled for r in self.queue):
            for req in [r for r in self.queue if r.cancelled]:
                req.done = True
            self.queue = [r for r in self.queue if not r.cancelled]

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def stats(self) -> dict:
        """Scheduler gauges for observability surfaces (serve.py /metrics)."""
        out = {
            "slots_busy": sum(r is not None for r in self.slots),
            "slots_total": self.max_slots,
            "queue_depth": len(self.queue),
        }
        if self.image_cache is not None:
            out.update({f"image_cache_{k}": v for k, v in self.image_cache.stats().items()})
        return out

    @replicated
    def run_to_completion(self, max_ticks: int = 100000) -> int:
        ticks = 0
        while self.has_work() and ticks < max_ticks:
            self.step()
            ticks += 1
        return ticks

    # -- scheduler ----------------------------------------------------------

    def _admit(self):
        for i in range(self.max_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                req.slot = i
                req.prefill_pos = 0
                self._adapter_ids[i] = req.adapter_id
                self.slots[i] = req

    def _release(self, req: _Request):
        self.slots[req.slot] = None
        req.slot = None
        req.done = True
        req.image_features = None  # drop the projected features' device memory

    @replicated
    @torch.no_grad()
    def step(self):
        """One scheduler tick: advance at most one prefill chunk for a joining
        request, then one decode step for every slot in decode phase."""
        self._sweep_cancelled()
        self._admit()

        # 1. advance the first slot still prefilling by one chunk
        for req in [r for r in self.slots if r is not None]:
            total = int(req.plan.lengths[0])
            if req.prefill_pos >= total:
                continue
            logits = self._prefill_chunk(req)
            req.prefill_pos += min(self.chunk_size, total - req.prefill_pos)
            if req.prefill_pos >= total:
                self._finish_prefill(req, self._first_token(req, logits))
            break  # one chunk per tick bounds decode-latency impact

        # 2. one decode step over slots in decode phase
        decoding = [r for r in self.slots
                    if r is not None and r.prefill_pos >= int(r.plan.lengths[0]) and r.last_token is not None]
        if not decoding:
            return
        next_np = self._decode(decoding)
        for r in decoding:
            tok = int(next_np[r.slot])
            self._lengths[r.slot] += 1
            r.last_token = tok
            if tok == r.eos_token_id:
                self._release(r)
                continue
            r.generated.append(tok)
            if len(r.generated) >= r.max_new_tokens:
                self._release(r)

    def _prefill_chunk(self, req: _Request) -> torch.Tensor:
        """Prefill the request's next chunk into its slot of the shared cache
        (the chunk padded to ``chunk_size`` rows); returns the logits [1, V]
        (fp32) of the chunk's last valid row."""
        lm = self.params["language_model"]
        dev = self.device
        plan, c0 = req.plan, req.prefill_pos
        csize = min(self.chunk_size, plan.max_len - c0)
        chunk_len = min(self.chunk_size, int(plan.lengths[0]) - c0)

        def cut(a):
            return torch.as_tensor(np.pad(a[:, c0: c0 + csize], ((0, 0), (0, self.chunk_size - csize))), device=dev)

        embeds = fuse_embeddings(self.params, cut(plan.token_ids), cut(plan.is_image), cut(plan.image_index),
                                 req.image_features, self.mesh, self.cfg.text.vocab_size)
        s = req.slot
        slot_cache = KVCache(self.cache.k[:, s: s + 1], self.cache.v[:, s: s + 1])
        ids = None
        if self.lora_bank is not None:
            ids = torch.full((1,), req.adapter_id, dtype=torch.int64, device=dev)
        hidden, _ = decoder_forward(
            lm, self.cfg.text, embeds, cut(plan.positions), slot_cache,
            write_pos=torch.full((1,), c0, dtype=torch.int32, device=dev),
            kv_len=torch.full((1,), c0 + chunk_len, dtype=torch.int32, device=dev),
            attn_impl=self.attn_impl, lora_bank=self.lora_bank, adapter_ids=ids, mesh=self.mesh,
        )
        return self._logits(hidden[:, max(chunk_len - 1, 0)])

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The whole vocabulary's logits (fp32) on every rank: the rank's
        vocabulary block, gathered over a mesh."""
        tc = self.cfg.text
        return gather_vocab(lm_head(self.params["language_model"], tc, hidden), tc.vocab_size, self.mesh)

    def _first_token(self, req: _Request, logits: torch.Tensor) -> int:
        if req.samples:
            return int(sample(logits, self._generator, req.generation)[0])
        return int(greedy(logits)[0])

    def _finish_prefill(self, req: _Request, first: int) -> None:
        """Record the first token and start decoding, or release at eos or
        a one-token budget."""
        req.last_token = first
        self._lengths[req.slot] = int(req.plan.lengths[0])
        if first == req.eos_token_id:
            self._release(req)
            return
        req.generated.append(first)
        if len(req.generated) >= req.max_new_tokens:
            self._release(req)

    # -- the decode step ------------------------------------------------------

    def graphed(self) -> bool:
        """Whether decode steps replay CUDA graphs (a CUDA engine on the
        kernels with ``decode_graphs``, on one rank: under a mesh of tp > 1
        the steps run eagerly)."""
        return (self.decode_graphs and self.device.type == "cuda" and self.attn_impl != PLAIN
                and (self.mesh is None or self.mesh.axis_size("model") == 1))

    def _stage(self, tokens, lengths, active, adapter_ids, sampling: np.ndarray) -> None:
        """Copy a step's host inputs ([S] tokens, lengths, active, adapter
        ids; [S, 4] sampling rows) into the static buffer the step reads: one
        asynchronous copy from pinned memory on CUDA (the last step's copy
        is done: its tokens were read back)."""
        h = self._step_host.numpy()
        h[:, 0], h[:, 1], h[:, 2], h[:, 3] = tokens, lengths, active, adapter_ids
        h[:, 4], h[:, 5] = sampling[:, 0], sampling[:, 1]
        h[:, 6:8] = np.ascontiguousarray(sampling[:, 2:]).view(np.int32)
        if self._step_dev is not self._step_host:
            self._step_dev.copy_(self._step_host, non_blocking=True)

    def _sampling_rows(self, decoding) -> np.ndarray:
        """[S, 4] fp32 host rows of the step's per-slot pick parameters:
        do_sample, top_k, temperature, top_p (neutral for greedy slots)."""
        rows = np.zeros((self.max_slots, 4), np.float32)
        rows[:, 2:] = 1.0
        for r in decoding:
            if r.samples:
                g = r.generation
                rows[r.slot] = (1.0, g.top_k, g.temperature, g.top_p)
        return rows

    def _decode_body(self, sampled: bool) -> torch.Tensor:
        """One decode step over all slots on the staged buffer (the step a
        graph captures): inactive slots write at ``max_len - 1`` with
        ``kv_len`` 1; the trunk's ``decode_scan`` (K3 in every layer, one
        K4 commit), lm_head, then the pick.  Writes the next tokens into the
        static output and returns it."""
        lm = self.params["language_model"]
        b = self._step_dev
        tokens, lengths, active = b[:, 0], b[:, 1], b[:, 2] != 0
        wp = torch.where(active, lengths, self.max_len - 1)
        embeds = embed_tokens(lm, tokens[:, None], self.mesh, self.cfg.text.vocab_size)
        hidden, _ = decoder_forward(
            lm, self.cfg.text, embeds, wp[:, None], self.cache,
            write_pos=wp, kv_len=torch.where(active, lengths + 1, 1), attn_impl=self.attn_impl,
            lora_bank=self.lora_bank, adapter_ids=b[:, 3].long() if self.lora_bank is not None else None,
            mesh=self.mesh,
        )
        logits = self._logits(hidden)[:, 0]
        if sampled:
            nxt = sample_batch(logits, self._generator, do_sample=b[:, 4] != 0, top_k=b[:, 5],
                               temperature=b[:, 6].view(torch.float32), top_p=b[:, 7].view(torch.float32))
        else:
            nxt = greedy(logits)
        self._next.copy_(nxt)
        return self._next

    def _step_fn(self, sampled: bool):
        """The decode step for ``sampled`` (any slot samples): a GraphedStep
        on a graphed engine (the sampled one registers the engine's
        generator), else its body."""
        step = self._steps.get(sampled)
        if step is None:
            engine = weakref.ref(self)  # weak: a deleted engine is freed at once, not by the collector
            body = lambda: engine()._decode_body(sampled)  # noqa: E731
            if self.graphed():
                step = GraphedStep(body, self._graph_pool, self.device,
                                   generators=(self._generator,) if sampled else ())
            else:
                step = body
            self._steps[sampled] = step
        return step

    def _decode(self, decoding) -> np.ndarray:
        """Stage and run one decode step for the ``decoding`` requests;
        returns every slot's next token (host)."""
        active = np.zeros(self.max_slots, np.int32)
        for r in decoding:
            self._tokens[r.slot] = r.last_token
            active[r.slot] = 1
        self._stage(self._tokens, self._lengths, active, self._adapter_ids, self._sampling_rows(decoding))
        step = self._step_fn(any(r.samples for r in decoding))
        out = step()
        if isinstance(step, GraphedStep):
            self.steps_graphed += 1
        else:
            self.steps_eager += 1
        return out.cpu().numpy()

    @replicated
    @torch.no_grad()
    def precompile(self) -> None:
        """Capture the greedy and the sampled decode step ahead of traffic:
        each follows one step over parked slots (nothing active, every write
        on the cache's last row); the generator is seeded again afterwards,
        so that precompiling leaves the draws of the traffic after it
        unchanged.  On a CPU engine, or without graphs, each runs eagerly
        once."""
        zeros = np.zeros(self.max_slots, np.int32)
        for sampled in (False, True):
            step = self._step_fn(sampled)
            if isinstance(step, GraphedStep) and step.graph is not None:
                continue
            self._stage(zeros, zeros, zeros, zeros, self._sampling_rows([]))
            step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._generator.manual_seed(self.rng_seed)

    @replicated
    def reset_latency_stats(self) -> None:
        """Clear the counts of graphed and eager steps (after a warm-up)."""
        self.steps_graphed = self.steps_eager = 0
