"""Generation runtime: prefill, decode step and a host streaming loop —
PyTorch port of the single-request path of ``omchat_tpu/runtime/generate.py``.

Prefill fills a cache of the bucketed prompt length plus the bucketed decode
budget and returns the first-token logits; each decode step runs the whole
trunk for one token against the read-only cache and commits the new rows
once.  Greedy decoding only; sampling, logprobs, penalties, constrained and
speculative decoding, chunked prefill and the on-device decode loop come with
later slices.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

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
from omchat_torch.ops.sampling import greedy
from omchat_torch.utils.device import resolve_device

PROMPT_BUCKET = 128  # merged prompts and the decode budget round up to multiples of this


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


class OmChatEngine:
    """The generation engine: prompts arrive as input_ids with ``-200`` sentinels
    plus a stack of image tiles (single_inference.py:43-62).

    ``params`` already live on ``device`` (default CUDA; raises without it).
    ``attn_impl=None`` runs the hand-written kernels on CUDA tensors (their
    plain versions on CPU tensors); ``"plain"`` runs the plain reference
    attention everywhere — chosen only explicitly.

    After :meth:`generate`, ``spans`` holds the stage times in seconds
    (``encode_images``, ``prefill``, ``ttft``, ``decode``), ``decode_steps``
    and the ``cache_len`` in rows; on CUDA every stage ends in a synchronize."""

    def __init__(
        self,
        cfg: OmChatConfig,
        params: dict,
        *,
        attn_impl: Optional[str] = None,
        device=None,
    ):
        self.cfg = cfg
        self.params = params
        self.attn_impl = attn_impl
        self.device = resolve_device(device)
        self.spans: dict = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- stages ------------------------------------------------------------

    @torch.no_grad()
    def encode_images(self, pixel_values) -> torch.Tensor:
        """[N, 3, H, W] tiles → flattened [N*L, D] projected features."""
        pv = torch.as_tensor(np.asarray(pixel_values), device=self.device)
        feats = encode_images(self.params, self.cfg, pv, attn_impl=self.attn_impl)
        return feats.reshape(-1, feats.shape[-1])

    def plan(self, batch_input_ids) -> MergePlan:
        return plan_multimodal_merge(
            batch_input_ids, self.cfg.image_seq_len, bucket=PROMPT_BUCKET,
            max_length=self.cfg.tokenizer_model_max_length,
        )

    @torch.no_grad()
    def prefill(self, plan: MergePlan, image_features: Optional[torch.Tensor], max_new_tokens: int):
        """Fuse embeddings, run the trunk over the merged prompt into a fresh
        cache; returns (last-valid-token logits [B, V] fp32, cache)."""
        lm = self.params["language_model"]
        dev = self.device
        cache_len = plan.max_len + round_up_to_bucket(max_new_tokens, PROMPT_BUCKET)
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        embeds = fuse_embeddings(self.params, t(plan.token_ids), t(plan.is_image), t(plan.image_index), image_features)
        b = embeds.shape[0]
        cache = init_kv_cache(self.cfg.text, b, cache_len, dtype=embeds.dtype, device=dev)
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
        """Greedy decode with host streaming.

        images: [N_total_tiles, 3, H, W] across the batch's sentinels, in
        sentinel order.  ``logits_callback(step, logits)`` sees each step's
        [B, V] fp32 logits before the token is picked."""
        gen = generation or GenerationConfig()
        if gen.do_sample or gen.presence_penalty or gen.frequency_penalty:
            raise NotImplementedError("sampling and penalties wait for a later slice; the port decodes greedily")
        stopper = KeywordStopper(stop_keywords, tokenizer) if stop_keywords else None
        self.spans = {}
        t0 = time.perf_counter()
        feats = self.encode_images(images) if images is not None else None
        self._sync()
        t1 = time.perf_counter()
        self.spans["encode_images"] = t1 - t0
        plan = self.plan(batch_input_ids)
        logits, cache = self.prefill(plan, feats, gen.max_new_tokens)
        self._sync()
        self.spans["prefill"] = time.perf_counter() - t1

        b = plan.token_ids.shape[0]
        kv_len = torch.as_tensor(plan.lengths, device=self.device)
        generated: List[List[int]] = [[] for _ in range(b)]
        done = np.zeros(b, bool)
        steps = 0
        t_dec = time.perf_counter()
        for step in range(gen.max_new_tokens):
            if logits_callback is not None:
                logits_callback(step, logits)
            tokens = greedy(logits)
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
            logits, cache = self.decode_step(tokens, kv_len, cache)
            kv_len = kv_len + 1
            steps += 1
        self._sync()
        self.spans["decode"] = time.perf_counter() - t_dec
        self.spans["decode_steps"] = steps
        self.spans["cache_len"] = cache.max_len
        return GenerateOutput(token_ids=generated, prompt_len=plan.lengths)
