"""Prompt-lookup speculative decoding — exact greedy, fewer decode steps
(PyTorch port of ``omchat_tpu/runtime/speculative.py``).

Draft tokens are proposed by matching the tail n-gram of the sequence
against its own earlier content (prompt lookup — no draft model), then
verified in ONE forward over the KV cache: ``1 + draft_len`` rows at
``write_pos = kv_len`` (on CUDA, K2 with those rows at ``q_offset = kv_len``;
under w8a8 the trunk's glue kernels at that many rows).  The verify step
runs eagerly.  Greedy outputs are those of step-by-step decoding (up to the
argmax of two kernel routes agreeing); the win is fewer sequential device
steps on continuations that echo the prompt.

Cache discipline: the verify forward writes all K+1 candidate entries at
``write_pos = kv_len``; rejected entries are garbage beyond the accepted
length and are overwritten by the next step's writes (the cache is
addressed by explicit write_pos / masked by kv_len everywhere).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from omchat_torch.config import GenerationConfig
from omchat_torch.models.decoder import decoder_forward
from omchat_torch.models.qwen2 import KVCache, embed_tokens, full_logits
from omchat_torch.ops.sampling import greedy
from omchat_torch.parallel.serving import agreed


def propose_draft(token_ids: Sequence[int], ngram: int = 2, k: int = 8) -> List[int]:
    """Propose up to ``k`` draft tokens by matching the trailing ``ngram``
    against the most recent earlier occurrence in ``token_ids``."""
    n = len(token_ids)
    if n <= ngram:
        return []
    tail = tuple(token_ids[-ngram:])
    # scan backwards for the most recent earlier match
    for start in range(n - ngram - 1, -1, -1):
        if tuple(token_ids[start: start + ngram]) == tail:
            return list(token_ids[start + ngram: start + ngram + k])
    return []


@torch.no_grad()
def verify_step(engine, tokens: torch.Tensor, write_pos: torch.Tensor, cache: KVCache):
    """Run [B, S] candidate tokens against the cache at ``write_pos`` [B]:
    returns the logits of every position [B, S, V] fp32 (the cache is
    written in place)."""
    lm = engine.params["language_model"]
    tc, mesh = engine.cfg.text, engine.mesh
    s = tokens.shape[1]
    positions = write_pos[:, None] + torch.arange(s, dtype=torch.int32, device=tokens.device)[None, :]
    hidden, _ = decoder_forward(lm, tc, embed_tokens(lm, tokens, mesh, tc.vocab_size), positions, cache,
                                write_pos=write_pos, kv_len=write_pos + s, attn_impl=engine.attn_impl, mesh=mesh)
    return full_logits(lm, tc, hidden, mesh)


def draft_context(input_ids: Sequence[int]) -> List[int]:
    """The lookup context of a prompt: its true (unexpanded) token ids."""
    return [t for t in input_ids if t >= 0]


@torch.no_grad()
def generate_speculative(
    engine,
    input_ids: Sequence[int],
    images=None,
    generation: Optional[GenerationConfig] = None,
    *,
    ngram: int = 2,
    draft_len: int = 8,
    stream_callback=None,
    draft_fn=None,
    logits_callback=None,
):
    """Greedy generation with prompt-lookup speculation (single sequence).

    Returns (generated_ids, num_device_steps) — the ids are
    ``engine.generate``'s greedy output; num_device_steps shows the saving.
    ``stream_callback`` receives each accepted token id (tokens arrive in
    bursts of 1 + n_accepted rather than one per step).
    ``draft_fn(context) -> List[int]`` overrides the prompt-lookup proposer
    (``context`` is prompt + generated so far), e.g. an oracle draft that
    measures the verify machinery's ceiling.  ``logits_callback(kv_len,
    tokens, logits)`` sees each verify step: the cache length it started
    from, its input ids (the last token, the draft, padding) and their
    [S, V] logits."""
    gen = generation or GenerationConfig()
    if gen.do_sample:
        raise ValueError("speculative decoding is greedy-only")
    dev = engine.device
    feats = engine.encode_images(images) if images is not None else None
    plan = engine.plan([input_ids])
    logits, cache = engine.prefill(plan, feats, gen.max_new_tokens + draft_len + 1)

    last = int(greedy(logits)[0])
    kv_len = int(plan.lengths[0])
    context = draft_context(input_ids)
    generated: List[int] = []
    steps = 0

    if last == gen.eos_token_id:
        return generated, steps
    generated.append(last)
    context.append(last)
    if stream_callback is not None:
        stream_callback(last)

    # a caller's draft_fn is a host decision every rank of a mesh takes from its leader
    propose = agreed(engine.mesh, draft_fn) or (lambda ctx: propose_draft(ctx, ngram=ngram, k=draft_len))
    while len(generated) < gen.max_new_tokens:
        draft = propose(context)[:draft_len]
        budget = gen.max_new_tokens - len(generated)
        draft = draft[: max(0, min(len(draft), budget))]
        # a fixed [1, 1 + draft_len] shape; padded positions are never
        # accepted (acceptance is bounded by len(draft))
        padded = [last] + list(draft) + [0] * (draft_len - len(draft))
        step_logits = verify_step(engine, torch.tensor([padded], dtype=torch.int32, device=dev),
                                  torch.tensor([kv_len], dtype=torch.int32, device=dev), cache)
        steps += 1
        if logits_callback is not None:
            logits_callback(kv_len, padded, step_logits[0])
        g = greedy(step_logits[0]).cpu().tolist()  # greedy continuation after each input position
        # accept the longest draft prefix the model agrees with, then take the
        # model's own next token (the "bonus" token on full acceptance)
        n_acc = 0
        while n_acc < len(draft) and draft[n_acc] == int(g[n_acc]):
            n_acc += 1
        new_tokens = [int(t) for t in draft[:n_acc]] + [int(g[n_acc])]

        done = False
        for t in new_tokens:
            if t == gen.eos_token_id:
                done = True
                break
            generated.append(t)
            context.append(t)
            if stream_callback is not None:
                stream_callback(t)
            if len(generated) >= gen.max_new_tokens:
                done = True
                break
        if done:
            break
        kv_len += 1 + n_acc  # entries actually consumed (last + accepted draft)
        last = generated[-1]
    return generated, steps
