"""Beam-search decoding (PyTorch port of ``omchat_tpu/runtime/beam_search.py``).

The reference's beam machinery (``BeamHypotheses``,
multimodal_encoder/utils.py:756-913, dead) and HF ``generate(num_beams=...)``
equivalent, recast for the static-cache engine: beams ride the batch
dimension of one decode state (:meth:`OmChatEngine.decode_state`), whose
cache rows are re-gathered in place to the surviving beams' parents each
step, so that the state's graphed step (K3 over ``num_beams`` rows, then K4)
keeps reading the addresses it was captured on.  Length-penalized,
eos-finalized."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from omchat_torch.config import GenerationConfig
from omchat_torch.models.qwen2 import KVCache


@dataclass
class BeamHypotheses:
    """Running best-finished-hypotheses pool (length-penalized)."""

    num_beams: int
    length_penalty: float = 1.0
    beams: List[Tuple[float, List[int]]] = None

    def __post_init__(self):
        self.beams = []

    def add(self, tokens: List[int], sum_logprob: float):
        score = sum_logprob / (max(len(tokens), 1) ** self.length_penalty)
        self.beams.append((score, tokens))
        self.beams.sort(key=lambda x: -x[0])
        del self.beams[self.num_beams:]

    def worst_score(self) -> float:
        return self.beams[-1][0] if len(self.beams) >= self.num_beams else -1e18

    def is_done(self, best_possible: float) -> bool:
        return len(self.beams) >= self.num_beams and best_possible <= self.worst_score()


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` as raw bytes when it is an fp8 cache (which ``index_select``
    does not take), else itself."""
    return t.view(torch.uint8) if t.element_size() == 1 else t


def gather_beams(cache: KVCache, parent: torch.Tensor) -> None:
    """Reorder the cache's batch dim to the surviving beams' parents, in
    place (the stacked cache [L, B, KVH, T, D] keeps its storage)."""
    for t in cache:
        _bits(t).copy_(_bits(t).index_select(1, parent))


def _log_softmax(logits: torch.Tensor) -> np.ndarray:
    return torch.log_softmax(logits.float(), dim=-1).cpu().numpy()


@torch.no_grad()
def beam_search(
    engine,
    input_ids: Sequence[int],
    images=None,
    *,
    num_beams: int = 4,
    max_new_tokens: int = 128,
    eos_token_id: int = 151645,
    length_penalty: float = 1.0,
    score_callback=None,
) -> List[int]:
    """Beam-search one prompt; returns the best hypothesis' generated ids.
    ``score_callback(step, scores, tokens)`` sees each step's surviving beams:
    their scores [beams] and generated ids."""
    dev = engine.device
    feats = engine.encode_images(images) if images is not None else None
    # replicate the prompt over the beam dimension (prefill once per beam)
    plan = engine.plan([list(input_ids)] * num_beams)
    st = engine.decode_state(num_beams, engine.cache_rows(plan, max_new_tokens))
    logits, _ = engine.prefill(plan, None if feats is None else feats.repeat(num_beams, 1), max_new_tokens,
                               cache=st.cache)
    engine._start(st, plan.lengths, GenerationConfig(max_new_tokens=max_new_tokens, eos_token_id=eos_token_id))
    run = st.run
    lp = _log_softmax(logits)
    vocab = lp.shape[-1]

    beam_scores = np.full(num_beams, -1e18, np.float64)
    beam_scores[0] = 0.0  # all beams start identical; keep one alive
    beam_tokens: List[List[int]] = [[] for _ in range(num_beams)]
    hyps = BeamHypotheses(num_beams, length_penalty)
    cache, kv_len = None, None  # an eager cache once fewer than num_beams beams survive

    for step in range(max_new_tokens):
        total = beam_scores[:, None] + lp  # [beams, V]
        flat = total.reshape(-1)
        # 2*num_beams candidates so eos picks don't starve the frontier
        top = np.argpartition(-flat, 2 * num_beams)[: 2 * num_beams]
        top = top[np.argsort(-flat[top])]

        next_parents, next_tokens, next_scores = [], [], []
        for cand in top:
            parent, tok = divmod(int(cand), vocab)
            score = float(flat[cand])
            if tok == eos_token_id:
                hyps.add(list(beam_tokens[parent]), score)
            else:
                next_parents.append(parent)
                next_tokens.append(tok)
                next_scores.append(score)
            if len(next_parents) == num_beams:
                break

        best_possible = float(np.max(next_scores)) / (max(step + 1, 1) ** length_penalty) if next_scores else -1e18
        if hyps.is_done(best_possible) or not next_parents or step == max_new_tokens - 1:
            for parent, tok, score in zip(next_parents, next_tokens, next_scores):
                hyps.add(beam_tokens[parent] + [tok], score)
            break

        beam_tokens = [beam_tokens[p] + [t] for p, t in zip(next_parents, next_tokens)]
        beam_scores = np.asarray(next_scores)
        if score_callback is not None:
            score_callback(step, beam_scores.copy(), [list(t) for t in beam_tokens])
        parents = torch.as_tensor(next_parents, dtype=torch.long, device=dev)
        tokens = torch.as_tensor(next_tokens, dtype=torch.int32, device=dev)
        if cache is None and len(next_parents) == num_beams:
            gather_beams(st.cache, parents)
            st.tokens.copy_(tokens)
            lp = _log_softmax(run())
            continue
        # fewer beams than the state holds: go on eagerly over a gathered cache
        if cache is None:
            cache, kv_len = st.cache, st.kv_len.clone()
        cache = KVCache(*(_bits(t).index_select(1, parents).view(t.dtype) for t in cache))
        kv_len = kv_len.index_select(0, parents)
        step_logits, cache = engine.decode_step(tokens, kv_len, cache)
        kv_len = kv_len + 1
        lp = _log_softmax(step_logits)

    return hyps.beams[0][1] if hyps.beams else beam_tokens[0]
