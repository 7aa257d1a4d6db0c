"""Token selection: greedy, temperature, top-k and top-p (PyTorch port of
``omchat_tpu/ops/sampling.py``).

The thresholds are the JAX package's, computed the same way; only the final
categorical draw differs, because it comes from an explicit
:class:`torch.Generator` (Gumbel-max over the kept logits) where JAX splits a
PRNG key.  Nothing here reads a tensor back to the host, so a decode roll
that samples stays on the device."""

from __future__ import annotations

import torch

from omchat_torch.config import GenerationConfig


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """[B, V] → [B] argmax token ids (int32; ties go to the first index)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.tensor(float("-inf"), device=logits.device), logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep the smallest prefix with cumulative prob >= p (always keep top-1)
    keep = cum - probs < p
    threshold = torch.where(keep, sorted_logits, torch.tensor(float("inf"), device=logits.device))
    threshold = threshold.amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, torch.tensor(float("-inf"), device=logits.device), logits)


def categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits) ([B, V] → [B] int32), by
    Gumbel-max: argmax(logits - log(E)) with E ~ Exp(1) from ``generator``.
    Rows of -inf logits other than the kept ones are never drawn."""
    e = torch.empty(logits.shape, dtype=torch.float32, device=logits.device).exponential_(generator=generator)
    return torch.argmax(logits.float() - torch.log(e), dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, generator: torch.Generator, cfg: GenerationConfig) -> torch.Tensor:
    """[B, V] → [B] next tokens per the generation config."""
    if not cfg.do_sample:
        return greedy(logits)
    logits = logits / max(cfg.temperature, 1e-6)
    logits = apply_top_k(logits, cfg.top_k)
    logits = apply_top_p(logits, cfg.top_p)
    return categorical(logits, generator)


def sample_batch_logits(logits, temperature, top_k, top_p) -> torch.Tensor:
    """The kept logits of :func:`sample_batch`: scaled by the per-row
    temperature, everything below the larger of the top-k and top-p
    thresholds (both read off one descending sort) set to -inf."""
    v = logits.shape[-1]
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    # top-k threshold: value at rank k-1 (k <= 0 keeps everything)
    k_idx = torch.clamp(top_k.long() - 1, 0, v - 1)
    kth = torch.gather(sorted_desc, 1, k_idx[:, None])
    ninf = torch.tensor(float("-inf"), device=logits.device)
    kth = torch.where(top_k[:, None] > 0, kth, ninf)
    # top-p threshold on the same sort
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_p[:, None]  # always keeps rank 0
    pth = torch.where(keep, sorted_desc, torch.tensor(float("inf"), device=logits.device)).amin(dim=-1, keepdim=True)
    return torch.where(scaled < torch.maximum(kth, pth), ninf, scaled)


def sample_batch(
    logits: torch.Tensor,
    generator: torch.Generator,
    do_sample: torch.Tensor,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
) -> torch.Tensor:
    """Per-row mixed greedy/sampled decoding for continuous batching.

    Every slot of a serving batch carries its own request's generation
    params: do_sample [B] bool, temperature/top_p [B] fp32, top_k [B] int32
    (<= 0 disables).  Greedy rows take the plain argmax."""
    sampled = categorical(sample_batch_logits(logits, temperature, top_k, top_p), generator)
    return torch.where(do_sample, sampled, greedy(logits))
