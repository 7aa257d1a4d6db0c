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
    """[B, V] → [B] next tokens per the generation config: greedy, or
    :func:`sample_from` with the config's parameters (temperature clamped to
    1e-6)."""
    if not cfg.do_sample:
        return greedy(logits)
    dev = logits.device
    return sample_from(logits, generator, torch.tensor([max(cfg.temperature, 1e-6)], dtype=torch.float32, device=dev),
                       torch.tensor([cfg.top_k], dtype=torch.int32, device=dev),
                       torch.tensor([cfg.top_p], dtype=torch.float32, device=dev))


def sample_from(logits: torch.Tensor, generator: torch.Generator, temperature: torch.Tensor, top_k: torch.Tensor,
                top_p: torch.Tensor) -> torch.Tensor:
    """A sampled pick with its parameters in tensors (temperature, top_p [1]
    fp32, temperature already clamped; top_k [1] int32), so that a captured
    decode step reads them from buffers: temperature, then :func:`apply_top_k`,
    then :func:`apply_top_p` (the JAX package's order), bit for bit, then the
    draw from ``generator``.  One descending sort gives the top-k threshold
    (the value at rank k-1; k <= 0 keeps every token) and, with the tokens
    below it set to -inf (the sort of :func:`apply_top_k`'s output), the
    top-p threshold over that renormalised prefix (p >= 1 keeps every token).
    Its constants are Python scalars: a CUDA graph capture takes no
    host-to-device copy."""
    v = logits.shape[-1]
    ninf = float("-inf")
    scaled = logits / temperature
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, 1, torch.clamp(top_k.long() - 1, 0, v - 1).expand(scaled.shape[0])[:, None])
    kth = torch.where(top_k > 0, kth, ninf)
    kept = torch.where(scaled < kth, ninf, scaled)
    sorted_kept = torch.where(sorted_desc < kth, ninf, sorted_desc)
    probs = torch.softmax(sorted_kept, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    pth = torch.where(cum - probs < top_p, sorted_kept, float("inf")).amin(dim=-1, keepdim=True)
    pth = torch.where(top_p >= 1.0, ninf, pth)
    return categorical(torch.where(kept < pth, ninf, kept), generator)


def sample_batch_logits(logits, temperature, top_k, top_p) -> torch.Tensor:
    """The kept logits of :func:`sample_batch`: scaled by the per-row
    temperature, everything below the larger of the top-k and top-p
    thresholds (both read off one descending sort) set to -inf.  Its
    constants are Python scalars, so a captured decode roll takes no
    host-to-device copy."""
    v = logits.shape[-1]
    ninf = float("-inf")
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    # top-k threshold: value at rank k-1 (k <= 0 keeps everything)
    k_idx = torch.clamp(top_k.long() - 1, 0, v - 1)
    kth = torch.gather(sorted_desc, 1, k_idx[:, None])
    kth = torch.where(top_k[:, None] > 0, kth, ninf)
    # top-p threshold on the same sort
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_p[:, None]  # always keeps rank 0
    pth = torch.where(keep, sorted_desc, float("inf")).amin(dim=-1, keepdim=True)
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
