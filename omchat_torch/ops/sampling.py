"""Token selection (PyTorch port of ``omchat_tpu/ops/sampling.py:17``).

The reference's live entry points decode greedily (single_inference.py:52-62);
sampling comes with a later slice."""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """[B, V] → [B] argmax token ids (int32)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
