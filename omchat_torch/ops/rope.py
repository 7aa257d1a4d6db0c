"""Rotary position embeddings with the reference's long-context scaling
(PyTorch port of ``omchat_tpu/ops/rope.py``).

Linear RoPE scaling (modeling_llama.py:156-172) and dynamic-NTK scaling
(modeling_llama.py:175-198), HF "rotate_half" layout.  cos/sin are computed in
float32 and cast to the activation dtype before they touch q/k, as the JAX
module does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from omchat_torch.config import RopeScalingConfig


def rope_frequencies(
    head_dim: int,
    theta: float = 1_000_000.0,
    scaling: Optional[RopeScalingConfig] = None,
    seq_len: Optional[torch.Tensor] = None,
    max_position_embeddings: int = 32768,
    device=None,
) -> torch.Tensor:
    """Inverse frequencies [head_dim/2] (float32), with optional NTK rescaling.

    Dynamic-NTK recomputes theta when seq_len exceeds max_position_embeddings
    (reference: modeling_llama.py:184-196); ``seq_len`` may be a tensor of any
    leading shape (one trigger per sequence)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    if scaling is not None and scaling.rope_type == "dynamic" and seq_len is not None:
        seq_len = seq_len.to(torch.float32)
        rescale = (scaling.factor * seq_len / max_position_embeddings) - (scaling.factor - 1)
        theta_eff = torch.where(
            seq_len > max_position_embeddings,
            theta * torch.clamp(rescale, min=1.0) ** (head_dim / (head_dim - 2)),
            torch.full_like(seq_len, theta),
        )
        return 1.0 / (theta_eff**exponent)
    return 1.0 / (theta**exponent)


def rope_cos_sin(
    positions: torch.Tensor,
    head_dim: int,
    theta: float = 1_000_000.0,
    scaling: Optional[RopeScalingConfig] = None,
    max_position_embeddings: int = 32768,
    dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer ``positions`` [..., S], each [..., S, head_dim]."""
    # dynamic-NTK triggers per sequence (last axis), not batch-globally
    seq_len = positions.amax(dim=-1, keepdim=True) + 1  # [..., 1]
    inv_freq = rope_frequencies(
        head_dim, theta, scaling, seq_len=seq_len[..., None],
        max_position_embeddings=max_position_embeddings, device=positions.device,
    )  # [..., 1, head_dim/2] when scaled, [head_dim/2] otherwise
    pos = positions.to(torch.float32)
    if scaling is not None and scaling.rope_type == "linear":
        pos = pos / scaling.factor
    freqs = pos[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """q/k: [B, S, H, D]; cos/sin: [B, S, D] or [S, D]."""
    if cos.dim() == q.dim() - 1:
        cos = cos[..., None, :]  # broadcast over heads
        sin = sin[..., None, :]
    cos = cos.to(q.dtype)
    sin = sin.to(q.dtype)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
