"""Normalization ops (PyTorch port of ``omchat_tpu/ops/norms.py``).

Statistics in float32, output cast back to the input dtype (reference:
modeling_intern_vit.py:33-44 InternRMSNorm, HF Qwen2RMSNorm).  The fused
w8a8 quantization kernels come with the w8a8 slice.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis; fp32 statistics, output in x.dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (scale.float() * xf).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis; fp32 statistics (InternViT-300M norm_type)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * scale.float() + bias.float()).to(x.dtype)


def apply_norm(x: torch.Tensor, params: dict, eps: float = 1e-6) -> torch.Tensor:
    """Dispatch on the param dict: {'scale'} → RMSNorm, {'scale','bias'} → LayerNorm."""
    if "bias" in params:
        return layer_norm(x, params["scale"], params["bias"], eps)
    return rms_norm(x, params["scale"], eps)
