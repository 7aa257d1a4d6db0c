"""Multimodal projector — PyTorch port of ``omchat_tpu/models/projector.py``.

Types linear, mlpNx_gelu and identity (reference builder.py:39-66); the
flagship checkpoint's projector is Linear(3200→3584) + GELU +
Linear(3584→3584) (``linear_1``/``linear_2``).  Quantized linears run
weight-only int8 through ``dense``, in w8a8 too, as in the JAX package.
cabstract and the MoE-LLaVA sparse projector come with a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from omchat_torch.config import ProjectorConfig
from omchat_torch.ops.linear import dense


def _mlp(params: dict, x: torch.Tensor, mlp_depth: int) -> torch.Tensor:
    x = dense(x, params["linear_1"])
    for i in range(2, mlp_depth + 1):
        x = F.gelu(x)  # exact erf GELU
        x = dense(x, params[f"linear_{i}"])
    return x


def projector_forward(params: dict, cfg: ProjectorConfig, features: torch.Tensor) -> torch.Tensor:
    """[..., mm_hidden] → [..., hidden]."""
    t = cfg.projector_type
    if t == "identity":
        return features
    if t == "linear":
        return dense(features, params["linear_1"])
    if t == "cabstract" or cfg.mlp_smoe:
        raise NotImplementedError(f"projector {t!r} (smoe={cfg.mlp_smoe}) waits for a later slice")
    return _mlp(params, features, cfg.mlp_depth)


def init_params(cfg: ProjectorConfig, mm_hidden: int, hidden: int, generator: torch.Generator,
                dtype=torch.float32, device=None) -> dict:
    """Random weights from a seeded generator (normal(0, 0.02) kernels, zero bias)."""
    if cfg.projector_type == "identity":
        return {}
    device = device if device is not None else generator.device

    def lin(i, o):
        return {
            "kernel": torch.randn((i, o), generator=generator, device=device, dtype=dtype).mul_(0.02),
            "bias": torch.zeros((o,), dtype=dtype, device=device),
        }

    params = {"linear_1": lin(mm_hidden, hidden)}
    if cfg.projector_type == "linear":
        return params
    for i in range(2, cfg.mlp_depth + 1):
        params[f"linear_{i}"] = lin(hidden, hidden)
    return params
