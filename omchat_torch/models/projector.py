"""Multimodal projector — PyTorch port of ``omchat_tpu/models/projector.py``.

Types linear, mlpNx_gelu, cabstract and identity (reference
builder.py:39-66); the flagship checkpoint's projector is Linear(3200→3584) +
GELU + Linear(3584→3584) (``linear_1``/``linear_2``).  ``mlp_smoe`` (the
legacy v1 MoE-LLaVA knob) makes mlpNx_gelu a top-k routed bank of expert
projectors (params ``router`` and ``experts``, stacked [E, ...]).  Quantized
linears run weight-only int8 through ``dense``, in w8a8 too, as in the JAX
package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from omchat_torch.config import ProjectorConfig
from omchat_torch.models.cabstractor import cabstractor_forward
from omchat_torch.models.cabstractor import init_params as cab_init
from omchat_torch.models.smoe import expert_bank, init_router, smoe_route
from omchat_torch.ops.linear import dense


def _mlp(params: dict, x: torch.Tensor, mlp_depth: int) -> torch.Tensor:
    x = dense(x, params["linear_1"])
    for i in range(2, mlp_depth + 1):
        x = F.gelu(x)  # exact erf GELU
        x = dense(x, params[f"linear_{i}"])
    return x


def projector_forward(params: dict, cfg: ProjectorConfig, features: torch.Tensor) -> torch.Tensor:
    """[..., mm_hidden] → [..., hidden] (cabstract also compresses the
    tokens to ``n_query``)."""
    t = cfg.projector_type
    if t == "identity":
        return features
    if t == "linear":
        return dense(features, params["linear_1"])
    if t == "cabstract":
        return cabstractor_forward(params, cfg, features)
    if cfg.mlp_smoe:
        combine, _ = smoe_route(params["router"], features, cfg.num_selected)
        return expert_bank(params["experts"], features, combine, lambda p, x: _mlp(p, x, cfg.mlp_depth))
    return _mlp(params, features, cfg.mlp_depth)


def init_params(cfg: ProjectorConfig, mm_hidden: int, hidden: int, generator: torch.Generator,
                dtype=torch.float32, device=None) -> dict:
    """Random weights from a seeded generator (normal(0, 0.02) kernels, zero
    bias); with ``mlp_smoe`` a router and ``num_experts`` experts of the
    mlpNx_gelu shape."""
    if cfg.projector_type == "identity":
        return {}
    if cfg.projector_type == "cabstract":
        return cab_init(cfg, mm_hidden, hidden, generator, dtype, device)
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
    if cfg.mlp_smoe:
        router = init_router(mm_hidden, cfg.num_experts, generator, dtype, device)
        experts = [{name: lin(*p["kernel"].shape) for name, p in params.items()} for _ in range(cfg.num_experts)]
        stacked = {name: {k: torch.stack([e[name][k] for e in experts]) for k in ("kernel", "bias")} for name in params}
        return {"router": router, "experts": stacked}
    return params
