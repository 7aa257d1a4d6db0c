"""Sparse mixture-of-expert MLP banks — PyTorch port of
``omchat_tpu/models/smoe.py``: the MoE-LLaVA-style options of the legacy v1
path (the ``mlp_smoe`` projector and the ``clip_smoe`` CLIP tower).

A linear router per token, softmax over ``num_experts``, the top
``num_selected`` kept and renormalized to sum to 1, and the weighted sum of
the selected experts' MLP outputs.  Expert parameters are stacked ([E, in,
out]) and every expert runs on every token, masked by its routing weight
(E is small: MoE-LLaVA uses 4), as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from omchat_torch.ops.linear import dense
from omchat_torch.utils.tree import tree_map


def smoe_route(router: dict, x: torch.Tensor, num_selected: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token routing weights, in fp32 (near-tie expert logits are
    order-sensitive).  Returns ``(combine, probs)``: ``combine`` [..., E]
    holds the top-``num_selected`` softmax probabilities renormalized to sum
    to 1 and zeros elsewhere; ``probs`` is the full softmax (for
    :func:`load_balancing_loss`)."""
    logits = dense(x.float(), {k: v.float() for k, v in router.items()})
    probs = torch.softmax(logits, dim=-1)
    top_v, top_i = torch.topk(probs, num_selected, dim=-1)
    combine = torch.zeros_like(probs).scatter_add_(-1, top_i, top_v)
    combine = combine / combine.sum(dim=-1, keepdim=True).clamp(min=torch.finfo(probs.dtype).tiny)
    return combine, probs


def expert_bank(params: dict, x: torch.Tensor, combine: torch.Tensor,
                mlp: Callable[[dict, torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Every expert's ``mlp`` on every token (params stacked over a leading E
    axis), summed with the routing weights.  [..., D_in] → [..., D_out]."""
    n = combine.shape[-1]
    outs = torch.stack([mlp(tree_map(lambda a, e=e: a[e], params), x) for e in range(n)], dim=-2)  # [..., E, D_out]
    return (outs * combine[..., None].to(outs.dtype)).sum(dim=-2)


def load_balancing_loss(probs: torch.Tensor, combine: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss E · Σ_e f_e · P_e (f_e: the share of tokens
    routed to expert e, P_e: its mean router probability); 1.0 under uniform
    routing.  Like the JAX package's, no training step calls it."""
    e = probs.shape[-1]
    flat_p = probs.reshape(-1, e)
    flat_c = (combine > 0).float().reshape(-1, e)
    f = (flat_c / flat_c.sum(dim=-1, keepdim=True).clamp(min=1.0)).mean(dim=0)
    return e * (f * flat_p.mean(dim=0)).sum()


def replicate_expert_params(params: dict, num_experts: int) -> dict:
    """One dense module's params stacked into an E-way bank of identical
    experts (the reference's pretrain-adapter load: the same weights in every
    expert)."""
    return tree_map(lambda a: a[None].expand(num_experts, *a.shape).contiguous(), params)


def init_router(d_in: int, num_experts: int, generator: torch.Generator, dtype=torch.float32, device=None) -> dict:
    """A router of normal(0, 0.02) kernel and zero bias."""
    device = device if device is not None else generator.device
    return {
        "kernel": torch.randn((d_in, num_experts), generator=generator, device=device).mul_(0.02).to(dtype),
        "bias": torch.zeros((num_experts,), dtype=dtype, device=device),
    }
