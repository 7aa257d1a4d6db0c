"""Qwen2-MoE decoder — PyTorch port of ``omchat_tpu/models/qwen2_moe.py``.

A layer is the Qwen2 GQA attention and a sparse MoE block: a top-k softmax
router over E experts (SwiGLU, ``moe_intermediate_size``) plus a shared
expert (SwiGLU, ``shared_expert_intermediate_size``) gated by a sigmoid.  The
layer body, the caches and the attention kernels are the dense trunk's
(:mod:`omchat_torch.models.qwen2`): only the MLP differs (``mlp_fn``).

Two routes for the experts (``moe_impl``), both plain PyTorch products, as
the JAX package computes them outside any Pallas kernel:

- ``"dense"``: every expert on every token, weighted by its routing weight
  (zero where the token does not pick it).  Static shapes, so a CUDA graph
  captures it; a decode step reads every expert's weights.
- ``"gmm"``: the token replicas sorted by expert, one ``torch.matmul`` a
  group, and a weighted scatter-add back (the JAX package's megablox route).
  It reads the group sizes on the host, so no CUDA graph can capture it.

Under a tensor-parallel mesh (expert parallelism) a rank holds a block of
whole experts (:func:`expert_block`, unevenly where tp does not divide E)
and its slice of the shared expert; the router runs replicated in fp32 on
the replicated input, so every rank picks the same experts, each route
runs the rank's experts only, and one reduce sums the experts' and the
shared expert's parts.  The group sizes of ``"gmm"`` differ between ranks,
but no collective sits inside the groups, so the ranks stay in step.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from omchat_torch.config import TextConfig
from omchat_torch.models.qwen2 import KVCache, qwen2_forward
from omchat_torch.models.qwen2 import init_params as dense_init
from omchat_torch.ops.linear import dense, silu
from omchat_torch.parallel.comm import copy_to_axis, model_slice, reduce_from_axis

MOE_IMPLS = ("dense", "gmm")


def _router(x: torch.Tensor, gate_kernel: torch.Tensor, cfg: TextConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, D] → (top-k weights [T, K] fp32, expert ids [T, K]): an fp32
    softmax over all experts, then the top k (HF Qwen2MoeSparseMoeBlock)."""
    probs = torch.softmax(x.float() @ gate_kernel.float(), dim=-1)
    topk_w, topk_idx = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    if cfg.norm_topk_prob:
        topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True)
    return topk_w, topk_idx


def expert_block(cfg: TextConfig, mesh=None) -> slice:
    """The experts this rank holds, [lo, hi) of E (all of them without a
    mesh): whole experts, the ceil-sized blocks first, as the expert axis's
    spec splits them."""
    return model_slice(cfg.num_experts, mesh)


def _experts_dense(x: torch.Tensor, p: dict, topk_w, topk_idx, cfg: TextConfig, mesh=None) -> torch.Tensor:
    """Every expert on every token, combined by the routing weights.  x [T, D].
    ``mesh``: ``p`` holds this rank's block of the experts, and the routing
    weights enter through *copy to the model axis*, so the router's gradient
    is whole on every rank."""
    combine = torch.zeros((x.shape[0], cfg.num_experts), dtype=torch.float32, device=x.device)
    combine = combine.scatter_add_(1, topk_idx, topk_w).to(x.dtype)  # [T, E]
    if mesh is not None:
        combine = copy_to_axis(combine, mesh)[:, expert_block(cfg, mesh)]  # [T, E_local]
    gate = torch.matmul(x, p["gate_proj"])  # [E, T, F]
    up = torch.matmul(x, p["up_proj"])
    out = torch.matmul(silu(gate) * up, p["down_proj"])  # [E, T, D]
    return torch.einsum("etd,te->td", out, combine)


def _experts_gmm(x: torch.Tensor, p: dict, topk_w, topk_idx, cfg: TextConfig, mesh=None) -> torch.Tensor:
    """The grouped product: the T * K token replicas sorted by expert, each
    expert's group through its SwiGLU, the outputs weighted and added back
    to their tokens.  ``mesh``: only the replicas routed to this rank's
    experts (``p`` holds that block), the rest of the sum on the other
    ranks."""
    k = cfg.num_experts_per_tok
    block = expert_block(cfg, mesh)
    flat_idx = topk_idx.reshape(-1)
    mine = torch.nonzero((flat_idx >= block.start) & (flat_idx < block.stop))[:, 0]
    local = flat_idx[mine] - block.start
    order = mine[torch.argsort(local, stable=True)]
    token_of = order // k
    xs = x[token_of]  # [replicas, D] in expert order
    sizes = torch.bincount(local, minlength=block.stop - block.start).tolist()
    out = torch.empty_like(xs)
    start = 0
    for e, n in enumerate(sizes):
        if n:
            rows = xs[start : start + n]
            h = silu(rows @ p["gate_proj"][e]) * (rows @ p["up_proj"][e])
            out[start : start + n] = h @ p["down_proj"][e]
            start += n
    w = topk_w.reshape(-1)[order].to(out.dtype)
    return torch.zeros_like(x).index_add_(0, token_of, out * w[:, None])


def _moe_block(x: torch.Tensor, p: dict, cfg: TextConfig, moe_impl: str, mesh=None) -> torch.Tensor:
    """x [B, S, D] → [B, S, D].  ``mesh``: expert parallelism.  A rank holds
    its block of the experts and its slice of the shared expert; the router
    runs replicated on the replicated input, the local experts on either
    route, and one reduce over the model axis sums the experts' and the
    shared expert's parts."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    topk_w, topk_idx = _router(xt, p["gate"]["kernel"], cfg)
    xc = copy_to_axis(xt, mesh)
    if moe_impl == "gmm":
        out = _experts_gmm(xc, p["experts"], topk_w, topk_idx, cfg, mesh)
    else:
        out = _experts_dense(xc, p["experts"], topk_w, topk_idx, cfg, mesh)
    se = p["shared_expert"]
    shared = dense(silu(dense(xc, se["gate_proj"])) * dense(xc, se["up_proj"]), se["down_proj"])
    shared_gate = torch.sigmoid(dense(xt, p["shared_expert_gate"]).float()).to(x.dtype)
    return reduce_from_axis(out + shared * copy_to_axis(shared_gate, mesh), mesh).reshape(b, s, d)


def moe_mlp(cfg: TextConfig, moe_impl: str = "dense"):
    """The ``mlp_fn`` of :func:`omchat_torch.models.qwen2.decoder_layer` for
    an MoE trunk.  ``a8`` is ignored (the expert products stay in the
    activations' dtype: routing scatters defeat static activation scales) and
    so is an mlp-side LoRA (no adapter has the experts' layout): only
    attention adapters serve on an MoE trunk, as in the JAX package."""
    if moe_impl not in MOE_IMPLS:
        raise ValueError(f"unknown moe_impl {moe_impl!r} (one of {MOE_IMPLS})")
    return lambda y, p, a8=False, lora=None, adapter_ids=None, mesh=None: _moe_block(y, p, cfg, moe_impl, mesh)


def check_lora_bank(cfg: TextConfig, lora_bank: Optional[dict]) -> None:
    """Refuse a LoRA bank that adapts the MLP of an MoE trunk: the block
    has no dense gate / up / down for it to adapt (attention targets
    serve)."""
    if cfg.is_moe and lora_bank is not None and lora_bank["layers"].get("mlp"):
        raise ValueError(f"a LoRA bank on an MoE trunk adapts attention only; this one also targets the MLP's "
                         f"{sorted(lora_bank['layers']['mlp'])}")


def qwen2_moe_forward(
    params: dict,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[KVCache] = None,
    write_pos: Optional[torch.Tensor] = None,
    kv_len: Optional[torch.Tensor] = None,
    *,
    attn_impl: Optional[str] = None,
    moe_impl: str = "dense",
    remat: bool = False,
    lora_bank: Optional[dict] = None,
    adapter_ids: Optional[torch.Tensor] = None,
    mesh=None,
    fsdp_dims: Optional[dict] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Same contract as :func:`omchat_torch.models.qwen2.qwen2_forward`:
    prefill into the cache, the cacheless pass, and the one-token decode step
    through ``decode_scan``.  Needs a homogeneous stack (every layer sparse,
    no ``mlp_only_layers``), which the released Qwen2-MoE checkpoints are.
    ``mesh``, ``fsdp_dims``: expert parallel over the model axis
    (:func:`_moe_block`), on the cacheless pass and the cached serving
    paths alike."""
    assert cfg.is_moe
    return qwen2_forward(params, cfg, inputs_embeds, positions, cache, write_pos, kv_len, attn_impl=attn_impl,
                         remat=remat, lora_bank=lora_bank, adapter_ids=adapter_ids,
                         mlp_fn=moe_mlp(cfg, moe_impl), mesh=mesh, fsdp_dims=fsdp_dims)


def init_params(cfg: TextConfig, generator: torch.Generator, dtype=torch.float32, device=None) -> dict:
    """Random weights from a seeded generator (the JAX ``init_params``
    distribution): the dense trunk's attention and norms, then the MoE
    block's normal(0, 0.02) router, experts and shared expert."""
    params = dense_init(cfg, generator, dtype, device, mlp=False)
    device = device if device is not None else generator.device
    n, d = cfg.num_hidden_layers, cfg.hidden_size
    e, fm, fs = cfg.num_experts, cfg.moe_intermediate_size, cfg.shared_expert_intermediate_size

    def nrm(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=dtype).mul_(0.02)

    params["layers"]["mlp"] = {
        "gate": {"kernel": nrm(n, d, e)},
        "experts": {"gate_proj": nrm(n, e, d, fm), "up_proj": nrm(n, e, d, fm), "down_proj": nrm(n, e, fm, d)},
        "shared_expert": {"gate_proj": {"kernel": nrm(n, d, fs)}, "up_proj": {"kernel": nrm(n, d, fs)},
                          "down_proj": {"kernel": nrm(n, fs, d)}},
        "shared_expert_gate": {"kernel": nrm(n, d, 1)},
    }
    return params


def convert_hf_moe_layers(state: dict, cfg: TextConfig, dtype=torch.bfloat16, device=None,
                          layers: Optional[Sequence[int]] = None) -> dict:
    """The HF Qwen2Moe layers' MLP weights (keys relative to ``model.``'s
    parent, as ``convert_qwen2`` takes them) → the MoE block's tree, of
    every layer or of those in ``layers`` stacked in that order (the
    sharded load reads one layer at a time)."""
    e = cfg.num_experts
    indices = range(cfg.num_hidden_layers) if layers is None else layers

    def stack(fmt):
        return torch.stack([state[fmt.format(i)].t() for i in indices]).to(dtype=dtype, device=device).contiguous()

    def stack_experts(proj):  # [L, E, in, out]
        return torch.stack([
            torch.stack([state[f"model.layers.{i}.mlp.experts.{j}.{proj}.weight"].t() for j in range(e)])
            for i in indices
        ]).to(dtype=dtype, device=device).contiguous()

    pre = "model.layers.{}.mlp."
    return {
        "gate": {"kernel": stack(pre + "gate.weight")},
        "experts": {name: stack_experts(name) for name in ("gate_proj", "up_proj", "down_proj")},
        "shared_expert": {name: {"kernel": stack(pre + f"shared_expert.{name}.weight")}
                          for name in ("gate_proj", "up_proj", "down_proj")},
        "shared_expert_gate": {"kernel": stack(pre + "shared_expert_gate.weight")},
    }
