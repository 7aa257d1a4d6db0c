"""LoRA / QLoRA fine-tuning: low-rank adapters over a frozen base — PyTorch
port of ``omchat_tpu/training/lora.py``.

- The adapters are a separate tree mirroring ``params["language_model"]
  ["layers"]``: per target ``a`` [L, in, r], ``b`` [L, r, out] and the scalar
  ``scale`` = alpha / rank, which is not trained.
- Only the adapter leaves require gradients; the base rides along frozen, so
  gradients and optimizer state are rank-sized.
- The base may be int8 (QLoRA): :func:`apply_lora` dequantizes the target
  kernels while adding the deltas.  The port stores int8 kernels [out, in]
  (:mod:`omchat_torch.ops.linear`); the dequantized kernel is the JAX
  package's ``kernel_q * scale`` in bf16, transposed back to [in, out].
- :func:`merge_lora` folds trained adapters into the checkpoint (bf16, or
  re-quantized to int8) for serving.

B starts at zero, so step 0 is exactly the base model.
:func:`build_lora_bank` stacks several adapters into a serving bank for
per-request LoRA (``OmChatEngine(lora_bank=)``, ``generate(adapter_id=)``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from omchat_torch.config import OmChatConfig
from omchat_torch.ops.attention import VJP
from omchat_torch.ops.linear import quantize_tree
from omchat_torch.utils.tree import tree_items

DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj")
ALL_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def _in_out(p: dict) -> Tuple[int, int, int]:
    """(L, in, out) of a stacked dense [L, in, out] or int8 [L, out, in] kernel."""
    if "kernel" in p:
        return tuple(p["kernel"].shape)
    n_layers, d_out, d_in = p["kernel_q"].shape
    return n_layers, d_in, d_out


def _find_targets(layers: dict, targets: Sequence[str]):
    """(group, name, param dict) of each adapted linear."""
    for group in ("self_attn", "mlp"):
        for name, p in layers.get(group, {}).items():
            if name in targets and isinstance(p, dict) and ("kernel" in p or "kernel_q" in p):
                yield group, name, p


def init_lora(generator: torch.Generator, params: dict, rank: int = 16, *, alpha: Optional[float] = None,
              targets: Sequence[str] = DEFAULT_TARGETS, dtype=torch.bfloat16, device=None) -> dict:
    """Adapter tree for ``params["language_model"]["layers"]``: per target
    ``a`` [L, in, r] ~ N(0, 1/r), ``b`` [L, r, out] = 0; ``scale`` = alpha /
    rank (alpha defaults to rank).  The a/b leaves require gradients."""
    layers = params["language_model"]["layers"]
    scale = (alpha if alpha is not None else float(rank)) / float(rank)
    device = device if device is not None else generator.device
    out: dict = {}
    for group, name, p in _find_targets(layers, targets):
        n_layers, d_in, d_out = _in_out(p)
        a = torch.randn((n_layers, d_in, rank), generator=generator, device=device) * rank**-0.5
        out.setdefault(group, {})[name] = {
            "a": a.to(dtype).requires_grad_(),
            "b": torch.zeros((n_layers, rank, d_out), dtype=dtype, device=device).requires_grad_(),
        }
    return {"layers": out, "scale": scale}


def lora_leaves(lora: dict) -> list:
    """The trained leaves (every a and b, in tree order)."""
    return [t for _, t in tree_items(lora["layers"])]


def apply_lora(params: dict, lora: dict) -> dict:
    """Effective full-model params: each target kernel becomes
    ``dequant(kernel) + scale * a @ b``; everything else is shared.  An int8
    base dequantizes to bf16 (as JAX does) and is then held in the
    activations' dtype, to which JAX's matmul promotes it (exactly)."""
    scale = float(lora["scale"])
    layers = params["language_model"]["layers"]
    act_dtype = params["language_model"]["embed_tokens"].dtype
    new_layers = dict(layers)
    for group, adapters in lora["layers"].items():
        new_group = dict(new_layers[group])
        for name, ab in adapters.items():
            p = new_group[name]
            if "kernel" in p:
                base = p["kernel"]
            else:  # QLoRA: [L, out, in] int8 x [L, out] scale, in bf16, back to [L, in, out]
                bf = torch.bfloat16
                base = (p["kernel_q"].to(bf) * p["scale"].to(bf)[..., :, None]).transpose(-1, -2)
            delta = torch.einsum("lir,lro->lio", ab["a"], ab["b"]) * scale
            kernel = base + delta.to(base.dtype)
            q = {"kernel": kernel if "kernel" in p else kernel.to(act_dtype)}
            if "bias" in p:
                q["bias"] = p["bias"]
            new_group[name] = q
        new_layers[group] = new_group
    lm = dict(params["language_model"])
    lm["layers"] = new_layers
    return {**params, "language_model": lm}


@torch.no_grad()
def merge_lora(params: dict, lora: dict, *, quantize: bool = False) -> dict:
    """Fold trained adapters into the checkpoint for serving; ``quantize``
    re-quantizes the merged trunk layers to int8."""
    merged = apply_lora(params, lora)
    if quantize:
        lm = dict(merged["language_model"])
        lm["layers"] = quantize_tree(lm["layers"])
        merged = {**merged, "language_model": lm}
    return merged


@torch.no_grad()
def build_lora_bank(adapters: Sequence[dict], dtype=torch.bfloat16, device=None) -> dict:
    """Stack adapter trees (this module's layout) into a serving bank for
    per-request multi-LoRA (:func:`omchat_torch.models.qwen2.lora_delta`).

    Returns {"layers": {group: {name: {"a": [L, N+1, in, rmax], "b": [L,
    N+1, rmax, out]}}}}: the layer axis first, so a layer's slice is that
    layer's bank, and the bank axis second.  Row 0 is the all-zero adapter
    (the base model); adapter i serves as bank id i+1.  Each adapter's
    ``scale`` is folded into its b, ranks are zero-padded to the widest
    (exact: the padded rows add a @ 0 + 0 @ b = 0), and a target an adapter
    lacks contributes zeros for it.  ``device``: default the first
    adapter's."""
    if not adapters:
        raise ValueError("build_lora_bank needs at least one adapter")
    n = len(adapters)
    leaves = [ab for ad in adapters for group in ad["layers"].values() for ab in group.values()]
    rmax = max(ab["a"].shape[-1] for ab in leaves)
    device = device if device is not None else leaves[0]["a"].device
    shapes: dict = {}  # the union of (group, name) targets with their (L, in, out)
    for ad in adapters:
        for group, names in ad["layers"].items():
            for name, ab in names.items():
                n_layers, d_in, _ = ab["a"].shape
                shapes.setdefault(group, {})[name] = (n_layers, d_in, ab["b"].shape[-1])
    bank: dict = {}
    for group, names in shapes.items():
        for name, (n_layers, d_in, d_out) in names.items():
            a = torch.zeros((n_layers, n + 1, d_in, rmax), dtype=dtype, device=device)
            b = torch.zeros((n_layers, n + 1, rmax, d_out), dtype=dtype, device=device)
            for i, ad in enumerate(adapters):
                ab = ad["layers"].get(group, {}).get(name)
                if ab is None:
                    continue
                r = ab["a"].shape[-1]
                a[:, i + 1, :, :r] = ab["a"].to(dtype)
                b[:, i + 1, :r, :] = (ab["b"] * ad["scale"]).to(dtype)
            bank.setdefault(group, {})[name] = {"a": a, "b": b}
    return {"layers": bank}


def lora_loss_fn(lora: dict, params: dict, cfg: OmChatConfig, batch: dict, *, attn_impl: Optional[str] = VJP,
                 remat: bool = True):
    """The loss of the adapted model; gradients reach only the adapters."""
    from omchat_torch.training.train_step import loss_fn

    return loss_fn(apply_lora(params, lora), cfg, batch, attn_impl=attn_impl, remat=remat)


def lora_train_step(lora: dict, opt_state: dict, params: dict, cfg: OmChatConfig, batch: dict, optimizer, *,
                    attn_impl: Optional[str] = VJP, remat: bool = True):
    """One (micro-)step over the adapters, updated in place.  Returns
    (lora, opt_state, loss)."""
    from omchat_torch.training.train_step import gradients

    leaves = lora_leaves(lora)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = lora_loss_fn(lora, params, cfg, batch, attn_impl=attn_impl, remat=remat)
    optimizer.update(leaves, gradients(loss, leaves), opt_state)
    return lora, opt_state, loss.detach()
