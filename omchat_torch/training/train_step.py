"""Multimodal training step — PyTorch port of the single-device part of
``omchat_tpu/training/train_step.py``.

- The same vision → projector → splice → decoder forward as inference, with
  labels = -100 on image and padding rows and next-token cross-entropy.
- The attention route defaults to ``"vjp"``: the differentiable flash
  attention (K16 on CUDA, its plain versions on the CPU); ``"plain"`` is the
  autograd reference (the JAX package's ``"xla"``).
- ``remat`` checkpoints every ViT and decoder layer.
- The optimizer reproduces the optax chain the JAX trainer builds
  (``cli/train.py:222-229, 422-437``): ``MultiSteps(chain(clip_by_global_norm,
  adamw))`` — see :class:`AdamW`.
- Frozen leaves are tensors with ``requires_grad=False`` (the counterpart of
  ``multi_transform(..., set_to_zero)``); the optimizer sees only the
  trainable ones, so stage-1 clips over the projector's gradients alone.

- :func:`make_sharded_train_step`: the step over a (data, model) mesh of
  ranks (data parallel, FSDP, Megatron tensor parallel), every collective
  explicit (:mod:`omchat_torch.parallel.comm`).  Sequence, context and
  Ulysses parallelism come with ROADMAP queue A item 13c, the pipeline step
  (``make_pp_train_step``) with item 13d.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple, Union

import torch

from omchat_torch.config import OmChatConfig
from omchat_torch.constants import IGNORE_INDEX
from omchat_torch.models.omchat import encode_images, fuse_embeddings
from omchat_torch.models.qwen2 import lm_head, qwen2_forward
from omchat_torch.ops.attention import VJP
from omchat_torch.ops.cross_entropy import cross_entropy_loss, vocab_parallel_token_losses
from omchat_torch.parallel import comm
from omchat_torch.parallel.sharding import check_train_tp, gather_params, leaf_specs, shard_params
from omchat_torch.utils.tree import tree_items

ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default, which the JAX trainer relies on (not torch's 1e-2)


class AdamW:
    """``optax.MultiSteps(optax.chain(optax.clip_by_global_norm(grad_clip),
    optax.adamw(lr, b1, b2, eps, weight_decay=weight_decay)), grad_accum)``
    over a list of tensors, updated in place.

    - MultiSteps: the gradients of ``grad_accum`` micro-steps are averaged
      (optax's running mean ``acc + (g - acc) / (n + 1)``); parameters change
      only on the last micro-step, and the schedule counts updates, not
      micro-steps.
    - clip_by_global_norm: ``g`` is replaced by ``(g / norm) * max_norm`` when
      the global norm is not below ``max_norm`` (no epsilon).
    - adamw: bias-corrected moments, ``mu_hat / (sqrt(nu_hat) + eps)``, plus
      ``weight_decay * p`` on every trained leaf, times ``-lr(count)`` with
      the update count starting at 0.
    The moments are held in fp32 (optax holds them in the params' dtype; for
    fp32 params the two agree)."""

    def __init__(self, lr: Union[float, Callable[[int], float]], *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = ADAMW_WEIGHT_DECAY, grad_clip: Optional[float] = None,
                 grad_accum: int = 1):
        self.lr = lr if callable(lr) else (lambda count, v=float(lr): v)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.grad_clip = grad_clip
        self.grad_accum = grad_accum

    def init(self, params: List[torch.Tensor]) -> dict:
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in params]  # noqa: E731
        state = {"count": 0, "mu": zeros(), "nu": zeros(), "mini_step": 0}
        if self.grad_accum > 1:
            state["acc"] = zeros()
        return state

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: dict,
               norm_fn: Optional[Callable[[List[torch.Tensor]], torch.Tensor]] = None) -> bool:
        """Apply one micro-step's gradients; returns whether the parameters
        changed.  ``norm_fn(grads)``: the global norm, where the leaves are
        shards of a larger tree (the sharded step's).  The gradients are
        widened to fp32 one leaf at a time."""
        if self.grad_accum > 1:
            n = state["mini_step"]
            for acc, g in zip(state["acc"], grads):
                acc.add_((g.float() - acc) / (n + 1.0))
            if n < self.grad_accum - 1:
                state["mini_step"] = n + 1
                return False
            grads = [acc.clone() for acc in state["acc"]]
            for acc in state["acc"]:
                acc.zero_()
            state["mini_step"] = 0
        clip_norm = None
        if self.grad_clip is not None:
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads)) if norm_fn is None else norm_fn(grads)
            if not bool(norm < self.grad_clip):
                clip_norm = norm
        count = state["count"]
        lr = self.lr(count)
        c1, c2 = 1 - self.b1 ** (count + 1), 1 - self.b2 ** (count + 1)
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            g = g.float()
            if clip_norm is not None:
                g = (g / clip_norm) * self.grad_clip
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * g.square())
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.weight_decay * p.float()
            p.copy_((p.float() - lr * upd).to(p.dtype))
        state["count"] = count + 1
        return True


def make_optimizer(lr: Union[float, Callable[[int], float]] = 1e-5, weight_decay: float = 0.0, b1: float = 0.9,
                   b2: float = 0.95, grad_clip: Optional[float] = None, grad_accum: int = 1) -> AdamW:
    """The JAX ``make_optimizer`` (whose own weight-decay default is 0; the
    CLI's adamw uses optax's 1e-4, :data:`ADAMW_WEIGHT_DECAY`).  Freezing is
    ``requires_grad=False`` on the params (:func:`init_train_state`)."""
    return AdamW(lr, b1=b1, b2=b2, weight_decay=weight_decay, grad_clip=grad_clip, grad_accum=grad_accum)


@dataclass
class TrainState:
    params: dict
    opt_state: dict
    step: int = 0


def trainable_leaves(params) -> List[torch.Tensor]:
    """The leaves that train, in tree order."""
    return [t for _, t in tree_items(params) if isinstance(t, torch.Tensor) and t.requires_grad]


def set_trainable(params: dict, trainable: Optional[Callable[[tuple], bool]] = None) -> dict:
    """``requires_grad`` on every floating leaf whose path ``trainable`` accepts
    (None: all), off on the others; returns ``params``."""
    for path, t in tree_items(params):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            t.requires_grad_(trainable is None or bool(trainable(path)))
    return params


def init_train_state(params: dict, optimizer: AdamW, trainable: Optional[Callable[[tuple], bool]] = None) -> TrainState:
    """``trainable``: a predicate on a leaf's path, e.g. ``lambda path:
    path[0] == "projector"`` for stage-1 (None: every floating leaf)."""
    set_trainable(params, trainable)
    return TrainState(params=params, opt_state=optimizer.init(trainable_leaves(params)), step=0)


def shift_labels(labels: torch.Tensor) -> torch.Tensor:
    """Next-token targets: labels shifted left, IGNORE_INDEX in the last column."""
    return torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], IGNORE_INDEX)], dim=1)


def loss_fn(params: dict, cfg: OmChatConfig, batch: dict, *, attn_impl: Optional[str] = VJP,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: token_ids [B, M], is_image [B, M], image_index [B, M],
    positions [B, M], labels [B, M] (-100 on ignored rows), optional
    pixel_values [N, 3, H, W] and segment_ids [B, M].  The ViT takes the
    trunk's attention route (``train_step.py:101-107``).  Returns (mean
    loss, number of valid labels)."""
    pixel_values = batch.get("pixel_values")
    feats = None
    if pixel_values is not None:
        feats = encode_images(params, cfg, pixel_values, attn_impl=attn_impl, remat=remat)
        feats = feats.reshape(-1, feats.shape[-1])
    embeds = fuse_embeddings(params, batch["token_ids"], batch["is_image"], batch["image_index"], feats)
    hidden, _ = qwen2_forward(params["language_model"], cfg.text, embeds, batch["positions"], attn_impl=attn_impl,
                              remat=remat, segment_ids=batch.get("segment_ids"))
    logits = lm_head(params["language_model"], cfg.text, hidden)
    return cross_entropy_loss(logits, shift_labels(batch["labels"]))


def gradients(loss: torch.Tensor, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d leaves (zeros for a leaf the loss does not reach)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def train_step(state: TrainState, cfg: OmChatConfig, batch: dict, optimizer: AdamW, *,
               attn_impl: Optional[str] = VJP, remat: bool = True) -> Tuple[TrainState, torch.Tensor]:
    """One (micro-)step: loss, gradients of the trainable leaves, the
    optimizer's in-place update.  Returns (state, loss)."""
    leaves = trainable_leaves(state.params)
    loss, _ = loss_fn(state.params, cfg, batch, attn_impl=attn_impl, remat=remat)
    optimizer.update(leaves, gradients(loss, leaves), state.opt_state)
    state.step += 1
    return state, loss.detach()


def model_flops(cfg: OmChatConfig, batch: dict, *, vit_backward: bool, trunk_weights_grad: bool,
                recompute: bool = False) -> float:
    """FLOPs a training step does, from the shapes (matmuls and attention):
    the ViT forward (and backward when it trains), the projector forward and
    weight gradient, the trunk forward, its input-gradient backward and, when
    it trains, its weight gradients; lm_head forward and input gradient.
    Causal attention counts its lower triangle; packing counts each
    document's own square.  That is the model's count (for ``mfu``);
    ``recompute`` adds the remat forwards the backward repeats (the trunk's,
    and the ViT's when it trains), the hardware's count (for ``hfu``)."""
    v, t = cfg.vision, cfg.text
    flops = 0.0
    pv = batch.get("pixel_values")
    if pv is not None:
        n, s = pv.shape[0], v.seq_len
        d, f = v.hidden_size, v.intermediate_size
        per_layer = 2 * n * s * (d * 3 * d + d * d + 2 * d * f) + 4 * n * s * s * d
        vit = v.num_hidden_layers * per_layer
        flops += vit * ((4 if recompute else 3) if vit_backward else 1)
        din, dmid = v.hidden_size, t.hidden_size  # the projector (mlp2x_gelu): forward, weight gradient
        flops += 2 * n * (s - 1) * (din * dmid + dmid * dmid) * (3 if vit_backward else 2)
    b, m = batch["token_ids"].shape
    d, f, h, kvh, hd = t.hidden_size, t.intermediate_size, t.num_attention_heads, t.num_key_value_heads, t.attn_head_dim
    dense_per_layer = 2 * b * m * (d * h * hd + 2 * d * kvh * hd + h * hd * d + 3 * d * f)
    seg = batch.get("segment_ids")
    if seg is None:
        pairs = b * m * (m + 1) / 2
    else:
        ids = seg.detach().cpu()
        pairs = sum(float(c) * (float(c) + 1) / 2 for row in ids for c in torch.unique(row[row >= 0], return_counts=True)[1])
    attn_per_layer = 4 * pairs * h * hd
    fwd = t.num_hidden_layers * (dense_per_layer + attn_per_layer)
    # backward: the input gradient costs one forward's dense products and
    # two of attention's (dQ, dK/dV over four products against two)
    bwd_in = t.num_hidden_layers * (dense_per_layer + 2 * attn_per_layer)
    bwd_w = t.num_hidden_layers * dense_per_layer if trunk_weights_grad else 0.0
    flops += (2 if recompute else 1) * fwd + bwd_in + bwd_w
    flops += 2 * b * m * d * t.vocab_size * 2  # lm_head forward + input gradient
    return float(flops)


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

BATCH_KEYS = ("token_ids", "is_image", "image_index", "positions", "labels", "segment_ids")
GRAD_BUCKET = 1 << 25  # elements per all-reduce of the data-parallel gradient sync


def sharded_token_losses(params: dict, cfg: OmChatConfig, batch: dict, mesh, *, attn_impl: Optional[str] = VJP,
                         remat: bool = True, fsdp_dims: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's part of the loss: (its rows' token losses [b, M], zero
    where no label counts; the valid mask).  ``params`` is the rank's shard,
    ``batch`` its slice (:func:`make_sharded_train_step`).  The ViT runs on the rank's
    tiles and the image features are all-gathered over ``data`` (with their
    gradient), so ``image_index`` keeps indexing the global feature rows.
    The labels follow the dense rule (outside [0, V): ignored) before the
    vocab-parallel loss.  ``fsdp_dims``: :func:`layer_gather_dims` of an
    FSDP spec tree."""
    fsdp_dims = fsdp_dims or {}
    pixel_values = batch.get("pixel_values")
    feats = None
    if pixel_values is not None:
        feats = encode_images(params, cfg, pixel_values, attn_impl=attn_impl, remat=remat, mesh=mesh,
                              vit_fsdp_dims=fsdp_dims.get("vision_tower"))
        feats = comm.all_gather_dim(feats.reshape(-1, feats.shape[-1]), mesh, "data", 0)
    v = cfg.text.vocab_size
    embeds = fuse_embeddings(params, batch["token_ids"], batch["is_image"], batch["image_index"], feats, mesh, v)
    hidden, _ = qwen2_forward(params["language_model"], cfg.text, embeds, batch["positions"], attn_impl=attn_impl,
                              remat=remat, segment_ids=batch.get("segment_ids"), mesh=mesh,
                              fsdp_dims=fsdp_dims.get("language_model"))
    logits = lm_head(params["language_model"], cfg.text, hidden, mesh)
    labels = shift_labels(batch["labels"])
    labels = torch.where((labels >= 0) & (labels < v), labels, IGNORE_INDEX)
    return vocab_parallel_token_losses(logits, labels, v, mesh)


def _data_loss(loss_sum: torch.Tensor, n_local: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's share of the global loss: its sum over the global number
    of valid labels (JAX's mean over the whole batch, not the mean of the
    ranks' means).  The shares sum to the loss over ``data``."""
    return loss_sum / comm.sum_value(n_local, mesh, "data").clamp(min=1)


def _sync_gradients(grads: List[torch.Tensor], specs: List[tuple], mesh) -> None:
    """Sum over ``data`` the gradients of the leaves that are whole on every
    data rank (an FSDP shard's gradient was reduce-scattered by its gather's
    backward), in buckets of :data:`GRAD_BUCKET` elements."""
    group = comm._group(mesh, "data")
    if group is None:
        return
    buckets: List[List[torch.Tensor]] = []
    for g in (g for g, spec in zip(grads, specs) if "data" not in spec):
        last = buckets[-1] if buckets else None
        if last is None or last[0].dtype != g.dtype or sum(x.numel() for x in last) + g.numel() > GRAD_BUCKET:
            buckets.append([g])
        else:
            last.append(g)
    for bucket in buckets:
        flat = comm.all_reduce_(torch.cat([g.reshape(-1) for g in bucket]), group)
        for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(part.view_as(g))


def _global_norm(specs: List[tuple], mesh):
    """``norm_fn`` of :meth:`AdamW.update` over shards: each leaf's squared
    norm over the ranks that replicate it, summed over the whole mesh (a
    replicated leaf counts once)."""
    tp, dp = mesh.axis_size("model"), mesh.axis_size("data")

    def norm(grads: List[torch.Tensor]) -> torch.Tensor:
        total = sum(g.float().square().sum() / ((1 if "model" in s else tp) * (1 if "data" in s else dp))
                    for g, s in zip(grads, specs))
        return torch.sqrt(comm.sum_value(comm.sum_value(total, mesh, "model"), mesh, "data"))

    return norm


def layer_gather_dims(specs: dict) -> dict:
    """{tower: one layer's tree of the dimension split over ``data``} from a
    spec tree (the stacked layer axis dropped): the FSDP layout that the
    towers' forwards gather layer by layer (their ``fsdp_dims``)."""

    def dims(node):
        if isinstance(node, dict):
            return {k: dims(v) for k, v in node.items()}
        return node.index("data") - 1 if "data" in node else None

    out = {}
    for tower in ("language_model", "vision_tower"):
        layers = specs.get(tower, {}).get("layers")
        if layers is not None:
            out[tower] = dims(layers)
    return out


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's slice of a global batch: the leading axis split over
    ``data`` (JAX's ``P("data")``).  The image tiles are padded with zero
    tiles to a multiple of dp (their features are never indexed) and split
    alike."""
    dp, d = mesh.axis_size("data"), mesh.axis_index("data")
    b = batch["token_ids"].shape[0]
    if b % dp:
        raise ValueError(f"the batch of {b} rows must be divisible by the data-parallel degree {dp}")
    out = {k: v.chunk(dp)[d].contiguous() for k, v in batch.items() if k in BATCH_KEYS}
    pv = batch.get("pixel_values")
    if pv is not None:
        pad = -pv.shape[0] % dp
        if pad:
            pv = torch.cat([pv, pv.new_zeros((pad, *pv.shape[1:]))])
        out["pixel_values"] = pv.chunk(dp)[d].contiguous()
    return out


def make_sharded_train_step(cfg: OmChatConfig, mesh, param_specs: dict, optimizer: AdamW, *,
                            attn_impl: Optional[str] = VJP, remat: bool = True, sequence_parallel: bool = False,
                            context_parallel: bool = False, ulysses: bool = False):
    """The train step over a (data, model) mesh of ranks (the JAX
    ``make_sharded_train_step``).  Returns ``(step, shard_batch, place)``:

    - ``place(params)``: this rank's shard of a canonical tree;
    - ``shard_batch(batch)``: this rank's slice of a global batch;
    - ``step(state, cfg, batch_slice) -> (state, loss)``: ``state`` holds the
      shards (:func:`init_train_state` on ``place(params)``) and the loss is
      the global batch's.

    The loss is JAX's: the sum over the global batch over the global count
    of valid labels.  A rank differentiates its share
    (:func:`_data_loss`); the gradients of the leaves that the data ranks
    replicate are summed over ``data``, an FSDP leaf's (its ``data`` shard,
    all-gathered layer by layer in the forward and again in the remat
    recompute) reduce-scattered by its gather's backward.  AdamW's moments
    are shards of the param shards; ``clip_by_global_norm`` covers the whole
    logical tree (:func:`_global_norm`).  Attention runs on each rank's
    heads (``"vjp"``: K16 on CUDA)."""
    for flag, on in (("sequence_parallel", sequence_parallel), ("context_parallel", context_parallel),
                     ("ulysses", ulysses)):
        if on:
            raise NotImplementedError(f"{flag} comes with ROADMAP queue A item 13c (sequence, context and Ulysses "
                                      "parallelism)")
    check_train_tp(cfg.text, mesh.axis_size("model"))
    fsdp_dims = layer_gather_dims(param_specs)
    cache: dict = {}

    def specs_of(params) -> List[tuple]:
        paths = tuple(p for p, t in tree_items(params) if isinstance(t, torch.Tensor) and t.requires_grad)
        if cache.get("paths") != paths:
            by_path = leaf_specs(params, param_specs)
            cache.update(paths=paths, specs=[by_path[p] for p in paths])
        return cache["specs"]

    def step(state: TrainState, cfg_: OmChatConfig, batch: dict) -> Tuple[TrainState, torch.Tensor]:
        leaves = trainable_leaves(state.params)
        specs = specs_of(state.params)
        losses, valid = sharded_token_losses(state.params, cfg_, batch, mesh, attn_impl=attn_impl, remat=remat,
                                             fsdp_dims=fsdp_dims)
        loss = _data_loss(losses.sum(), valid.sum(), mesh)
        grads = gradients(loss, leaves)
        _sync_gradients(grads, specs, mesh)
        optimizer.update(leaves, grads, state.opt_state, norm_fn=_global_norm(specs, mesh))
        state.step += 1
        return state, comm.sum_value(loss.detach(), mesh, "data")

    def place(params: dict) -> dict:
        return shard_params(params, mesh, param_specs)

    return step, (lambda batch: shard_batch(batch, mesh)), place


def _path_tree(paths, tensors) -> dict:
    tree: dict = {}
    for path, t in zip(paths, tensors):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def gather_state(state: TrainState, mesh, param_specs: dict, shapes: dict) -> dict:
    """The canonical train state from every rank's shards (collective: every
    rank calls it): ``{"params", "opt_state"}`` as the single-device trainer
    saves it, the moments in the trainable leaves' order.  ``shapes``:
    :func:`~omchat_torch.parallel.sharding.canonical_shapes` of the tree."""
    paths = [p for p, t in tree_items(state.params) if isinstance(t, torch.Tensor) and t.requires_grad]
    params = gather_params(state.params, mesh, param_specs, shapes)
    opt = dict(state.opt_state)
    for key in ("mu", "nu", "acc"):
        if key in opt:
            full = dict(tree_items(gather_params(_path_tree(paths, opt[key]), mesh, param_specs, shapes)))
            opt[key] = [full[p] for p in paths]
    return {"params": params, "opt_state": opt}


def shard_state(saved: dict, mesh, param_specs: dict, optimizer: AdamW,
                trainable: Optional[Callable[[tuple], bool]] = None, device=None) -> TrainState:
    """A rank's train state from a canonical one (:func:`gather_state`'s, or
    the single-device trainer's checkpoint): any world resumes any other's."""
    params = shard_params(saved["params"], mesh, param_specs)
    if device is not None:
        params = _to(params, device)
    state = init_train_state(params, optimizer, trainable)
    paths = [p for p, t in tree_items(params) if isinstance(t, torch.Tensor) and t.requires_grad]
    opt = dict(saved["opt_state"])
    for key in ("mu", "nu", "acc"):
        if key in opt:
            local = dict(tree_items(shard_params(_path_tree(paths, opt[key]), mesh, param_specs)))
            opt[key] = [local[p].to(device) if device is not None else local[p] for p in paths]
    state.opt_state = opt
    return state


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree
