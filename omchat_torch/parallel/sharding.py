"""Param partition specs and the per-rank shards — PyTorch port of
``omchat_tpu/parallel/sharding.py``.

A spec is a tuple of axis names, one per leading dimension of its leaf
(``None`` = replicated), leaf for leaf the JAX package's ``PartitionSpec``:
Megatron column splits (q/k/v, gate/up, qkv, fc1: the output dimension over
``model``), row splits (o_proj, down_proj, proj, fc2: the input dimension),
the vocab-sharded embedding and lm_head, the MoE experts over ``model``
(expert parallelism), and with ``fsdp=True`` the other dimension of every
layer kernel over ``data``.

GSPMD partitions any dimension and pads what does not divide; explicit
tensor parallelism computes on the shards, so a :class:`Spec` also says how
its ``model`` dimension splits:

- ``units``: the dimension splits into whole units (heads), ceil-sized
  blocks first (:func:`split_sizes`: InternViT-6B's 25 heads are 13 + 12 at
  tp 2 and 7 + 6 + 6 + 6 at tp 4); a plain dimension splits by elements the
  same way;
- ``blocks``: the dimension is that many equal blocks, each split alike.
  The fused ViT ``attn.qkv`` kernel [L, D, 3D] (and its bias) is q | k | v:
  a rank's shard holds its own heads of q, of k and of v (Megatron's
  head-wise layout), not a contiguous third of the columns.
  :func:`gather_params` restores the canonical column order;
- ``whole_unless_even``: the dimension splits only where tp divides its
  ``units``, and every rank holds it whole otherwise: the kv heads
  (k_proj, v_proj, their biases and a LoRA bank's k / v targets), which
  JAX's :func:`kv_cache_specs` replicates with the cache when ``KVH % tp``.

The ``data`` axis (FSDP) splits evenly; a dimension that dp does not divide
is refused with a message (GSPMD would pad it).

:func:`shard_params` gives one rank's local tree and :func:`gather_params`
rebuilds the canonical tree, from every rank's tree (no process group
needed) or, in a live world, through collectives.  Both take the rank's
coordinates on the mesh explicitly.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from omchat_torch.config import OmChatConfig, TextConfig, VisionConfig
from omchat_torch.utils.tree import tree_items, tree_map


class Spec(tuple):
    """A partition spec: a tuple of axis names (equal to the same tuple),
    with the ``model`` dimension's ``units`` and ``blocks`` (see the module
    docstring)."""

    def __new__(cls, *axes, units: Optional[int] = None, blocks: int = 1, whole_unless_even: bool = False):
        self = super().__new__(cls, axes)
        self.units, self.blocks, self.whole_unless_even = units, blocks, whole_unless_even
        return self

    def __reduce__(self):
        return (_spec, (tuple(self), self.units, self.blocks, self.whole_unless_even))

    def __repr__(self) -> str:
        extra = ((f", units={self.units}" if self.units else "") + (f", blocks={self.blocks}" if self.blocks > 1 else "")
                 + (", whole_unless_even=True" if self.whole_unless_even else ""))
        return f"P({', '.join(map(repr, self))}{extra})"


def _spec(axes, units, blocks, whole_unless_even=False):
    return Spec(*axes, units=units, blocks=blocks, whole_unless_even=whole_unless_even)


def _like(spec, *axes) -> Spec:
    """A spec over ``axes`` that splits its ``model`` dimension as ``spec``
    (a :class:`Spec` or a plain tuple) does."""
    return Spec(*axes, units=getattr(spec, "units", None), blocks=getattr(spec, "blocks", 1),
                whole_unless_even=getattr(spec, "whole_unless_even", False))


P = Spec


def is_spec(x) -> bool:
    return isinstance(x, tuple)


def spec_map(fn, specs):
    """``fn`` over every spec of a spec tree (a spec is a tuple leaf)."""
    if isinstance(specs, dict):
        return {k: spec_map(fn, v) for k, v in specs.items()}
    return fn(specs)


def split_sizes(n: int, parts: int) -> List[int]:
    """``n`` split into ``parts`` blocks, the ceil-sized ones first."""
    base, rem = divmod(n, parts)
    return [base + 1] * rem + [base] * (parts - rem)


def block_range(n: int, parts: int, index: int, units: Optional[int] = None) -> Tuple[int, int]:
    """[lo, hi) of block ``index`` of an ``n``-wide dimension of ``units``
    whole units (default: ``n`` elements) split over ``parts``."""
    units = units or n
    if n % units:
        raise ValueError(f"a dimension of {n} is not {units} whole units")
    w = n // units
    sizes = split_sizes(units, parts)
    lo = sum(sizes[:index]) * w
    return lo, lo + sizes[index] * w


def qwen2_param_specs(cfg: TextConfig, *, fsdp: bool = False) -> dict:
    """Specs of the Qwen2 (or Qwen2-MoE) trunk's tree."""
    d = "data" if fsdp else None
    h, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
    specs = {
        "embed_tokens": P("model", None),
        "layers": {
            "input_layernorm": {"scale": P()},
            "post_attention_layernorm": {"scale": P()},
            "self_attn": {
                "q_proj": {"kernel": P(None, d, "model", units=h)},
                "k_proj": {"kernel": P(None, d, "model", units=kvh, whole_unless_even=True)},
                "v_proj": {"kernel": P(None, d, "model", units=kvh, whole_unless_even=True)},
                "o_proj": {"kernel": P(None, "model", d, units=h)},
            },
            "mlp": {
                "gate_proj": {"kernel": P(None, d, "model")},
                "up_proj": {"kernel": P(None, d, "model")},
                "down_proj": {"kernel": P(None, "model", d)},
            },
        },
        "norm": {"scale": P()},
    }
    if cfg.is_moe:
        # expert parallelism: the expert axis over `model`; the router
        # replicates and the shared expert splits like the dense MLP
        specs["layers"]["mlp"] = {
            "gate": {"kernel": P()},
            "experts": {
                "gate_proj": P(None, "model", None, None),
                "up_proj": P(None, "model", None, None),
                "down_proj": P(None, "model", None, None),
            },
            "shared_expert": {
                "gate_proj": {"kernel": P(None, d, "model")},
                "up_proj": {"kernel": P(None, d, "model")},
                "down_proj": {"kernel": P(None, "model", d)},
            },
            "shared_expert_gate": {"kernel": P()},
        }
    if cfg.attention_bias:
        for name, units in (("q_proj", h), ("k_proj", kvh), ("v_proj", kvh)):
            specs["layers"]["self_attn"][name]["bias"] = P(None, "model", units=units,
                                                           whole_unless_even=name != "q_proj")
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = {"kernel": P(None, "model")}
    return specs


# a LoRA bank's targets: the column-parallel ones (their output split like
# the target kernel's) and the row-parallel ones (their input split)
_COLUMN_TARGETS = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROW_TARGETS = ("o_proj", "down_proj")


def lora_bank_specs(cfg: TextConfig, bank: dict) -> dict:
    """Specs of a serving LoRA bank (``build_lora_bank``: leaves ``a`` [L,
    N, in, r] and ``b`` [L, N, r, out]) that mirror each target kernel's:
    on a column-parallel target ``a`` is whole and ``b`` holds the rank's
    output columns (whole heads for q / k / v; k / v whole on every rank
    where the kv heads do not split); on a row-parallel target ``a`` holds
    the rank's input rows and ``b`` is whole, so the rank's delta is a
    partial sum that joins the target's before the reduce."""
    h, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
    units = {"q_proj": h, "k_proj": kvh, "v_proj": kvh, "o_proj": h}
    out: dict = {}
    for group, names in bank["layers"].items():
        for name in names:
            u = units.get(name)
            if name in _COLUMN_TARGETS:
                spec = {"a": P(), "b": P(None, None, None, "model", units=u,
                                         whole_unless_even=name in ("k_proj", "v_proj"))}
            elif name in _ROW_TARGETS:
                spec = {"a": P(None, None, "model", None, units=u), "b": P()}
            else:
                raise ValueError(f"a LoRA bank target {group}.{name} has no tensor-parallel layout")
            out.setdefault(group, {})[name] = spec
    return {"layers": out}


def shard_lora_bank(cfg: TextConfig, bank: Optional[dict], mesh) -> Optional[dict]:
    """This rank's shard of a whole serving bank (:func:`lora_bank_specs`);
    the bank itself without a mesh or at tp 1, None without a bank."""
    if bank is None or mesh is None or mesh.axis_size("model") == 1:
        return bank
    return shard_params(bank, mesh, lora_bank_specs(cfg, bank))


def check_trunk_tp(cfg: TextConfig, tp: int) -> None:
    """The serving rule: the q heads split into whole heads, unevenly where
    tp does not divide them (:func:`split_sizes`), the kv heads split where
    tp divides them and stay whole on every rank otherwise (JAX's
    :func:`kv_cache_specs`), every other dimension splits by elements.  Only
    a rank that would hold no q head (tp above the q heads) is refused: the
    JAX package pads such a rank out."""
    h = cfg.num_attention_heads
    if tp > h:
        raise ValueError(f"tp={tp} would leave a rank without a q head (the trunk has {h}); serve at tp <= {h}")


def check_train_tp(cfg: TextConfig, tp: int) -> None:
    """The trainer's rule: tp divides both the q and the kv head counts, so
    that no weight is replicated over the model axis (replicated k / v
    kernels would need their gradients summed over the ranks, ROADMAP queue
    A, the trainer at an indivisible tp); serving takes any tp
    (:func:`check_trunk_tp`)."""
    h, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
    if tp > 1 and (h % tp or kvh % tp):
        raise ValueError(f"tp={tp} must divide the trunk's {h} q heads and {kvh} kv heads to train; the trainer "
                         "at an indivisible tp waits for ROADMAP queue A item 13 (serving takes it)")


def vision_param_specs(cfg: VisionConfig, *, fsdp: bool = False) -> dict:
    """Specs of the InternViT tree: qkv head-wise (``blocks=3``) and proj
    by heads, each split into whole heads however many there are."""
    d = "data" if fsdp else None
    h = cfg.num_attention_heads
    specs = {
        "class_embedding": P(),
        "position_embedding": P(),
        "patch_embedding": {"kernel": P(), "bias": P()},
        "layers": {
            "norm1": {"scale": P()},
            "norm2": {"scale": P()},
            "ls1": P(),
            "ls2": P(),
            "attn": {
                "qkv": {"kernel": P(None, d, "model", units=h, blocks=3)},
                "proj": {"kernel": P(None, "model", d, units=h), "bias": P()},
            },
            "mlp": {
                "fc1": {"kernel": P(None, d, "model"), "bias": P(None, "model")},
                "fc2": {"kernel": P(None, "model", d), "bias": P()},
            },
        },
    }
    if cfg.w8a8:  # the calibrated static fc1 scales [L] (read by the one-device glue route only)
        specs["layers"]["mlp"]["fc1_out_scale"] = P()
    if cfg.qkv_bias:
        specs["layers"]["attn"]["qkv"]["bias"] = P(None, "model", units=h, blocks=3)
    if cfg.qk_normalization:
        specs["layers"]["attn"]["q_norm"] = {"scale": P()}
        specs["layers"]["attn"]["k_norm"] = {"scale": P()}
    if cfg.norm_type == "layer_norm":
        specs["layers"]["norm1"]["bias"] = P()
        specs["layers"]["norm2"]["bias"] = P()
    return specs


def projector_specs(params: dict) -> dict:
    """mlpNx_gelu / linear projector: the first linear column-parallel, the
    rest row-parallel into a replicated output; the smoe expert bank
    (stacked [E, in, out]) the same along its trailing matmul dimensions,
    the router replicated; any other structure (cabstract) replicates."""
    out = {}
    names = sorted(k for k in params if k.startswith("linear_"))
    for i, name in enumerate(names):
        if i == 0 and len(names) > 1:
            out[name] = {"kernel": P(None, "model"), "bias": P("model")}
        elif i == 0:
            out[name] = {"kernel": P(), "bias": P()}
        else:
            out[name] = {"kernel": P("model", None), "bias": P()}
    if "experts" in params:
        enames = sorted(params["experts"])
        eout = {}
        for i, name in enumerate(enames):
            if i == 0 and len(enames) > 1:
                eout[name] = {"kernel": P(None, None, "model"), "bias": P(None, "model")}
            elif i == 0:
                eout[name] = {"kernel": P(), "bias": P()}
            else:
                eout[name] = {"kernel": P(None, "model", None), "bias": P()}
        out["experts"] = eout
    for k in params:
        if k not in out:
            out[k] = tree_map(lambda _: P(), params[k])
    return out


def specs_without_axis(specs, axis: str):
    """``axis`` replaced by None (replicated) everywhere in a spec tree."""

    def fix(spec):
        axes = [None if a == axis else (tuple(x for x in a if x != axis) if isinstance(a, tuple) else a)
                for a in spec]
        return _like(spec, *axes)

    return spec_map(fix, specs)


def omchat_param_specs(cfg: OmChatConfig, params: dict, *, fsdp: bool = False) -> dict:
    specs = {
        "vision_tower": vision_param_specs(cfg.vision, fsdp=fsdp),
        "projector": projector_specs(params.get("projector", {})),
        "language_model": qwen2_param_specs(cfg.text, fsdp=fsdp),
    }
    if "image_newline" in params:  # v1 spatial_unpad newline (replicated)
        specs["image_newline"] = P()
    return specs


def kv_cache_specs(cfg: TextConfig, mesh, batch: Optional[int] = None):
    """Cache [L, B, KVH, T, D]: batch over data, kv heads over model, each
    axis only where it divides evenly (else it replicates), JAX's spec.  The
    serving engines split their caches and page pools by it
    (:func:`local_kv_shape`): at a tp that does not divide the kv heads
    every rank holds all of them, as k_proj / v_proj are whole there."""
    from omchat_torch.models.qwen2 import KVCache

    tp, dp = mesh.axis_size("model"), mesh.axis_size("data")
    head_axis = "model" if cfg.num_key_value_heads % tp == 0 else None
    batch_axis = "data" if (batch is None or batch % dp == 0) else None
    spec = P(None, batch_axis, head_axis, None, None)
    return KVCache(k=spec, v=spec)


def local_kv_shape(cfg: TextConfig, mesh, lead: int, rows: int, *, pool: bool = False) -> List[int]:
    """This rank's shape of a cache [L, B=lead, KVH, T=rows, D] split by
    :func:`kv_cache_specs`, or with ``pool`` of a page pool [L, P+1=lead,
    KVH, page=rows, D], whose page axis never splits.  Without a mesh, the
    whole shape."""
    shape = [cfg.num_hidden_layers, lead, cfg.num_key_value_heads, rows, cfg.attn_head_dim]
    if mesh is None:
        return shape
    spec = kv_cache_specs(cfg, mesh, batch=lead).k
    if pool:
        spec = Spec(None, None, *spec[2:])
    return local_shape(shape, spec, mesh.coords(), mesh.shape)


def adapt_specs_to_quantized(specs, params):
    """A spec tree rewritten for an int8 tree: ``kernel_q`` keeps the
    kernel's spec (the JAX package's layout; the port stores the code
    matrix transposed, see :mod:`omchat_torch.ops.linear`), the
    per-output-channel ``scale`` drops the contraction axis."""
    if isinstance(specs, dict) and isinstance(params, dict):
        if "kernel" in specs and "kernel_q" in params:
            kspec = specs["kernel"]
            out = dict(specs)
            out.pop("kernel")
            out["kernel_q"] = kspec
            out["scale"] = _like(kspec, *(tuple(kspec[:-2]) + tuple(kspec[-1:]))) if len(kspec) >= 2 else P()
            if "bias" in out and "bias" not in params:
                out.pop("bias")
            return out
        return {k: adapt_specs_to_quantized(v, params.get(k, {})) for k, v in specs.items()}
    return specs


# --------------------------------------------------------------------------
# shards of one leaf
# --------------------------------------------------------------------------


def _axes(spec) -> List[Tuple[int, str]]:
    out = []
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        if isinstance(ax, tuple):
            raise NotImplementedError(f"spec {spec}: one dimension over several axes")
        out.append((dim, ax))
    return out


def _model_parts(n: int, spec, tp: int) -> List[List[Tuple[int, int]]]:
    """Per model rank, the [lo, hi) ranges (one per block) of an ``n``-wide
    dimension; the whole dimension on every rank for a
    ``whole_unless_even`` spec whose units tp does not divide."""
    if getattr(spec, "whole_unless_even", False) and (spec.units or n) % tp:
        return [[(0, n)]] * tp
    blocks = getattr(spec, "blocks", 1)
    per = n // blocks
    return [[(b * per + lo, b * per + hi) for b in range(blocks)
             for lo, hi in [block_range(per, tp, m, getattr(spec, "units", None))]] for m in range(tp)]


def shard_leaf(t: torch.Tensor, spec, coords: Dict[str, int], shape: Dict[str, int]) -> torch.Tensor:
    """The shard of ``t`` that the rank at ``coords`` holds on a mesh of
    ``shape`` ({axis: size}; an axis the mesh lacks replicates)."""
    for dim, ax in _axes(spec):
        size = shape.get(ax, 1)
        if size == 1:
            continue
        n = t.shape[dim]
        if ax == "model":
            t = torch.cat([t.narrow(dim, lo, hi - lo) for lo, hi in _model_parts(n, spec, size)[coords[ax]]], dim)
        else:
            if n % size:
                raise ValueError(f"a dimension of {n} does not split evenly over the {size} ranks of {ax!r} "
                                 f"(spec {spec}, shape {tuple(t.shape)}); the JAX package pads it, the port "
                                 "refuses it (ROADMAP queue A item 13)")
            t = t.narrow(dim, coords[ax] * (n // size), n // size)
    return t.contiguous().clone()


def local_shape(shape: Sequence[int], spec, coords: Dict[str, int], mesh_shape: Dict[str, int]) -> List[int]:
    """The shape of a leaf's shard at ``coords``."""
    out = list(shape)
    for dim, ax in _axes(spec):
        size = mesh_shape.get(ax, 1)
        if size == 1:
            continue
        if ax == "model":
            out[dim] = sum(hi - lo for lo, hi in _model_parts(shape[dim], spec, size)[coords[ax]])
        else:
            out[dim] = shape[dim] // size
    return out


def unshard_leaf(shards: Dict[Tuple[Tuple[str, int], ...], torch.Tensor], spec, shape: Dict[str, int]):
    """The canonical leaf from its shards keyed by coordinates
    (``tuple(sorted(coords.items()))``)."""
    axes = _axes(spec)

    def build(fixed: dict, rest: list):
        if not rest:
            key = tuple(sorted({**{a: 0 for a in shape}, **fixed}.items()))
            return shards[key]
        (dim, ax), rest = rest[0], rest[1:]
        size = shape.get(ax, 1)
        if size == 1:
            return build(fixed, rest)
        parts = [build({**fixed, ax: i}, rest) for i in range(size)]
        if ax != "model":
            return torch.cat(parts, dim)
        if getattr(spec, "whole_unless_even", False) and (spec.units or parts[0].shape[dim]) % size:
            return parts[0]  # every rank holds it whole
        blocks = getattr(spec, "blocks", 1)
        if blocks == 1:
            return torch.cat(parts, dim)
        split = [p.chunk(blocks, dim) for p in parts]
        return torch.cat([split[i][b] for b in range(blocks) for i in range(size)], dim)

    return build({}, axes)


# --------------------------------------------------------------------------
# trees
# --------------------------------------------------------------------------


def _spec_at(specs, path):
    node = specs
    for k in path:
        if is_spec(node):
            return node
        node = node[k]
    return node


def leaf_specs(params: dict, specs: dict) -> Dict[tuple, tuple]:
    """{leaf path: its spec} over the param tree.  Int8 leaves are adapted,
    and a ``kernel_q`` spec (in the JAX package's [in, out] terms) has its
    last two entries swapped for the port's [out, in] codes."""
    specs = adapt_specs_to_quantized(specs, params)
    out = {}
    for path, _ in tree_items(params):
        spec = _spec_at(specs, path)
        if path[-1] == "kernel_q" and len(spec) >= 2:
            spec = _like(spec, *(tuple(spec[:-2]) + (spec[-1], spec[-2])))
        out[path] = spec
    return out


def _set(tree: dict, path: tuple, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def shard_params(params: dict, mesh, specs: dict, coords: Optional[Dict[str, int]] = None) -> dict:
    """The local tree of the rank at ``coords`` (default: the mesh's own
    rank): each leaf's shard, contiguous and copied."""
    coords = coords if coords is not None else mesh.coords()
    by_path = leaf_specs(params, specs)
    out: dict = {}
    for path, t in tree_items(params):
        _set(out, path, shard_leaf(t, by_path[path], coords, mesh.shape) if isinstance(t, torch.Tensor) else t)
    return out


def gather_params(local, mesh, specs: dict, shapes: Optional[Dict[tuple, Sequence[int]]] = None) -> dict:
    """The canonical tree.  ``local``: {rank: that rank's tree} for every
    rank of the mesh (no process group needed), or this rank's tree in a
    live world, gathered through the world's collectives (``shapes``:
    {path: canonical shape}, needed there, from :func:`canonical_shapes`)."""
    if isinstance(local, dict) and local and all(isinstance(k, int) for k in local):
        trees = local
        any_tree = next(iter(trees.values()))
        by_path = leaf_specs(any_tree, specs)
        out: dict = {}
        for path, t in tree_items(any_tree):
            if not isinstance(t, torch.Tensor):
                _set(out, path, t)
                continue
            shards = {tuple(sorted(mesh.coords(r).items())): dict(tree_items(tree))[path] for r, tree in trees.items()}
            _set(out, path, unshard_leaf(shards, by_path[path], mesh.shape))
        return out
    return _gather_live(local, mesh, specs, shapes)


def shard_stacked(layer_fn, n_layers: int, mesh, specs: dict, device=None) -> dict:
    """This rank's shard of a tree stacked on a leading layer axis, built one
    layer at a time: ``layer_fn(i)`` gives layer ``i``'s whole tree (each
    leaf with a leading axis of 1, on any device); its shard is copied into
    the stacked shard on ``device``, allocated at the first layer, and the
    layer is dropped, so a rank holds its shard plus one whole layer.
    Without a mesh, the whole tree the same way."""
    out = None
    for i in range(n_layers):
        layer = layer_fn(i)
        shard = layer if mesh is None else shard_params(layer, mesh, specs)
        if out is None:
            out = tree_map(lambda t: torch.empty((n_layers, *t.shape[1:]), dtype=t.dtype, device=device), shard)
        for (_, dst), (_, src) in zip(tree_items(out), tree_items(shard)):
            dst[i].copy_(src[0])
        del layer, shard
    return out


def canonical_shapes(params: dict) -> Dict[tuple, List[int]]:
    return {path: list(t.shape) for path, t in tree_items(params) if isinstance(t, torch.Tensor)}


def _gather_live(local: dict, mesh, specs: dict, shapes) -> dict:
    """Every rank's shard of every leaf reaches every rank (one all-gather
    over the world per leaf, each shard padded to the largest), then the
    canonical leaf is assembled as from a dict of trees."""
    import torch.distributed as dist

    from omchat_torch.parallel.comm import issue

    world = mesh.size
    by_path = leaf_specs(local, specs)
    out: dict = {}
    ranks = list(range(world))  # all_gather_into_tensor orders the shards by world rank
    for path, t in tree_items(local):
        if not isinstance(t, torch.Tensor):
            _set(out, path, t)
            continue
        spec = by_path[path]
        if world == 1 or not _axes(spec):
            _set(out, path, t.detach().clone())
            continue
        full = shapes[path]
        sizes = [local_shape(full, spec, mesh.coords(r), mesh.shape) for r in ranks]
        numel = max(int(torch.Size(s).numel()) for s in sizes)
        flat = torch.zeros(numel, dtype=t.dtype, device=t.device)
        flat[: t.numel()] = t.detach().reshape(-1)
        buf = flat.new_empty(world * numel)
        issue("all_gather", dist.all_gather_into_tensor, buf, flat)
        shards = {tuple(sorted(mesh.coords(r).items())): buf[i * numel: i * numel + int(torch.Size(s).numel())]
                  .reshape(s) for i, (r, s) in enumerate(zip(ranks, sizes))}
        _set(out, path, unshard_leaf(shards, spec, mesh.shape))
    return out
