"""Checkpoint loading: safetensors → the port's param tree — PyTorch port of
``omchat_tpu/checkpoint/loader.py``.

Both key layouts of the reference's converter (convert_omchat_to_hf.py:26-59):

- HF bundle: ``vision_tower.*``, ``multi_modal_projector.linear_N.*``,
  ``language_model.model.*``, ``language_model.lm_head.weight``;
- repo-native: ``model.vision_tower.vision_tower.*``,
  ``model.mm_projector.{0,2}.*``, ``model.*``, ``lm_head.weight``.

Torch linear weights [out, in] are transposed to the port's [in, out]; the
patch conv stays OIHW; per-layer tensors are stacked on a leading layer axis.
Files are read with ``safetensors.torch``.  :func:`load_mm_projector` and
:func:`load_lora_adapter` read the training artifacts (stage-1 projector,
LoRA adapter) that either package writes.
"""

from __future__ import annotations

import glob
import os
import re
from collections.abc import Mapping
from typing import Dict, Optional, Sequence

import torch

from omchat_torch.config import OmChatConfig, TextConfig, VisionConfig


def load_safetensors_dir(directory: str) -> Dict[str, torch.Tensor]:
    """Read all ``*.safetensors`` in a directory into one flat dict (CPU)."""
    from safetensors.torch import safe_open

    out: Dict[str, torch.Tensor] = {}
    paths = sorted(glob.glob(os.path.join(directory, "*.safetensors")))
    if not paths:
        raise FileNotFoundError(f"no .safetensors under {directory}")
    for path in paths:
        with safe_open(path, framework="pt") as f:
            for key in f.keys():
                out[key] = f.get_tensor(key)
    return out


def _canonical_key(key: str) -> Optional[str]:
    """A repo-native key's HF-bundle name (None: a key the loader drops)."""
    if key.endswith(".inv_freq"):
        return None
    if key.startswith("model.vision_tower."):
        return key[len("model.vision_tower.") :]
    if key.startswith("model.mm_projector."):
        rest = key[len("model.mm_projector.") :]
        m = re.match(r"^(\d+)\.(.*)$", rest)
        rest = f"linear_{int(m.group(1)) // 2 + 1}.{m.group(2)}" if m else f"linear_1.{rest}"
        return f"multi_modal_projector.{rest}"
    if key.startswith("model.") or key.startswith("lm_head."):
        return "language_model." + key
    return key


def normalize_key_layout(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Map repo-native key names onto the HF-bundle layout (the canonical one)."""
    return {_canonical_key(k): v for k, v in state.items() if _canonical_key(k) is not None}


class LazyState(Mapping):
    """A checkpoint directory's tensors by canonical (HF-bundle) key, each
    read from its memory-mapped file when looked up, so that a rank reads
    only the layers it converts.  ``sub(prefix)``: the keys under
    ``prefix``, with it stripped."""

    def __init__(self, directory: Optional[str] = None, *, _keys=None, _handles=None):
        if _keys is not None:
            self._keys, self._handles = _keys, _handles
            return
        from safetensors.torch import safe_open

        paths = sorted(glob.glob(os.path.join(directory, "*.safetensors")))
        if not paths:
            raise FileNotFoundError(f"no .safetensors under {directory}")
        self._handles = [safe_open(path, framework="pt") for path in paths]
        names = [(i, k) for i, f in enumerate(self._handles) for k in f.keys()]
        native = any(k.startswith("model.") for _, k in names)
        self._keys = {(_canonical_key(k) if native else k): (i, k) for i, k in names}
        self._keys.pop(None, None)

    def __getitem__(self, key: str) -> torch.Tensor:
        i, k = self._keys[key]
        return self._handles[i].get_tensor(k)

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def sub(self, prefix: str) -> "LazyState":
        keys = {k[len(prefix):]: v for k, v in self._keys.items() if k.startswith(prefix)}
        return LazyState(_keys=keys, _handles=self._handles)


def _stacker(state, n_layers, dtype, device):
    """``stack(fmt)``: the leaf of every layer in ``n_layers`` (a count, or
    the layer indices to take) stacked on a leading axis."""
    indices = range(n_layers) if isinstance(n_layers, int) else n_layers

    def stack(fmt: str, transpose: bool = False) -> torch.Tensor:
        arrs = [state[fmt.format(i)] for i in indices]
        if transpose:
            arrs = [a.t() for a in arrs]
        return torch.stack(arrs).to(dtype=dtype, device=device).contiguous()

    return stack


def convert_vision_tower(state: Dict[str, torch.Tensor], cfg: VisionConfig, dtype=torch.bfloat16, device=None) -> dict:
    """Keys like ``embeddings.class_embedding``, ``encoder.layers.N...`` → tree."""
    return {**vision_top(state, dtype, device), "layers": convert_vision_layers(state, cfg, dtype, device)}


def vision_top(state, dtype=torch.bfloat16, device=None) -> dict:
    """The tower's leaves outside its layers: the embeddings."""
    one = lambda k: state[k].to(dtype=dtype, device=device).contiguous()  # noqa: E731
    return {
        "class_embedding": one("embeddings.class_embedding").reshape(-1),
        "position_embedding": one("embeddings.position_embedding")[0],
        "patch_embedding": {
            "kernel": one("embeddings.patch_embedding.weight"),  # OIHW, as F.conv2d takes it
            "bias": one("embeddings.patch_embedding.bias"),
        },
    }


def convert_vision_layers(state, cfg: VisionConfig, dtype=torch.bfloat16, device=None,
                          layers: Optional[Sequence[int]] = None) -> dict:
    """The tower's ``layers`` subtree: every layer, or those in ``layers``
    stacked in that order."""
    stack = _stacker(state, cfg.num_hidden_layers if layers is None else layers, dtype, device)
    lay = "encoder.layers.{}."
    params = {
        "norm1": {"scale": stack(lay + "norm1.weight")},
        "norm2": {"scale": stack(lay + "norm2.weight")},
        "ls1": stack(lay + "ls1"),
        "ls2": stack(lay + "ls2"),
        "attn": {
            "qkv": {"kernel": stack(lay + "attn.qkv.weight", True)},
            "proj": {"kernel": stack(lay + "attn.proj.weight", True), "bias": stack(lay + "attn.proj.bias")},
        },
        "mlp": {
            "fc1": {"kernel": stack(lay + "mlp.fc1.weight", True), "bias": stack(lay + "mlp.fc1.bias")},
            "fc2": {"kernel": stack(lay + "mlp.fc2.weight", True), "bias": stack(lay + "mlp.fc2.bias")},
        },
    }
    if "encoder.layers.0.attn.qkv.bias" in state:
        params["attn"]["qkv"]["bias"] = stack(lay + "attn.qkv.bias")
    if cfg.qk_normalization:
        params["attn"]["q_norm"] = {"scale": stack(lay + "attn.q_norm.weight")}
        params["attn"]["k_norm"] = {"scale": stack(lay + "attn.k_norm.weight")}
    if cfg.norm_type == "layer_norm":
        params["norm1"]["bias"] = stack(lay + "norm1.bias")
        params["norm2"]["bias"] = stack(lay + "norm2.bias")
    return params


def convert_qwen2(state: Dict[str, torch.Tensor], cfg: TextConfig, dtype=torch.bfloat16, device=None) -> dict:
    """Keys like ``model.embed_tokens.weight``, ``model.layers.N...``,
    ``lm_head.weight`` → tree (the dense trunk, or with ``cfg.is_moe`` the
    MoE trunk's layers, :func:`~omchat_torch.models.qwen2_moe.
    convert_hf_moe_layers`)."""
    params = qwen2_top(state, cfg, dtype, device)
    params["layers"] = qwen2_layers(state, cfg, dtype, device)
    return params


def qwen2_top(state, cfg: TextConfig, dtype=torch.bfloat16, device=None) -> dict:
    """The trunk's leaves outside its layers: the embedding, the final norm
    and an untied lm_head."""
    one = lambda k: state[k].to(dtype=dtype, device=device).contiguous()  # noqa: E731
    params = {"embed_tokens": one("model.embed_tokens.weight"), "norm": {"scale": one("model.norm.weight")}}
    if not cfg.tie_word_embeddings and "lm_head.weight" in state:
        params["lm_head"] = {"kernel": state["lm_head.weight"].t().to(dtype=dtype, device=device).contiguous()}
    return params


def qwen2_layers(state, cfg: TextConfig, dtype=torch.bfloat16, device=None,
                 layers: Optional[Sequence[int]] = None) -> dict:
    """The trunk's ``layers`` subtree: every layer, or those in ``layers``
    stacked in that order."""
    stack = _stacker(state, cfg.num_hidden_layers if layers is None else layers, dtype, device)

    def proj(name, bias):
        p = {"kernel": stack("model.layers.{}." + name + ".weight", True)}
        if bias:
            p["bias"] = stack("model.layers.{}." + name + ".bias")
        return p

    params = {
        "input_layernorm": {"scale": stack("model.layers.{}.input_layernorm.weight")},
        "post_attention_layernorm": {"scale": stack("model.layers.{}.post_attention_layernorm.weight")},
        "self_attn": {
            "q_proj": proj("self_attn.q_proj", cfg.attention_bias),
            "k_proj": proj("self_attn.k_proj", cfg.attention_bias),
            "v_proj": proj("self_attn.v_proj", cfg.attention_bias),
            "o_proj": proj("self_attn.o_proj", False),
        },
    }
    if cfg.is_moe:
        from omchat_torch.models.qwen2_moe import convert_hf_moe_layers

        params["mlp"] = convert_hf_moe_layers(state, cfg, dtype, device, layers)
    else:
        params["mlp"] = {
            "gate_proj": proj("mlp.gate_proj", False),
            "up_proj": proj("mlp.up_proj", False),
            "down_proj": proj("mlp.down_proj", False),
        }
    return params


def convert_projector(state: Dict[str, torch.Tensor], dtype=torch.bfloat16, device=None) -> dict:
    """Keys like ``linear_1.weight`` → tree."""
    params: dict = {}
    for key, val in state.items():
        m = re.match(r"^(linear_\d+)\.(weight|bias)$", key)
        if not m:
            continue
        name, kind = m.group(1), m.group(2)
        val = val.t() if kind == "weight" else val
        params.setdefault(name, {})["kernel" if kind == "weight" else "bias"] = (
            val.to(dtype=dtype, device=device).contiguous()
        )
    return params


def _subdict(state: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix) :]: v for k, v in state.items() if k.startswith(prefix)}


def convert_omchat_state_dict(state: Dict[str, torch.Tensor], cfg: OmChatConfig, dtype=torch.bfloat16,
                              device=None) -> dict:
    """Full OmChat checkpoint (either key layout) → tree with top-level
    {vision_tower, projector, language_model}."""
    if any(k.startswith("model.") for k in state):
        state = normalize_key_layout(state)
    vt_prefix = (
        "vision_tower.vision_tower."
        if any(k.startswith("vision_tower.vision_tower.") for k in state)
        else "vision_tower."
    )
    out = {
        "vision_tower": convert_vision_tower(_subdict(state, vt_prefix), cfg.vision, dtype, device),
        "projector": convert_projector(_subdict(state, "multi_modal_projector."), dtype, device),
        "language_model": convert_qwen2(_subdict(state, "language_model."), cfg.text, dtype, device),
    }
    for key in ("image_newline", "language_model.model.image_newline"):
        if key in state:
            out["image_newline"] = state[key].to(dtype=dtype, device=device)
            break
    return out


def load_mm_projector(path: str, dtype=torch.bfloat16, device=None) -> dict:
    """Load a projector-only checkpoint (the stage-1 ``pretrain_mm_mlp_adapter``)
    → projector tree.  ``path``: a directory holding ``mm_projector.safetensors``
    (or the reference's ``mm_projector.bin``), or the file.  Key layouts:
    ``multi_modal_projector.linear_N.*`` (``save_mm_projector``, the HF
    bundle), ``model.mm_projector.I.*`` (nn.Sequential indices, I // 2 + 1 =
    N) and dotted native ``projector.<path>`` keys."""
    if os.path.isdir(path):
        for name in ("mm_projector.safetensors", "mm_projector.bin"):
            if os.path.exists(os.path.join(path, name)):
                path = os.path.join(path, name)
                break
        else:
            raise FileNotFoundError(f"no mm_projector.safetensors/.bin in {path}")
    if path.endswith(".bin"):
        raw = torch.load(path, map_location="cpu", weights_only=True)
        state = {k.split("mm_projector.")[1]: v for k, v in raw.items() if "mm_projector" in k}
    else:
        from safetensors.torch import load_file

        state = load_file(path)
        if any(k.startswith("projector.") for k in state):
            out: dict = {}
            for k, v in state.items():
                node, parts = out, k.split(".")[1:]
                for part in parts[:-1]:
                    node = node.setdefault(part, {})
                node[parts[-1]] = v.to(dtype=dtype, device=device)
            return out
        if any(k.startswith("multi_modal_projector.") for k in state):
            return convert_projector(_subdict(state, "multi_modal_projector."), dtype, device)
        state = {k.split("mm_projector.")[-1]: v for k, v in state.items()}
    remapped = {}
    for k, v in state.items():
        m = re.match(r"^(\d+)\.(weight|bias)$", k)
        if m:
            remapped[f"linear_{int(m.group(1)) // 2 + 1}.{m.group(2)}"] = v
    if not remapped:
        raise ValueError(f"unrecognized projector checkpoint key layout in {path}")
    return convert_projector(remapped, dtype, device)


def load_lora_adapter(directory: str, dtype=torch.bfloat16, device=None) -> dict:
    """Read an adapter written by either package's ``save_lora_adapter`` into
    the LoRA tree layout (``training/lora.py``)."""
    import json

    from safetensors.torch import load_file

    with open(os.path.join(directory, "adapter_config.json")) as f:
        meta = json.load(f)
    if meta.get("format") != "omchat-tpu-lora":
        raise ValueError(f"not an omchat LoRA adapter: {directory}")
    layers: dict = {}
    for key, arr in load_file(os.path.join(directory, "adapter_model.safetensors")).items():
        prefix, group, name, leaf = key.split(".")
        if prefix != "layers" or leaf not in ("a", "b"):
            raise ValueError(f"unexpected adapter key {key}")
        layers.setdefault(group, {}).setdefault(name, {})[leaf] = arr.to(dtype=dtype, device=device)
    return {"layers": layers, "scale": float(meta["scale"])}


def load_omchat_checkpoint(model_path: str, dtype=torch.bfloat16, config: Optional[OmChatConfig] = None,
                           device=None):
    """Load config + weights from a checkpoint directory → (cfg, params)."""
    if config is None:
        config = OmChatConfig.from_json(os.path.join(model_path, "config.json"))
    state = load_safetensors_dir(model_path)
    return config, convert_omchat_state_dict(state, config, dtype, device)


def load_omchat_checkpoint_sharded(model_path: str, mesh, dtype=torch.bfloat16, config: Optional[OmChatConfig] = None,
                                   device=None, transform=None):
    """(cfg, this rank's shard of the tree) from a checkpoint directory,
    read one layer at a time: the leaves outside the layer stacks are
    converted on the host and sharded, then every layer of the tower and of
    the trunk is read, converted, passed through ``transform`` and sharded
    into the stacked shard on ``device``
    (:func:`omchat_torch.parallel.sharding.shard_stacked`), so a rank's
    device holds its shard and at most one whole layer.  The specs are
    :func:`~omchat_torch.parallel.sharding.omchat_param_specs` (an int8 tree
    through ``adapt_specs_to_quantized``).  ``transform(tree, where, index)``
    (``where``: "rest", "vision_layer" or "text_layer", a layer with a
    leading axis of 1, on the host) is what must see whole weights before
    they are split: the LoRA merge, the int8 quantization, the w8a8
    calibration; ``index`` is the layer's, None for "rest".  It sees "rest"
    first, then the tower's layers in order, then the trunk's.  An MoE
    layer's experts are read whole and split into whole experts."""
    from omchat_torch.parallel.sharding import omchat_param_specs, shard_params, shard_stacked
    from omchat_torch.utils.tree import tree_map

    if config is None:
        config = OmChatConfig.from_json(os.path.join(model_path, "config.json"))
    transform = transform or (lambda tree, where, index: tree)
    state = LazyState(model_path)
    vt = state.sub("vision_tower.vision_tower." if any(k.startswith("vision_tower.vision_tower.") for k in state)
                   else "vision_tower.")
    lm = state.sub("language_model.")
    host = torch.device("cpu")
    rest = {
        "vision_tower": vision_top(vt, dtype, host),
        "projector": convert_projector(state.sub("multi_modal_projector."), dtype, host),
        "language_model": qwen2_top(lm, config.text, dtype, host),
    }
    for key in ("image_newline", "language_model.model.image_newline"):
        if key in state:
            rest["image_newline"] = state[key].to(dtype=dtype)
            break
    rest = transform(rest, "rest", None)
    specs = omchat_param_specs(config, rest)
    params = tree_map(lambda t: t.to(device), shard_params(rest, mesh, specs))
    params["vision_tower"]["layers"] = shard_stacked(
        lambda i: transform(convert_vision_layers(vt, config.vision, dtype, host, [i]), "vision_layer", i),
        config.vision.num_hidden_layers, mesh, specs["vision_tower"]["layers"], device)
    params["language_model"]["layers"] = shard_stacked(
        lambda i: transform(qwen2_layers(lm, config.text, dtype, host, [i]), "text_layer", i),
        config.text.num_hidden_layers, mesh, specs["language_model"]["layers"], device)
    return config, params
