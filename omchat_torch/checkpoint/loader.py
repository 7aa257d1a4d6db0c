"""Checkpoint loading: safetensors → the port's param tree — PyTorch port of
``omchat_tpu/checkpoint/loader.py``.

Both key layouts of the reference's converter (convert_omchat_to_hf.py:26-59):

- HF bundle: ``vision_tower.*``, ``multi_modal_projector.linear_N.*``,
  ``language_model.model.*``, ``language_model.lm_head.weight``;
- repo-native: ``model.vision_tower.vision_tower.*``,
  ``model.mm_projector.{0,2}.*``, ``model.*``, ``lm_head.weight``.

Torch linear weights [out, in] are transposed to the port's [in, out]; the
patch conv stays OIHW; per-layer tensors are stacked on a leading layer axis.
Files are read with ``safetensors.torch``.  Stand-alone projector and LoRA
adapter loading come with later slices.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Optional

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


def normalize_key_layout(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Map repo-native key names onto the HF-bundle layout (the canonical one)."""
    out = {}
    for key, val in state.items():
        if key.endswith(".inv_freq"):
            continue
        if key.startswith("model.vision_tower."):
            key = key[len("model.vision_tower.") :]
        elif key.startswith("model.mm_projector."):
            rest = key[len("model.mm_projector.") :]
            m = re.match(r"^(\d+)\.(.*)$", rest)
            rest = f"linear_{int(m.group(1)) // 2 + 1}.{m.group(2)}" if m else f"linear_1.{rest}"
            key = f"multi_modal_projector.{rest}"
        elif key.startswith("model.") or key.startswith("lm_head."):
            key = "language_model." + key
        out[key] = val
    return out


def _stacker(state, n_layers: int, dtype, device):
    def stack(fmt: str, transpose: bool = False) -> torch.Tensor:
        arrs = [state[fmt.format(i)] for i in range(n_layers)]
        if transpose:
            arrs = [a.t() for a in arrs]
        return torch.stack(arrs).to(dtype=dtype, device=device).contiguous()

    return stack


def convert_vision_tower(state: Dict[str, torch.Tensor], cfg: VisionConfig, dtype=torch.bfloat16, device=None) -> dict:
    """Keys like ``embeddings.class_embedding``, ``encoder.layers.N...`` → tree."""
    stack = _stacker(state, cfg.num_hidden_layers, dtype, device)
    one = lambda k: state[k].to(dtype=dtype, device=device).contiguous()  # noqa: E731
    lay = "encoder.layers.{}."
    params = {
        "class_embedding": one("embeddings.class_embedding").reshape(-1),
        "position_embedding": one("embeddings.position_embedding")[0],
        "patch_embedding": {
            "kernel": one("embeddings.patch_embedding.weight"),  # OIHW, as F.conv2d takes it
            "bias": one("embeddings.patch_embedding.bias"),
        },
        "layers": {
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
        },
    }
    if "encoder.layers.0.attn.qkv.bias" in state:
        params["layers"]["attn"]["qkv"]["bias"] = stack(lay + "attn.qkv.bias")
    if cfg.qk_normalization:
        params["layers"]["attn"]["q_norm"] = {"scale": stack(lay + "attn.q_norm.weight")}
        params["layers"]["attn"]["k_norm"] = {"scale": stack(lay + "attn.k_norm.weight")}
    if cfg.norm_type == "layer_norm":
        params["layers"]["norm1"]["bias"] = stack(lay + "norm1.bias")
        params["layers"]["norm2"]["bias"] = stack(lay + "norm2.bias")
    return params


def convert_qwen2(state: Dict[str, torch.Tensor], cfg: TextConfig, dtype=torch.bfloat16, device=None) -> dict:
    """Keys like ``model.embed_tokens.weight``, ``model.layers.N...``,
    ``lm_head.weight`` → tree (dense trunk)."""
    if cfg.is_moe:
        raise NotImplementedError("Qwen2-MoE checkpoints wait for the MoE slice")
    stack = _stacker(state, cfg.num_hidden_layers, dtype, device)
    one = lambda k: state[k].to(dtype=dtype, device=device).contiguous()  # noqa: E731

    def proj(name, bias):
        p = {"kernel": stack("model.layers.{}." + name + ".weight", True)}
        if bias:
            p["bias"] = stack("model.layers.{}." + name + ".bias")
        return p

    params = {
        "embed_tokens": one("model.embed_tokens.weight"),
        "layers": {
            "input_layernorm": {"scale": stack("model.layers.{}.input_layernorm.weight")},
            "post_attention_layernorm": {"scale": stack("model.layers.{}.post_attention_layernorm.weight")},
            "self_attn": {
                "q_proj": proj("self_attn.q_proj", cfg.attention_bias),
                "k_proj": proj("self_attn.k_proj", cfg.attention_bias),
                "v_proj": proj("self_attn.v_proj", cfg.attention_bias),
                "o_proj": proj("self_attn.o_proj", False),
            },
            "mlp": {
                "gate_proj": proj("mlp.gate_proj", False),
                "up_proj": proj("mlp.up_proj", False),
                "down_proj": proj("mlp.down_proj", False),
            },
        },
        "norm": {"scale": one("model.norm.weight")},
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in state:
        params["lm_head"] = {"kernel": state["lm_head.weight"].t().to(dtype=dtype, device=device).contiguous()}
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


def load_omchat_checkpoint(model_path: str, dtype=torch.bfloat16, config: Optional[OmChatConfig] = None,
                           device=None):
    """Load config + weights from a checkpoint directory → (cfg, params)."""
    if config is None:
        config = OmChatConfig.from_json(os.path.join(model_path, "config.json"))
    state = load_safetensors_dir(model_path)
    return config, convert_omchat_state_dict(state, config, dtype, device)
