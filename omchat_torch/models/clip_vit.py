"""CLIP and SigLIP vision towers — PyTorch port of
``omchat_tpu/models/clip_vit.py`` (the HF ``CLIPVisionModel`` /
``SiglipVisionModel`` transformer trunks, the reference builder's fallback
encoders).

- CLIP: CLS + learned position embeddings, ``pre_layrnorm`` (HF's spelling)
  before the encoder, pre-LayerNorm blocks, quick-GELU; no post-LN for
  feature extraction.
- SigLIP: no CLS token, the tanh GELU, the post-LN applied to the last
  hidden state; the attention-pooling head is not needed for features.
- ``clip_smoe`` (the legacy v1 knob): each layer's MLP is a top-k routed
  bank of expert MLPs (:mod:`omchat_torch.models.smoe`).

Attention goes through :func:`omchat_torch.ops.attention.attention`,
non-causal: on CUDA kernel K2 at the towers' head widths (64 for CLIP-L, 72
for SigLIP so400m).  Params keep the JAX package's layout (per-layer tensors
stacked on a leading axis, linear kernels [in, out]) but the patch conv,
which is OIHW for ``F.conv2d``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from omchat_torch.ops.attention import attention
from omchat_torch.ops.linear import dense, gelu_tanh
from omchat_torch.ops.norms import layer_norm
from omchat_torch.utils.tree import layer_list


@dataclass(frozen=True)
class ClipVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"  # siglip: "gelu_pytorch_tanh"
    use_class_token: bool = True  # siglip: False
    post_layernorm: bool = False  # siglip applies the final LN to the hidden states
    # CLIP-SMoE (the legacy v1 clip_smoe knob): each layer's MLP becomes a
    # top-k routed bank of num_experts MLPs
    clip_smoe: bool = False
    num_experts: int = 4
    num_selected: int = 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @staticmethod
    def siglip_so400m() -> "ClipVisionConfig":
        return ClipVisionConfig(
            hidden_size=1152,
            intermediate_size=4304,
            num_hidden_layers=27,
            num_attention_heads=16,
            image_size=384,
            patch_size=14,
            layer_norm_eps=1e-6,
            hidden_act="gelu_pytorch_tanh",
            use_class_token=False,
            post_layernorm=True,
        )


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name in ("gelu_pytorch_tanh", "gelu_new"):
        return gelu_tanh(x)
    return F.gelu(x)


def _mlp(cfg: ClipVisionConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return dense(_act(dense(x, p["fc1"]), cfg.hidden_act), p["fc2"])


def _layer(cfg: ClipVisionConfig, x: torch.Tensor, p: dict, attn_impl: Optional[str]) -> torch.Tensor:
    b, n, d = x.shape
    h, hd = cfg.num_attention_heads, cfg.head_dim
    y = layer_norm(x, p["layer_norm1"]["scale"], p["layer_norm1"]["bias"], cfg.layer_norm_eps)
    q = dense(y, p["attn"]["q_proj"]).reshape(b, n, h, hd)
    k = dense(y, p["attn"]["k_proj"]).reshape(b, n, h, hd)
    v = dense(y, p["attn"]["v_proj"]).reshape(b, n, h, hd)
    # HF CLIP scales q by head_dim^-0.5 before QK^T; attention() does the same
    o = attention(q, k, v, causal=False, impl=attn_impl).reshape(b, n, d)
    x = x + dense(o, p["attn"]["out_proj"])
    y = layer_norm(x, p["layer_norm2"]["scale"], p["layer_norm2"]["bias"], cfg.layer_norm_eps)
    if cfg.clip_smoe:
        from omchat_torch.models.smoe import expert_bank, smoe_route

        combine, _ = smoe_route(p["router"], y, cfg.num_selected)
        return x + expert_bank(p["experts"], y, combine, lambda ep, xx: _mlp(cfg, ep, xx))
    return x + _mlp(cfg, p["mlp"], y)


def clip_vit_forward(params: dict, cfg: ClipVisionConfig, pixel_values: torch.Tensor, *, feature_layer: int = -2,
                     attn_impl: Optional[str] = None) -> torch.Tensor:
    """[B, 3, H, W] → hidden states after layer ``feature_layer`` (HF
    hidden_states indexing: -1 = the last layer's output; the default -2 runs
    all layers but the last)."""
    kernel = params["patch_embedding"]["kernel"]
    x = F.conv2d(pixel_values.to(kernel.dtype), kernel, params["patch_embedding"].get("bias"),
                 stride=cfg.patch_size)  # [B, D, gh, gw]
    b, d = x.shape[:2]
    x = x.flatten(2).transpose(1, 2)  # [B, gh*gw, D]
    if cfg.use_class_token:
        x = torch.cat([params["class_embedding"].to(x.dtype).expand(b, 1, d), x], dim=1)
    x = x + params["position_embedding"][None].to(x.dtype)
    if "pre_layernorm" in params:
        x = layer_norm(x, params["pre_layernorm"]["scale"], params["pre_layernorm"]["bias"], cfg.layer_norm_eps)

    num_layers = cfg.num_hidden_layers
    n_run = num_layers + 1 + feature_layer if feature_layer < 0 else feature_layer
    n_run = max(0, min(num_layers, n_run))
    for layer in layer_list(params["layers"], n_run):
        x = _layer(cfg, x, layer, attn_impl)
    if cfg.post_layernorm and n_run == num_layers and "post_layernorm" in params:
        x = layer_norm(x, params["post_layernorm"]["scale"], params["post_layernorm"]["bias"], cfg.layer_norm_eps)
    return x


def convert_hf_clip_vision(state: Dict[str, torch.Tensor], cfg: ClipVisionConfig, dtype=torch.bfloat16,
                           prefix: str = "vision_model.") -> dict:
    """HF CLIPVisionModel / SiglipVisionModel state dict → tree.

    With ``cfg.clip_smoe`` the layers' MLPs become an expert bank from the
    reference's ``...layers.{i}.experts.{e}.fc*`` keys; a missing expert
    replicates the dense MLP (the reference's init) and a missing router
    starts uniform (zeros).  The tree stays on the state's device."""
    def g(k):
        return state[prefix + k]

    def cast(t):
        return t.to(dtype).contiguous()

    n = cfg.num_hidden_layers

    def stack(fmt, transpose=False):
        arrs = [g(fmt.format(i)) for i in range(n)]
        return cast(torch.stack([a.t() if transpose else a for a in arrs]))

    def proj(name):
        return {"kernel": stack("encoder.layers.{}." + name + ".weight", True),
                "bias": stack("encoder.layers.{}." + name + ".bias")}

    def norm(name):
        return {"scale": stack("encoder.layers.{}." + name + ".weight"),
                "bias": stack("encoder.layers.{}." + name + ".bias")}

    params = {
        "patch_embedding": {"kernel": cast(g("embeddings.patch_embedding.weight"))},  # OIHW
        "position_embedding": cast(g("embeddings.position_embedding.weight")),
        "layers": {
            "layer_norm1": norm("layer_norm1"),
            "layer_norm2": norm("layer_norm2"),
            "attn": {name: proj("self_attn." + name) for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "mlp": {"fc1": proj("mlp.fc1"), "fc2": proj("mlp.fc2")},
        },
    }
    if prefix + "embeddings.patch_embedding.bias" in state:
        params["patch_embedding"]["bias"] = cast(g("embeddings.patch_embedding.bias"))
    if cfg.use_class_token:
        params["class_embedding"] = cast(g("embeddings.class_embedding").reshape(-1))
    if cfg.clip_smoe:
        def expert_proj(name):
            def one(i, e):
                k = f"encoder.layers.{i}.experts.{e}.{name}."
                src = k if prefix + k + "weight" in state else f"encoder.layers.{i}.mlp.{name}."
                return g(src + "weight").t(), g(src + "bias")

            pairs = [[one(i, e) for e in range(cfg.num_experts)] for i in range(n)]
            return {"kernel": cast(torch.stack([torch.stack([w for w, _ in row]) for row in pairs])),
                    "bias": cast(torch.stack([torch.stack([b for _, b in row]) for row in pairs]))}

        params["layers"]["experts"] = {"fc1": expert_proj("fc1"), "fc2": expert_proj("fc2")}
        if prefix + "encoder.layers.0.router.weight" in state:
            params["layers"]["router"] = {"kernel": stack("encoder.layers.{}.router.weight", True),
                                          "bias": stack("encoder.layers.{}.router.bias")}
        else:
            dev = g("embeddings.position_embedding.weight").device
            params["layers"]["router"] = {
                "kernel": torch.zeros((n, cfg.hidden_size, cfg.num_experts), dtype=dtype, device=dev),
                "bias": torch.zeros((n, cfg.num_experts), dtype=dtype, device=dev),
            }
        del params["layers"]["mlp"]
    if prefix + "pre_layrnorm.weight" in state:  # HF CLIP's spelling
        params["pre_layernorm"] = {"scale": cast(g("pre_layrnorm.weight")), "bias": cast(g("pre_layrnorm.bias"))}
    if prefix + "post_layernorm.weight" in state:
        params["post_layernorm"] = {"scale": cast(g("post_layernorm.weight")), "bias": cast(g("post_layernorm.bias"))}
    return params
