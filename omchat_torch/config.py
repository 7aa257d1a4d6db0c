"""Typed configuration tree for the PyTorch port of OmChat (a copy of
``omchat_tpu/config.py``; the port imports nothing of the JAX package).

The reference scatters configuration across argparse flags, HF ``PretrainedConfig``
attributes read via ``getattr`` defaults, and training namespaces (see SURVEY.md §5
"Config / flag system").  Here there is exactly one typed tree; HF checkpoint
``config.json`` files remain the source of truth via :meth:`OmChatConfig.from_hf_dict`
(key names follow the reference's omchat/hf/configuration_omchat.py).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple


def _filter_kwargs(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass(frozen=True)
class VisionConfig:
    """InternViT geometry (reference: intern_vit_6b/configuration_intern_vit.py:63-83).

    Defaults are the InternViT-6B-448px geometry used by the omchat-v2.0-13B
    checkpoint.  :meth:`internvit_300m` gives the 300M alternative
    (intern_vit_300m/configuration_intern_vit.py:67-74).
    """

    hidden_size: int = 3200
    intermediate_size: int = 12800
    num_hidden_layers: int = 45
    num_attention_heads: int = 25
    num_channels: int = 3
    patch_size: int = 14
    image_size: int = 448
    qkv_bias: bool = False
    qk_normalization: bool = True
    norm_type: str = "rms_norm"  # 300M uses "layer_norm"
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-6
    initializer_factor: float = 0.1  # LayerScale init value
    drop_path_rate: float = 0.0
    attention_dropout: float = 0.0
    dropout: float = 0.0
    # Serving mode (not an HF checkpoint key): int8×int8 matmuls with dynamic
    # per-token activation quantization (the ViT encode; see
    # models/intern_vit.py).
    w8a8: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patch_tokens(self) -> int:
        """Patch tokens per tile, excluding CLS (1024 for 448px/14px)."""
        return self.num_patches_per_side**2

    @property
    def seq_len(self) -> int:
        """Sequence length through the encoder (CLS + patches)."""
        return self.num_patch_tokens + 1

    @staticmethod
    def internvit_6b() -> "VisionConfig":
        return VisionConfig()

    @staticmethod
    def internvit_300m() -> "VisionConfig":
        # reference: intern_vit_300m/configuration_intern_vit.py:67-74
        return VisionConfig(
            hidden_size=1024,
            intermediate_size=4096,
            num_hidden_layers=24,
            num_attention_heads=16,
            qk_normalization=False,
            norm_type="layer_norm",
            drop_path_rate=0.1,
        )

    @staticmethod
    def from_hf_dict(d: dict) -> "VisionConfig":
        d = dict(d)
        d.setdefault("norm_type", "rms_norm")
        return VisionConfig(**_filter_kwargs(VisionConfig, d))


@dataclass(frozen=True)
class RopeScalingConfig:
    """RoPE scaling — the reference's long-context mechanism
    (modeling_llama.py:156-198: linear and dynamic-NTK)."""

    rope_type: str = "linear"  # "linear" | "dynamic"
    factor: float = 1.0

    @staticmethod
    def from_hf_dict(d: Optional[dict]) -> Optional["RopeScalingConfig"]:
        if d is None:
            return None
        return RopeScalingConfig(
            rope_type=d.get("rope_type", d.get("type", "linear")),
            factor=float(d.get("factor", 1.0)),
        )


@dataclass(frozen=True)
class TextConfig:
    """Qwen2 / Qwen2-MoE decoder geometry (HF Qwen2Config-compatible keys).

    Defaults are Qwen2-7B (the omchat-v2.0-13B text tower). MoE fields are only
    read when ``num_experts > 0`` (reference alt decoder:
    omchat/model/language_model/omchat_qwen2_moe.py).
    """

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    head_dim: Optional[int] = None
    hidden_act: str = "silu"
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    rope_scaling: Optional[RopeScalingConfig] = None
    attention_bias: bool = True  # Qwen2 uses qkv bias, no o bias
    tie_word_embeddings: bool = False
    # MoE (Qwen2-MoE) — 0 experts means dense.
    num_experts: int = 0
    num_experts_per_tok: int = 4
    moe_intermediate_size: int = 0
    shared_expert_intermediate_size: int = 0
    decoder_sparse_step: int = 1
    norm_topk_prob: bool = False
    mlp_only_layers: Tuple[int, ...] = ()
    # Serving mode (not an HF key): int8×int8 matmuls with dynamic activation
    # quantization on the prefill path (decode stays weight-only int8).
    w8a8: bool = False

    @property
    def attn_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.hidden_size // self.num_attention_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def moe_layer(self, layer_idx: int) -> bool:
        """Whether ``layer_idx`` uses the sparse MoE block (HF Qwen2Moe semantics)."""
        if not self.is_moe:
            return False
        if layer_idx in self.mlp_only_layers:
            return False
        return (layer_idx + 1) % self.decoder_sparse_step == 0 if self.decoder_sparse_step > 1 else True

    @staticmethod
    def qwen2_7b() -> "TextConfig":
        return TextConfig()

    @staticmethod
    def from_hf_dict(d: dict) -> "TextConfig":
        d = dict(d)
        d["rope_scaling"] = RopeScalingConfig.from_hf_dict(d.get("rope_scaling"))
        if "mlp_only_layers" in d and d["mlp_only_layers"] is not None:
            d["mlp_only_layers"] = tuple(d["mlp_only_layers"])
        return TextConfig(**_filter_kwargs(TextConfig, d))


@dataclass(frozen=True)
class ProjectorConfig:
    """Multimodal projector (reference: multimodal_projector/builder.py:39-66).

    ``mlp2x_gelu`` is the HF-checkpoint projector, Linear(3200→3584)+GELU+
    Linear(3584→3584) (hf/modeling_omchat.py:523-535).
    """

    projector_type: str = "mlp2x_gelu"  # linear | mlpNx_gelu | cabstract | identity
    n_query: int = 144  # cabstract only
    depth: int = 3  # cabstract RegStage depth
    mlp_depth: int = 2  # derived from mlpNx_gelu
    # MoE-LLaVA sparse projector (legacy v1 knobs, omchat_llama.py:58-63):
    # mlpNx_gelu becomes a top-k routed bank of num_experts expert MLPs
    mlp_smoe: bool = False
    num_experts: int = 4
    num_selected: int = 2

    @staticmethod
    def from_type(
        projector_type: str,
        n_query: int = 144,
        mlp_smoe: bool = False,
        num_experts: int = 4,
        num_selected: int = 2,
    ) -> "ProjectorConfig":
        import re

        m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
        mlp_depth = int(m.group(1)) if m else 1
        return ProjectorConfig(
            projector_type=projector_type, n_query=n_query, mlp_depth=mlp_depth,
            mlp_smoe=mlp_smoe, num_experts=num_experts, num_selected=num_selected,
        )


@dataclass(frozen=True)
class OmChatConfig:
    """Top-level model config; mirrors hf/configuration_omchat.py:99-198."""

    vision: VisionConfig = field(default_factory=VisionConfig)
    text: TextConfig = field(default_factory=TextConfig)
    projector: ProjectorConfig = field(default_factory=ProjectorConfig)
    image_grid_pinpoints: Tuple[Tuple[int, int], ...] = (
        (448, 896),
        (896, 448),
        (896, 896),
        (1344, 448),
        (448, 1344),
        (1344, 1344),
    )
    # The HF bundle hardcodes hidden_states[-1] minus CLS (modeling_omchat.py:750-753);
    # the repo-native stack reads mm_vision_select_layer. -1/"patch" is the parity target.
    vision_feature_layer: int = -1
    vision_feature_select_strategy: str = "default"  # "default" drops CLS
    image_token_index: int = -200
    ignore_index: int = -100
    tokenizer_model_max_length: Optional[int] = None
    tokenizer_padding_side: str = "right"
    # OmChat-v1 legacy fusion (reference omchat_llama.py:421-459): "flat" is
    # the v2 per-tile sentinel expansion; "spatial"/"spatial_unpad" arranges
    # each image's tiles into the anyres grid (LLaVA-NeXT layout) with a
    # learned image_newline — one sentinel per IMAGE, variable tokens.
    mm_patch_merge_type: str = "flat"

    @property
    def image_seq_len(self) -> int:
        """Projected tokens contributed per tile."""
        if self.projector.projector_type == "cabstract":
            return self.projector.n_query
        return self.vision.num_patch_tokens

    @staticmethod
    def from_hf_dict(d: dict) -> "OmChatConfig":
        vision = VisionConfig.from_hf_dict(d.get("vision_config", {}) or {})
        text = TextConfig.from_hf_dict(d.get("text_config", {}) or {})
        proj = ProjectorConfig.from_type(
            d.get("mm_projector_type", "mlp2x_gelu"),
            n_query=d.get("mm_projector_n_query") or 144,  # builder.py:45-48
            # legacy v1 MoE-LLaVA knobs (omchat_llama.py:58-63) — flat keys
            mlp_smoe=bool(d.get("mlp_smoe", False)),
            num_experts=d.get("num_experts") or 4,
            num_selected=d.get("num_selected") or 2,
        )
        pin = d.get("image_grid_pinpoints")
        pinpoints = tuple(tuple(p) for p in pin) if pin else OmChatConfig.image_grid_pinpoints
        return OmChatConfig(
            vision=vision,
            text=text,
            projector=proj,
            image_grid_pinpoints=pinpoints,
            vision_feature_layer=d.get("vision_feature_layer", -1),
            vision_feature_select_strategy=d.get("vision_feature_select_strategy", "default"),
            tokenizer_model_max_length=d.get("tokenizer_model_max_length"),
            tokenizer_padding_side=d.get("tokenizer_padding_side", "right"),
            mm_patch_merge_type=d.get("mm_patch_merge_type", "flat"),
        )

    def with_w8a8(self) -> "OmChatConfig":
        """Serving mode: int8×int8 matmuls on the compute-bound paths
        (ViT encode + LLM prefill); decode stays weight-only int8."""
        return dataclasses.replace(
            self,
            vision=dataclasses.replace(self.vision, w8a8=True),
            text=dataclasses.replace(self.text, w8a8=True),
        )

    def to_hf_dict(self) -> dict:
        """Inverse of :meth:`from_hf_dict`: the loadable HF-bundle config.json
        content (the shape hf/configuration_omchat.py:99-198 serializes).
        Serving-only fields (w8a8) are not checkpoint keys and are omitted."""
        vision = dataclasses.asdict(self.vision)
        vision.pop("w8a8", None)
        text = dataclasses.asdict(self.text)
        text.pop("w8a8", None)
        text["mlp_only_layers"] = list(self.text.mlp_only_layers)
        if self.text.rope_scaling is not None:
            text["rope_scaling"] = {
                "rope_type": self.text.rope_scaling.rope_type,
                "factor": self.text.rope_scaling.factor,
            }
        d = {
            "model_type": "omchat",
            "architectures": ["OmChatForConditionalGeneration"],
            "vision_config": vision,
            "text_config": text,
            "mm_projector_type": self.projector.projector_type,
            "mm_projector_n_query": self.projector.n_query,
            "image_grid_pinpoints": [list(p) for p in self.image_grid_pinpoints],
            "vision_feature_layer": self.vision_feature_layer,
            "vision_feature_select_strategy": self.vision_feature_select_strategy,
            "image_token_index": self.image_token_index,
            "ignore_index": self.ignore_index,
            "tokenizer_padding_side": self.tokenizer_padding_side,
        }
        if self.mm_patch_merge_type != "flat":
            d["mm_patch_merge_type"] = self.mm_patch_merge_type
        if self.projector.mlp_smoe:
            d["mlp_smoe"] = True
            d["num_experts"] = self.projector.num_experts
            d["num_selected"] = self.projector.num_selected
        if self.tokenizer_model_max_length is not None:
            d["tokenizer_model_max_length"] = self.tokenizer_model_max_length
        return d

    @staticmethod
    def from_json(path: str) -> "OmChatConfig":
        with open(path) as f:
            return OmChatConfig.from_hf_dict(json.load(f))

    @staticmethod
    def omchat_v2_13b() -> "OmChatConfig":
        """The flagship omchat-v2.0-13B-single-beta_hf geometry."""
        return OmChatConfig()

    @staticmethod
    def tiny(vocab_size: int = 512) -> "OmChatConfig":
        """A tiny config for tests: 2-layer ViT on 56px images, 2-layer decoder."""
        return OmChatConfig(
            vision=VisionConfig(
                hidden_size=64,
                intermediate_size=128,
                num_hidden_layers=2,
                num_attention_heads=4,
                image_size=56,
                patch_size=14,
            ),
            text=TextConfig(
                vocab_size=vocab_size,
                hidden_size=64,
                intermediate_size=128,
                num_hidden_layers=2,
                num_attention_heads=4,
                num_key_value_heads=2,
                max_position_embeddings=1024,
            ),
            image_grid_pinpoints=((56, 112), (112, 56), (112, 112)),
        )


@dataclass(frozen=True)
class GenerationConfig:
    """Decode-loop parameters (reference defaults: single_inference.py:52-62)."""

    max_new_tokens: int = 1024
    eos_token_id: int = 151645
    do_sample: bool = False
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    # OpenAI-style repetition controls (engine path; 0.0 = off).  Applied as
    # logits[t] -= presence*1[count(t)>0] + frequency*count(t) over the
    # tokens generated so far, before temperature/top-k/top-p.
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
