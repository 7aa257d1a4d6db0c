"""OmChat `trust_remote_code` configuration.

This file is shipped inside checkpoints exported by omchat-tpu's PyTorch
port (`omchat_torch.checkpoint.save.export_hf_bundle`) so the directory loads
with `AutoModel.from_pretrained(..., trust_remote_code=True)` — the same
interop surface the reference converter produces (its
convert_omchat_to_hf.py:104-106, hf_example.py:9-16).  It is standalone
torch/transformers code with no dependency on either omchat package; the
JAX package ships the same code (its export/hf_code).
"""

from transformers import Qwen2Config, Qwen2MoeConfig
from transformers.configuration_utils import PretrainedConfig


class OmChatVisionConfig(PretrainedConfig):
    """InternViT geometry (defaults: the 6B-448px tower of omchat-v2.0-13B)."""

    model_type = "omchat_vision"

    def __init__(
        self,
        hidden_size=3200,
        intermediate_size=12800,
        num_hidden_layers=45,
        num_attention_heads=25,
        num_channels=3,
        patch_size=14,
        image_size=448,
        qkv_bias=False,
        qk_normalization=True,
        norm_type="rms_norm",
        hidden_act="gelu",
        layer_norm_eps=1e-6,
        initializer_factor=0.1,
        drop_path_rate=0.0,
        attention_dropout=0.0,
        dropout=0.0,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_channels = num_channels
        self.patch_size = patch_size
        self.image_size = image_size
        self.qkv_bias = qkv_bias
        self.qk_normalization = qk_normalization
        self.norm_type = norm_type
        self.hidden_act = hidden_act
        self.layer_norm_eps = layer_norm_eps
        self.initializer_factor = initializer_factor
        self.drop_path_rate = drop_path_rate
        self.attention_dropout = attention_dropout
        self.dropout = dropout


class OmChatConfig(PretrainedConfig):
    """Composite config: InternViT vision tower + Qwen2/Qwen2-MoE decoder +
    multimodal projector and anyres-tiling parameters."""

    model_type = "omchat"
    sub_configs = {"vision_config": OmChatVisionConfig}

    def __init__(
        self,
        vision_config=None,
        text_config=None,
        mm_projector_type="mlp2x_gelu",
        mm_projector_n_query=144,
        image_grid_pinpoints=None,
        vision_feature_layer=-1,
        vision_feature_select_strategy="default",
        image_token_index=-200,
        ignore_index=-100,
        tokenizer_padding_side="right",
        tokenizer_model_max_length=None,
        **kwargs,
    ):
        if vision_config is None:
            vision_config = {}
        if isinstance(vision_config, dict):
            vision_config = OmChatVisionConfig(**vision_config)
        self.vision_config = vision_config

        if text_config is None:
            text_config = {}
        if isinstance(text_config, dict):
            text_config = dict(text_config)
            if text_config.get("head_dim") is None:
                text_config.pop("head_dim", None)
            cls = Qwen2MoeConfig if text_config.get("num_experts") else Qwen2Config
            text_config = cls(**text_config)
        self.text_config = text_config

        self.mm_projector_type = mm_projector_type
        self.mm_projector_n_query = mm_projector_n_query
        self.image_grid_pinpoints = image_grid_pinpoints or [
            [448, 896], [896, 448], [896, 896], [1344, 448], [448, 1344], [1344, 1344]
        ]
        self.vision_feature_layer = vision_feature_layer
        self.vision_feature_select_strategy = vision_feature_select_strategy
        self.image_token_index = image_token_index
        self.ignore_index = ignore_index
        self.tokenizer_padding_side = tokenizer_padding_side
        self.tokenizer_model_max_length = tokenizer_model_max_length
        super().__init__(**kwargs)
