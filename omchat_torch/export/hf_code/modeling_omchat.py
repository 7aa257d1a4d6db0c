"""OmChat `trust_remote_code` model — standalone torch/transformers.

Shipped inside checkpoints exported by omchat-tpu's PyTorch port
(`omchat_torch.checkpoint.save.export_hf_bundle`); the directory loads via
`AutoModel.from_pretrained(..., trust_remote_code=True)` exactly like the
reference converter's output (its convert_omchat_to_hf.py:104-106,
hf_example.py:9-16).

This is an original torch implementation written to the exported weight
layout (`vision_tower.*` / `multi_modal_projector.*` / `language_model.*`,
see omchat_torch/checkpoint/save.py::flatten_to_hf_state), behaviorally
matching the omchat-tpu engines (the JAX package and its PyTorch port):

- InternViT tower: conv patchify + CLS + bicubic position-embedding
  interpolation, packed-QKV attention with optional qk-RMSNorm over the
  flattened head dim, pre-norm blocks with LayerScale, rms/layer-norm switch
  (the 300M geometry), NO final layernorm;
- linear / mlpNx_gelu projector;
- image-feature splice at the −200 sentinel positions, then a stock HF
  Qwen2/Qwen2-MoE decoder.

Token-id embedding clamps out-of-range ids to vocab_size−1, matching XLA's
gather clamping in the JAX engine (real checkpoints never hit this; the
hardcoded ChatML ids only exceed tiny test vocabularies).
"""

from typing import List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from transformers import Qwen2ForCausalLM, Qwen2MoeForCausalLM
from transformers.generation import GenerationMixin
from transformers.modeling_utils import PreTrainedModel

from .configuration_omchat import OmChatConfig, OmChatVisionConfig


class OmChatRMSNorm(nn.Module):
    def __init__(self, hidden_size: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden_size))
        self.variance_epsilon = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = x.float()
        x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.variance_epsilon)
        return (self.weight.float() * x).to(dtype)


def _make_norm(cfg: OmChatVisionConfig) -> nn.Module:
    if cfg.norm_type == "layer_norm":
        return nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
    return OmChatRMSNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class InternVisionEmbeddings(nn.Module):
    """Patchify conv + CLS token + position embeddings with bicubic
    interpolation for arbitrary grids (fp32 interpolation math)."""

    def __init__(self, cfg: OmChatVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.class_embedding = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Parameter(torch.zeros(1, n_pos, cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(
            cfg.num_channels, cfg.hidden_size, kernel_size=cfg.patch_size, stride=cfg.patch_size
        )

    def _pos_embed(self, h: int, w: int) -> torch.Tensor:
        pos = self.position_embedding
        src = self.cfg.image_size // self.cfg.patch_size
        if h == src and w == src:
            return pos
        cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
        d = pos.shape[-1]
        grid = patch_pos.float().reshape(1, src, src, d).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(h, w), mode="bicubic", align_corners=False)
        grid = grid.permute(0, 2, 3, 1).reshape(1, h * w, d).to(pos.dtype)
        return torch.cat([cls_pos, grid], dim=1)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(pixel_values.to(self.patch_embedding.weight.dtype))
        b, d, h, w = x.shape
        x = x.flatten(2).transpose(1, 2)  # [B, h*w, D]
        cls = self.class_embedding.expand(b, -1, -1)
        x = torch.cat([cls, x], dim=1)
        return x + self._pos_embed(h, w)


class InternAttention(nn.Module):
    """Packed-QKV non-causal attention; optional qk-RMSNorm over the
    flattened (heads × head_dim) axis before the head split."""

    def __init__(self, cfg: OmChatVisionConfig):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.qk_normalization = cfg.qk_normalization
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size, bias=cfg.qkv_bias)
        self.proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        if cfg.qk_normalization:
            self.q_norm = OmChatRMSNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
            self.k_norm = OmChatRMSNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        if self.qk_normalization:
            q = self.q_norm(q)
            k = self.k_norm(k)
        q = q.view(b, n, self.num_heads, self.head_dim).transpose(1, 2)
        k = k.view(b, n, self.num_heads, self.head_dim).transpose(1, 2)
        v = v.view(b, n, self.num_heads, self.head_dim).transpose(1, 2)
        out = F.scaled_dot_product_attention(q, k, v)
        out = out.transpose(1, 2).reshape(b, n, d)
        return self.proj(out)


class InternMLP(nn.Module):
    def __init__(self, cfg: OmChatVisionConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))  # exact erf GELU


class InternVisionEncoderLayer(nn.Module):
    """Pre-norm block with LayerScale: x + ls1·attn(norm1(x)); x + ls2·mlp(norm2(x))."""

    def __init__(self, cfg: OmChatVisionConfig):
        super().__init__()
        self.norm1 = _make_norm(cfg)
        self.norm2 = _make_norm(cfg)
        self.attn = InternAttention(cfg)
        self.mlp = InternMLP(cfg)
        self.ls1 = nn.Parameter(cfg.initializer_factor * torch.ones(cfg.hidden_size))
        self.ls2 = nn.Parameter(cfg.initializer_factor * torch.ones(cfg.hidden_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x)) * self.ls1
        x = x + self.mlp(self.norm2(x)) * self.ls2
        return x


class InternVisionEncoder(nn.Module):
    def __init__(self, cfg: OmChatVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            InternVisionEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)
        )

    def forward(self, x: torch.Tensor, feature_layer: int = -1) -> torch.Tensor:
        n = len(self.layers)
        n_run = n + 1 + feature_layer if feature_layer < 0 else feature_layer
        n_run = max(0, min(n, n_run))
        for layer in self.layers[:n_run]:
            x = layer(x)
        return x


class InternVisionModel(nn.Module):
    """No final layernorm — the last hidden state is the raw block output."""

    def __init__(self, cfg: OmChatVisionConfig):
        super().__init__()
        self.embeddings = InternVisionEmbeddings(cfg)
        self.encoder = InternVisionEncoder(cfg)

    def forward(self, pixel_values: torch.Tensor, feature_layer: int = -1) -> torch.Tensor:
        return self.encoder(self.embeddings(pixel_values), feature_layer=feature_layer)


class OmChatMultiModalProjector(nn.Module):
    """linear / mlpNx_gelu projector with `linear_i` child naming
    (the exported weight-layout contract; GELU is the exact erf form)."""

    def __init__(self, config: OmChatConfig):
        super().__init__()
        t = config.mm_projector_type
        mm, d = config.vision_config.hidden_size, config.text_config.hidden_size
        if t == "identity":
            self.depth = 0
            return
        import re

        m = re.match(r"^mlp(\d+)x_gelu$", t)
        self.depth = int(m.group(1)) if m else 1
        self.linear_1 = nn.Linear(mm, d)
        for i in range(2, self.depth + 1):
            setattr(self, f"linear_{i}", nn.Linear(d, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.depth == 0:
            return x
        x = self.linear_1(x)
        for i in range(2, self.depth + 1):
            x = getattr(self, f"linear_{i}")(F.gelu(x))
        return x


class OmChatPreTrainedModel(PreTrainedModel):
    config_class = OmChatConfig
    base_model_prefix = "model"
    supports_gradient_checkpointing = False
    _no_split_modules = ["InternVisionEncoderLayer", "Qwen2DecoderLayer", "Qwen2MoeDecoderLayer"]

    def _init_weights(self, module):
        std = 0.02
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            module.weight.data.normal_(mean=0.0, std=std)
            if module.bias is not None:
                module.bias.data.zero_()


class OmChatForConditionalGeneration(OmChatPreTrainedModel, GenerationMixin):
    """InternViT tower + projector + Qwen2 decoder with the −200 image splice."""

    def __init__(self, config: OmChatConfig):
        super().__init__(config)
        self.vision_tower = InternVisionModel(config.vision_config)
        self.multi_modal_projector = OmChatMultiModalProjector(config)
        lm_cls = (
            Qwen2MoeForCausalLM
            if getattr(config.text_config, "num_experts", 0)
            else Qwen2ForCausalLM
        )
        self.language_model = lm_cls(config.text_config)
        self.post_init()

    def get_input_embeddings(self):
        return self.language_model.get_input_embeddings()

    def set_input_embeddings(self, value):
        self.language_model.set_input_embeddings(value)

    def _embed_ids(self, input_ids: torch.Tensor) -> torch.Tensor:
        embed = self.get_input_embeddings()
        clamped = input_ids.clamp(min=0, max=embed.num_embeddings - 1)
        return embed(clamped)

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """[N, 3, H, W] tiles → [N, P, text_hidden] projected features
        (feature layer per config, CLS dropped for the 'default' strategy)."""
        hidden = self.vision_tower(images, feature_layer=self.config.vision_feature_layer)
        if self.config.vision_feature_select_strategy in ("default", "patch"):
            hidden = hidden[:, 1:]
        return self.multi_modal_projector(hidden)

    def _merge_images(
        self,
        input_ids: torch.Tensor,
        features: torch.Tensor,
        labels: Optional[torch.Tensor],
    ):
        """Splice tile features at the −200 sentinel positions, consuming
        tiles in order across the batch; pad rows to the merged max length
        (right padding).  Returns (inputs_embeds, attention_mask, labels)."""
        sentinel = self.config.image_token_index
        ignore = self.config.ignore_index
        rows_embeds: List[torch.Tensor] = []
        rows_labels: List[torch.Tensor] = []
        tile = 0
        for b in range(input_ids.shape[0]):
            ids = input_ids[b]
            pieces, lpieces = [], []
            start = 0
            positions = (ids == sentinel).nonzero(as_tuple=True)[0].tolist()
            lbl = labels[b] if labels is not None else None
            for pos in positions:
                if pos > start:
                    pieces.append(self._embed_ids(ids[start:pos]))
                    if lbl is not None:
                        lpieces.append(lbl[start:pos])
                pieces.append(features[tile])
                if lbl is not None:
                    lpieces.append(
                        torch.full((features.shape[1],), ignore, dtype=lbl.dtype, device=lbl.device)
                    )
                tile += 1
                start = pos + 1
            if start < ids.shape[0]:
                pieces.append(self._embed_ids(ids[start:]))
                if lbl is not None:
                    lpieces.append(lbl[start:])
            rows_embeds.append(torch.cat(pieces, dim=0))
            if lbl is not None:
                rows_labels.append(torch.cat(lpieces, dim=0))
        max_len = max(r.shape[0] for r in rows_embeds)
        if self.config.tokenizer_model_max_length:
            max_len = min(max_len, self.config.tokenizer_model_max_length)
        b = len(rows_embeds)
        embeds = rows_embeds[0].new_zeros(b, max_len, rows_embeds[0].shape[-1])
        mask = torch.zeros(b, max_len, dtype=torch.long, device=input_ids.device)
        out_labels = (
            torch.full((b, max_len), ignore, dtype=labels.dtype, device=labels.device)
            if labels is not None
            else None
        )
        for i, r in enumerate(rows_embeds):
            n = min(r.shape[0], max_len)
            embeds[i, :n] = r[:n]
            mask[i, :n] = 1
            if out_labels is not None:
                out_labels[i, :n] = rows_labels[i][:n]
        return embeds, mask, out_labels

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        past_key_values=None,
        inputs_embeds: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
        images: Optional[Union[torch.Tensor, List[torch.Tensor]]] = None,
        use_cache: Optional[bool] = None,
        **kwargs,
    ):
        past_len = past_key_values.get_seq_length() if past_key_values is not None else 0
        if inputs_embeds is None:
            if past_len > 0:
                # decode step: embed the new token(s); the mask covers the
                # merged cache (image features already live in the KV cache)
                inputs_embeds = self._embed_ids(input_ids)
                attention_mask = torch.ones(
                    input_ids.shape[0],
                    past_len + input_ids.shape[1],
                    dtype=torch.long,
                    device=input_ids.device,
                )
            elif images is not None and (input_ids == self.config.image_token_index).any():
                if isinstance(images, (list, tuple)):
                    images = torch.cat(list(images), dim=0)
                if images.dim() == 5:  # [B, N, 3, H, W] padded batch form
                    images = images.flatten(0, 1)
                features = self.encode_images(images)
                inputs_embeds, attention_mask, labels = self._merge_images(
                    input_ids, features, labels
                )
            else:
                inputs_embeds = self._embed_ids(input_ids)
        return self.language_model(
            attention_mask=attention_mask,
            position_ids=position_ids,
            past_key_values=past_key_values,
            inputs_embeds=inputs_embeds,
            labels=labels,
            use_cache=use_cache,
            **kwargs,
        )

    def prepare_inputs_for_generation(
        self,
        input_ids,
        past_key_values=None,
        attention_mask=None,
        images=None,
        use_cache=True,
        **kwargs,
    ):
        past_len = past_key_values.get_seq_length() if past_key_values is not None else 0
        if past_len > 0:
            input_ids = input_ids[:, -1:]
            images = None
            attention_mask = None  # rebuilt from the cache length in forward
        return {
            "input_ids": input_ids,
            "past_key_values": past_key_values,
            "attention_mask": attention_mask,
            "images": images,
            "use_cache": use_cache,
        }

    def _reorder_cache(self, *args, **kwargs):
        return self.language_model._reorder_cache(*args, **kwargs)
