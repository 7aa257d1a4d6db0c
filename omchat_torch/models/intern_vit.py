"""InternViT vision tower — PyTorch port of ``omchat_tpu/models/intern_vit.py``.

- conv patchify + CLS + bicubic-interpolated position embeddings
  (modeling_intern_vit.py:61-102),
- packed-QKV attention with qk-RMSNorm over the flattened head dim,
- pre-norm blocks with LayerScale ls1/ls2; no final norm.

Params are a dict of tensors in the JAX package's layout (per-layer tensors
stacked on a leading layer axis, linear kernels [in, out]) except the patch
conv, which is OIHW for ``F.conv2d``.  The w8a8 glue scan and the fc1
calibration come with the w8a8 slice.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from omchat_torch.config import VisionConfig
from omchat_torch.ops.attention import PLAIN, attention
from omchat_torch.ops.flash_attention import packed_prescale, packed_qkv_norm_attention, packed_seq_supported
from omchat_torch.ops.linear import dense
from omchat_torch.utils.tree import layer_slice
from omchat_torch.ops.norms import apply_norm, rms_norm


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel with A=-0.75 (torch bicubic)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=64)
def bicubic_interp_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] matrix matching F.interpolate(mode='bicubic',
    align_corners=False) with index clamping at the borders."""
    if src == dst:
        return np.eye(src, dtype=np.float32)
    scale = src / dst
    out = np.zeros((dst, src), dtype=np.float64)
    for i in range(dst):
        center = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(center))
        t = center - x0
        taps = np.array([x0 - 1, x0, x0 + 1, x0 + 2])
        weights = _cubic_kernel(np.array([t + 1.0, t, 1.0 - t, 2.0 - t]))
        for tap, w in zip(taps, weights):
            out[i, min(max(tap, 0), src - 1)] += w
    return out.astype(np.float32)


def interpolate_pos_embed(pos_embed: torch.Tensor, src_grid: int, dst_h: int, dst_w: int) -> torch.Tensor:
    """Bicubic-resample patch position embeddings [src*src, D] → [dst_h*dst_w, D] in fp32."""
    if src_grid == dst_h == dst_w:
        return pos_embed
    d = pos_embed.shape[-1]
    grid = pos_embed.float().reshape(src_grid, src_grid, d)
    mh = torch.from_numpy(bicubic_interp_matrix(src_grid, dst_h)).to(pos_embed.device)
    mw = torch.from_numpy(bicubic_interp_matrix(src_grid, dst_w)).to(pos_embed.device)
    grid = torch.einsum("hs,swd->hwd", mh, grid)
    grid = torch.einsum("wt,htd->hwd", mw, grid)
    return grid.reshape(dst_h * dst_w, d).to(pos_embed.dtype)


def embeddings(params: dict, cfg: VisionConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """Patchify + CLS + position embeddings.  [B, 3, H, W] → [B, 1+N, D]."""
    kernel = params["patch_embedding"]["kernel"]  # OIHW [D, 3, P, P]
    dtype = kernel.dtype
    x = F.conv2d(pixel_values.to(dtype), kernel, stride=cfg.patch_size)
    x = x + params["patch_embedding"]["bias"].to(dtype)[:, None, None]
    b, d, h, w = x.shape
    patch_embeds = x.flatten(2).transpose(1, 2)  # [B, h*w, D]
    cls = params["class_embedding"].to(dtype).expand(b, 1, d)
    embeds = torch.cat([cls, patch_embeds], dim=1)
    pos = params["position_embedding"]  # [1+N_train, D]
    patch_pos = interpolate_pos_embed(pos[1:], cfg.num_patches_per_side, h, w)
    pos = torch.cat([pos[:1], patch_pos], dim=0)
    return embeds + pos[None].to(dtype)


def _attention_fused(cfg: VisionConfig, layer: dict, qkv: torch.Tensor, valid_len: int) -> torch.Tensor:
    """qk-norm (prescale folded into the q gamma) + packed attention on
    [B, SP, 3D] — kernel K1 on CUDA."""
    if not cfg.qk_normalization:
        raise NotImplementedError("packed attention without qk-norm (300M tower) waits for a later slice")
    return packed_qkv_norm_attention(
        qkv,
        num_heads=cfg.num_attention_heads,
        q_gamma=layer["attn"]["q_norm"]["scale"] * packed_prescale(cfg.head_dim),
        k_gamma=layer["attn"]["k_norm"]["scale"],
        eps=cfg.layer_norm_eps,
        valid_len=valid_len,
    )


def _layer_forward(
    cfg: VisionConfig,
    x: torch.Tensor,
    layer: dict,
    *,
    attn_impl: Optional[str],
    fused_valid_len: Optional[int] = None,
) -> torch.Tensor:
    """One pre-norm block: x + ls1*attn(norm1(x)); x + ls2*mlp(norm2(x)).

    ``fused_valid_len`` selects the packed path: q/k/v stay in the
    [B, SP, 3*H*D] layout the qkv matmul writes and rows >= fused_valid_len
    are padding."""
    b, n, d = x.shape
    h, hd = cfg.num_attention_heads, cfg.head_dim
    y = apply_norm(x, layer["norm1"], cfg.layer_norm_eps)
    qkv = dense(y, layer["attn"]["qkv"])
    if fused_valid_len is not None:
        attn_out = _attention_fused(cfg, layer, qkv, fused_valid_len)
    else:
        q, k, v = qkv.chunk(3, dim=-1)
        if cfg.qk_normalization:
            q = rms_norm(q, layer["attn"]["q_norm"]["scale"], cfg.layer_norm_eps)
            k = rms_norm(k, layer["attn"]["k_norm"]["scale"], cfg.layer_norm_eps)
        q = q.reshape(b, n, h, hd)
        k = k.reshape(b, n, h, hd)
        v = v.reshape(b, n, h, hd)
        attn_out = attention(q, k, v, causal=False, impl=attn_impl).reshape(b, n, d)
    x = x + dense(attn_out, layer["attn"]["proj"]) * layer["ls1"]
    y = apply_norm(x, layer["norm2"], cfg.layer_norm_eps)
    y = dense(F.gelu(dense(y, layer["mlp"]["fc1"])), layer["mlp"]["fc2"])  # exact erf GELU
    return x + y * layer["ls2"]


def intern_vit_forward(
    params: dict,
    cfg: VisionConfig,
    pixel_values: torch.Tensor,
    *,
    feature_layer: int = -1,
    attn_impl: Optional[str] = None,
) -> torch.Tensor:
    """Run the tower; returns hidden states after layer ``feature_layer``
    (-1: the last; CLS kept, see :func:`feature_select`).

    Packed path (any device, unless ``attn_impl="plain"``): when the head
    width allows, the whole stack runs at the sequence length padded once to
    a multiple of 8 — every op but attention is row-local and attention masks
    the pad columns — so nothing is re-packed around the attention kernel.
    ``attn_impl="plain"`` takes the split path with the plain reference
    attention (the JAX package's ``attn_impl="xla"``)."""
    x = embeddings(params, cfg, pixel_values)
    s = x.shape[1]
    fused = attn_impl != PLAIN and packed_seq_supported(cfg.head_dim) and cfg.qk_normalization
    sp = (s + 7) // 8 * 8 if fused else s
    if sp != s:
        x = F.pad(x, (0, 0, 0, sp - s))

    num_layers = cfg.num_hidden_layers
    n_run = num_layers + 1 + feature_layer if feature_layer < 0 else feature_layer
    n_run = max(0, min(num_layers, n_run))
    layers = params["layers"]
    for i in range(n_run):
        x = _layer_forward(cfg, x, layer_slice(layers, i), attn_impl=attn_impl, fused_valid_len=s if fused else None)
    return x[:, :s] if sp != s else x


def feature_select(hidden: torch.Tensor, strategy: str = "default") -> torch.Tensor:
    """'default' drops the CLS token (reference feature_select, internVIT_encoder.py:35-43)."""
    if strategy in ("default", "patch"):
        return hidden[:, 1:]
    if strategy in ("full", "cls_patch"):
        return hidden
    raise ValueError(f"Unknown vision_feature_select_strategy: {strategy}")


def init_params(cfg: VisionConfig, generator: torch.Generator, dtype=torch.float32, device=None) -> dict:
    """Random weights from a seeded generator (the JAX ``init_params``
    distribution, not its bits): normal(0, 0.02) matrices, unit norms,
    LayerScale at ``initializer_factor``."""
    d, f, l = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    device = device if device is not None else generator.device

    def nrm(shape, scale=0.02):
        return torch.randn(shape, generator=generator, device=device, dtype=dtype).mul_(scale)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    params = {
        "class_embedding": nrm((d,), 1.0),
        "position_embedding": nrm((cfg.num_patch_tokens + 1, d)),
        "patch_embedding": {
            "kernel": nrm((d, cfg.num_channels, cfg.patch_size, cfg.patch_size)),
            "bias": full((d,), 0.0),
        },
        "layers": {
            "norm1": {"scale": full((l, d), 1.0)},
            "norm2": {"scale": full((l, d), 1.0)},
            "ls1": full((l, d), cfg.initializer_factor),
            "ls2": full((l, d), cfg.initializer_factor),
            "attn": {
                "qkv": {"kernel": nrm((l, d, 3 * d))},
                "proj": {"kernel": nrm((l, d, d)), "bias": full((l, d), 0.0)},
            },
            "mlp": {
                "fc1": {"kernel": nrm((l, d, f)), "bias": full((l, f), 0.0)},
                "fc2": {"kernel": nrm((l, f, d)), "bias": full((l, d), 0.0)},
            },
        },
    }
    if cfg.qkv_bias:
        params["layers"]["attn"]["qkv"]["bias"] = full((l, 3 * d), 0.0)
    if cfg.qk_normalization:
        params["layers"]["attn"]["q_norm"] = {"scale": full((l, d), 1.0)}
        params["layers"]["attn"]["k_norm"] = {"scale": full((l, d), 1.0)}
    if cfg.norm_type == "layer_norm":
        params["layers"]["norm1"]["bias"] = full((l, d), 0.0)
        params["layers"]["norm2"]["bias"] = full((l, d), 0.0)
    return params
