"""InternViT vision tower — PyTorch port of ``omchat_tpu/models/intern_vit.py``.

- conv patchify + CLS + bicubic-interpolated position embeddings
  (modeling_intern_vit.py:61-102),
- packed-QKV attention, with qk-RMSNorm over the flattened head dim where the
  tower has it,
- pre-norm blocks with LayerScale ls1/ls2; no final norm.

Params are a dict of tensors in the JAX package's layout (per-layer tensors
stacked on a leading layer axis, linear kernels [in, out]) except the patch
conv, which is OIHW for ``F.conv2d``, and quantized int8 kernels, which are
[out, in] (:mod:`omchat_torch.ops.linear`).

w8a8 (``cfg.w8a8`` with quantized params): the matmuls run int8 x int8 with
per-token activation quantization and the MLP takes the tanh GELU.  On the
packed path the stack runs as the glue scan (:func:`_layer_forward_glue`):
each layer hands the next its residual stream plus the int8 codes and row
scales of its normed value, so every residual + norm + quantize is one fused
pass (K8, K11) and fc1 writes int8 codes (K9, with the static scales of
:func:`calibrate_fc1_scales`).

Tensor parallelism (``mesh``: the training pass, and the serving engines'
encode under a mesh, where the split path's attention is K2 on the rank's
heads, since K1's fused qk-norm cannot sum over ranks): a rank holds its
heads of q, of k and of v in the head-wise ``qkv`` shard
(:mod:`omchat_torch.parallel.sharding`; 25 heads split 13 + 12 at tp 2), its
slice of fc1 and of its bias, and the rows of proj and fc2 that read them;
the outputs of proj and fc2 are reduced over the model axis before their
replicated biases and LayerScale.  w8a8 under a mesh is the unfused chain
(the glue scan needs the packed path, as JAX's glue route needs its Pallas
route): qkv and fc1 are column products on the replicated normed input,
proj and fc2 row products over the whole row's codes with their int32
partials summed (:func:`~omchat_torch.parallel.comm.row_parallel_int8`),
and a calibrated ``fc1_out_scale`` rides in the shard unread.  The qk-RMSNorm normalizes over the whole
(head, head_dim) axis, so a rank's sum of squares over its own heads is
summed over the model axis and divided by the full width.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from omchat_torch.config import VisionConfig
from omchat_torch.ops.attention import attention
from omchat_torch.ops.flash_attention import (
    packed_prescale,
    packed_qkv_norm_attention,
    packed_self_attention,
    packed_seq_supported,
)
from omchat_torch.ops.linear import dense, dense_prequant, div127, gelu_tanh, quantize_activations
from omchat_torch.ops.norms import add_rmsnorm_quant, apply_norm, rms_norm
from omchat_torch.ops.quant_matmul import attn_proj_glue_quant, fc1_gelu_quant, proj_glue_supported
from omchat_torch.parallel.comm import copy_to_axis, gather_layer, model_slice, row_parallel_dense, sum_over_axis
from omchat_torch.utils.tree import layer_list, layer_slice


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
    """Packed attention on [B, SP, 3D]: with qk-norm (prescale folded into
    the q gamma) kernel K1 on CUDA; without, the q/k/v column blocks read in
    place and prescaled in the kernel, K5."""
    if not cfg.qk_normalization:
        q, k, v = qkv.chunk(3, dim=-1)
        return packed_self_attention(q, k, v, num_heads=cfg.num_attention_heads, valid_len=valid_len,
                                     prescaled=False)
    return packed_qkv_norm_attention(
        qkv,
        num_heads=cfg.num_attention_heads,
        q_gamma=layer["attn"]["q_norm"]["scale"] * packed_prescale(cfg.head_dim),
        k_gamma=layer["attn"]["k_norm"]["scale"],
        eps=cfg.layer_norm_eps,
        valid_len=valid_len,
    )


def _qk_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, width: int, mesh) -> torch.Tensor:
    """RMSNorm over the whole (head, head_dim) axis of ``width``.  ``mesh``:
    ``x`` holds this rank's heads and ``scale`` their slice of the gamma;
    the sum of squares of its own columns is summed over the model axis (in
    both directions: every rank uses the sum for its own heads), over
    ``width``."""
    if mesh is None:
        return rms_norm(x, scale, eps)
    xf = x.float()
    var = sum_over_axis(xf.square().sum(dim=-1, keepdim=True), mesh) / width
    return (scale.float() * (xf * torch.rsqrt(var + eps))).to(x.dtype)


def _layer_forward(
    cfg: VisionConfig,
    x: torch.Tensor,
    layer: dict,
    *,
    attn_impl: Optional[str],
    fused_valid_len: Optional[int] = None,
    with_fc1_amax: bool = False,
    mesh=None,
):
    """One pre-norm block: x + ls1*attn(norm1(x)); x + ls2*mlp(norm2(x)).

    ``fused_valid_len`` selects the packed path: q/k/v stay in the
    [B, SP, 3*H*D] layout the qkv matmul writes and rows >= fused_valid_len
    are padding.  ``with_fc1_amax`` also returns max |gelu(fc1(.))| (the
    calibration pass).  ``mesh``: ``layer`` is this rank's tensor-parallel
    shard (the split path): its heads of q, k and v, its slice of fc1; the
    normed inputs enter through *copy to the model axis* and proj's and
    fc2's partial sums (in w8a8 the int32 accumulators) are reduced before
    their replicated biases and LayerScale."""
    b, n, d = x.shape
    hd = cfg.head_dim
    a8 = cfg.w8a8
    if mesh is not None and fused_valid_len is not None:
        raise NotImplementedError("a tensor-parallel ViT layer runs the split path")
    y = copy_to_axis(apply_norm(x, layer["norm1"], cfg.layer_norm_eps), mesh)
    qkv = dense(y, layer["attn"]["qkv"], a8=a8)
    if fused_valid_len is not None:
        attn_out = _attention_fused(cfg, layer, qkv, fused_valid_len)
    else:
        q, k, v = qkv.chunk(3, dim=-1)
        if cfg.qk_normalization:
            heads = model_slice(d, mesh, units=cfg.num_attention_heads)
            q = _qk_norm(q, copy_to_axis(layer["attn"]["q_norm"]["scale"], mesh)[heads], cfg.layer_norm_eps, d,
                         mesh)
            k = _qk_norm(k, copy_to_axis(layer["attn"]["k_norm"]["scale"], mesh)[heads], cfg.layer_norm_eps, d,
                         mesh)
        q = q.reshape(b, n, -1, hd)
        k = k.reshape(b, n, -1, hd)
        v = v.reshape(b, n, -1, hd)
        attn_out = attention(q, k, v, causal=False, impl=attn_impl).reshape(b, n, -1)
    x = x + row_parallel_dense(attn_out, layer["attn"]["proj"], mesh, a8=a8) * layer["ls1"]
    y = copy_to_axis(apply_norm(x, layer["norm2"], cfg.layer_norm_eps), mesh)
    # exact erf GELU, except in w8a8 on quantized params: the tanh form, whose
    # output is re-quantized at once (the JAX package's choice)
    hid = dense(y, layer["mlp"]["fc1"], a8=a8)
    hid = gelu_tanh(hid) if a8 and "kernel_q" in layer["mlp"]["fc1"] else F.gelu(hid)
    x = x + row_parallel_dense(hid, layer["mlp"]["fc2"], mesh, a8=a8) * layer["ls2"]
    if with_fc1_amax:
        return x, hid.float().abs().amax()
    return x


def _layer_forward_glue(cfg: VisionConfig, carry: tuple, layer: dict, *, valid_len: int) -> tuple:
    """w8a8 packed-path block.  The carry is (x, int8 codes of norm1(x), row
    scales); ``layer["next_norm1_scale"]`` is the next layer's norm1 gamma,
    so the carry always holds the quantized input of the next matmul."""
    x, xq, rs = carry
    eps = cfg.layer_norm_eps
    qkv = dense_prequant(xq, rs, layer["attn"]["qkv"], dtype=x.dtype)
    attn_out = _attention_fused(cfg, layer, qkv, valid_len)
    proj = layer["attn"]["proj"]
    n_out, k_in = proj["kernel_q"].shape
    if proj_glue_supported(k_in, n_out):  # K11: the bf16 proj output never reaches memory
        x, xq, rs = attn_proj_glue_quant(attn_out, x, proj, layer["ls1"], layer["norm2"]["scale"], eps)
    else:
        x, xq, rs = add_rmsnorm_quant(x, dense(attn_out, proj, a8=True), layer["ls1"], layer["norm2"]["scale"], eps)
    mlp = layer["mlp"]
    if "fc1_out_scale" in mlp:  # static scale: fc1 writes int8 codes only (K9)
        codes = fc1_gelu_quant(xq, rs, mlp["fc1"], mlp["fc1_out_scale"])
        y = dense_prequant(codes, mlp["fc1_out_scale"], mlp["fc2"], dtype=x.dtype)
    else:
        y = dense(gelu_tanh(dense_prequant(xq, rs, mlp["fc1"], dtype=x.dtype)), mlp["fc2"], a8=True)
    return add_rmsnorm_quant(x, y, layer["ls2"], layer["next_norm1_scale"], eps)


def intern_vit_forward(
    params: dict,
    cfg: VisionConfig,
    pixel_values: torch.Tensor,
    *,
    feature_layer: int = -1,
    attn_impl: Optional[str] = None,
    remat: bool = False,
    mesh=None,
    fsdp_dims: Optional[dict] = None,
) -> torch.Tensor:
    """Run the tower; returns hidden states after layer ``feature_layer``
    (-1: the last; CLS kept, see :func:`feature_select`).

    Packed path (the inference route, ``attn_impl=None``, without remat):
    when the head width allows, the whole stack runs at the sequence length
    padded once to a multiple of 8 — every op but attention is row-local and
    attention masks the pad columns — so nothing is re-packed around the
    attention kernel (K1, or K5 for a tower without qk-norm).  Any other
    route takes the split path, the qk-norm
    applied outside attention: ``attn_impl="plain"`` with the plain reference
    attention (the JAX package's ``"xla"``), ``attn_impl="vjp"`` with the
    differentiable flash attention (K16, non-causal; the training route).
    ``remat`` checkpoints every layer when gradients are recorded.

    ``mesh``: ``params`` is this rank's shard; every layer runs
    tensor-parallel on the split path (:func:`_layer_forward`).
    ``fsdp_dims``: one layer's tree of the dimension each leaf is split on
    over ``data``; the shards are all-gathered inside the layer's
    checkpoint."""
    x = embeddings(params, cfg, pixel_values)
    s = x.shape[1]
    fused = mesh is None and attn_impl is None and not remat and packed_seq_supported(cfg.head_dim)
    sp = (s + 7) // 8 * 8 if fused else s
    if sp != s:
        x = F.pad(x, (0, 0, 0, sp - s))

    num_layers = cfg.num_hidden_layers
    n_run = num_layers + 1 + feature_layer if feature_layer < 0 else feature_layer
    n_run = max(0, min(num_layers, n_run))
    layers = params["layers"]
    # w8a8 + packed path + RMSNorm + quantized params: the glue scan (a8 on
    # unquantized params stays a no-op, as dense() promises)
    glue = (fused and cfg.w8a8 and "bias" not in layers["norm1"] and n_run > 0
            and "kernel_q" in layers["attn"]["qkv"])
    if glue:
        next_norm1 = torch.roll(layers["norm1"]["scale"][:n_run], -1, dims=0)
        carry = (x, *quantize_activations(rms_norm(x, layers["norm1"]["scale"][0], cfg.layer_norm_eps)))
        for i in range(n_run):
            layer = layer_slice(layers, i)
            layer["next_norm1_scale"] = next_norm1[i]
            carry = _layer_forward_glue(cfg, carry, layer, valid_len=s)
        x = carry[0]
    else:
        def fn(x, layer):
            return _layer_forward(cfg, x, gather_layer(layer, mesh, fsdp_dims), attn_impl=attn_impl,
                                  fused_valid_len=s if fused else None, mesh=mesh)

        for layer in layer_list(layers, n_run):
            x = checkpoint(fn, x, layer, use_reentrant=False) if remat and torch.is_grad_enabled() else fn(x, layer)
    return x[:, :s] if sp != s else x


def calibration_layer(cfg: VisionConfig, x: torch.Tensor, layer: dict, attn_impl: Optional[str] = None):
    """One layer of the calibration pass (the unfused w8a8 split path on a
    whole layer): (its output, its amax of ``gelu(fc1(.))``)."""
    return _layer_forward(cfg, x, layer, attn_impl=attn_impl, with_fc1_amax=True)


def fc1_scale(amax: torch.Tensor) -> torch.Tensor:
    """The static fc1 output scale of an amax: max(amax, 1e-6) / 127 in fp32."""
    return div127(amax.float().clamp(min=1e-6))


@torch.no_grad()
def calibrate_fc1_scales(params: dict, cfg: VisionConfig, pixel_values: torch.Tensor,
                         attn_impl: Optional[str] = None) -> dict:
    """Per-layer static fc1-output scales for the quantizing fc1 epilogue.

    Runs the whole tower on a calibration batch through the unfused w8a8 path
    (``cfg.w8a8`` set, params quantized) and records each layer's amax of
    ``gelu(fc1(.))``; the scale amax/127 clips nothing seen here.  Returns a
    new params dict with ``layers.mlp.fc1_out_scale`` [L] fp32 set — the glue
    scan picks it up."""
    x = embeddings(params, cfg, pixel_values)
    amax = []
    for i in range(cfg.num_hidden_layers):
        x, a = calibration_layer(cfg, x, layer_slice(params["layers"], i), attn_impl)
        amax.append(a)
    scales = fc1_scale(torch.stack(amax))
    out = dict(params)
    out["layers"] = dict(params["layers"])
    out["layers"]["mlp"] = {**params["layers"]["mlp"], "fc1_out_scale": scales}
    return out


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
