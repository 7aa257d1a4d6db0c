"""On-device image preprocessing for fixed-shape frame streams — PyTorch port
of ``omchat_tpu/processing/device_pipeline.py``.

A fast path beside the PIL host pipeline (``processing/video.py``), which
stays the default (``OmChatModel.chat_video`` takes it): for workloads whose
input shape is constant (video frames, camera feeds) one device pass resizes,
rescales and normalizes a whole batch, and the host sends uint8 (3 bytes a
pixel) instead of float32.

The resize is the JAX package's, ``jax.image.resize(method="bicubic")``: a
Keys cubic with a = -0.5, anti-aliased on a downscale (the kernel widened by
the scale), its weights renormalised where the support leaves the image.
``torch.nn.functional.interpolate(mode="bicubic")`` computes another function
(a = -0.75, edges clamped), so the port builds JAX's [in, out] weight matrix
of each axis on the host, as ``scale_and_translate`` does, and applies the
two on the device as two ``torch.matmul`` products.  Outputs track the PIL
host path to about 1e-2 per channel, as the JAX package's do.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from omchat_torch.constants import IMAGENET_MEAN, IMAGENET_STD
from omchat_torch.utils.device import resolve_device


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 at |x| (float32)."""
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x + np.float32(2.0),
                   out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


@lru_cache(maxsize=16)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] float32 weights of JAX's anti-aliased Keys-cubic resize of
    one axis (``jax/_src/image/scale.py:compute_weight_mat`` with scale
    out/in and no translation), computed in float32 as JAX computes it."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(x.astype(f32))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0) * np.finfo(np.float32).eps, w / np.where(total != 0, total, f32(1)),
                 f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(in_size) - f32(0.5))
    return np.where(inside[None, :], w, f32(0)).astype(f32)


@torch.no_grad()
def device_preprocess_frames(frames_u8, tile_size: int = 448, device=None) -> torch.Tensor:
    """[T, H, W, 3] uint8 → [T, 3, tile, tile] float32, CLIP-normalized, on
    ``device`` (default CUDA; the frames' own device when they are a tensor).

    The device analogue of :func:`omchat_torch.processing.video.process_video_frames`
    (plain square resize per frame + ImageNet normalize): x / 255, JAX's
    bicubic resize of each spatial axis whose size changes (two matmuls),
    clipped to [0, 1] as PIL clamps to the uint8 range, then normalized."""
    if isinstance(frames_u8, torch.Tensor):
        x = frames_u8.to(resolve_device(device) if device is not None else frames_u8.device)
    else:
        x = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(resolve_device(device))
    _, h, w, _ = x.shape
    x = x.permute(0, 3, 1, 2).to(torch.float32) / 255.0  # [T, 3, H, W]
    if h != tile_size:  # rows: [T, 3, W, H] @ [H, tile]
        x = torch.matmul(x.transpose(2, 3), torch.from_numpy(resize_weights(h, tile_size)).to(x.device))
        x = x.transpose(2, 3)
    if w != tile_size:  # columns: [T, 3, tile, W] @ [W, tile]
        x = torch.matmul(x, torch.from_numpy(resize_weights(w, tile_size)).to(x.device))
    x = x.clamp(0.0, 1.0)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)[:, None, None]
    return ((x - mean) / std).contiguous()


def frames_to_device_batch(frames, num_samples: int = 32) -> np.ndarray:
    """PIL frames → stacked uint8 [T, H, W, 3] (uniform sampling), the cheap
    host side of the device pipeline."""
    from omchat_torch.processing.video import sample_frame_indices

    idx = sample_frame_indices(len(frames), num_samples)
    return np.stack([np.asarray(frames[i].convert("RGB"), np.uint8) for i in idx])
