"""S2 multi-scale vision forward (Scaling-on-Scales) — PyTorch port of
``omchat_tpu/models/multiscale.py``: the OmChat-v1 path runs its CLIP tower at
(336, 672, 1008).

Resize the image to each scale, split the scales above the base into
base-size crops, run the crops through the tower as one batch, reassemble
each scale's feature grid, average-pool it back to the base grid, and
concatenate the scales along the channels: [B, L_base, C × scales].
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F


def _resize_bilinear(images: torch.Tensor, size: int) -> torch.Tensor:
    """[B, 3, H, W] → [B, 3, size, size], as ``jax.image.resize(method=
    "bilinear")`` computes it: a triangle filter widened by the scale when it
    shrinks (antialiased), plain bilinear when it enlarges."""
    return F.interpolate(images, size=(size, size), mode="bilinear", align_corners=False, antialias=True)


def _split_tiles(images: torch.Tensor, num_split: int) -> torch.Tensor:
    """[B, C, S, S] → [B*n², C, S/n, S/n] in raster order."""
    b, c, s, _ = images.shape
    t = s // num_split
    x = images.reshape(b, c, num_split, t, num_split, t).permute(0, 2, 4, 1, 3, 5)  # [B, ny, nx, C, t, t]
    return x.reshape(b * num_split * num_split, c, t, t)


def _merge_feature_grid(feats: torch.Tensor, b: int, num_split: int) -> torch.Tensor:
    """[B*n², L, C] → [B, n*side, n*side, C]."""
    _, l, c = feats.shape
    side = math.isqrt(l)
    x = feats.reshape(b, num_split, num_split, side, side, c).permute(0, 1, 3, 2, 4, 5)  # [B, ny, side, nx, side, C]
    return x.reshape(b, num_split * side, num_split * side, c)


def multiscale_forward(forward_feature: Callable[[torch.Tensor], torch.Tensor], images: torch.Tensor,
                       img_sizes: Sequence[int] = (336, 672, 1008), max_split_size: int = 336) -> torch.Tensor:
    """Run ``forward_feature`` ([B, 3, s, s] → [B, L, C] patch features, no
    CLS) at each scale and fuse.  Returns [B, L_base, C * len(img_sizes)]."""
    b = images.shape[0]
    outputs, base_side = [], None
    for size in img_sizes:
        num_split = max(size // max_split_size, 1)
        resized = _resize_bilinear(images, size)
        tiles = _split_tiles(resized, num_split) if num_split > 1 else resized
        grid = _merge_feature_grid(forward_feature(tiles), b, num_split)
        if base_side is None:
            base_side = grid.shape[1]
        if grid.shape[1] != base_side:  # average-pool down to the base grid
            f = grid.shape[1] // base_side
            grid = grid.reshape(b, base_side, f, base_side, f, grid.shape[-1]).mean(dim=(2, 4))
        outputs.append(grid.reshape(b, base_side * base_side, -1))
    return torch.cat(outputs, dim=-1)
