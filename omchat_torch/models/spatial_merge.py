"""LLaVA-NeXT "spatial_unpad" patch merge, the OmChat-v1 fusion layout —
PyTorch port of ``omchat_tpu/models/spatial_merge.py``.

The tiles' features are laid out on the anyres grid, the aspect-ratio
padding is cropped away, a learned ``image_newline`` embedding ends each row,
and the thumbnail's features go first.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from omchat_torch.processing.anyres import get_anyres_image_grid_shape


def unpad_image(tensor: torch.Tensor, original_size: Tuple[int, int]) -> torch.Tensor:
    """Crop the centred aspect-ratio padding.  tensor: [C, H, W];
    original_size: (width, height), as the reference unpacks it."""
    original_width, original_height = original_size
    current_height, current_width = tensor.shape[1:]
    if original_width / original_height > current_width / current_height:
        new_height = int(original_height * (current_width / original_width))
        padding = (current_height - new_height) // 2
        return tensor[:, padding : current_height - padding, :]
    new_width = int(original_width * (current_height / original_height))
    padding = (current_width - new_width) // 2
    return tensor[:, :, padding : current_width - padding]


def spatial_unpad_merge(tile_features: torch.Tensor, image_size: Tuple[int, int],
                        grid_pinpoints: Sequence[Sequence[int]], tile_pixels: int, image_newline: torch.Tensor, *,
                        patch_merge_type: str = "spatial_unpad") -> torch.Tensor:
    """The anyres tiles' features in the LLaVA-NeXT token layout.

    tile_features: [1 + n_tiles, hw, C] (the thumbnail, then the tiles in
    raster order), hw = (tile_pixels / 14)²; image_newline: [C].  Returns
    [T, C]."""
    base = tile_features[0]
    if tile_features.shape[0] == 1:  # one tile: its features, and the newline in unpad mode
        if "unpad" in patch_merge_type:
            return torch.cat([base, image_newline[None].to(base.dtype)], dim=0)
        return base
    hw, c = base.shape
    side = int(hw**0.5)
    gw, gh = get_anyres_image_grid_shape(image_size, grid_pinpoints, tile_pixels)
    feat = tile_features[1:].reshape(gh, gw, side, side, c)
    if "unpad" in patch_merge_type:
        feat = unpad_image(feat.permute(4, 0, 2, 1, 3).reshape(c, gh * side, gw * side), image_size)
        newline = image_newline[:, None, None].to(feat.dtype).expand(c, feat.shape[1], 1)
        feat = torch.cat([feat, newline], dim=-1).reshape(c, -1).t()  # [H * (W + 1), C]
    else:
        feat = feat.permute(0, 2, 1, 3, 4).reshape(-1, c)
    return torch.cat([base, feat], dim=0)
