"""CLIP-style per-tile preprocessing (resize → center-crop → rescale → normalize).

Reproduces the exact host-side math of the reference's two tile pipelines:

- repo-native: HF ``CLIPImageProcessor(crop_size=448, size=448, ImageNet stats)``
  built in omchat/model/multimodal_encoder/internVIT_encoder.py:24-33;
- HF bundle: ``OmChatImageProcessor._preprocess``
  (omchat/hf/image_processing_omchat.py:335-422).

Both resize the shortest edge to 448 with PIL bicubic, center-crop 448, rescale by
1/255, and normalize with ImageNet mean/std.  Output is float32 CHW.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
from PIL import Image

from omchat_torch.constants import IMAGENET_MEAN, IMAGENET_STD


def resize_shortest_edge_size(size: Tuple[int, int], shortest_edge: int) -> Tuple[int, int]:
    """Output (height, width) for shortest-edge resize, HF semantics.

    Mirrors ``transformers.image_transforms.get_resize_output_image_size`` with
    ``default_to_square=False``.
    """
    height, width = size
    short, long = (width, height) if width <= height else (height, width)
    new_short = shortest_edge
    new_long = int(new_short * long / short)
    return (new_long, new_short) if width <= height else (new_short, new_long)


def center_crop(arr: np.ndarray, crop_height: int, crop_width: int) -> np.ndarray:
    """Center crop an HWC array; zero-pads if the crop is larger (HF semantics)."""
    height, width = arr.shape[:2]
    top = (height - crop_height) // 2
    left = (width - crop_width) // 2

    if top >= 0 and left >= 0 and top + crop_height <= height and left + crop_width <= width:
        return arr[top : top + crop_height, left : left + crop_width]

    # Crop larger than image: pad with zeros, centered.
    new_height = max(crop_height, height)
    new_width = max(crop_width, width)
    out = np.zeros((new_height, new_width) + arr.shape[2:], dtype=arr.dtype)
    pad_top = (new_height - height) // 2
    pad_left = (new_width - width) // 2
    out[pad_top : pad_top + height, pad_left : pad_left + width] = arr
    top = (new_height - crop_height) // 2
    left = (new_width - crop_width) // 2
    return out[top : top + crop_height, left : left + crop_width]


def preprocess_tile(
    image: Union[Image.Image, np.ndarray],
    crop_size: int = 448,
    shortest_edge: int = 448,
    image_mean: Sequence[float] = IMAGENET_MEAN,
    image_std: Sequence[float] = IMAGENET_STD,
    rescale_factor: float = 1.0 / 255.0,
    do_resize: bool = True,
    do_center_crop: bool = True,
) -> np.ndarray:
    """Preprocess one tile to a normalized float32 CHW array.

    PIL is the resampling backend (bicubic), matching HF image transforms which
    round-trip numpy→PIL→numpy for resizing.
    """
    if isinstance(image, np.ndarray):
        pil = Image.fromarray(image.astype(np.uint8))
    else:
        pil = image
    if pil.mode != "RGB":
        pil = pil.convert("RGB")

    if do_resize:
        h, w = resize_shortest_edge_size((pil.height, pil.width), shortest_edge)
        if (h, w) != (pil.height, pil.width):
            pil = pil.resize((w, h), resample=Image.Resampling.BICUBIC)

    arr = np.asarray(pil)  # HWC uint8

    if do_center_crop:
        arr = center_crop(arr, crop_size, crop_size)

    arr = arr.astype(np.float32) * np.float32(rescale_factor)
    mean = np.asarray(image_mean, dtype=np.float32)
    std = np.asarray(image_std, dtype=np.float32)
    arr = (arr - mean) / std
    return arr.transpose(2, 0, 1).astype(np.float32)  # CHW
