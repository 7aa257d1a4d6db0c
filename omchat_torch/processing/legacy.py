"""Legacy and auxiliary preprocessing paths — PyTorch port of
``omchat_tpu/processing/legacy.py``.

- :func:`process_images`: the aspect-ratio dispatch (pad / anyres / plain)
  of training-era callers (reference mm_utils.py:164-180);
- :func:`gpt4style_tiles`: an overall view and 2×2 block crops, the anyres
  predecessor (reference image_processors/gpt4style.py:23-45);
- :func:`load_image_from_base64` (reference mm_utils.py:160-161).
"""

from __future__ import annotations

import base64
from io import BytesIO
from typing import List, Sequence

import numpy as np
from PIL import Image

from omchat_torch.constants import DEFAULT_GRID_PINPOINTS, IMAGENET_MEAN
from omchat_torch.processing.anyres import expand2square
from omchat_torch.processing.clip_preprocess import preprocess_tile
from omchat_torch.processing.image_processor import process_anyres_image


def load_image_from_base64(data: str) -> Image.Image:
    return Image.open(BytesIO(base64.b64decode(data)))


def process_images(images: Sequence[Image.Image], image_aspect_ratio: str = "anyres",
                   grid_pinpoints=DEFAULT_GRID_PINPOINTS, tile_size: int = 448,
                   image_mean: Sequence[float] = IMAGENET_MEAN):
    """'pad': expand2square with the mean colour; 'anyres': tiling; else the
    plain per-image preprocess.  Returns a stacked array when the shapes
    agree, else a list (the reference's behaviour)."""
    if image_aspect_ratio not in ("pad", "anyres"):
        return np.stack([preprocess_tile(im, crop_size=tile_size, shortest_edge=tile_size) for im in images])
    new_images = []
    for image in images:
        if image_aspect_ratio == "pad":
            image = expand2square(image, tuple(int(x * 255) for x in image_mean))
            new_images.append(preprocess_tile(image, crop_size=tile_size, shortest_edge=tile_size))
        else:
            new_images.append(process_anyres_image(image, grid_pinpoints, tile_size))
    if all(x.shape == new_images[0].shape for x in new_images):
        return np.stack(new_images)
    return new_images


def gpt4style_tiles(image: Image.Image, tile_size: int = 336) -> List[np.ndarray]:
    """The overall resized view, then 2×2 block crops of the 2×-resized image."""
    big = image.resize((tile_size * 2, tile_size * 2))
    crops = [image.resize((tile_size, tile_size))]
    for i in range(2):
        for j in range(2):
            crops.append(big.crop((j * tile_size, i * tile_size, (j + 1) * tile_size, (i + 1) * tile_size)))
    return [preprocess_tile(c, crop_size=tile_size, shortest_edge=tile_size) for c in crops]
