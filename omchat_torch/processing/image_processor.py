"""OmChat anyres image processor.

Drop-in behavioral equivalent of the reference's two image front-ends:

- :func:`process_anyres_image` — the repo-native path
  (omchat/mm_utils.py:119-158): ``[thumbnail] + tiles``, each
  through CLIP preprocessing; returns a list/stack of CHW float32 arrays.
- :class:`OmChatImageProcessor` — the HF-bundle path
  (omchat/hf/image_processing_omchat.py:569-733): batch API
  returning ``{"pixel_values": [B, maxP, 3, 448, 448], "num_patches": [B]}``
  with zero-padding on the patch dimension (``_pad_for_batching``, :530-567).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
from PIL import Image

from omchat_torch.constants import DEFAULT_GRID_PINPOINTS, IMAGENET_MEAN, IMAGENET_STD
from omchat_torch.processing.anyres import anyres_tile_images, dynamic_tile_images
from omchat_torch.processing.clip_preprocess import preprocess_tile


def process_anyres_image(
    image: Image.Image,
    grid_pinpoints: Sequence[Sequence[int]] = DEFAULT_GRID_PINPOINTS,
    tile_size: int = 448,
    return_best_res: bool = False,
    use_native: Optional[bool] = None,
):
    """anyres-tile one image → [N, 3, tile, tile] float32 (thumbnail first).

    Matches reference mm_utils.py:119-158 with the InternViT CLIP processor
    settings (crop 448, shortest-edge 448, ImageNet stats).  ``use_native``
    routes the pad/tile/normalize through the fused C++ pipeline
    (:mod:`omchat_torch.processing.native`; the same output to float32
    rounding): None takes it when its library builds, as in the JAX package;
    True raises with the compiler's output when it does not; False keeps the
    numpy path.
    """
    if use_native is None:
        from omchat_torch.processing import native

        use_native = native.available()
    if use_native:
        from omchat_torch.processing import native
        from omchat_torch.processing.anyres import select_best_resolution

        stacked = native.anyres_process_native(image, grid_pinpoints, tile_size)
        if return_best_res:
            return stacked, select_best_resolution(image.size, grid_pinpoints)
        return stacked
    tiles, best_resolution = anyres_tile_images(image, grid_pinpoints, tile_size)
    arrays = [preprocess_tile(t, crop_size=tile_size, shortest_edge=tile_size) for t in tiles]
    stacked = np.stack(arrays, axis=0)
    if return_best_res:
        return stacked, best_resolution
    return stacked


def process_dynamic_image(
    image: Image.Image,
    max_num: int = 6,
    tile_size: int = 448,
) -> np.ndarray:
    """InternVL dynamic tiling path (OmChat-2.1 multi-image/video style;
    reference mm_utils.py:315-322)."""
    tiles = dynamic_tile_images(image, max_num=max_num, image_size=tile_size, use_thumbnail=True)
    return np.stack([preprocess_tile(t, crop_size=tile_size, shortest_edge=tile_size) for t in tiles], axis=0)


class OmChatImageProcessor:
    """HF-bundle-shaped batch image processor.

    ``preprocess(images)`` → dict with
      - ``pixel_values``: float32 ``[B, max_patches, 3, crop, crop]`` (zero-padded)
      - ``num_patches``:  int32 ``[B]`` true patch counts (thumbnail included)

    Mirrors omchat/hf/image_processing_omchat.py:569-733.
    """

    def __init__(
        self,
        crop_size: int = 448,
        shortest_edge: int = 448,
        image_grid_pinpoints: Sequence[Sequence[int]] = DEFAULT_GRID_PINPOINTS,
        image_mean: Sequence[float] = IMAGENET_MEAN,
        image_std: Sequence[float] = IMAGENET_STD,
    ):
        self.crop_size = crop_size
        self.shortest_edge = shortest_edge
        self.image_grid_pinpoints = [list(p) for p in image_grid_pinpoints]
        self.image_mean = list(image_mean)
        self.image_std = list(image_std)

    def _process_one(self, image: Image.Image) -> np.ndarray:
        tiles, _ = anyres_tile_images(image, self.image_grid_pinpoints, self.crop_size)
        return np.stack(
            [
                preprocess_tile(
                    t,
                    crop_size=self.crop_size,
                    shortest_edge=self.shortest_edge,
                    image_mean=self.image_mean,
                    image_std=self.image_std,
                )
                for t in tiles
            ],
            axis=0,
        )

    def preprocess(self, images: Union[Image.Image, Sequence[Image.Image]]) -> dict:
        if isinstance(images, Image.Image):
            images = [images]
        per_image = [self._process_one(im) for im in images]
        num_patches = np.asarray([p.shape[0] for p in per_image], dtype=np.int32)
        max_patches = int(num_patches.max())
        c = per_image[0].shape[1]
        out = np.zeros((len(per_image), max_patches, c, self.crop_size, self.crop_size), dtype=np.float32)
        for i, p in enumerate(per_image):
            out[i, : p.shape[0]] = p
        return {"pixel_values": out, "num_patches": num_patches}

    def __call__(self, images) -> dict:
        return self.preprocess(images)


def split_pixel_values(pixel_values: np.ndarray, num_patches: np.ndarray) -> List[np.ndarray]:
    """Undo the patch-dimension padding (reference: processing_omchat.py:133-141)."""
    return [pixel_values[i, : int(n)] for i, n in enumerate(num_patches)]
