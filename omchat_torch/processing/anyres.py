"""anyres high-resolution tiling geometry.

Behavioral contract of the reference's host-side tiling
(omchat/mm_utils.py:12-158 and
omchat/hf/image_processing_omchat.py:424-528):

1. pick the best grid resolution from ``grid_pinpoints`` (maximize effective
   resolution, then minimize waste),
2. aspect-preserving resize + black center-pad to that resolution,
3. cut into raster-order ``tile_size`` (448) squares,
4. prepend a square thumbnail of the full image.

Pure Python/PIL/numpy — the bit-parity path (a copy of the JAX package's
module; the port imports nothing of it).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

from PIL import Image


def select_best_resolution(
    original_size: Tuple[int, int], possible_resolutions: Sequence[Sequence[int]]
) -> Tuple[int, int]:
    """Pick the pinpoint resolution that best fits ``original_size`` (width, height).

    Maximizes effective (non-wasted) resolution after aspect-preserving downscale,
    breaking ties by minimum wasted area — including the reference's exact
    ``int()`` truncation and strict-inequality tie-breaking
    (reference: mm_utils.py:12-39).
    """
    original_width, original_height = original_size
    best_fit: Tuple[int, int] = None  # type: ignore[assignment]
    max_effective_resolution = 0
    min_wasted_resolution = float("inf")

    for width, height in possible_resolutions:
        scale = min(width / original_width, height / original_height)
        downscaled_width = int(original_width * scale)
        downscaled_height = int(original_height * scale)
        effective_resolution = min(downscaled_width * downscaled_height, original_width * original_height)
        wasted_resolution = (width * height) - effective_resolution

        if effective_resolution > max_effective_resolution or (
            effective_resolution == max_effective_resolution and wasted_resolution < min_wasted_resolution
        ):
            max_effective_resolution = effective_resolution
            min_wasted_resolution = wasted_resolution
            best_fit = (width, height)

    return best_fit


def compute_resize_shape(
    original_size: Tuple[int, int], target_resolution: Tuple[int, int]
) -> Tuple[int, int]:
    """Aspect-preserving (new_width, new_height) inside ``target_resolution``.

    Matches the reference's ``math.ceil`` + ``min`` clamping exactly
    (reference: mm_utils.py:53-64).
    """
    original_width, original_height = original_size
    target_width, target_height = target_resolution

    scale_w = target_width / original_width
    scale_h = target_height / original_height

    if scale_w < scale_h:
        new_width = target_width
        new_height = min(math.ceil(original_height * scale_w), target_height)
    else:
        new_height = target_height
        new_width = min(math.ceil(original_width * scale_h), target_width)
    return new_width, new_height


def resize_and_pad_image(image: Image.Image, target_resolution: Tuple[int, int]) -> Image.Image:
    """Aspect-preserving resize then black center-pad (reference: mm_utils.py:42-74)."""
    new_width, new_height = compute_resize_shape(image.size, target_resolution)
    target_width, target_height = target_resolution

    resized_image = image.resize((new_width, new_height))  # PIL default = bicubic for RGB

    new_image = Image.new("RGB", (target_width, target_height), (0, 0, 0))
    paste_x = (target_width - new_width) // 2
    paste_y = (target_height - new_height) // 2
    new_image.paste(resized_image, (paste_x, paste_y))
    return new_image


def divide_to_patches(image: Image.Image, patch_size: int) -> List[Image.Image]:
    """Raster-order ``patch_size`` square crops (reference: mm_utils.py:77-96)."""
    patches = []
    width, height = image.size
    for i in range(0, height, patch_size):
        for j in range(0, width, patch_size):
            patches.append(image.crop((j, i, j + patch_size, i + patch_size)))
    return patches


def get_anyres_image_grid_shape(
    image_size: Tuple[int, int], grid_pinpoints: Sequence[Sequence[int]], patch_size: int
) -> Tuple[int, int]:
    """(grid_w, grid_h) in tiles for an input image (reference: mm_utils.py:99-116)."""
    width, height = select_best_resolution(image_size, grid_pinpoints)
    return width // patch_size, height // patch_size


def num_anyres_tiles(
    image_size: Tuple[int, int], grid_pinpoints: Sequence[Sequence[int]], tile_size: int
) -> int:
    """Total tiles produced for an image: thumbnail + grid tiles."""
    gw, gh = get_anyres_image_grid_shape(image_size, grid_pinpoints, tile_size)
    return 1 + gw * gh


def anyres_tile_images(
    image: Image.Image,
    grid_pinpoints: Sequence[Sequence[int]],
    tile_size: int,
) -> Tuple[List[Image.Image], Tuple[int, int]]:
    """Produce [thumbnail] + raster tiles as PIL images, plus the best resolution.

    Thumbnail-first ordering is the reference's live behavior
    (mm_utils.py:151 ``[image_original_resize] + patches``).
    The thumbnail is a plain square resize of the *original* image
    (mm_utils.py:143-146).
    """
    best_resolution = select_best_resolution(image.size, grid_pinpoints)
    image_padded = resize_and_pad_image(image, best_resolution)
    patches = divide_to_patches(image_padded, tile_size)
    thumbnail = image.resize((tile_size, tile_size))
    return [thumbnail] + patches, best_resolution


def _pick_tile_grid(
    size: Tuple[int, int], min_num: int, max_num: int, tile: int
) -> Tuple[int, int]:
    """Choose a (cols, rows) tile grid whose aspect ratio best matches the
    image.

    Behavior is pinned golden to the reference's find_closest_aspect_ratio
    (mm_utils.py:325-338) including its two quirks, reproduced deliberately:
    candidate grids are ordered by tile count (ascending, set-dedup order for
    ties), and an equal-ratio-diff candidate only replaces the incumbent when
    the image covers more than half the candidate grid's pixel area — i.e.
    large images tie-break toward MORE tiles, small ones keep fewer.
    """
    w, h = size
    grids = sorted(
        {
            (cols, rows)
            for total in range(min_num, max_num + 1)
            for cols in range(1, total + 1)
            for rows in range(1, total + 1)
            if min_num <= cols * rows <= max_num
        },
        key=lambda g: g[0] * g[1],
    )
    want = w / h
    best, best_diff = (1, 1), float("inf")
    for grid in grids:
        diff = abs(want - grid[0] / grid[1])
        takes = diff < best_diff or (
            diff == best_diff and w * h > 0.5 * tile * tile * grid[0] * grid[1]
        )
        if takes:
            best, best_diff = grid, diff
    return best


def dynamic_tile_images(
    image: Image.Image,
    min_num: int = 1,
    max_num: int = 6,
    image_size: int = 448,
    use_thumbnail: bool = True,
) -> List[Image.Image]:
    """InternVL-style aspect-ratio-bucketed dynamic tiling.

    This is the OmChat-2.1 multi-image/video preprocessing
    (reference: mm_utils.py:276-338 ``dynamic_preprocess``); the image is
    resized onto the chosen grid and cropped raster-order, with the thumbnail
    inserted at index 0 (mm_utils.py:312) — note anyres puts its thumbnail
    first as well but via concatenation (process_anyres_image).
    """
    cols, rows = _pick_tile_grid(image.size, min_num, max_num, image_size)
    resized = image.resize((image_size * cols, image_size * rows))

    tiles = [
        resized.crop(
            (c * image_size, r * image_size, (c + 1) * image_size, (r + 1) * image_size)
        )
        for r in range(rows)
        for c in range(cols)
    ]
    if use_thumbnail and len(tiles) != 1:
        tiles.insert(0, image.resize((image_size, image_size)))
    return tiles


def expand2square(pil_img: Image.Image, background_color) -> Image.Image:
    """Pad to square with a background color (reference: mm_utils.py:183-194)."""
    width, height = pil_img.size
    if width == height:
        return pil_img
    if width > height:
        result = Image.new(pil_img.mode, (width, width), background_color)
        result.paste(pil_img, (0, (width - height) // 2))
        return result
    result = Image.new(pil_img.mode, (height, height), background_color)
    result.paste(pil_img, ((height - width) // 2, 0))
    return result
