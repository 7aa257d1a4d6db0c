"""Video preprocessing: frame sampling + per-frame tile encode.

The reference's released video support is vestigial — 4-D per-sample tensors
route to an *undefined* ``encode_videos`` (omchat_arch.py:87; SURVEY.md §5
"long context").  This module supplies the working equivalent for the
32-frame MMBench-Video configuration (README.md:187-200): uniform frame
sampling, square 448px resize + CLIP normalization per frame, one ``<image>``
sentinel per frame in the prompt, each frame contributing one ViT tile.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
from PIL import Image

from omchat_torch.constants import DEFAULT_IMAGE_TOKEN
from omchat_torch.processing.clip_preprocess import preprocess_tile


def sample_frame_indices(num_frames: int, num_samples: int = 32) -> List[int]:
    """Uniformly sample ``num_samples`` frame indices (MMBench-Video protocol)."""
    if num_frames <= num_samples:
        return list(range(num_frames))
    return [int(i) for i in np.linspace(0, num_frames - 1, num_samples)]


def process_video_frames(
    frames: Sequence[Image.Image],
    tile_size: int = 448,
    num_samples: int = 32,
) -> np.ndarray:
    """Frames → float32 [T, 3, tile, tile] (plain square resize per frame,
    CLIP normalize; no anyres tiling per frame — token volume stays T×1024)."""
    idx = sample_frame_indices(len(frames), num_samples)
    arrays = []
    for i in idx:
        f = frames[i].resize((tile_size, tile_size))
        arrays.append(preprocess_tile(f, crop_size=tile_size, shortest_edge=tile_size))
    return np.stack(arrays, axis=0)


def load_video_frames(path: str, num_samples: int = 32) -> List[Image.Image]:
    """Decode ``path`` into at most ``num_samples`` uniformly-sampled frames.

    Accepts a directory of frame images (sorted by name), a multi-frame image
    PIL can step through (animated GIF/WebP), or any container imageio can
    read (mp4 etc. — imageio is optional; a clear error names it if absent).
    """
    import os

    if os.path.isdir(path):
        names = sorted(
            n for n in os.listdir(path)
            if n.lower().endswith((".jpg", ".jpeg", ".png", ".bmp", ".webp"))
        )
        if not names:
            raise ValueError(f"no frame images found in directory {path}")
        idx = sample_frame_indices(len(names), num_samples)
        return [Image.open(os.path.join(path, names[i])).convert("RGB") for i in idx]

    if path.lower().endswith((".gif", ".webp", ".png", ".apng")):
        img = Image.open(path)
        n = getattr(img, "n_frames", 1)
        frames = []
        for i in sample_frame_indices(n, num_samples):
            img.seek(i)
            frames.append(img.convert("RGB"))
        return frames

    try:
        import imageio.v3 as iio
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "reading video containers needs imageio; pass a directory of "
            "frames or an animated GIF instead"
        ) from e
    arr = iio.imread(path)  # [T, H, W, C]
    if arr.ndim == 3:
        arr = arr[None]
    idx = sample_frame_indices(arr.shape[0], num_samples)
    return [Image.fromarray(arr[i]).convert("RGB") for i in idx]


def video_prompt(text: str, num_frames: int) -> str:
    """One sentinel per frame: ``frame:<image>`` lines then the question."""
    return (
        "\n".join(["frame:" + DEFAULT_IMAGE_TOKEN] * num_frames)
        + "\n"
        + text.replace(DEFAULT_IMAGE_TOKEN, "").strip()
    )
