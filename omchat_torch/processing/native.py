"""ctypes binding for the native host tile pipeline
(``omchat_torch/csrc_host/tile_pipeline.cpp``) — PyTorch port of
``omchat_tpu/processing/native.py``.

The fused C++ pad+tile+normalize replaces the Python per-tile loop (PIL crop
→ numpy rescale → normalize → transpose) on the serving hot path; resampling
stays in PIL, so the tiles equal the numpy path's to float32 rounding.

The library is built from the port's own copy of the source at first use,
with the flags of ``native/Makefile`` (``g++ -O3 -march=native -fPIC
-std=c++17 -pthread -shared``; ``$CXX`` names another compiler), into
``omchat_torch/_build/``.  Its file name carries a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one reused.
Nothing is built at import time, and nothing outside the checkout is read:
the JAX package's prebuilt library and its ``OMCHAT_NATIVE_LIB`` override
are not carried.

Where the JAX binding swallows a failed build, this one keeps the compiler's
output: :func:`available` is False after a failure (the ``use_native=None``
route of ``process_anyres_image`` then takes the numpy path, as in JAX), and
:func:`load`, which the functions here call, raises it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from omchat_torch.constants import DEFAULT_GRID_PINPOINTS, IMAGENET_MEAN, IMAGENET_STD
from omchat_torch.processing.anyres import compute_resize_shape, select_best_resolution

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc_host", "tile_pipeline.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread", "-shared")

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[str] = None  # the failed build's or load's message, kept for load()


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join((compiler(), *CXX_FLAGS)).encode())
    return os.path.join(BUILD_DIR, f"libtile_pipeline-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the source unless its library exists; returns the library's
    path.  Raises ``RuntimeError`` with the compiler's output on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [compiler(), *CXX_FLAGS, "-o", tmp, SOURCE]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native tile pipeline: {' '.join(cmd)} did not run: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native tile pipeline: {' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built on first use.  After a failure every call
    raises ``RuntimeError`` with the first failure's message."""
    global _LIB, _ERROR
    with _lock:
        if _LIB is not None:
            return _LIB
        if _ERROR is not None:
            raise RuntimeError(_ERROR)
        try:
            lib = ctypes.CDLL(build())
        except (RuntimeError, OSError) as e:
            _ERROR = str(e)
            raise RuntimeError(_ERROR) from e
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.omchat_normalize_tiles.argtypes = [
            u8p, f32p, ctypes.c_int, ctypes.c_int, f32p, f32p, ctypes.c_float, ctypes.c_int,
        ]
        lib.omchat_pad_tile_normalize.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, f32p, f32p, ctypes.c_float, ctypes.c_int,
        ]
        lib.omchat_normalize_tiles.restype = lib.omchat_pad_tile_normalize.restype = None
        _LIB = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads (it is built by this call)."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def normalize_tiles(
    tiles_u8: np.ndarray,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    rescale: float = 1.0 / 255.0,
    num_threads: int = 8,
) -> np.ndarray:
    """[N, T, T, 3] uint8 → [N, 3, T, T] float32 via the native kernel."""
    lib = load()
    tiles_u8 = np.ascontiguousarray(tiles_u8, dtype=np.uint8)
    if tiles_u8.ndim != 4 or tiles_u8.shape[1] != tiles_u8.shape[2] or tiles_u8.shape[3] != 3:
        raise ValueError(f"normalize_tiles: expected [N, T, T, 3] uint8 tiles, got {tiles_u8.shape}")
    n, t = tiles_u8.shape[0], tiles_u8.shape[1]
    out = np.empty((n, 3, t, t), np.float32)
    m = np.asarray(mean, np.float32)
    s = np.asarray(std, np.float32)
    lib.omchat_normalize_tiles(_u8p(tiles_u8), _f32p(out), n, t, _f32p(m), _f32p(s), rescale, num_threads)
    return out


def anyres_process_native(
    image: Image.Image,
    grid_pinpoints=DEFAULT_GRID_PINPOINTS,
    tile_size: int = 448,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    num_threads: int = 8,
) -> np.ndarray:
    """Native anyres: PIL resizes (bit-exact) + fused C++ pad/tile/normalize.

    Output matches :func:`omchat_torch.processing.image_processor.process_anyres_image`
    (thumbnail first, raster tiles) to float32 rounding."""
    lib = load()
    if image.mode != "RGB":
        image = image.convert("RGB")
    target_w, target_h = select_best_resolution(image.size, grid_pinpoints)
    new_w, new_h = compute_resize_shape(image.size, (target_w, target_h))
    resized = np.ascontiguousarray(np.asarray(image.resize((new_w, new_h)), dtype=np.uint8))

    gx, gy = target_w // tile_size, target_h // tile_size
    tiles = np.empty((gx * gy, 3, tile_size, tile_size), np.float32)
    m = np.asarray(mean, np.float32)
    s = np.asarray(std, np.float32)
    lib.omchat_pad_tile_normalize(
        _u8p(resized), new_h, new_w, target_h, target_w, tile_size,
        _f32p(tiles), _f32p(m), _f32p(s), np.float32(1.0 / 255.0), num_threads,
    )

    thumb = np.asarray(image.resize((tile_size, tile_size)), dtype=np.uint8)
    thumb_n = normalize_tiles(thumb[None], mean, std, num_threads=1)
    return np.concatenate([thumb_n, tiles], axis=0)
