"""The port's native host tile pipeline (``omchat_torch/processing/native.py``
over its own copy of ``tile_pipeline.cpp``) on the CPU: ``normalize_tiles``
and ``anyres_process_native`` within 1e-6 of the JAX package's numpy path
(``process_anyres_image(use_native=False)``), parametrised over image sizes;
``process_anyres_image``'s ``use_native`` routes as the JAX package's; an
edited source builds a new library; a compiler that fails makes
``use_native=True`` raise with its output, and ``use_native=None`` take the
numpy path.
"""

import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from omchat_torch.processing import image_processor as tip
from omchat_torch.processing import native

TOL = 1e-6  # the fused pass computes x * (1/255/std) - mean/std, the numpy path (x/255 - mean)/std


def _image(seed, w, h):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, size=(h, w, 3), dtype=np.uint8))


@pytest.fixture()
def fresh(tmp_path, monkeypatch):
    """The binding over a copy of the source, building into ``tmp_path``,
    nothing loaded yet."""
    src = tmp_path / "tile_pipeline.cpp"
    shutil.copy(native.SOURCE, src)
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", None)
    return src


def test_normalize_tiles_matches_numpy():
    from omchat_tpu.processing.clip_preprocess import preprocess_tile

    tiles = np.random.default_rng(0).integers(0, 256, size=(4, 448, 448, 3), dtype=np.uint8)
    ours = native.normalize_tiles(tiles)
    ref = np.stack([preprocess_tile(Image.fromarray(t), do_resize=False, do_center_crop=False) for t in tiles])
    assert ours.shape == (4, 3, 448, 448) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("size", [(640, 480), (1920, 1080), (448, 448), (300, 1200), (1000, 700)])
def test_anyres_native_matches_jax_numpy_path(size):
    from omchat_tpu.processing.image_processor import process_anyres_image

    img = _image(sum(size), *size)
    ours = native.anyres_process_native(img)
    ref = process_anyres_image(img, use_native=False)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)


def test_use_native_routes_as_jax():
    from omchat_tpu.processing.image_processor import process_anyres_image

    img = _image(3, 900, 500)
    numpy_path = tip.process_anyres_image(img, use_native=False)
    np.testing.assert_array_equal(numpy_path, process_anyres_image(img, use_native=False))
    np.testing.assert_array_equal(tip.process_anyres_image(img, use_native=True), native.anyres_process_native(img))
    np.testing.assert_array_equal(tip.process_anyres_image(img), native.anyres_process_native(img))  # it builds here
    tiles, best = tip.process_anyres_image(img, return_best_res=True, use_native=True)
    assert best == process_anyres_image(img, return_best_res=True, use_native=False)[1]
    np.testing.assert_allclose(tiles, numpy_path, atol=TOL, rtol=0)


def test_malformed_tiles_are_refused():
    with pytest.raises(ValueError, match=r"\[N, T, T, 3\]"):
        native.normalize_tiles(np.zeros((2, 8, 6, 3), np.uint8))
    with pytest.raises(ValueError, match=r"\[N, T, T, 3\]"):
        native.normalize_tiles(np.zeros((8, 8, 3), np.uint8))


def test_a_source_edit_rebuilds(fresh):
    first = native.library_path()
    native.load()
    assert os.path.exists(first)
    with open(fresh, "a") as f:
        f.write("\n// an edit\n")
    second = native.library_path()
    assert second != first and not os.path.exists(second)
    assert native.build() == second and os.path.exists(second)
    assert native.build() == second  # unchanged now: reused


def test_a_failing_compiler_raises_on_use_native_true(fresh, tmp_path, monkeypatch):
    cxx = tmp_path / "broken-cxx"
    cxx.write_text(f"#!{sys.executable}\nimport sys\nsys.stderr.write('cc1plus: fatal error: broken\\n')\n"
                   "sys.exit(1)\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    img = _image(5, 500, 400)
    with pytest.raises(RuntimeError, match="fatal error: broken"):
        tip.process_anyres_image(img, use_native=True)
    assert not native.available()
    with pytest.raises(RuntimeError, match="fatal error: broken"):  # the first failure's output, kept
        native.normalize_tiles(np.zeros((1, 8, 8, 3), np.uint8))
    # None keeps the JAX meaning: the numpy path when the library does not build
    np.testing.assert_array_equal(tip.process_anyres_image(img), tip.process_anyres_image(img, use_native=False))
