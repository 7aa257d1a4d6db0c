"""The kernel library's build cache: a library's file name must change when
anything that compiles into it changes, so that an edit is never served a
stale ``.so`` from ``omchat_torch/_build/``.  No ``nvcc`` is needed: only
the names are computed, over a throwaway copy of ``csrc/``."""

import os
import shutil

import pytest

from omchat_torch.ops import kernel_lib


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(kernel_lib.CSRC_DIR, dst)
    monkeypatch.setattr(kernel_lib, "CSRC_DIR", str(dst))
    return dst


def _append(path, text="\n// edited\n"):
    with open(path, "a") as f:
        f.write(text)


def test_every_header_is_hashed_into_every_library(csrc_copy):
    headers = sorted(n for n in os.listdir(csrc_copy) if n.endswith(".cuh"))
    assert "common.cuh" in headers and "sm90.cuh" in headers
    before = {src: kernel_lib._library_path(src) for src in kernel_lib.SOURCES}
    for h in headers:
        _append(csrc_copy / h)
        after = {src: kernel_lib._library_path(src) for src in kernel_lib.SOURCES}
        assert all(after[s] != before[s] for s in kernel_lib.SOURCES), h
        before = after


def test_a_header_edit_renames_the_library_that_includes_it(csrc_copy):
    src = "flash_attention_bwd.cu"
    assert '#include "sm90.cuh"' in (csrc_copy / src).read_text()
    old = kernel_lib._library_path(src)
    _append(csrc_copy / "sm90.cuh")
    new = kernel_lib._library_path(src)
    assert new != old
    assert os.path.dirname(new) == kernel_lib.BUILD_DIR
    assert os.path.basename(new).startswith("libflash_attention_bwd-")


def test_a_source_edit_renames_only_its_own_library(csrc_copy):
    before = {src: kernel_lib._library_path(src) for src in kernel_lib.SOURCES}
    _append(csrc_copy / "flash_attention_bwd.cu")
    after = {src: kernel_lib._library_path(src) for src in kernel_lib.SOURCES}
    changed = [s for s in kernel_lib.SOURCES if after[s] != before[s]]
    assert changed == ["flash_attention_bwd.cu"]


def test_a_new_header_renames_every_library(csrc_copy):
    before = {src: kernel_lib._library_path(src) for src in kernel_lib.SOURCES}
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    after = {src: kernel_lib._library_path(src) for src in kernel_lib.SOURCES}
    assert all(after[s] != before[s] for s in kernel_lib.SOURCES)
