"""Build and load the port's hand-written CUDA kernels.

Each ``omchat_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with :mod:`ctypes`.  A
library is built at first use into ``omchat_torch/_build/`` (listed in
``.gitignore``); its file name carries a hash of its sources, so an edited
kernel is rebuilt and an unchanged one is reused.  :func:`build_all` starts one
``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU-only test environment has no
``nvcc`` and imports every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = (
    "packed_qkv_norm_attention.cu",
    "flash_attention.cu",
    "flash_decode_stacked.cu",
    "commit_rows.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else
    the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit to build the kernels")


def _library_path(source: str) -> str:
    h = hashlib.sha256()
    for name in (source, "common.cuh"):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:12]}.so")


def build_all(sources: Iterable[str] = SOURCES, verbose: bool = False) -> float:
    """Compile every source whose library is missing, one ``nvcc`` per
    source started together; returns the wall seconds spent.  Raises with the
    compiler's output if any build fails."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for src in sources:
        out = _library_path(src)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", tmp, os.path.join(CSRC_DIR, src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src}:\n{log}")
            continue
        if verbose and log:
            print(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def library(source: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<source>`` (built on first use)."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            path = _library_path(source)
            if not os.path.exists(path):
                build_all([source])
            lib = ctypes.CDLL(path)
            lib.omchat_cuda_error_string.argtypes = [ctypes.c_int]
            lib.omchat_cuda_error_string.restype = ctypes.c_char_p
            _loaded[source] = lib
        return lib


def launch(source: str, fn_name: str, argtypes, *args) -> None:
    """Call the C entry point ``fn_name`` of ``csrc/<source>`` (every pointer
    and the stream as ``c_void_p``, every size as ``c_int``) and raise if it
    reports a CUDA error for its launch."""
    lib = library(source)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        msg = lib.omchat_cuda_error_string(err).decode()
        raise RuntimeError(f"{fn_name}: CUDA launch failed ({err}: {msg})")


def stream_ptr(device: Optional[torch.device] = None) -> int:
    """PyTorch's current CUDA stream as an integer handle for ctypes."""
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
