#!/usr/bin/env python3
"""Check the wgmma descriptors and TMA maps of ``omchat_torch/csrc/sm90.cuh``
(bf16) and ``omchat_torch/csrc/s8_gemm_sm90.cuh`` (int8) on the card, one
product at a time, against ``torch.matmul`` and ``torch._int_mm``.

    python3 chip_probes/wgmma_desc_probe.py

Builds ``chip_probes/wgmma_desc_probe.cu`` with nvcc (sm_90a) into
``omchat_torch/_build/`` and runs four products on bf16 tiles loaded by TMA
into 128-byte-swizzled shared memory: S = Q K^T (m64n128k16, both K-major,
rows 64-127 of a 128-row tile), P V (m64n128k16, P in registers, V
MN-major over 128 rows), K Q^T over 64-row tiles (m64n64k16) and P V over a
64-row V.  Each fp32 result must match the fp32 product of the same bf16
inputs within 1e-3 (sums in another order).  Then mode 4: an int8 A B^T
(m64n128k32 s8, rows 64-127 of a 128-row A tile, both operands K-major from
rank-2 TMA maps), which must equal ``torch._int_mm`` exactly (int32 sums are
exact).  Exits 1 if a product fails.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from omchat_torch.ops import kernel_lib  # noqa: E402

MODES = {0: "S = Q K^T, m64n128k16 ss, 128-row tiles", 1: "O = P V, m64n128k16 rs, V MN-major, 128 rows",
         2: "S^T = K Q^T, m64n64k16 ss, 64-row tiles", 3: "dV = P^T dO, m64n128k16 rs, dO MN-major, 64 rows"}


def build() -> ctypes.CDLL:
    out = os.path.join(kernel_lib.BUILD_DIR, "libwgmma_desc_probe.so")
    os.makedirs(kernel_lib.BUILD_DIR, exist_ok=True)
    cmd = [kernel_lib.nvcc_path(), *kernel_lib.NVCC_FLAGS, "-I", kernel_lib.CSRC_DIR, "-o", out,
           os.path.join(HERE, "wgmma_desc_probe.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stdout + res.stderr)
    lib = ctypes.CDLL(out)
    lib.omchat_wgmma_probe.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    lib.omchat_wgmma_probe.restype = ctypes.c_int
    lib.omchat_s8_probe.argtypes = [ctypes.c_void_p] * 4
    lib.omchat_s8_probe.restype = ctypes.c_int
    return lib


def run_s8(lib, gen) -> int:
    """Mode 4: the int8 product's largest |difference| from torch._int_mm (must be 0)."""
    a = torch.randint(-128, 128, (128, 128), generator=gen, device="cuda", dtype=torch.int8)
    b = torch.randint(-128, 128, (128, 128), generator=gen, device="cuda", dtype=torch.int8)
    c = torch.full((64, 128), -(2**31), dtype=torch.int32, device="cuda")
    err = lib.omchat_s8_probe(a.data_ptr(), b.data_ptr(), c.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mode 4: launch failed ({err})")
    torch.cuda.synchronize()
    return int((c.long() - torch._int_mm(a[64:].contiguous(), b.t()).long()).abs().max())


def run(lib, mode: int, gen) -> float:
    rows_a = 128 if mode == 0 else 64
    rows_b = 128 if mode in (0, 1) else 64
    a = torch.randn(rows_a, 128, generator=gen, device="cuda").bfloat16()
    b = torch.randn(rows_b, 128, generator=gen, device="cuda").bfloat16()
    p = torch.rand(64, rows_b, generator=gen, device="cuda").bfloat16()
    n = 64 if mode == 2 else 128
    c = torch.full((64, n), float("nan"), device="cuda")
    err = lib.omchat_wgmma_probe(a.data_ptr(), b.data_ptr(), p.data_ptr(), c.data_ptr(), mode,
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mode {mode}: launch failed ({err})")
    torch.cuda.synchronize()
    if mode == 0:
        ref = a[64:].float() @ b.float().T
    elif mode == 2:
        ref = a.float() @ b.float().T
    else:
        ref = p.float() @ b.float()
    return float((c - ref).abs().max()) if torch.isfinite(c).all() else float("inf")


def main() -> int:
    if not torch.cuda.is_available():
        print("wgmma_desc_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda, flush=True)
    lib = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for mode, what in MODES.items():
        err = run(lib, mode, gen)
        good = err <= 1e-3
        ok = ok and good
        print(f"mode {mode} ({what}): max_abs_err={err:.3g} {'ok' if good else 'FAILED'}", flush=True)
    err = run_s8(lib, gen)
    ok = ok and err == 0
    print(f"mode 4 (int8 A B^T, m64n128k32 s8, rank-2 maps): max_abs_err={err} {'ok' if err == 0 else 'FAILED'}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
