"""In-place K/V row commit (K4).

PyTorch port of ``commit_rows`` from ``omchat_tpu/ops/paged_attention.py:619``
(the module name is kept so readers find it; the paged serving kernels come
with a later slice).  The wrapper :func:`commit_rows` sends CPU tensors to
:func:`commit_rows_plain` and launches the CUDA kernel
(``omchat_torch/csrc/commit_rows.cu``) on CUDA tensors, or raises;
``commit_rows.launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from omchat_torch.ops import kernel_lib

# C signature: k_pool, v_pool, pages, offsets, k_rows, v_rows, N, KVH, PS, D, stream
_K4_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def commit_rows_plain(k_pool, v_pool, pages, offsets, k_rows, v_rows):
    """``pool[pages[i], :, offsets[i]] = rows[i]`` in place."""
    pages = torch.as_tensor(pages, dtype=torch.long, device=k_pool.device)
    offsets = torch.as_tensor(offsets, dtype=torch.long, device=k_pool.device)
    k_pool[pages, :, offsets] = k_rows.to(k_pool.dtype)
    v_pool[pages, :, offsets] = v_rows.to(v_pool.dtype)
    return k_pool, v_pool


def commit_rows(
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    pages: torch.Tensor,
    offsets: torch.Tensor,
    k_rows: torch.Tensor,
    v_rows: torch.Tensor,
):
    """Write N single-token K/V rows into the pools IN PLACE.

    k/v_pool [P, KVH, PS, D]; pages, offsets [N] int32; k/v_rows [N, KVH, D].
    The pools are updated in place — PyTorch's counterpart of the TPU call's
    ``input_output_aliases`` — and returned.  Only the N target rows change;
    every other byte of the pools is left as it was.  Rows sharing a
    (page, offset) race; callers never write one twice."""
    if k_pool.device.type == "cpu":
        return commit_rows_plain(k_pool, v_pool, pages, offsets, k_rows, v_rows)
    for t in (k_pool, v_pool, k_rows, v_rows):
        if t.device.type != "cuda":
            raise ValueError(f"commit_rows: expected CUDA tensors, got {t.device}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()) or k_pool.shape != v_pool.shape:
        raise ValueError("commit_rows: the pools must be contiguous and of one shape")
    if k_pool.dtype != torch.bfloat16 or v_pool.dtype != torch.bfloat16:
        raise TypeError(f"commit_rows: the CUDA kernel takes a bfloat16 cache, got {k_pool.dtype}")
    P, KVH, PS, D = k_pool.shape
    n = int(pages.shape[0])
    kr = k_rows.to(k_pool.dtype).reshape(n, KVH, D).contiguous()
    vr = v_rows.to(v_pool.dtype).reshape(n, KVH, D).contiguous()
    pg = torch.as_tensor(pages, dtype=torch.int32, device=k_pool.device).contiguous()
    of = torch.as_tensor(offsets, dtype=torch.int32, device=k_pool.device).contiguous()
    kernel_lib.launch(
        "commit_rows.cu", "omchat_commit_rows", _K4_ARGS,
        *map(kernel_lib.ptr, (k_pool, v_pool, pg, of, kr, vr)), n, KVH, PS, D, kernel_lib.stream_ptr(k_pool.device),
    )
    commit_rows.launches += 1
    return k_pool, v_pool


commit_rows.launches = 0
