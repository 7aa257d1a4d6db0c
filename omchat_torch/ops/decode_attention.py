"""Flash decode over the stacked, read-only KV cache with a self column (K3).

PyTorch port of ``omchat_tpu/ops/decode_attention.py:109 flash_decode_stacked``.
The wrapper :func:`flash_decode_stacked` sends a CPU tensor to
:func:`flash_decode_stacked_plain` and launches the CUDA kernel
(``omchat_torch/csrc/flash_decode_stacked.cu``) on a CUDA tensor, or raises;
``flash_decode_stacked.launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from omchat_torch.ops import kernel_lib

# C signature: q, k_cache, v_cache, cache_len, layer, k_new, v_new, out, B, KVH, T, D, group, stream
_K3_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def flash_decode_stacked_plain(q, k_cache, v_cache, cache_len, layer: int, k_new, v_new):
    """The kernel's function: layer ``layer`` of the cache, columns below
    ``cache_len`` plus the in-flight token as one always-valid column;
    natural-exp softmax with scale D^-0.5, p rounded to the cache dtype for the
    PV product.  q [B, 1, H, D] → [B, 1, H, D]."""
    B, _, H, D = q.shape
    kc, vc = k_cache[layer], v_cache[layer]  # [B, KVH, T, D]
    KVH, T = kc.shape[1], kc.shape[2]
    G = H // KVH
    qg = q[:, 0].reshape(B, KVH, G, D).float()
    k = torch.cat([kc, k_new.to(kc.dtype)[:, :, None]], dim=2).float()
    v = torch.cat([vc, v_new.to(vc.dtype)[:, :, None]], dim=2)
    s = torch.einsum("bngd,bntd->bngt", qg, k) * D**-0.5
    idx = torch.arange(T + 1, device=q.device)
    lens = torch.as_tensor(cache_len, dtype=torch.int64, device=q.device).expand(B)
    valid = (idx[None, :] < lens[:, None]) | (idx[None, :] == T)
    s = torch.where(valid[:, None, None, :], s, torch.tensor(float("-inf"), device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bngt,bntd->bngd", p.to(v.dtype).float(), v.float()) * (1.0 / l)
    return o.reshape(B, 1, H, D).to(q.dtype)


def flash_decode_stacked(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    layer: int,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
) -> torch.Tensor:
    """Decode attention against layer ``layer`` of a stacked READ-ONLY cache.

    q [B, 1, H, D]; k/v_cache [L, B, KVH, T, D] (the whole stack — the kernel
    reaches the layer by pointer offset, nothing is sliced or copied);
    cache_len [B] int32 valid cached rows EXCLUDING the new token; k_new/v_new
    [B, KVH, D].  Returns [B, 1, H, D]."""
    if q.device.type == "cpu":
        return flash_decode_stacked_plain(q, k_cache, v_cache, cache_len, layer, k_new, v_new)
    L, B, KVH, T, D = k_cache.shape
    H = q.shape[2]
    for t in (q, k_cache, v_cache, k_new, v_new):
        if t.device.type != "cuda" or t.dtype != torch.bfloat16:
            raise TypeError(f"flash_decode_stacked: the CUDA kernel takes bfloat16 CUDA tensors, got {t.dtype} on {t.device}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("flash_decode_stacked: the stacked cache must be contiguous")
    if q.shape[1] != 1 or H % KVH or H // KVH > 8 or D != 128 or not 0 <= layer < L:
        raise ValueError(f"flash_decode_stacked: unsupported shape q={tuple(q.shape)} cache={tuple(k_cache.shape)}")
    qc = q.contiguous()
    kn, vn = k_new.contiguous(), v_new.contiguous()
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device).expand(B).contiguous()
    out = torch.empty_like(qc)
    kernel_lib.launch(
        "flash_decode_stacked.cu", "omchat_flash_decode_stacked", _K3_ARGS,
        *map(kernel_lib.ptr, (qc, k_cache, v_cache, lens)), int(layer), *map(kernel_lib.ptr, (kn, vn, out)),
        B, KVH, T, D, H // KVH, kernel_lib.stream_ptr(q.device),
    )
    flash_decode_stacked.launches += 1
    return out


flash_decode_stacked.launches = 0
