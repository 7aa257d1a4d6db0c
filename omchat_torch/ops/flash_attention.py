"""Flash attention forward: the ViT's packed qk-norm attention (K1), its
sibling without the norm (K5) and the causal GQA prefill attention (K2).

PyTorch port of ``omchat_tpu/ops/flash_attention.py``.  Each kernel comes as

- a wrapper (:func:`packed_qkv_norm_attention`, :func:`packed_self_attention`,
  :func:`flash_attention`, and K1's first step :func:`qk_norm_prepass`): a
  CPU tensor goes to the plain PyTorch version, a CUDA tensor launches the
  hand-written CUDA kernel (``omchat_torch/csrc/``) or raises — there is no
  fallback from the kernel to the plain version, and an operand that the
  kernels' TMA tensor maps cannot take is refused by name;
- the plain version (``*_plain``), which computes the kernel's function
  without tiling: the CPU tests run it and ``chip_smoke.py`` holds the kernel
  against it;
- a launch counter, ``<wrapper>.launches``, raised by one at every kernel
  launch and nowhere else (K2's segment-ids entry counts apart, in
  ``flash_attention.seg_launches``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from omchat_torch.ops import kernel_lib
from omchat_torch.ops.attention import per_batch
from omchat_torch.ops.fp8 import E4M3, cast_to

LOG2E = 1.4426950408889634
# The JAX kernels' finite mask value (-0.7 * float32 max): a fully masked
# row never produces inf - inf.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# C signatures: qkv, gq, gk, qkn, rows, HD, eps, stream /
# q, q row / batch strides, k, ..., v, ..., q_scale, out, B, SP, H, D, valid_len, stream /
# q, k, v each with its head / row / batch strides, out, q_offset, kv_len, B, S, H, KVH, T, D, causal, stream
_PREPASS_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_PACKED_ARGS = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_void_p]
                + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_K2_ARGS = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong] * 3
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
# K2 with segment ids: q, k, v as above, out, seg, kv_len, B, S, H, KVH, D, causal, stream
_K2_SEG_ARGS = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong] * 3
                + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _require_cuda(name: str, *tensors: torch.Tensor, cache=()) -> str:
    """Every operand on CUDA and bfloat16, but the ``cache`` operands (a K/V
    cache or pool), which may be bfloat16 or e4m3, both of one dtype.  Returns
    the suffix of the kernel's C entry point for the cache's dtype: "" or
    "_e4m3"."""
    for t in (*tensors, *cache):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got {t.dtype}")
    dtypes = {t.dtype for t in cache}
    if len(dtypes) > 1 or not dtypes <= {torch.bfloat16, E4M3}:
        raise TypeError(f"{name}: the CUDA kernel takes a bfloat16 or e4m3 cache of one dtype, got {dtypes}")
    return "_e4m3" if E4M3 in dtypes else ""


def _tma_strides(name: str, what: str, t: torch.Tensor) -> tuple:
    """The element strides of ``t`` but the last, as the kernels' TMA tensor
    maps take them; raises, naming the operand, on what a map cannot take: a
    column stride other than 1, a base not 16-byte aligned, a stride not a
    multiple of 16 bytes.  A dimension of size 1 gets the stride it would have
    in a contiguous tensor (its own is never used)."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: {what} needs a unit column stride for TMA, got strides {tuple(t.stride())}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: {what}'s base address is not 16-byte aligned, as TMA needs")
    strides, inner = [], t.shape[-1]
    for n, st in zip(reversed(t.shape[:-1]), reversed(t.stride()[:-1])):
        st = st if n > 1 else inner
        if st * t.element_size() % 16:
            raise ValueError(f"{name}: {what} has a stride of {st} elements, not a multiple of 16 bytes as TMA needs "
                             f"(strides {tuple(t.stride())})")
        strides.append(st)
        inner = st * n
    return tuple(reversed(strides))


# ---------------------------------------------------------------------------
# K1: qk-RMSNorm + packed non-causal attention (InternViT-6B)
# ---------------------------------------------------------------------------


def packed_seq_supported(head_dim: int) -> bool:
    """Whether the ViT takes the pad-once packed path (head width 128, the
    kernel's).  The TPU kernel also capped the sequence at its VMEM budget
    (1600); the CUDA kernel tiles the kv axis, so the length does not matter."""
    return head_dim == 128


def packed_prescale(head_dim: int) -> float:
    """Fold into the q gamma: the softmax scale and the exp→exp2 change."""
    return head_dim**-0.5 * LOG2E


def packed_qkv_norm_attention_plain(qkv, rq, rk, gq, gk, *, num_heads: int, valid_len: int):
    """The kernel's function, untiled: q/k normalised as (x * rstd) * gamma
    in fp32 and rounded to the input dtype, full-row exp2 softmax with columns
    >= valid_len masked, p rounded to the input dtype for the PV product."""
    B, SP, HD3 = qkv.shape
    HD = HD3 // 3
    D = HD // num_heads
    dt = qkv.dtype
    q = (qkv[..., :HD].float() * rq[..., None] * gq).to(dt).reshape(B, SP, num_heads, D)
    k = (qkv[..., HD : 2 * HD].float() * rk[..., None] * gk).to(dt).reshape(B, SP, num_heads, D)
    v = qkv[..., 2 * HD :].reshape(B, SP, num_heads, D)
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float())
    if valid_len < SP:
        s[..., valid_len:] = float("-inf")
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l_inv = 1.0 / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhst,bthd->bhsd", p.to(dt).float(), v.float()) * l_inv
    return o.transpose(1, 2).reshape(B, SP, HD).to(dt)


def qk_norm_stats(qkv: torch.Tensor, q_gamma, k_gamma, eps: float):
    """Per-token rstd over the flattened H*D axis ([B, SP] fp32) and fp32
    gammas — outside the kernel, as in JAX (flash_attention.py:594-597)."""
    HD = qkv.shape[-1] // 3
    qf = qkv[..., :HD].float()
    kf = qkv[..., HD : 2 * HD].float()
    rq = torch.rsqrt(qf.square().mean(dim=-1) + eps).contiguous()
    rk = torch.rsqrt(kf.square().mean(dim=-1) + eps).contiguous()
    return rq, rk, q_gamma.float().contiguous(), k_gamma.float().contiguous()


def qk_norm_prepass_plain(qkv: torch.Tensor, q_gamma, k_gamma, eps: float):
    """K1's prepass, untiled: qn = (x * rstd_q) * gq and kn = (x * rstd_k) * gk
    in fp32 over the q and k column blocks of qkv, rounded to qkv's dtype —
    the values the kernel's QK dot takes.  Returns (qn, kn), [B, SP, H*D]."""
    HD = qkv.shape[-1] // 3
    rq, rk, gq, gk = qk_norm_stats(qkv, q_gamma, k_gamma, eps)
    qn = (qkv[..., :HD].float() * rq[..., None] * gq).to(qkv.dtype)
    kn = (qkv[..., HD : 2 * HD].float() * rk[..., None] * gk).to(qkv.dtype)
    return qn, kn


def qk_norm_prepass(qkv: torch.Tensor, q_gamma, k_gamma, eps: float):
    """K1's prepass (``omchat_qk_norm_prepass``): the q and k column blocks of
    each qkv row normalised and multiplied by their gammas, once.  qkv:
    [B, SP, 3*H*D]; returns (qn, kn), [B, SP, H*D] each (views of one
    [2, B, SP, H*D] tensor on CUDA)."""
    if qkv.device.type == "cpu":
        return qk_norm_prepass_plain(qkv, q_gamma, k_gamma, eps)
    _require_cuda("qk_norm_prepass", qkv)
    B, SP, HD3 = qkv.shape
    HD = HD3 // 3
    qkv = qkv.contiguous()
    gq, gk = q_gamma.float().contiguous(), k_gamma.float().contiguous()
    if (HD % 8 or HD > 4096 or gq.shape != (HD,) or gk.shape != (HD,)
            or any(t.data_ptr() % 16 for t in (qkv, gq, gk))):
        raise ValueError(f"qk_norm_prepass: qkv {tuple(qkv.shape)} / gammas {tuple(gq.shape)} {tuple(gk.shape)} "
                         "unsupported (H*D a multiple of 8 up to 4096, 16-byte aligned bases)")
    qkn = torch.empty((2, B, SP, HD), dtype=qkv.dtype, device=qkv.device)
    kernel_lib.launch(
        "packed_qkv_norm_attention.cu", "omchat_qk_norm_prepass", _PREPASS_ARGS,
        *map(kernel_lib.ptr, (qkv, gq, gk, qkn)), B * SP, HD, float(eps), kernel_lib.stream_ptr(qkv.device),
    )
    qk_norm_prepass.launches += 1
    return qkn[0], qkn[1]


qk_norm_prepass.launches = 0


def _packed_attention(name: str, q, k, v, q_scale: float, num_heads: int, valid_len: int) -> torch.Tensor:
    """``omchat_packed_attention`` over [B, SP, H*128] q, k, v read in place
    through their strides: K1's attention (q, k normalised, q_scale 1) and K5."""
    B, SP, HD = q.shape
    strides = [_tma_strides(name, what, t) for what, t in (("q", q), ("k", k), ("v", v))]
    out = torch.empty((B, SP, HD), dtype=q.dtype, device=q.device)
    args = []
    for t, (sb, sr) in zip((q, k, v), strides):
        args += [kernel_lib.ptr(t), sr, sb]
    kernel_lib.launch(
        "packed_qkv_norm_attention.cu", "omchat_packed_attention", _PACKED_ARGS, *args, float(q_scale),
        kernel_lib.ptr(out), B, SP, num_heads, HD // num_heads, valid_len, kernel_lib.stream_ptr(q.device),
    )
    return out


def packed_qkv_norm_attention(
    qkv: torch.Tensor,
    *,
    num_heads: int,
    q_gamma: torch.Tensor,
    k_gamma: torch.Tensor,
    eps: float,
    valid_len: Optional[int] = None,
) -> torch.Tensor:
    """qk-RMSNorm + packed non-causal self-attention over unsplit qkv.

    qkv: [B, SP, 3*H*D] as the fused qkv matmul writes it; q_gamma must
    already include ``packed_prescale(D)``.  Returns [B, SP, H*D]; rows >=
    valid_len are garbage.  On CUDA: the prepass (``qk_norm_prepass``), then
    the attention over qn, kn and the v block of qkv in place."""
    B, SP, HD3 = qkv.shape
    HD = HD3 // 3
    D = HD // num_heads
    valid_len = SP if valid_len is None else int(valid_len)
    if qkv.device.type == "cpu":
        rq, rk, gq, gk = qk_norm_stats(qkv, q_gamma, k_gamma, eps)
        return packed_qkv_norm_attention_plain(qkv, rq, rk, gq, gk, num_heads=num_heads, valid_len=valid_len)
    _require_cuda("packed_qkv_norm_attention", qkv)
    if D != 128 or not 1 <= valid_len <= SP:
        raise ValueError(f"packed_qkv_norm_attention: head_dim {D} / valid_len {valid_len} unsupported")
    qkv = qkv.contiguous()
    qn, kn = qk_norm_prepass(qkv, q_gamma, k_gamma, eps)
    out = _packed_attention("packed_qkv_norm_attention", qn, kn, qkv[..., 2 * HD :], 1.0, num_heads, valid_len)
    packed_qkv_norm_attention.launches += 1
    return out


packed_qkv_norm_attention.launches = 0


# ---------------------------------------------------------------------------
# K5: packed non-causal attention without the qk-norm
# ---------------------------------------------------------------------------


def packed_self_attention_plain(q, k, v, *, num_heads: int, valid_len: int, prescaled: bool = False):
    """K5's function, untiled: q × (D^-0.5 · log2 e) in fp32 rounded to q's
    dtype (unless ``prescaled``), full-row exp2 softmax with columns >=
    valid_len masked, p rounded to v's dtype for the PV product, the output
    scaled by 1 / l of the fp32 row sums."""
    B, SP, HD = q.shape
    D = HD // num_heads
    dt = q.dtype
    qs = q if prescaled else (q.float() * packed_prescale(D)).to(dt)
    qh, kh, vh = (t.reshape(B, SP, num_heads, D) for t in (qs, k, v))
    s = torch.einsum("bshd,bthd->bhst", qh.float(), kh.float())
    if valid_len < SP:
        s[..., valid_len:] = float("-inf")
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l_inv = 1.0 / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhst,bthd->bhsd", p.to(v.dtype).float(), vh.float()) * l_inv
    return o.transpose(1, 2).reshape(B, SP, HD).to(dt)


def packed_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    num_heads: int,
    valid_len: Optional[int] = None,
    prescaled: bool = False,
) -> torch.Tensor:
    """Packed non-causal self-attention over [B, SP, H*D] lane slices, the
    ViT route of a tower without qk-norm.

    q, k, v: [B, SP, H*D] — views of the fused qkv matmul's output
    (``qkv.chunk(3, -1)``) are read in place through their strides;
    ``prescaled``: q already carries ``packed_prescale(D)``.  Returns
    [B, SP, H*D]; rows >= valid_len are garbage."""
    B, SP, HD = q.shape
    D = HD // num_heads
    valid_len = SP if valid_len is None else int(valid_len)
    if q.device.type == "cpu":
        return packed_self_attention_plain(q, k, v, num_heads=num_heads, valid_len=valid_len, prescaled=prescaled)
    _require_cuda("packed_self_attention", q, k, v)
    if D != 128 or not 1 <= valid_len <= SP or not q.shape == k.shape == v.shape:
        raise ValueError(f"packed_self_attention: head_dim {D} / valid_len {valid_len} / shapes "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)} unsupported")
    out = _packed_attention("packed_self_attention", q, k, v, 1.0 if prescaled else packed_prescale(D), num_heads,
                            valid_len)
    packed_self_attention.launches += 1
    return out


packed_self_attention.launches = 0


# ---------------------------------------------------------------------------
# K2: causal / non-causal GQA flash attention
# ---------------------------------------------------------------------------


def _prescale_q(q: torch.Tensor) -> torch.Tensor:
    """q * D^-0.5 * log2(e) in q's own dtype (flash_attention.py:450); without
    this bf16 rounding the result drifts from the JAX path.  The factor is
    filled on q's device (no host copy), so a CUDA graph can capture K2."""
    return q * torch.full((), q.shape[-1] ** -0.5 * LOG2E, dtype=q.dtype, device=q.device)


def head_dim_supported(head_dim: int, e4m3: bool = False) -> bool:
    """Whether the CUDA attention kernels over a cache take this head width:
    K2 (:func:`flash_attention`), K3 / K6 (``ops.decode_attention``) and K12 /
    K13 / K14 (``ops.paged_attention``) all take a row of whole 16-byte
    pieces, which TMA's strides and the 16-byte copies need, up to 128
    columns: a multiple of 8 from 8 to 128 on a bfloat16 cache, of 16 from 16
    to 128 on an e4m3 cache (one byte a value).  The JAX kernels take any
    width."""
    step = 16 if e4m3 else 8
    return head_dim % step == 0 and step <= head_dim <= 128


def require_head_dim(name: str, head_dim: int, e4m3: bool) -> None:
    """Raise, naming the kernel and the width, unless :func:`head_dim_supported`."""
    if not head_dim_supported(head_dim, e4m3):
        rule = ("a multiple of 16 from 16 to 128 (an e4m3 row must be whole 16-byte pieces)" if e4m3
                else "a multiple of 8 from 8 to 128")
        raise ValueError(f"{name}: head width {head_dim} on a{'n e4m3' if e4m3 else ' bfloat16'} cache is not "
                         f"taken by the CUDA kernel, which takes {rule}")


def flash_attention_plain(q, k, v, *, causal: bool, q_offset, kv_len, segment_ids=None):
    """The kernel's function, untiled.  q: [B, S, H, D]; k/v [B, KVH, T, D].

    q pre-scaled in its dtype, fp32 scores in the exp2 domain, the finite
    mask value, p rounded to v's dtype for the PV product (to e4m3 on an fp8
    cache, as the TPU kernel's ``p.astype(v.dtype)``); a row with no valid
    column outputs zeros.  With ``segment_ids`` [B, S] (S == T) a column is
    valid only where its id equals the row's, so a row of padding (id -1,
    past ``kv_len``) outputs zeros too; the TPU kernel leaves such a row
    unspecified (its finite mask value averages v over the tiles it visited)."""
    B, S, H, D = q.shape
    KVH, T = k.shape[1], k.shape[2]
    G = H // KVH
    dev = q.device
    q_off = per_batch(q_offset, B, T - S, dev)
    kvl = per_batch(kv_len, B, T, dev)
    qg = _prescale_q(q).reshape(B, S, KVH, G, D).permute(0, 2, 3, 1, 4)  # [B, KVH, G, S, D]
    s = torch.einsum("bngsd,bntd->bngst", qg.float(), k.float())
    col = torch.arange(T, device=dev)
    mask = (col[None, None, :] < kvl[:, None, None]).expand(B, S, T)
    if causal:
        row = torch.arange(S, device=dev)[None, :, None] + q_off[:, None, None]
        mask = mask & (col[None, None, :] <= row)
    if segment_ids is not None:
        mask = mask & (segment_ids[:, :, None] == segment_ids[:, None, :])
    s = torch.where(mask[:, None, None], s, torch.tensor(DEFAULT_MASK_VALUE, device=dev))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bngst,bntd->bngsd", cast_to(p, v.dtype).float(), v.float()) / l
    o = torch.where(mask.any(dim=-1)[:, None, None, :, None], o, torch.zeros((), device=dev))
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    q_offset=None,
    kv_len=None,
    kv_format: str = "btnd",
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention forward.  q: [B, S, H, D]; k/v: [B, T, KVH, D]
    ("btnd") or [B, KVH, T, D] ("bntd", the cache layout the kernel reads;
    bfloat16 or e4m3 on CUDA).  Returns [B, S, H, D] in q.dtype; semantics of
    ``attention_reference``.  On CUDA, D is any width that
    :func:`head_dim_supported` takes; another raises.

    ``segment_ids`` [B, S] int32 (multi-document packing, -1 = padding):
    self-attention only (S == T, else ValueError, as in JAX), ``kv_len``
    defaulting to each row's count of ids >= 0 (flash_attention.py:333-337);
    on CUDA ``omchat_flash_attention_seg`` over a bf16 K / V without
    ``q_offset`` (the e4m3 cache never carries segments)."""
    if kv_format == "btnd":
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    elif kv_format != "bntd":
        raise ValueError(f"unknown kv_format {kv_format!r}")
    B, S, H, D = q.shape
    KVH, T = k.shape[1], k.shape[2]
    if segment_ids is not None:
        if S != T:
            raise ValueError("segment_ids packing requires self-attention (S == T)")
        if kv_len is None:
            kv_len = (segment_ids >= 0).sum(dim=1, dtype=torch.int32)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len, segment_ids=segment_ids)
    suffix = _require_cuda("flash_attention", q, cache=(k, v))
    if segment_ids is not None and (suffix or q_offset is not None):
        raise ValueError("flash_attention: segment_ids take a bf16 K / V and no q_offset on CUDA (the packed "
                         "forward is cacheless)")
    require_head_dim("flash_attention", D, bool(suffix))
    if H % KVH != 0 or k.shape != v.shape:
        raise ValueError(f"flash_attention: heads {H}/{KVH}, k {tuple(k.shape)} / v {tuple(v.shape)} unsupported by "
                         "the CUDA kernel")
    ks, vs = _tma_strides("flash_attention", "k", k), _tma_strides("flash_attention", "v", v)
    qs = _prescale_q(q).contiguous()
    kvl = per_batch(kv_len, B, T, q.device)
    out = torch.empty_like(qs)
    if segment_ids is not None:
        seg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
        if seg.shape != (B, S):
            raise ValueError(f"flash_attention: segment_ids {tuple(seg.shape)}, expected {(B, S)}")
        kernel_lib.launch(
            "flash_attention.cu", "omchat_flash_attention_seg", _K2_SEG_ARGS,
            kernel_lib.ptr(qs), D, H * D, S * H * D, kernel_lib.ptr(k), ks[1], ks[2], ks[0],
            kernel_lib.ptr(v), vs[1], vs[2], vs[0], *map(kernel_lib.ptr, (out, seg, kvl)), B, S, H, KVH, D,
            int(causal), kernel_lib.stream_ptr(q.device),
        )
        flash_attention.seg_launches += 1
        return out
    q_off = per_batch(q_offset, B, T - S, q.device)
    kernel_lib.launch(
        "flash_attention.cu", "omchat_flash_attention" + suffix, _K2_ARGS,
        kernel_lib.ptr(qs), D, H * D, S * H * D, kernel_lib.ptr(k), ks[1], ks[2], ks[0],
        kernel_lib.ptr(v), vs[1], vs[2], vs[0], *map(kernel_lib.ptr, (out, q_off, kvl)), B, S, H, KVH, T, D,
        int(causal), kernel_lib.stream_ptr(q.device),
    )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # omchat_flash_attention / _e4m3
flash_attention.seg_launches = 0  # omchat_flash_attention_seg
