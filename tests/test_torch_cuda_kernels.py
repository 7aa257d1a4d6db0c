"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests need an NVIDIA GPU (Hopper,
sm_90a): without one they skip.  They cover edge cases that ``chip_smoke.py``
(main-path shapes only) does not: partial tiles, GQA
groups 7 and 2, empty and ragged caches, non-causal and btnd layouts.  Run on
the card from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py -q

Inputs are bf16; tolerance atol = rtol = 2e-2 (bf16 rounding of p and of the
output, sums in another order), except the row commit, which is bitwise.
"""

import pytest
import torch

from omchat_torch.ops import decode_attention as da
from omchat_torch.ops import flash_attention as fa
from omchat_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda
TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


@pytest.mark.parametrize("B,SP,valid,H", [(2, 72, 65, 3), (1, 136, 136, 2), (3, 1032, 1025, 2)])
def test_packed_qkv_norm_attention_kernel(gen, B, SP, valid, H):
    D = 128
    qkv = _randn(gen, B, SP, 3 * H * D)
    qg = (1 + 0.1 * _randn(gen, H * D).float()).to(torch.bfloat16) * fa.packed_prescale(D)
    kg = (1 + 0.1 * _randn(gen, H * D).float()).to(torch.bfloat16)
    n0 = fa.packed_qkv_norm_attention.launches
    out = fa.packed_qkv_norm_attention(qkv, num_heads=H, q_gamma=qg, k_gamma=kg, eps=1e-6, valid_len=valid)
    torch.cuda.synchronize()
    assert fa.packed_qkv_norm_attention.launches == n0 + 1
    rq, rk, gq, gk = fa.qk_norm_stats(qkv, qg, kg, 1e-6)
    ref = fa.packed_qkv_norm_attention_plain(qkv, rq, rk, gq, gk, num_heads=H, valid_len=valid)
    torch.testing.assert_close(out[:, :valid].float(), ref[:, :valid].float(), **TOL)


@pytest.mark.parametrize(
    "H,KVH,S,T,q_off,kv_len,causal,fmt",
    [
        (28, 4, 200, 328, [0], [190], True, "bntd"),
        (14, 2, 64, 256, [40, 100], [90, 164], True, "bntd"),
        (4, 2, 70, 70, [0, 0], [70, 33], True, "bntd"),
        (4, 4, 50, 50, None, None, False, "btnd"),
        (4, 2, 16, 64, [0], [0], True, "bntd"),
    ],
    ids=["group7", "group7_offsets", "group2_ragged", "noncausal_btnd", "empty_kv"],
)
def test_flash_attention_kernel(gen, H, KVH, S, T, q_off, kv_len, causal, fmt):
    D = 128
    B = len(q_off) if q_off is not None else 1
    q = _randn(gen, B, S, H, D)
    kv_shape = (B, KVH, T, D) if fmt == "bntd" else (B, T, KVH, D)
    k, v = _randn(gen, *kv_shape), _randn(gen, *kv_shape)
    qo = torch.tensor(q_off, dtype=torch.int32, device="cuda") if q_off is not None else None
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda") if kv_len is not None else None
    out = fa.flash_attention(q, k, v, causal=causal, q_offset=qo, kv_len=kl, kv_format=fmt)
    torch.cuda.synchronize()
    kb, vb = (k, v) if fmt == "bntd" else (k.transpose(1, 2), v.transpose(1, 2))
    ref = fa.flash_attention_plain(q, kb, vb, causal=causal, q_offset=qo, kv_len=kl)
    for b in range(B):
        rows = S if kv_len is None else max(0, min(S, kv_len[b] - (q_off[b] if q_off else 0)))
        if kv_len is not None and kv_len[b] == 0:
            assert (out[b] == 0).all()  # no valid column: zeros, as the TPU kernel writes
            continue
        torch.testing.assert_close(out[b, :rows].float(), ref[b, :rows].float(), **TOL)


@pytest.mark.parametrize("H,KVH,lens,layer", [(28, 4, [0], 0), (28, 4, [3110], 27), (4, 2, [1, 200], 1),
                                              (14, 2, [255, 17], 2)],
                         ids=["empty", "main_shape", "group2", "group7_ragged"])
def test_flash_decode_stacked_kernel(gen, H, KVH, lens, layer):
    D = 128
    B, T = len(lens), 3328 if max(lens) > 256 else 256
    L = max(3, layer + 1)
    q = _randn(gen, B, 1, H, D)
    kc, vc = _randn(gen, L, B, KVH, T, D), _randn(gen, L, B, KVH, T, D)
    kn, vn = _randn(gen, B, KVH, D), _randn(gen, B, KVH, D)
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = da.flash_decode_stacked(q, kc, vc, cl, layer, kn, vn)
    torch.cuda.synchronize()
    ref = da.flash_decode_stacked_plain(q, kc, vc, cl, layer, kn, vn)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


def test_commit_rows_kernel_is_bitwise_and_in_place(gen):
    dtype = torch.bfloat16
    P, KVH, PS, D = 8, 4, 64, 128
    kp = torch.randn(P, KVH, PS, D, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(P, KVH, PS, D, generator=gen, device="cuda").to(dtype)
    pages = torch.tensor([0, 5, 7, 2], dtype=torch.int32, device="cuda")
    offs = torch.tensor([0, 63, 31, 8], dtype=torch.int32, device="cuda")
    kr = torch.randn(4, KVH, D, generator=gen, device="cuda").to(dtype)
    vr = torch.randn(4, KVH, D, generator=gen, device="cuda").to(dtype)
    kref, vref = kp.clone(), vp.clone()
    ko, vo = pa.commit_rows(kp, vp, pages, offs, kr, vr)
    torch.cuda.synchronize()
    assert ko.data_ptr() == kp.data_ptr() and vo.data_ptr() == vp.data_ptr()
    pa.commit_rows_plain(kref, vref, pages, offs, kr, vr)
    assert torch.equal(kp, kref) and torch.equal(vp, vref)
