"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests need an NVIDIA GPU (Hopper,
sm_90a): without one they skip.  They cover edge cases that ``chip_smoke.py``
(main-path shapes only) does not: partial tiles, GQA
groups 7 and 2, empty and ragged caches, non-causal and btnd layouts; for the
paged kernels a zero length, lengths on a page boundary, 16 ragged requests,
strided tables, a partly filled last page and duplicate parking pages.  Run on
the card from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py -q

Inputs are bf16; tolerance atol = rtol = 2e-2 (bf16 rounding of p and of the
output, sums in another order), except the row and page commits, which are
bitwise.  The w8a8 kernels (K7 rmsnorm_quant, K8 add_rmsnorm_quant, K9 fc1 +
GELU + quantize, K11 proj glue) at M not a tile multiple, M <= 16 and rows of
all zeros (the 1e-6 floor of the row scale): int8 codes within one of the
plain version's and at least 99% equal (fp32 sums in another order), row
scales rtol 1e-5, x' bitwise for K8 and within one bf16 ulp for K11.
"""

import pytest
import torch

from omchat_torch.ops import decode_attention as da
from omchat_torch.ops import flash_attention as fa
from omchat_torch.ops import norms
from omchat_torch.ops import paged_attention as pa
from omchat_torch.ops import quant_matmul as qm

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


def _paged_pool(gen, P, KVH, D, lengths, W):
    """A bf16 pool of P pages + the parking page P, shuffled live pages per
    request, parking entries past each length."""
    PS = 128
    kp, vp = _randn(gen, P + 1, KVH, PS, D), _randn(gen, P + 1, KVH, PS, D)
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(1)).tolist()
    tables = torch.full((len(lengths), W), P, dtype=torch.int32)
    used = 0
    for b, n in enumerate(lengths):
        live = -(-n // PS)
        tables[b, :live] = torch.tensor(perm[used: used + live], dtype=torch.int32)
        used += live
    return kp, vp, tables.cuda()


@pytest.mark.parametrize(
    "lengths,self_col,page_offset",
    [([0, 5], True, 0), ([128, 256, 129], True, 0),
     ([3, 700, 1, 2300, 128, 64, 999, 1500, 17, 400, 2048, 255, 600, 90, 1200, 33], True, 0),
     ([0, 300], False, 0), ([200, 77], True, 3)],
    ids=["length0", "page_boundary", "b16_ragged", "no_self_column", "page_offset"],
)
def test_paged_flash_decode_kernel(gen, lengths, self_col, page_offset):
    H, KVH, D = 28, 4, 128
    B = len(lengths)
    W = max(4, -(-max(lengths) // 128))
    P = sum(-(-n // 128) for n in lengths) + 2
    kp, vp, tables = _paged_pool(gen, P, KVH, D, lengths, W)
    if page_offset:  # the pages sit after `page_offset` pages of another layer
        kp = torch.cat([_randn(gen, page_offset, *kp.shape[1:]), kp])
        vp = torch.cat([_randn(gen, page_offset, *vp.shape[1:]), vp])
    q = _randn(gen, B, 1, H, D)
    kn, vn = (_randn(gen, B, KVH, D), _randn(gen, B, KVH, D)) if self_col else (None, None)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    wide = torch.cat([tables, torch.zeros_like(tables)], dim=1)[:, :W]  # a column slice keeps its row stride
    n0 = pa.paged_flash_decode.launches
    out = pa.paged_flash_decode(q, kp, vp, lens, wide, kn, vn, page_offset=page_offset)
    torch.cuda.synchronize()
    assert pa.paged_flash_decode.launches == n0 + 1
    ref = pa.paged_flash_decode_plain(q, kp, vp, lens, wide, kn, vn, page_offset=page_offset)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    for b, n in enumerate(lengths):
        if n == 0:  # no page read: exactly v_new (or zeros), no NaN
            want = vn[b].repeat_interleave(H // KVH, dim=0) if self_col else torch.zeros_like(out[b, 0])
            assert torch.equal(out[b, 0], want)


@pytest.mark.parametrize(
    "C,q_offset,chunk_len",
    [(128, [0, 256], [128, 100]), (256, [1024], [200]), (1024, [1024], [1024])],
    ids=["ragged_rows", "partial_last_page", "serving_chunk"],
)
def test_paged_flash_prefill_kernel(gen, C, q_offset, chunk_len):
    H, KVH, D = 28, 4, 128
    B = len(q_offset)
    kv_len = [o + n for o, n in zip(q_offset, chunk_len)]
    W = 33
    P = sum(-(-n // 128) for n in kv_len) + 1
    kp, vp, tables = _paged_pool(gen, P, KVH, D, kv_len, W)
    q = _randn(gen, B, C, H, D)
    qo = torch.tensor(q_offset, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    out = pa.paged_flash_prefill(q, kp, vp, kl, tables, qo)
    torch.cuda.synchronize()
    ref = pa.paged_flash_prefill_plain(q, kp, vp, kl, tables, qo)
    for b in range(B):
        torch.testing.assert_close(out[b, :chunk_len[b]].float(), ref[b, :chunk_len[b]].float(), **TOL)
    k, v = pa._gather_pages(kp, vp, tables)  # the pages gathered, then K2: the same function
    gathered = fa.flash_attention(q, k, v, causal=True, q_offset=qo, kv_len=kl, kv_format="bntd")
    for b in range(B):
        torch.testing.assert_close(out[b, :chunk_len[b]].float(), gathered[b, :chunk_len[b]].float(), **TOL)


def test_commit_pages_kernel_is_bitwise_in_place_with_duplicate_parking(gen):
    L, P, KVH, D, PS = 3, 9, 4, 128, 128
    pool_k = _randn(gen, L * (P + 1), KVH, PS, D)
    pool_v = _randn(gen, L * (P + 1), KVH, PS, D)
    B, C = 2, 3  # scratch cache [L, B, KVH, C*PS, D] seen as [L*B, C, KVH, PS, D]
    scratch_k = _randn(gen, L, B, KVH, C * PS, D)
    scratch_v = _randn(gen, L, B, KVH, C * PS, D)
    view_k = scratch_k.view(L * B, KVH, C, PS, D).transpose(1, 2)
    view_v = scratch_v.view(L * B, KVH, C, PS, D).transpose(1, 2)
    pages = torch.tensor([[[1, 4, P], [2, P, P]]] * L, dtype=torch.int32)  # duplicates on the parking page
    pages = (pages + torch.arange(L, dtype=torch.int32)[:, None, None] * (P + 1)).reshape(-1).cuda()
    ref_k, ref_v = pool_k.clone(), pool_v.clone()
    ko, vo = pa.commit_pages(pool_k, pool_v, pages, view_k, view_v)
    torch.cuda.synchronize()
    assert ko.data_ptr() == pool_k.data_ptr() and vo.data_ptr() == pool_v.data_ptr()
    pa.commit_pages_plain(ref_k, ref_v, pages, view_k, view_v)
    real = torch.ones(L * (P + 1), dtype=torch.bool)
    real[P::P + 1] = False
    assert torch.equal(pool_k[real], ref_k[real]) and torch.equal(pool_v[real], ref_v[real])
    chunks = view_k.reshape(-1, KVH, PS, D)
    for li in range(L):  # each 16-byte vector of a parking page comes from one of its chunks
        park = pool_k[li * (P + 1) + P].reshape(-1, 8)
        cands = chunks[(pages == li * (P + 1) + P).nonzero()[:, 0]].reshape(-1, park.shape[0], 8)
        assert bool((park[None] == cands).all(dim=-1).any(dim=0).all())


def _codes_close(got, want):
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1 and float((d == 0).float().mean()) >= 0.99


def _within_ulp(got, want):
    ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp(min=1e-30))) - 7)
    assert bool(((got.float() - want.float()).abs() <= ulp).all())


@pytest.mark.parametrize("rows,D", [(1, 64), (5, 3584), (130, 3200)])
def test_rmsnorm_quant_kernels(gen, rows, D):
    x, gamma = _randn(gen, rows, D), (1 + 0.1 * _randn(gen, D).float()).bfloat16()
    x[0] = 0  # the scale floor: max(0, 1e-6) / 127, codes 0
    n7, n8 = norms.rmsnorm_quant.launches, norms.add_rmsnorm_quant.launches
    q, rs = norms.rmsnorm_quant(x, gamma)
    torch.cuda.synchronize()
    qp, rp = norms.rmsnorm_quant_plain(x, gamma)
    _codes_close(q, qp)
    torch.testing.assert_close(rs, rp, rtol=1e-5, atol=0)
    assert float(rs[0, 0]) == pytest.approx(1e-6 / 127) and not q[0].any()
    delta, ls = _randn(gen, rows, D), (0.1 * _randn(gen, D).float()).bfloat16()
    delta[0] = 0
    for scale in (ls, None):
        xn, q, rs = norms.add_rmsnorm_quant(x, delta, scale, gamma)
        torch.cuda.synchronize()
        xp, qp, rp = norms.add_rmsnorm_quant_plain(x, delta, scale, gamma)
        assert torch.equal(xn, xp)
        _codes_close(q, qp)
        torch.testing.assert_close(rs, rp, rtol=1e-5, atol=0)
    assert (norms.rmsnorm_quant.launches, norms.add_rmsnorm_quant.launches) == (n7 + 1, n8 + 2)


def _qlinear(gen, n, k, bias):
    p = {"kernel_q": torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8),
         "scale": (torch.rand(n, generator=gen, device="cuda") * 4e-4 + 1e-4).bfloat16()}
    if bias:
        p["bias"] = (0.05 * _randn(gen, n).float()).bfloat16()
    return p


@pytest.mark.parametrize("M,K,N,bias", [(13, 256, 384, True), (300, 256, 384, False), (129, 3200, 1280, True)])
def test_fc1_gelu_quant_kernel(gen, M, K, N, bias):
    xq = torch.randint(-127, 128, (M, K), generator=gen, device="cuda", dtype=torch.int8)
    xq[1] = 0  # a row of zeros: h is the bias alone
    rs = torch.rand((M, 1), generator=gen, device="cuda") * 0.01 + 1e-3
    p = _qlinear(gen, N, K, bias)
    os_ = torch.tensor(0.02, device="cuda")
    n0 = qm.dense_prequant_gelu_quant_cuda.launches
    out = qm.fc1_gelu_quant(xq, rs, p, os_)
    torch.cuda.synchronize()
    assert qm.dense_prequant_gelu_quant_cuda.launches == n0 + 1 and out.shape == (M, N)
    _codes_close(out, qm.dense_prequant_gelu_quant_plain(xq, rs, p, os_))


@pytest.mark.parametrize("M,K,bias,ls", [(7, 256, True, True), (70, 384, False, True), (33, 3584, False, False)])
def test_attn_proj_glue_quant_kernel(gen, M, K, bias, ls):
    a, x = (0.5 * _randn(gen, M, K).float()).bfloat16(), _randn(gen, M, K)
    a[1] = 0  # the row scale floor on the attention output
    p = _qlinear(gen, K, K, bias)
    scale = (0.05 + 0.1 * _randn(gen, K).float()).bfloat16() if ls else None
    gamma = (1 + 0.1 * _randn(gen, K).float()).bfloat16()
    n0 = qm.attn_proj_glue_quant.launches
    xn, q, rs = qm.attn_proj_glue_quant(a, x, p, scale, gamma)
    torch.cuda.synchronize()
    assert qm.attn_proj_glue_quant.launches == n0 + 1
    xp, qp, rp = qm.attn_proj_glue_quant_plain(a, x, p, scale, gamma)
    _within_ulp(xn, xp)
    _codes_close(q, qp)
    torch.testing.assert_close(rs, rp, rtol=1e-5, atol=0)
