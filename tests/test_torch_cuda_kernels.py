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
scales rtol 1e-5, x' bitwise for K8 and K11; K7 and K8 (with and without
LayerScale) at D on both edges of each count of vectors a thread (64 to
16384) and at 1 row, fewer rows than their persistent grid and many times
it, a row's bits the same alone and inside a batch of 3200, two launches
bitwise equal; K11 also at the path's shapes
(the ViT proj 3200 with bias and LayerScale, the Qwen2 o_proj 3584 with
neither, M from 1 to 3096 across its 128-row tiles), codes and row scales
within chip_smoke.py's phase-11 limits (±1, 99% equal, rtol 1e-2).  The
training attention kernels (K16a forward + lse, K16b dQ, K16c dK/dV) at
ragged lengths, GQA groups 1, 2 and 7, causal and not, packed with a -1
tail, at the edges of the 128-row tiles (S = 127, 128, 129, 257), a
ViT-like 1 x 1025 at 25 heads and a packed case whose document boundaries
fall inside 128-row tiles: outputs and gradients within the bf16 tolerance
above, lse atol 1e-3
(fp32 sums in another order), padding rows lse = -inf and output 0 (and
dQ 0 where lse = -inf), dQ and dK/dV bitwise the same on a second run (no
atomics), and a k whose base TMA cannot take refused; the same at head
widths 8, 16, 64, 72 and 120 (the trunk's 14 / 2 heads causal, the 300M
ViT's 16 / 16 over 1025 rows, packed rows causal and not, rows whose lse is
-inf), and widths 12 / 136 and fp32 refused by name.  The fp8 (e4m3) KV
cache: K2, K3, K12, K13 and K14 over e4m3 caches at the bf16 tolerance, but
K2, whose p is rounded to e4m3 against the running row max (the plain version
rounds it against the row's global max, as the TPU kernel and its XLA
reference differ): atol = rtol = 5e-2; K13 over bf16 and e4m3 pools on K12's
cases; the e4m3 stores of K4 and K15 bitwise against ``ops.fp8.to_e4m3`` on
every bf16 bit pattern (NaN past 464), and K15's at the serving run's
largest commit with values past 464, +-inf, NaN and subnormals, bitwise the
plain commit.  Page sizes 16, 32 and 64: K12, K13
and K14 over bf16 and e4m3 pools at the bf16 tolerance, and K12 / K13 at
page size 32 bitwise equal to page size 128 on the same logical cache.  K10
(gate / up + silu * up + quantize) at M not a tile multiple and M <= 16:
codes as K9's.  K9 and K10 (the int8 TMA + wgmma mainloop) also at M = 1 and
127-129 about a 128-row tile, N = 384, K = 3200 and 3584 and the path's
shapes, a second launch bitwise the same, and a misaligned xq copied by the
wrapper to codes bitwise the aligned ones; K5 (packed attention without
qk-norm) on the qkv chunk views, prescaled and not; K3 and K6 (the split-KV decode kernels) over bf16 and
e4m3 caches at ragged lengths, lengths 0 and 1, at a chunk's edges (chunk -
1, chunk, chunk + 1) and T, 16 ragged requests, K3 at layer 27 of a 28-layer
stack, with keys planted at every chunk edge, two launches bitwise equal;
K6 against K3 with the self column on the same step (the bf16 tolerance).
K13 (split-KV over the page tables' capacity) on both pools at lengths 0, 1
and a chunk's edges, with one request filling every chunk and the others
only the first, bitwise the same on a second launch and under a CUDA-graph
replay over new lengths.  K12 (split-KV on K13's chunks and arithmetic)
bitwise equal to K13 on both pools in those cases and at page sizes 16-128,
bitwise the same on a second launch and under a CUDA-graph replay.  Head
widths: K3 and K6 (3328-row cache, lengths at the chunk edges), K12 bitwise
K13 (a request filling every chunk), K14 (ragged chunks at page size 16) and
K2's e4m3 entry at Qwen2-0.5B's 14 / 2 heads and every width the rule takes
(multiples of 8 from 8 to 128 on bf16, of 16 on e4m3), K12 / K13 at D = 64
and page sizes 16 and 64, and other widths refused before any launch.  The
single-request surface's regimes: K2 at S = 1, 9 and 64 query rows past
q_offset 127, 3187, 3199 and 3200 (a speculative verify step, a chunk; the
causal edge inside a kv tile and on its boundary), K3 at B = 4 (beams) and
over a 33024-row cache (a 32-frame video), K7, K11 and K10 at M = 9 (one
128-row tile, mostly padding), each with a planted fault that must fall
outside the tolerance; the sampled decode step replayed from a CUDA graph,
bitwise its eager run from one seed.  The paged engine's routes: the graphed
speculative verify bitwise its eager body (tokens and both pools, bf16 and
e4m3), the verify on the kernels against its plain route at 2+2 layers, and
pipelined graphed rolls giving the unpipelined run's tokens.
"""

import pytest
import torch

from omchat_torch.ops import decode_attention as da
from omchat_torch.ops import flash_attention as fa
from omchat_torch.ops import norms
from omchat_torch.ops import paged_attention as pa
from omchat_torch.ops import quant_matmul as qm
from omchat_torch.ops.fp8 import E4M3, to_e4m3

pytestmark = pytest.mark.cuda
TOL = dict(atol=2e-2, rtol=2e-2)
K2_E4M3_TOL = dict(atol=5e-2, rtol=5e-2)


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


# The split-KV decode kernels (K3, K6): phase 23's 16 ragged lengths, and
# lengths at a chunk's edges ("edges": 0, 1, chunk - 1, chunk, chunk + 1, T,
# with the chunk that decode_splits gives this card at B = 6).
B16_LENS = [1, 2, 17, 128, 512, 640, 1000, 1024, 1536, 2047, 2048, 2500, 3000, 3188, 3189, 3328]


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


def _decode_case(gen, H, KVH, lens, T, L, cache, D=128):
    """q [B, 1, H, D] carrying its kv head's direction u, a cache [L, B, KVH,
    T, D] whose rows at every chunk edge (the last row of a split and the
    first of the next) hold 0.8 u, so that they take most of each row's
    softmax, and the lengths."""
    B = len(lens)
    rows = da.decode_splits(B, KVH, T, _sms())[1]
    u = (torch.randint(0, 2, (KVH, D), generator=gen, device="cuda") * 2 - 1).to(torch.bfloat16)
    q = _randn(gen, B, 1, H, D) + u.repeat_interleave(H // KVH, dim=0)
    kc, vc = _randn(gen, L, B, KVH, T, D), _randn(gen, L, B, KVH, T, D)
    for e in range(rows, T, rows):
        kc[:, :, :, e - 1] = kc[:, :, :, e] = 0.8 * u
    if cache == "e4m3":
        kc, vc = to_e4m3(kc), to_e4m3(vc)
    return q, kc, vc, torch.tensor(lens, dtype=torch.int32, device="cuda")


def _edge_lens(KVH, T):
    rows = da.decode_splits(6, KVH, T, _sms())[1]
    return [0, 1, rows - 1, rows, rows + 1, T]


@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
@pytest.mark.parametrize("H,KVH,lens,layer", [(28, 4, [0], 0), (28, 4, [3110], 27), (4, 2, [1, 200], 1),
                                              (14, 2, [255, 17], 2), (28, 4, "edges", 1), (28, 4, B16_LENS, 27)],
                         ids=["empty", "main_shape", "group2", "group7_ragged", "chunk_edges", "B16_ragged"])
def test_flash_decode_stacked_kernel(gen, H, KVH, lens, layer, cache):
    """K3 against its plain version, and two launches bitwise equal (the
    splits merge in a fixed order)."""
    D = 128
    T = 3328 if lens == "edges" or max(lens) > 256 else 256
    lens = _edge_lens(KVH, T) if lens == "edges" else lens
    q, kc, vc, cl = _decode_case(gen, H, KVH, lens, T, max(3, layer + 1), cache)
    kn, vn = _randn(gen, len(lens), KVH, D), _randn(gen, len(lens), KVH, D)
    out = da.flash_decode_stacked(q, kc, vc, cl, layer, kn, vn)
    again = da.flash_decode_stacked(q, kc, vc, cl, layer, kn, vn)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
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


def _norm_quant_grid():
    """Blocks of K7's persistent grid on this card up to D = 4096 (three an
    SM, ``K7_BLOCKS_PER_SM`` in csrc/norm_quant.cu; one past it)."""
    return torch.cuda.get_device_properties(0).multi_processor_count * 3


# K7 / K8: D at both edges of each V = ceil(D / 2048) vectors a K7 thread
# (1-8), rows of 1, fewer than K7's persistent grid ("under": grid - 1) and
# many times it ("many": 8 x grid + 3, rows left over for some blocks)
NORM_QUANT_CASES = [(1, 64), (5, 3584), (130, 3200), ("under", 2048), ("many", 2056), ("many", 3200), (1, 3584),
                    ("under", 3584), ("many", 3584), ("under", 4096), ("many", 6144), ("many", 8192), (1, 10240),
                    ("under", 12288), ("many", 14336), ("many", 16384), (1, 16384)]


@pytest.mark.parametrize("rows,D", NORM_QUANT_CASES)
def test_rmsnorm_quant_kernels(gen, rows, D):
    rows = {"under": _norm_quant_grid() - 1, "many": 8 * _norm_quant_grid() + 3}.get(rows, rows)
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


@pytest.mark.parametrize("D", [3200, 3584])
def test_rmsnorm_quant_rows_do_not_depend_on_their_block(gen, D):
    """A row's codes, scale and x' are the same bits whether it is quantized
    alone or inside a batch of 3200 rows (another block, another pass of the
    row loop), and two launches on one batch are bitwise equal."""
    x, delta = _randn(gen, 3200, D), _randn(gen, 3200, D)
    gamma, ls = (1 + 0.1 * _randn(gen, D).float()).bfloat16(), (0.1 * _randn(gen, D).float()).bfloat16()
    x[7] = 0
    delta[7] = 0
    picks = [0, 1, 7, _norm_quant_grid() - 1, _norm_quant_grid(), 1234, 3199]
    batch = {"K7": norms.rmsnorm_quant(x, gamma), "K8": norms.add_rmsnorm_quant(x, delta, ls, gamma),
             "K8 without LayerScale": norms.add_rmsnorm_quant(x, delta, None, gamma)}
    again = {"K7": norms.rmsnorm_quant(x, gamma), "K8": norms.add_rmsnorm_quant(x, delta, ls, gamma),
             "K8 without LayerScale": norms.add_rmsnorm_quant(x, delta, None, gamma)}
    for i in picks:
        alone = {"K7": norms.rmsnorm_quant(x[i:i + 1], gamma),
                 "K8": norms.add_rmsnorm_quant(x[i:i + 1], delta[i:i + 1], ls, gamma),
                 "K8 without LayerScale": norms.add_rmsnorm_quant(x[i:i + 1], delta[i:i + 1], None, gamma)}
        torch.cuda.synchronize()
        for name, outs in alone.items():
            for got, want in zip(outs, batch[name]):
                assert torch.equal(got[0].view(torch.uint8), want[i].view(torch.uint8)), (name, i)
    for name, outs in again.items():
        for got, want in zip(outs, batch[name]):
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), name


def _qlinear(gen, n, k, bias):
    p = {"kernel_q": torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8),
         "scale": (torch.rand(n, generator=gen, device="cuda") * 4e-4 + 1e-4).bfloat16()}
    if bias:
        p["bias"] = (0.05 * _randn(gen, n).float()).bfloat16()
    return p


# K9 and K10 on the int8 mainloop: M = 1 and 127 / 128 / 129 about a 128-row
# tile (TMA zero-fills the rows past M, which are not stored), N = 384 (three
# 128-column tiles, six of K10's 64-column ones), K = 3200 and 3584 (25 and
# 28 K stages, not a multiple of the ring depth), and the path's shapes.
S8_EDGES = [(1, 3200, 384), (127, 3584, 384), (128, 3200, 384), (129, 3584, 384)]


@pytest.mark.parametrize("M,K,N,bias", [(13, 256, 384, True), (300, 256, 384, False), (129, 3200, 1280, True)]
                         + [(M, K, N, M % 2 == 1) for M, K, N in S8_EDGES] + [(3096, 3200, 12800, True)])
def test_fc1_gelu_quant_kernel(gen, M, K, N, bias):
    xq = torch.randint(-127, 128, (M, K), generator=gen, device="cuda", dtype=torch.int8)
    xq[min(1, M - 1)] = 0  # a row of zeros: h is the bias alone
    rs = torch.rand((M, 1), generator=gen, device="cuda") * 0.01 + 1e-3
    p = _qlinear(gen, N, K, bias)
    os_ = torch.tensor(0.02, device="cuda")
    n0 = qm.dense_prequant_gelu_quant_cuda.launches
    out = qm.fc1_gelu_quant(xq, rs, p, os_)
    again = qm.fc1_gelu_quant(xq, rs, p, os_)
    torch.cuda.synchronize()
    assert qm.dense_prequant_gelu_quant_cuda.launches == n0 + 2 and out.shape == (M, N)
    assert torch.equal(out, again)
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
    assert torch.equal(xn, xp)
    _codes_close(q, qp)
    torch.testing.assert_close(rs, rp, rtol=1e-5, atol=0)


@pytest.mark.parametrize("M", [1, 63, 64, 65, 1000, 3096])
@pytest.mark.parametrize("N,vit", [(3200, True), (3584, False)], ids=["vit_proj", "qwen2_o_proj"])
def test_attn_proj_glue_quant_kernel_at_path_shapes(gen, M, N, vit):
    """K11 at the widths the path gives it (bias and LayerScale on the ViT
    proj, neither on the o_proj) and at M on both sides of its 64-row
    warpgroup and 128-row tile edges: x' bitwise the plain version's (the
    int32 product is exact, the epilogue elementwise), codes and row scales
    within phase 11's limits, a second launch bitwise the same."""
    a, x = (0.5 * _randn(gen, M, N).float()).bfloat16(), _randn(gen, M, N)
    p = _qlinear(gen, N, N, vit)
    ls = (0.05 + 0.1 * _randn(gen, N).float()).bfloat16() if vit else None
    gamma = (1 + 0.1 * _randn(gen, N).float()).bfloat16()
    n0 = qm.attn_proj_glue_quant.launches
    xn, q, rs = qm.attn_proj_glue_quant(a, x, p, ls, gamma)
    again = qm.attn_proj_glue_quant(a, x, p, ls, gamma)
    torch.cuda.synchronize()
    assert qm.attn_proj_glue_quant.launches == n0 + 2
    assert all(torch.equal(u, v) for u, v in zip((xn, q, rs), again))
    xp, qp, rp = qm.attn_proj_glue_quant_plain(a, x, p, ls, gamma)
    assert torch.equal(xn, xp)
    _codes_close(q, qp)
    torch.testing.assert_close(rs, rp, rtol=1e-2, atol=0)


def _train_attn_case(gen, B, S, H, KVH, packed, D=128):
    q, k, v, do = _randn(gen, B, S, H, D), _randn(gen, B, S, KVH, D), _randn(gen, B, S, KVH, D), \
        _randn(gen, B, S, H, D)
    seg = None
    if packed:  # three documents and a -1 tail on every row
        seg = torch.full((B, S), -1, dtype=torch.int32, device="cuda")
        cut = [0, S // 5, S // 2, S - 7]
        for i in range(3):
            seg[:, cut[i]:cut[i + 1]] = i
    return q, k, v, do, seg


TRAIN_CASES = [(1, 200, 4, 2, True, False), (2, 77, 7, 1, False, False), (1, 130, 3, 3, False, True),
               (2, 300, 28, 4, True, True),
               # the edges of K16a's 128-row tiles and K16c's 128-row blocks / 64-row q tiles
               (1, 127, 7, 1, True, False), (1, 128, 7, 1, True, False), (1, 129, 7, 1, True, False),
               (2, 257, 14, 2, True, False), (1, 1025, 25, 25, False, False),
               # document boundaries at rows 76 and 192: inside 128-row tiles
               (1, 384, 28, 4, True, True),
               # boundaries at rows 205 and 1018: inside 64-row kv tiles (K16b's), a ragged tail past 1024
               (1, 1025, 28, 4, True, True)]
TRAIN_IDS = ["causal_group2_ragged", "noncausal_group7", "noncausal_mha_packed", "causal_group7_packed",
             "causal_group7_s127", "causal_group7_s128", "causal_group7_s129", "causal_group7_s257",
             "vit_like_1025_mha", "causal_group7_packed_boundary_in_tile", "causal_group7_packed_1025"]


@pytest.mark.parametrize("B,S,H,KVH,causal,packed", TRAIN_CASES, ids=TRAIN_IDS)
def test_flash_fwd_kernel(gen, B, S, H, KVH, causal, packed):
    from omchat_torch.ops import flash_attention_bwd as fb

    q, k, v, _, seg = _train_attn_case(gen, B, S, H, KVH, packed)
    n0 = fb.flash_fwd.launches
    out, lse = fb.flash_fwd(q, k, v, causal, seg)
    torch.cuda.synchronize()
    assert fb.flash_fwd.launches == n0 + 1
    ro, rl = fb.flash_fwd_plain(q, k, v, causal, seg)
    valid = torch.ones((B, S), dtype=torch.bool, device="cuda") if seg is None else seg >= 0
    torch.testing.assert_close(out[valid].float(), ro[valid].float(), **TOL)
    torch.testing.assert_close(lse.transpose(1, 2)[valid], rl.transpose(1, 2)[valid], atol=1e-3, rtol=1e-4)
    assert bool(torch.isneginf(lse.transpose(1, 2)[~valid]).all()) and bool((out[~valid] == 0).all())


@pytest.mark.parametrize("B,S,H,KVH,causal,packed", TRAIN_CASES, ids=TRAIN_IDS)
def test_flash_bwd_dq_kernel(gen, B, S, H, KVH, causal, packed):
    from omchat_torch.ops import flash_attention_bwd as fb

    q, k, v, do, seg = _train_attn_case(gen, B, S, H, KVH, packed)
    out, lse = fb.flash_fwd_plain(q, k, v, causal, seg)
    di = fb.flash_di(do, out)
    n0 = fb.flash_bwd_dq.launches
    dq = fb.flash_bwd_dq(q, k, v, do, lse, di, causal, seg)
    again = fb.flash_bwd_dq(q, k, v, do, lse, di, causal, seg, q_scaled=fb._prescaled(q))
    torch.cuda.synchronize()
    assert fb.flash_bwd_dq.launches == n0 + 2
    assert torch.equal(dq, again)  # a block owns its rows' dQ: bitwise the same every run
    torch.testing.assert_close(dq.float(), fb.flash_bwd_dq_plain(q, k, v, do, lse, di, causal, seg).float(), **TOL)
    if seg is not None:  # padding rows (lse = -inf) get zero gradient
        assert bool((dq[seg < 0] == 0).all())


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_dq_kernel_zero_rows_where_lse_is_minus_inf(gen, causal):
    """A row whose lse is -inf (no valid column) gets a zero dQ row, in a
    ragged tail and mid-tile, without segment ids."""
    from omchat_torch.ops import flash_attention_bwd as fb

    q, k, v, do, _ = _train_attn_case(gen, 2, 200, 14, 2, False)
    out, lse = fb.flash_fwd_plain(q, k, v, causal)
    di = fb.flash_di(do, out)
    rows = [0, 63, 64, 130, 199]
    lse[:, :, rows] = float("-inf")
    dq = fb.flash_bwd_dq(q, k, v, do, lse, di, causal)
    torch.cuda.synchronize()
    assert bool((dq[:, rows] == 0).all())
    torch.testing.assert_close(dq.float(), fb.flash_bwd_dq_plain(q, k, v, do, lse, di, causal).float(), **TOL)


def test_flash_bwd_dq_kernel_refuses_a_misaligned_base(gen):
    """TMA needs a 16-byte aligned base: a k one element into its storage is
    refused, and nothing launches."""
    from omchat_torch.ops import flash_attention_bwd as fb

    q, k, v, do, _ = _train_attn_case(gen, 1, 128, 4, 2, False)
    k_off = torch.empty(k.numel() + 1, dtype=k.dtype, device="cuda")[1:].view(k.shape)
    k_off.copy_(k)
    out, lse = fb.flash_fwd_plain(q, k, v, True)
    di = fb.flash_di(do, out)
    n0 = fb.flash_bwd_dq.launches
    with pytest.raises(RuntimeError, match="omchat_flash_attention_bwd_dq"):
        fb.flash_bwd_dq(q, k_off, v, do, lse, di, True)
    assert fb.flash_bwd_dq.launches == n0


@pytest.mark.parametrize("B,S,H,KVH,causal,packed", TRAIN_CASES, ids=TRAIN_IDS)
def test_flash_bwd_dkv_kernel_is_deterministic(gen, B, S, H, KVH, causal, packed):
    from omchat_torch.ops import flash_attention_bwd as fb

    q, k, v, do, seg = _train_attn_case(gen, B, S, H, KVH, packed)
    out, lse = fb.flash_fwd_plain(q, k, v, causal, seg)
    di = fb.flash_di(do, out)
    n0 = fb.flash_bwd_dkv.launches
    dk, dv = fb.flash_bwd_dkv(q, k, v, do, lse, di, causal, seg)
    dk2, dv2 = fb.flash_bwd_dkv(q, k, v, do, lse, di, causal, seg)
    torch.cuda.synchronize()
    assert fb.flash_bwd_dkv.launches == n0 + 2
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)  # no atomics: bitwise the same every run
    rk, rv = fb.flash_bwd_dkv_plain(q, k, v, do, lse, di, causal, seg)
    torch.testing.assert_close(dk.float(), rk.float(), **TOL)
    torch.testing.assert_close(dv.float(), rv.float(), **TOL)


# K16 at head widths other than 128 (every multiple of 8 from 8 to 128 is taken):
# the ragged causal trunk at Qwen2-0.5B's 14 / 2 heads, InternViT-300M's
# non-causal 16 / 16 over 1025 rows, and packed rows causal and not
K16_WIDTHS = (8, 16, 64, 72, 120)
K16_WIDTH_SHAPES = {"causal_group7_ragged": (2, 200, 14, 2, True, False), "vit300m_1025": (1, 1025, 16, 16, False, False),
                    "causal_group7_packed": (1, 384, 14, 2, True, True),
                    "noncausal_group7_packed": (1, 300, 14, 2, False, True)}
K16_WIDTH_CASES = [(D, c) for D in K16_WIDTHS for c in K16_WIDTH_SHAPES]


@pytest.mark.parametrize("D,case", K16_WIDTH_CASES, ids=[f"{c}_D{D}" for D, c in K16_WIDTH_CASES])
def test_training_attention_kernels_at_head_width(gen, D, case):
    """K16a, K16b and K16c at width D: one launch each, within TOL of their
    plain versions (lse atol 1e-3), padding rows lse = -inf, output 0 and
    zero dQ, dQ and dK / dV bitwise the same on a second launch."""
    from omchat_torch.ops import flash_attention_bwd as fb

    B, S, H, KVH, causal, packed = K16_WIDTH_SHAPES[case]
    q, k, v, do, seg = _train_attn_case(gen, B, S, H, KVH, packed, D=D)
    n0 = (fb.flash_fwd.launches, fb.flash_bwd_dq.launches, fb.flash_bwd_dkv.launches)
    out, lse = fb.flash_fwd(q, k, v, causal, seg)
    ro, rl = fb.flash_fwd_plain(q, k, v, causal, seg)
    di = fb.flash_di(do, ro)
    dq = fb.flash_bwd_dq(q, k, v, do, rl, di, causal, seg)
    dk, dv = fb.flash_bwd_dkv(q, k, v, do, rl, di, causal, seg)
    dq2 = fb.flash_bwd_dq(q, k, v, do, rl, di, causal, seg)
    dk2, dv2 = fb.flash_bwd_dkv(q, k, v, do, rl, di, causal, seg)
    torch.cuda.synchronize()
    assert (fb.flash_fwd.launches, fb.flash_bwd_dq.launches, fb.flash_bwd_dkv.launches) == (
        n0[0] + 1, n0[1] + 2, n0[2] + 2)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    valid = torch.ones((B, S), dtype=torch.bool, device="cuda") if seg is None else seg >= 0
    torch.testing.assert_close(out[valid].float(), ro[valid].float(), **TOL)
    torch.testing.assert_close(lse.transpose(1, 2)[valid], rl.transpose(1, 2)[valid], atol=1e-3, rtol=1e-4)
    assert bool(torch.isneginf(lse.transpose(1, 2)[~valid]).all()) and bool((out[~valid] == 0).all())
    torch.testing.assert_close(dq.float(), fb.flash_bwd_dq_plain(q, k, v, do, rl, di, causal, seg).float(), **TOL)
    rk, rv = fb.flash_bwd_dkv_plain(q, k, v, do, rl, di, causal, seg)
    torch.testing.assert_close(dk.float(), rk.float(), **TOL)
    torch.testing.assert_close(dv.float(), rv.float(), **TOL)
    assert bool((dq[~valid] == 0).all())


@pytest.mark.parametrize("D", K16_WIDTHS)
@pytest.mark.parametrize("causal", [True, False])
def test_training_backward_kernels_at_head_width_where_lse_is_minus_inf(gen, D, causal):
    """Rows whose lse is -inf (in a ragged tail and mid-tile) get zero dQ and
    add nothing to dK / dV, at width D without segment ids."""
    from omchat_torch.ops import flash_attention_bwd as fb

    q, k, v, do, _ = _train_attn_case(gen, 2, 200, 14, 2, False, D=D)
    out, lse = fb.flash_fwd_plain(q, k, v, causal)
    di = fb.flash_di(do, out)
    rows = [0, 63, 64, 130, 199]
    lse[:, :, rows] = float("-inf")
    dq = fb.flash_bwd_dq(q, k, v, do, lse, di, causal)
    dk, dv = fb.flash_bwd_dkv(q, k, v, do, lse, di, causal)
    torch.cuda.synchronize()
    assert bool((dq[:, rows] == 0).all())
    torch.testing.assert_close(dq.float(), fb.flash_bwd_dq_plain(q, k, v, do, lse, di, causal).float(), **TOL)
    rk, rv = fb.flash_bwd_dkv_plain(q, k, v, do, lse, di, causal)
    torch.testing.assert_close(dk.float(), rk.float(), **TOL)
    torch.testing.assert_close(dv.float(), rv.float(), **TOL)


def test_training_attention_kernels_refuse_other_widths_and_fp32(gen):
    """Widths the rule refuses (12, 136) and an fp32 q raise before any
    launch, naming the width or the dtype: no fallback to the plain version."""
    from omchat_torch.ops import flash_attention_bwd as fb

    counts = (fb.flash_fwd, fb.flash_bwd_dq, fb.flash_bwd_dkv)
    n0 = [f.launches for f in counts]
    for D in (12, 136):
        q, k, v, do, _ = _train_attn_case(gen, 1, 64, 14, 2, False, D=D)
        lse = torch.zeros(1, 14, 64, device="cuda")
        for call in (lambda: fb.flash_fwd(q, k, v, True), lambda: fb.flash_bwd_dq(q, k, v, do, lse, lse, True),
                     lambda: fb.flash_bwd_dkv(q, k, v, do, lse, lse, True)):
            with pytest.raises(ValueError, match=f"head width {D} "):
                call()
    q, k, v, _, _ = _train_attn_case(gen, 1, 64, 14, 2, False, D=64)
    with pytest.raises(TypeError, match="takes bfloat16, got torch.float32"):
        fb.flash_fwd(q.float(), k, v, True)
    assert [f.launches for f in counts] == n0


# ---------------------------------------------------------------------------
# the fp8 (e4m3) KV cache and K13
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pool", ["bf16", "e4m3"])
@pytest.mark.parametrize(
    "lengths,self_col",
    [([0, 5], True), ([128, 256, 129], True),
     ([3, 700, 1, 2300, 128, 64, 999, 1500, 17, 400, 2048, 255, 600, 90, 1200, 33], True), ([0, 300], False)],
    ids=["length0", "page_boundary", "b16_ragged", "no_self_column"],
)
@pytest.mark.parametrize("kernel", ["auto", "manual"], ids=["k12", "k13"])
def test_paged_decode_kernels_on_bf16_and_e4m3_pools(gen, kernel, lengths, self_col, pool):
    H, KVH, D = 28, 4, 128
    B = len(lengths)
    W = max(4, -(-max(lengths) // 128))
    P = sum(-(-n // 128) for n in lengths) + 2
    kp, vp, tables = _paged_pool(gen, P, KVH, D, lengths, W)
    kp = torch.cat([_randn(gen, 3, *kp.shape[1:]), kp])  # another layer's 3 pages first
    vp = torch.cat([_randn(gen, 3, *vp.shape[1:]), vp])
    if pool == "e4m3":
        kp, vp = to_e4m3(kp), to_e4m3(vp)
    q = _randn(gen, B, 1, H, D)
    kn, vn = (_randn(gen, B, KVH, D), _randn(gen, B, KVH, D)) if self_col else (None, None)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    fn = pa.DECODE_KERNELS[kernel]
    n0 = fn.launches
    out = fn(q, kp, vp, lens, tables, kn, vn, page_offset=3)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    ref = pa.paged_flash_decode_plain(q, kp, vp, lens, tables, kn, vn, page_offset=3)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


def _k13_case(gen, lengths, W, pool):
    """K13's operands over a flat two-layer pool (the layer at page_offset P + 1)."""
    H, KVH, D = 28, 4, 128
    P = sum(-(-n // 128) for n in lengths) + 2
    kp, vp, tables = _paged_pool(gen, P, KVH, D, lengths, W)
    kp = torch.cat([_randn(gen, P + 1, *kp.shape[1:]), kp])
    vp = torch.cat([_randn(gen, P + 1, *vp.shape[1:]), vp])
    if pool == "e4m3":
        kp, vp = to_e4m3(kp), to_e4m3(vp)
    B = len(lengths)
    q, kn, vn = _randn(gen, B, 1, H, D), _randn(gen, B, KVH, D), _randn(gen, B, KVH, D)
    return q, kp, vp, torch.tensor(lengths, dtype=torch.int32, device="cuda"), tables, kn, vn, P + 1


@pytest.mark.parametrize("pool", ["bf16", "e4m3"])
@pytest.mark.parametrize("case", ["chunk_edges", "one_request_fills_every_chunk"])
def test_paged_decode_manual_split_kv(gen, case, pool):
    """K13 cuts each request's capacity into chunks (paged_splits): lengths
    0, 1 and at a chunk's edges (chunk - 1, chunk, chunk + 1), and a batch in
    which one request fills every chunk and the others only the first, against
    the plain version; a second launch is bitwise the same (fixed merge order)."""
    W, KVH = 26, 4
    chunk = pa.paged_splits(6, KVH, W * 128, _sms())[1]
    lengths = ([0, 1, chunk - 1, chunk, chunk + 1, W * 128] if case == "chunk_edges"
               else [W * 128, 5, chunk - 1, chunk, 100, 1])
    q, kp, vp, lens, tables, kn, vn, off = _k13_case(gen, lengths, W, pool)
    assert pa.paged_splits(len(lengths), KVH, W * 128, _sms())[0] > 1, "the capacity must span several chunks"
    n0 = pa.paged_flash_decode_manual.launches
    out = pa.paged_flash_decode_manual(q, kp, vp, lens, tables, kn, vn, page_offset=off)
    again = pa.paged_flash_decode_manual(q, kp, vp, lens, tables, kn, vn, page_offset=off)
    torch.cuda.synchronize()
    assert pa.paged_flash_decode_manual.launches == n0 + 2
    assert torch.equal(out, again)
    ref = pa.paged_flash_decode_plain(q, kp, vp, lens, tables, kn, vn, page_offset=off)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    if 0 in lengths:  # no page read: exactly v_new
        b = lengths.index(0)
        assert torch.equal(out[b, 0], vn[b].repeat_interleave(q.shape[2] // KVH, dim=0))


@pytest.mark.parametrize("pool", ["bf16", "e4m3"])
def test_paged_decode_manual_replays_under_a_cuda_graph(gen, pool):
    """K13's two launches and its scratch capture into a CUDA graph; a replay
    over new lengths (read on the card, not the host) equals the eager call."""
    W, KVH = 20, 4
    lengths = [2500, 64, 300, 1000, 0, 129, 2047, 512]
    q, kp, vp, lens, tables, kn, vn, off = _k13_case(gen, lengths, W, pool)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pa.paged_flash_decode_manual(q, kp, vp, lens, tables, kn, vn, page_offset=off)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = pa.paged_flash_decode_manual(q, kp, vp, lens, tables, kn, vn, page_offset=off)
    lens.copy_(torch.tensor([2500, 1, 255, 256, 257, 128, 2000, 0], dtype=torch.int32))
    graph.replay()
    want = pa.paged_flash_decode_manual(q, kp, vp, lens, tables, kn, vn, page_offset=off)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    ref = pa.paged_flash_decode_plain(q, kp, vp, lens, tables, kn, vn, page_offset=off)
    torch.testing.assert_close(got.float(), ref.float(), **TOL)


@pytest.mark.parametrize("pool", ["bf16", "e4m3"])
@pytest.mark.parametrize("case", ["chunk_edges", "one_request_fills_every_chunk"])
def test_paged_decode_k12_is_bitwise_k13(gen, case, pool):
    """K12 and K13 share their chunks and arithmetic and differ only in their
    copies, so on the same inputs they give the same bits: at lengths 0, 1 and
    a chunk's edges, and with one request filling every chunk; a second K12
    launch is bitwise the same, and a request of length 0 returns v_new."""
    W, KVH = 26, 4
    chunk = pa.paged_splits(6, KVH, W * 128, _sms())[1]
    lengths = ([0, 1, chunk - 1, chunk, chunk + 1, W * 128] if case == "chunk_edges"
               else [W * 128, 5, chunk - 1, chunk, 100, 1])
    q, kp, vp, lens, tables, kn, vn, off = _k13_case(gen, lengths, W, pool)
    n0 = pa.paged_flash_decode.launches
    k12 = pa.paged_flash_decode(q, kp, vp, lens, tables, kn, vn, page_offset=off)
    again = pa.paged_flash_decode(q, kp, vp, lens, tables, kn, vn, page_offset=off)
    k13 = pa.paged_flash_decode_manual(q, kp, vp, lens, tables, kn, vn, page_offset=off)
    torch.cuda.synchronize()
    assert pa.paged_flash_decode.launches == n0 + 2
    assert torch.equal(k12, k13) and torch.equal(k12, again)
    torch.testing.assert_close(k12.float(), pa.paged_flash_decode_plain(
        q, kp, vp, lens, tables, kn, vn, page_offset=off).float(), **TOL)
    if 0 in lengths:
        b = lengths.index(0)
        assert torch.equal(k12[b, 0], vn[b].repeat_interleave(q.shape[2] // KVH, dim=0))


@pytest.mark.parametrize("pool", ["bf16", "e4m3"])
def test_paged_decode_k12_replays_under_a_cuda_graph(gen, pool):
    """K12's two launches and its scratch capture into a CUDA graph; a replay
    over new lengths equals the eager call and K13's."""
    W, KVH = 20, 4
    lengths = [2500, 64, 300, 1000, 0, 129, 2047, 512]
    q, kp, vp, lens, tables, kn, vn, off = _k13_case(gen, lengths, W, pool)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pa.paged_flash_decode(q, kp, vp, lens, tables, kn, vn, page_offset=off)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = pa.paged_flash_decode(q, kp, vp, lens, tables, kn, vn, page_offset=off)
    lens.copy_(torch.tensor([2500, 1, 255, 256, 257, 128, 2000, 0], dtype=torch.int32))
    graph.replay()
    want = pa.paged_flash_decode(q, kp, vp, lens, tables, kn, vn, page_offset=off)
    k13 = pa.paged_flash_decode_manual(q, kp, vp, lens, tables, kn, vn, page_offset=off)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, k13)


def test_flash_attention_and_decode_kernels_e4m3(gen):
    """K2 (prefill over the cache) and K3 (decode over the stacked cache) on
    an e4m3 cache."""
    H, KVH, S, T, D = 28, 4, 200, 328, 128
    q = _randn(gen, 2, S, H, D)
    k, v = to_e4m3(_randn(gen, 2, KVH, T, D)), to_e4m3(_randn(gen, 2, KVH, T, D))
    qo = torch.tensor([0, 100], dtype=torch.int32, device="cuda")
    kl = torch.tensor([190, 290], dtype=torch.int32, device="cuda")
    out = fa.flash_attention(q, k, v, causal=True, q_offset=qo, kv_len=kl, kv_format="bntd")
    ref = fa.flash_attention_plain(q, k, v, causal=True, q_offset=qo, kv_len=kl)
    for b, rows in enumerate((190, 190)):
        torch.testing.assert_close(out[b, :rows].float(), ref[b, :rows].float(), **K2_E4M3_TOL)
    kc, vc = to_e4m3(_randn(gen, 3, 2, KVH, T, D)), to_e4m3(_randn(gen, 3, 2, KVH, T, D))
    qd, kn, vn = _randn(gen, 2, 1, H, D), _randn(gen, 2, KVH, D), _randn(gen, 2, KVH, D)
    cl = torch.tensor([0, 311], dtype=torch.int32, device="cuda")
    out = da.flash_decode_stacked(qd, kc, vc, cl, 2, kn, vn)
    torch.testing.assert_close(out.float(), da.flash_decode_stacked_plain(qd, kc, vc, cl, 2, kn, vn).float(), **TOL)


def test_paged_flash_prefill_kernel_e4m3(gen):
    H, KVH, D, C = 28, 4, 128, 256
    q_offset, chunk_len = [0, 1024], [256, 200]
    kv_len = [o + n for o, n in zip(q_offset, chunk_len)]
    kp, vp, tables = _paged_pool(gen, sum(-(-n // 128) for n in kv_len) + 1, KVH, D, kv_len, 12)
    kp, vp = to_e4m3(kp), to_e4m3(vp)
    q = _randn(gen, 2, C, H, D)
    qo = torch.tensor(q_offset, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    out = pa.paged_flash_prefill(q, kp, vp, kl, tables, qo)
    ref = pa.paged_flash_prefill_plain(q, kp, vp, kl, tables, qo)
    for b in range(2):
        torch.testing.assert_close(out[b, :chunk_len[b]].float(), ref[b, :chunk_len[b]].float(), **TOL)


def test_e4m3_stores_round_every_bf16_pattern_as_to_e4m3(gen):
    """K4 (rows) and K15 (a page) store all 65536 bf16 bit patterns into e4m3
    pools exactly as ``to_e4m3`` does: NaN past 464, never saturated."""
    KVH, PS, D = 4, 128, 128
    patterns = torch.arange(-32768, 32768, dtype=torch.int32, device="cuda").to(torch.int16).view(torch.bfloat16)
    want = to_e4m3(patterns).view(torch.uint8)
    kp, vp = (torch.zeros(3, KVH, PS, D, dtype=E4M3, device="cuda") for _ in range(2))
    rows = patterns.view(PS, KVH, D)
    pa.commit_rows(kp, vp, torch.full((PS,), 1, dtype=torch.int32, device="cuda"),
                   torch.arange(PS, dtype=torch.int32, device="cuda"), rows, rows.flip(0))
    torch.cuda.synchronize()
    assert torch.equal(kp[1].transpose(0, 1).reshape(-1).view(torch.uint8), want)
    assert torch.equal(vp[1].transpose(0, 1).flip(0).reshape(-1).view(torch.uint8), want)
    assert not kp[0].view(torch.uint8).any() and not kp[2].view(torch.uint8).any()  # nothing else written
    kp.zero_()
    page = patterns.view(1, KVH, PS, D)
    pa.commit_pages(kp, vp, torch.tensor([2], dtype=torch.int32, device="cuda"), page, page)
    torch.cuda.synchronize()
    assert torch.equal(kp[2].reshape(-1).view(torch.uint8), want)
    assert not kp[:2].view(torch.uint8).any()


def test_commit_pages_e4m3_at_the_serving_shape(gen):
    """K15 into an e4m3 pool at the serving run's largest commit (a strided
    28 x 8 x 4 x 512 x 128 scratch cache, 896 pages at distinct random pool
    pages), values spread past 464 with +-inf, NaN, -0 and subnormals
    planted: bitwise the plain commit, and a second launch the same."""
    L, B, KVH, T, D, PS, NP = 28, 8, 4, 512, 128, 128, 193
    CH = T // PS
    scratch = [(100 * _randn(gen, L, B, KVH, T, D).float()).bfloat16() for _ in range(2)]
    flat = scratch[0].view(-1)
    flat[:6] = torch.tensor([float("inf"), -float("inf"), float("nan"), -0.0, 1e-40, -3e-3], dtype=torch.bfloat16)
    views = [t.view(L * B, KVH, CH, PS, D).transpose(1, 2) for t in scratch]
    pages = torch.randperm(L * NP, generator=gen, device="cuda")[:L * B * CH].int()
    pools = [torch.zeros(L * NP, KVH, PS, D, dtype=E4M3, device="cuda") for _ in range(2)]
    refs = [p.clone() for p in pools]
    pa.commit_pages(*pools, pages, *views)
    torch.cuda.synchronize()
    first = [p.clone() for p in pools]
    pa.commit_pages(*pools, pages, *views)
    pa.commit_pages_plain(*refs, pages, *views)
    torch.cuda.synchronize()
    for got, again, want in zip(first, pools, refs):
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        assert torch.equal(again.view(torch.uint8), got.view(torch.uint8))


# ---------------------------------------------------------------------------
# page sizes 16, 32, 64; K10, K5, K6
# ---------------------------------------------------------------------------


def _paged_pool_ps(gen, PS, KVH, D, lengths, W, e4m3):
    """As _paged_pool, at page size PS (and the pool in e4m3 if asked)."""
    P = sum(-(-n // PS) for n in lengths) + 2
    kp, vp = _randn(gen, P + 1, KVH, PS, D), _randn(gen, P + 1, KVH, PS, D)
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(2)).tolist()
    tables = torch.full((len(lengths), W), P, dtype=torch.int32)
    used = 0
    for b, n in enumerate(lengths):
        live = -(-n // PS)
        tables[b, :live] = torch.tensor(perm[used: used + live], dtype=torch.int32)
        used += live
    if e4m3:
        kp, vp = to_e4m3(kp), to_e4m3(vp)
    return kp, vp, tables.cuda()


@pytest.mark.parametrize("pool", ["bf16", "e4m3"])
@pytest.mark.parametrize("kernel", ["auto", "manual"], ids=["k12", "k13"])
@pytest.mark.parametrize("PS", [16, 32, 64])
def test_paged_decode_kernels_at_page_size(gen, PS, kernel, pool):
    H, KVH, D = 28, 4, 128
    lengths = [0, 1, PS, 128, 129, 3 * PS + 5, 700, 2047]
    W = max(-(-n // PS) for n in lengths) + 1
    kp, vp, tables = _paged_pool_ps(gen, PS, KVH, D, lengths, W, pool == "e4m3")
    q, kn, vn = _randn(gen, len(lengths), 1, H, D), _randn(gen, len(lengths), KVH, D), _randn(gen, len(lengths), KVH, D)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    fn = pa.DECODE_KERNELS[kernel]
    n0 = fn.launches
    out = fn(q, kp, vp, lens, tables, kn, vn)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    torch.testing.assert_close(out.float(), pa.paged_flash_decode_plain(q, kp, vp, lens, tables, kn, vn).float(), **TOL)


@pytest.mark.parametrize("kernel", ["auto", "manual"], ids=["k12", "k13"])
def test_paged_decode_page_size_32_is_bitwise_page_size_128(gen, kernel):
    """The same logical cache in 128-row pages and in 32-row pages: a stage,
    each warp's columns and the merge order do not depend on the page size."""
    H, KVH, D = 28, 4, 128
    lengths = [5, 128, 300, 1000]
    kp, vp, t128 = _paged_pool_ps(gen, 128, KVH, D, lengths, 8, False)
    k, v = pa._gather_pages(kp, vp, t128)  # [B, KVH, 1024, D], the logical cache
    B = len(lengths)
    k32 = k.view(B, KVH, 32, 32, D).transpose(1, 2).reshape(B * 32, KVH, 32, D).contiguous()
    v32 = v.view(B, KVH, 32, 32, D).transpose(1, 2).reshape(B * 32, KVH, 32, D).contiguous()
    t32 = torch.arange(B * 32, dtype=torch.int32, device="cuda").view(B, 32)
    q, kn, vn = _randn(gen, B, 1, H, D), _randn(gen, B, KVH, D), _randn(gen, B, KVH, D)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    fn = pa.DECODE_KERNELS[kernel]
    a, b = fn(q, kp, vp, lens, t128, kn, vn), fn(q, k32, v32, lens, t32, kn, vn)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("pool", ["bf16", "e4m3"])
@pytest.mark.parametrize("PS", [16, 32, 64, 128])
def test_paged_decode_k12_is_bitwise_k13_at_page_size(gen, PS, pool):
    H, KVH, D = 28, 4, 128
    lengths = [0, 1, PS, 128, 129, 3 * PS + 5, 700, 2047]
    W = max(-(-n // PS) for n in lengths) + 1
    kp, vp, tables = _paged_pool_ps(gen, PS, KVH, D, lengths, W, pool == "e4m3")
    q, kn, vn = _randn(gen, len(lengths), 1, H, D), _randn(gen, len(lengths), KVH, D), _randn(gen, len(lengths), KVH, D)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    k12 = pa.paged_flash_decode(q, kp, vp, lens, tables, kn, vn)
    k13 = pa.paged_flash_decode_manual(q, kp, vp, lens, tables, kn, vn)
    torch.cuda.synchronize()
    assert torch.equal(k12, k13)


@pytest.mark.parametrize("pool", ["bf16", "e4m3"])
@pytest.mark.parametrize("PS", [16, 32, 64])
def test_paged_flash_prefill_kernel_at_page_size(gen, PS, pool):
    H, KVH, D, C = 28, 4, 128, 256
    q_offset, chunk_len = [0, 4 * PS, 1024], [256, 200, 77]
    kv_len = [o + n for o, n in zip(q_offset, chunk_len)]
    W = max(-(-n // PS) for n in kv_len) + 1
    kp, vp, tables = _paged_pool_ps(gen, PS, KVH, D, kv_len, W, pool == "e4m3")
    q = _randn(gen, 3, C, H, D)
    qo = torch.tensor(q_offset, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    out = pa.paged_flash_prefill(q, kp, vp, kl, tables, qo)
    torch.cuda.synchronize()
    ref = pa.paged_flash_prefill_plain(q, kp, vp, kl, tables, qo)
    for b in range(3):
        torch.testing.assert_close(out[b, :chunk_len[b]].float(), ref[b, :chunk_len[b]].float(), **TOL)


@pytest.mark.parametrize("M,K,N", [(13, 256, 384), (300, 256, 384), (129, 3584, 1280)] + S8_EDGES
                         + [(1024, 3584, 18944), (3200, 3584, 18944)])
def test_swiglu_quant_kernel(gen, M, K, N):
    xq = torch.randint(-127, 128, (M, K), generator=gen, device="cuda", dtype=torch.int8)
    zero = min(1, M - 1)
    xq[zero] = 0  # a row of zeros: codes 0
    rs = torch.rand((M, 1), generator=gen, device="cuda") * 0.01 + 1e-3
    gp, up = _qlinear(gen, N, K, False), _qlinear(gen, N, K, False)
    os_ = torch.tensor(0.05, device="cuda")
    n0 = qm.dense_prequant_swiglu_quant_cuda.launches
    out = qm.swiglu_quant(xq, rs, gp, up, os_)
    again = qm.swiglu_quant(xq, rs, gp, up, os_)
    torch.cuda.synchronize()
    assert qm.dense_prequant_swiglu_quant_cuda.launches == n0 + 2 and out.shape == (M, N)
    assert torch.equal(out, again)
    _codes_close(out, qm.dense_prequant_swiglu_quant_plain(xq, rs, gp, up, os_))
    assert not out[zero].any()


@pytest.mark.parametrize("kernel", ["fc1_gelu", "swiglu"])
def test_s8_gemm_kernels_take_a_misaligned_xq(gen, kernel):
    """An xq view whose base is 1 byte past a 16-byte boundary (TMA takes no
    such base): the wrapper copies it and launches the kernel, whose codes
    are bitwise those of the aligned xq."""
    M, K, N = 70, 256, 384
    buf = torch.randint(-127, 128, (M * K + 1,), generator=gen, device="cuda", dtype=torch.int8)
    xq = buf[1:].view(M, K)
    assert xq.data_ptr() % 16 and xq.is_contiguous()
    rs = torch.rand((M, 1), generator=gen, device="cuda") * 0.01 + 1e-3
    os_ = torch.tensor(0.05, device="cuda")
    if kernel == "fc1_gelu":
        p = _qlinear(gen, N, K, True)
        wrapper, run = qm.dense_prequant_gelu_quant_cuda, lambda x: qm.fc1_gelu_quant(x, rs, p, os_)
    else:
        gp, up = _qlinear(gen, N, K, False), _qlinear(gen, N, K, False)
        wrapper, run = qm.dense_prequant_swiglu_quant_cuda, lambda x: qm.swiglu_quant(x, rs, gp, up, os_)
    n0 = wrapper.launches
    out, aligned = run(xq), run(xq.clone())
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + 2
    assert torch.equal(out, aligned)


@pytest.mark.parametrize("B,SP,valid,H,prescaled", [(2, 72, 65, 3, False), (1, 136, 136, 2, True),
                                                    (3, 1032, 1025, 2, False)])
def test_packed_self_attention_kernel(gen, B, SP, valid, H, prescaled):
    D = 128
    qkv = _randn(gen, B, SP, 3 * H * D)
    q, k, v = qkv.chunk(3, dim=-1)
    n0 = fa.packed_self_attention.launches
    out = fa.packed_self_attention(q, k, v, num_heads=H, valid_len=valid, prescaled=prescaled)
    torch.cuda.synchronize()
    assert fa.packed_self_attention.launches == n0 + 1
    ref = fa.packed_self_attention_plain(q, k, v, num_heads=H, valid_len=valid, prescaled=prescaled)
    torch.testing.assert_close(out[:, :valid].float(), ref[:, :valid].float(), **TOL)


@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
@pytest.mark.parametrize("H,KVH,lens", [(28, 4, [3188]), (28, 4, [0, 1, 512, 1000]), (4, 2, [200, 77]),
                                        (28, 4, "edges"), (28, 4, B16_LENS)],
                         ids=["main_shape", "ragged_zero_one_tile", "group2", "chunk_edges", "B16_ragged"])
def test_flash_decode_kernel(gen, H, KVH, lens, cache):
    """K6 against its plain version, zeros at length 0, and two launches
    bitwise equal."""
    T = 3328 if lens == "edges" or max(lens) > 256 else 256
    lens = _edge_lens(KVH, T) if lens == "edges" else lens
    q, kc, vc, cl = _decode_case(gen, H, KVH, lens, T, 1, cache)
    kc, vc = kc[0], vc[0]
    n0 = da.flash_decode.launches
    out = da.flash_decode(q, kc, vc, cl)
    again = da.flash_decode(q, kc, vc, cl)
    torch.cuda.synchronize()
    assert da.flash_decode.launches == n0 + 2
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), da.flash_decode_plain(q, kc, vc, cl).float(), **TOL)
    for b, n in enumerate(lens):
        if n == 0:
            assert not out[b].any()


def test_flash_decode_kernel_equals_k3_with_the_self_column(gen):
    """K6 over a layer cache with the step's row written in (cache_len + 1)
    against K3 over the stacked cache plus the self column (cache_len)."""
    H, KVH, D, L, T = 28, 4, 128, 3, 512
    kc, vc = _randn(gen, L, 2, KVH, T, D), _randn(gen, L, 2, KVH, T, D)
    q, kn, vn = _randn(gen, 2, 1, H, D), _randn(gen, 2, KVH, D), _randn(gen, 2, KVH, D)
    cl = torch.tensor([300, 17], dtype=torch.int32, device="cuda")
    k3 = da.flash_decode_stacked(q, kc, vc, cl, 1, kn, vn)
    kw, vw = kc[1].clone(), vc[1].clone()
    for b in range(2):
        kw[b, :, int(cl[b])] = kn[b]
        vw[b, :, int(cl[b])] = vn[b]
    k6 = da.flash_decode(q, kw, vw, cl + 1)
    torch.cuda.synchronize()
    torch.testing.assert_close(k6.float(), k3.float(), **TOL)


# The TMA + wgmma kernels of K2, K1 and K5 (csrc/flash_fwd_sm90.cuh): 128-row
# q and kv tiles, so q row counts one past a tile, offsets that put the causal
# diagonal across two kv tiles, row tiles wholly past kv_len (written as
# zeros without loading anything), and the 64-column ragged last tile.
@pytest.mark.parametrize(
    "H,KVH,S,T,q_off,kv_len",
    [(28, 4, 129, 300, [37, 100], [166, 229]), (14, 2, 257, 400, [100, 37], [357, 250]),
     (4, 1, 257, 257, [0], [257])],
    ids=["rows129_offsets37_100", "rows257_offsets100_37", "rows257_group4"],
)
def test_flash_attention_kernel_across_kv_tiles(gen, H, KVH, S, T, q_off, kv_len):
    D = 128
    B = len(q_off)
    q, k, v = _randn(gen, B, S, H, D), _randn(gen, B, KVH, T, D), _randn(gen, B, KVH, T, D)
    qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    n0 = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=True, q_offset=qo, kv_len=kl, kv_format="bntd")
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    ref = fa.flash_attention_plain(q, k, v, causal=True, q_offset=qo, kv_len=kl)
    for b in range(B):
        rows = min(S, kv_len[b] - q_off[b])
        torch.testing.assert_close(out[b, :rows].float(), ref[b, :rows].float(), **TOL)


@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
def test_flash_attention_kernel_batched_prefill_skips_padding(gen, cache):
    """The paged engine's batched short prefill: B=8 x 512 rows at kv_len
    64-512 and one 0; row tiles wholly past kv_len read zeros."""
    H, KVH, S, D = 28, 4, 512, 128
    lens = [64, 100, 128, 129, 300, 0, 511, 512]
    B = len(lens)
    q = _randn(gen, B, S, H, D)
    k, v = _randn(gen, B, KVH, S, D), _randn(gen, B, KVH, S, D)
    if cache == "e4m3":
        k, v = to_e4m3(k), to_e4m3(v)
    qo = torch.zeros(B, dtype=torch.int32, device="cuda")
    kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = fa.flash_attention(q, k, v, causal=True, q_offset=qo, kv_len=kl, kv_format="bntd")
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q, k, v, causal=True, q_offset=qo, kv_len=kl)
    tol = TOL if cache == "bf16" else K2_E4M3_TOL
    for b, n in enumerate(lens):
        torch.testing.assert_close(out[b, :n].float(), ref[b, :n].float(), **tol)
        assert not out[b, (n + 127) // 128 * 128:].any()  # skipped row tiles
        if n == 0:
            assert not out[b].any()


@pytest.mark.parametrize(
    "B,S,T,q_off,kv_len",
    [(1, 3200, 3328, [0], [3187]), (3, 257, 400, [0, 37, 100], [257, 200, 357])],
    ids=["main_shape", "ragged"],
)
def test_flash_attention_kernel_e4m3_tiles(gen, B, S, T, q_off, kv_len):
    """K2 on an e4m3 cache: TMA stages the bytes, the block widens them once."""
    H, KVH, D = 28, 4, 128
    q = _randn(gen, B, S, H, D)
    k, v = to_e4m3(_randn(gen, B, KVH, T, D)), to_e4m3(_randn(gen, B, KVH, T, D))
    qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    out = fa.flash_attention(q, k, v, causal=True, q_offset=qo, kv_len=kl, kv_format="bntd")
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q, k, v, causal=True, q_offset=qo, kv_len=kl)
    for b in range(B):
        rows = min(S, kv_len[b] - q_off[b])
        torch.testing.assert_close(out[b, :rows].float(), ref[b, :rows].float(), **K2_E4M3_TOL)


@pytest.mark.parametrize("B,SP,valid,H", [(2, 8, 1, 3), (2, 72, 65, 3), (3, 1032, 1025, 25)],
                         ids=["valid1", "valid65", "valid1025"])
def test_packed_attention_kernels_at_valid_len(gen, B, SP, valid, H):
    """K1 (prepass, then the attention over qn / kn and v in place) and K5 at
    valid_len 1, 65 and the ViT's 1025 (a one-row last kv tile)."""
    D = 128
    qkv = _randn(gen, B, SP, 3 * H * D)
    qg = (1 + 0.1 * _randn(gen, H * D).float()).to(torch.bfloat16) * fa.packed_prescale(D)
    kg = (1 + 0.1 * _randn(gen, H * D).float()).to(torch.bfloat16)
    n0, p0 = fa.packed_qkv_norm_attention.launches, fa.qk_norm_prepass.launches
    out = fa.packed_qkv_norm_attention(qkv, num_heads=H, q_gamma=qg, k_gamma=kg, eps=1e-6, valid_len=valid)
    qn, kn = fa.qk_norm_prepass(qkv, qg, kg, 1e-6)
    torch.cuda.synchronize()
    assert fa.packed_qkv_norm_attention.launches == n0 + 1 and fa.qk_norm_prepass.launches == p0 + 2
    # the prepass within two bf16 ulps of its plain version (rstd summed in another order)
    for got, want in zip((qn, kn), fa.qk_norm_prepass_plain(qkv, qg, kg, 1e-6)):
        torch.testing.assert_close(got.float(), want.float(), atol=1e-6, rtol=8e-3)
    rq, rk, gq, gk = fa.qk_norm_stats(qkv, qg, kg, 1e-6)
    ref = fa.packed_qkv_norm_attention_plain(qkv, rq, rk, gq, gk, num_heads=H, valid_len=valid)
    torch.testing.assert_close(out[:, :valid].float(), ref[:, :valid].float(), **TOL)
    q, k, v = qkv.chunk(3, dim=-1)
    out5 = fa.packed_self_attention(q, k, v, num_heads=H, valid_len=valid)
    torch.cuda.synchronize()
    ref5 = fa.packed_self_attention_plain(q, k, v, num_heads=H, valid_len=valid)
    torch.testing.assert_close(out5[:, :valid].float(), ref5[:, :valid].float(), **TOL)


def test_flash_attention_kernel_k_and_v_of_different_layouts(gen):
    """The ViT's split route: q and k normalised into new [B, N, H, D]
    tensors, v a column block of the fused qkv (row stride 3 H D), each read
    in place through its own strides."""
    B, N, H, D = 2, 1025, 25, 128
    qkv = _randn(gen, B, N, 3 * H * D)
    q, k = _randn(gen, B, N, H, D), _randn(gen, B, N, H, D)
    v = qkv[..., 2 * H * D:].view(B, N, H, D)
    out = fa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q, k.transpose(1, 2), v.transpose(1, 2), causal=False, q_offset=None, kv_len=None)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


def test_attention_kernels_refuse_what_tma_cannot_take(gen):
    """A row stride that is not a multiple of 16 bytes, or a base that is not
    16-byte aligned, is refused by name before any launch."""
    H, KVH, S, T, D = 4, 2, 16, 64, 128
    q = _randn(gen, 1, S, H, D)
    wide = _randn(gen, 1, KVH, T, D + 4)
    k, v = wide[..., :D], wide[..., 4:]
    n0 = fa.flash_attention.launches
    with pytest.raises(ValueError, match="flash_attention: k has a stride of 132 elements"):
        fa.flash_attention(q, k, v, causal=True, kv_format="bntd")
    qkv = _randn(gen, 1, 8 * 3 * H * D + 1)[:, 1:].view(1, 8, 3 * H * D)
    qq, kk, vv = qkv.chunk(3, dim=-1)
    with pytest.raises(ValueError, match="packed_self_attention: q's base address is not 16-byte aligned"):
        fa.packed_self_attention(qq, kk, vv, num_heads=H)
    assert fa.flash_attention.launches == n0


def _misaligned(t):
    """A contiguous copy of ``t`` whose base sits one element past ``t``'s
    own allocation's start, so that no 16-byte vector can take it."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return flat.copy_(t.reshape(-1)).view(t.shape)


@pytest.mark.parametrize("pool", ["bf16", "e4m3"])
@pytest.mark.parametrize("KVH,D,N,misaligned", [
    (4, 128, 28, False), (4, 128, 448, False), (3, 40, 9, False),  # 16-byte vectors
    (3, 20, 9, False), (2, 12, 5, False), (4, 128, 28, True),  # one value a thread
], ids=["vec_4x128_decode", "vec_4x128_serving", "vec_3x40", "scalar_3x20", "scalar_2x12", "scalar_misaligned"])
def test_commit_rows_vector_and_scalar_paths(gen, KVH, D, N, misaligned, pool):
    """K4 writes N rows at distinct (page, offset) bitwise as the plain commit
    does (into e4m3 as ``to_e4m3`` rounds, with values past 464, +-inf and NaN
    among them) and leaves every other byte of the pools as it was: through
    16-byte vectors where D is a multiple of 8 and the pointers allow, one
    value a thread otherwise."""
    P, PS = 40, 16
    dtype = torch.bfloat16 if pool == "bf16" else E4M3
    kr = _randn(gen, N, KVH, D) * 100
    vr = _randn(gen, N, KVH, D) * 100
    kr.view(-1)[:4] = torch.tensor([500.0, -float("inf"), float("nan"), 1e-9], dtype=torch.bfloat16)
    slots = torch.randperm(P * PS, generator=gen, device="cuda")[:N]
    pages, offs = (slots // PS).int(), (slots % PS).int()
    base_k = torch.randint(0, 256, (P, KVH, PS, D * (2 if pool == "bf16" else 1)), generator=gen, device="cuda",
                           dtype=torch.uint8).view(dtype)
    base_v = torch.randint(0, 256, base_k.view(torch.uint8).shape, generator=gen, device="cuda",
                           dtype=torch.uint8).view(dtype)
    if misaligned:
        kp, vp, kr, vr = map(_misaligned, (base_k, base_v, kr, vr))
        assert kp.data_ptr() % 16 and kr.data_ptr() % 16
    else:
        kp, vp = base_k.clone(), base_v.clone()
    kref, vref = kp.clone(), vp.clone()
    n0 = pa.commit_rows.launches
    ko, vo = pa.commit_rows(kp, vp, pages, offs, kr, vr)
    torch.cuda.synchronize()
    assert pa.commit_rows.launches == n0 + 1 and ko.data_ptr() == kp.data_ptr() and vo.data_ptr() == vp.data_ptr()
    pa.commit_rows_plain(kref, vref, pages, offs, kr, vr)
    bits = torch.uint8 if pool == "e4m3" else torch.int16
    assert torch.equal(kp.view(bits), kref.view(bits)) and torch.equal(vp.view(bits), vref.view(bits))


def test_graphed_step_counts_replays_and_checks_its_capture(gen):
    """A ``GraphedStep`` re-adds its capture's launches at each replay, so K4's
    counter reads one a call; a body whose capture launches other kernels
    than its eager first run is refused at capture."""
    from omchat_torch.runtime.cuda_graphs import GraphedStep

    kp, vp = (torch.zeros(4, 4, 16, 128, dtype=torch.bfloat16, device="cuda") for _ in range(2))
    rows = _randn(gen, 2, 4, 128)
    pages, offs = torch.tensor([0, 3], dtype=torch.int32, device="cuda"), torch.tensor([1, 5], dtype=torch.int32,
                                                                                        device="cuda")
    pool = torch.cuda.graph_pool_handle()
    step = GraphedStep(lambda: pa.commit_rows(kp, vp, pages, offs, rows, rows), pool, torch.device("cuda"))
    n0 = pa.commit_rows.launches
    for _ in range(4):
        step()
    torch.cuda.synchronize()
    assert pa.commit_rows.launches == n0 + 4 and step.replays == 3
    assert torch.equal(kp[pages.long(), :, offs.long()], rows)

    calls = []

    def eager_only():
        calls.append(1)
        if len(calls) == 1:
            pa.commit_rows(kp, vp, pages, offs, rows, rows)

    with pytest.raises(RuntimeError, match="commit_rows"):
        GraphedStep(eager_only, pool, torch.device("cuda"))()


def test_graphed_step_captures_while_garbage_that_holds_cuda_state_waits(gen):
    """Cyclic garbage left by earlier engines (here: cycles holding a captured
    graph, its pool, pinned host memory and device memory) is not collected
    inside a capture, even with the collector set to run at nearly every
    allocation: the capture of a 24-GEMM body succeeds and replays the eager
    result (the lost captures of ROADMAP C6)."""
    import gc

    from omchat_torch.runtime.cuda_graphs import GraphedStep

    x = _randn(gen, 64, 896)
    ws = [_randn(gen, 896, 896) * 0.05 for _ in range(24)]

    def body():
        h = x
        for w in ws:
            h = (h @ w).float().softmax(-1).bfloat16()
        return h

    def garbage():
        a, b = [], []
        a.append(b)
        b.append(a)
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            x @ ws[0]
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle()):
            y = x @ ws[0]
        a += [graph, y, torch.empty(1 << 20, pin_memory=True), torch.empty(1 << 22, device="cuda")]

    thresholds = gc.get_threshold()
    want = body()
    for _ in range(4):
        for _ in range(6):
            garbage()
        gc.set_threshold(1, 1, 1)
        try:
            step = GraphedStep(body, torch.cuda.graph_pool_handle(), torch.device("cuda"))
            step()
            got = step()
            torch.cuda.synchronize()
        finally:
            gc.set_threshold(*thresholds)
        assert step.graph is not None and torch.equal(got, want)


def _graph_model():
    """OmChatConfig() at full width with 2 ViT and 2 LLM layers, random bf16
    weights (seed 0)."""
    import dataclasses

    from omchat_torch.config import OmChatConfig
    from omchat_torch.models import intern_vit, projector, qwen2

    full = OmChatConfig()
    cfg = dataclasses.replace(full, vision=dataclasses.replace(full.vision, num_hidden_layers=2),
                              text=dataclasses.replace(full.text, num_hidden_layers=2))
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    return cfg, {"vision_tower": intern_vit.init_params(cfg.vision, g, bf),
                 "projector": projector.init_params(cfg.projector, cfg.vision.hidden_size, cfg.text.hidden_size, g, bf),
                 "language_model": qwen2.init_params(cfg.text, g, bf)}


@pytest.fixture(scope="module")
def graph_model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return _graph_model()


def _prompts(n, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [[151644] + [int(t) for t in rng.integers(2000, 20000, int(rng.integers(64, 600)))] for _ in range(n)]


@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
def test_decode_graphs_give_the_eager_tokens(graph_model, cache):
    """On the card, ``generate`` and ``generate_ondevice`` replaying a CUDA
    graph of the decode step give the tokens of the same step run eagerly,
    bit for bit; a second request of the same shape replays without
    capturing; the launch counters read what the eager run launched."""
    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.cuda_graphs import GraphedStep
    from omchat_torch.runtime.generate import OmChatEngine

    cfg, params = graph_model
    dtype = None if cache == "bf16" else E4M3
    gen = GenerationConfig(max_new_tokens=24, eos_token_id=-1)
    ids = _prompts(1)[0]
    counted = (da.flash_decode_stacked, pa.commit_rows)

    def run(eng, fn="generate"):
        for c in counted:
            c.launches = 0
        out = getattr(eng, fn)([ids], None, gen).token_ids
        torch.cuda.synchronize()
        return out, [c.launches for c in counted]

    eager = OmChatEngine(cfg, params, image_cache_size=0, cache_dtype=dtype, decode_graphs=False)
    want, want_launches = run(eager)
    assert want_launches == [23 * 2, 23] and len(want[0]) == 24
    graphed = OmChatEngine(cfg, params, image_cache_size=0, cache_dtype=dtype)
    got, launches = run(graphed)
    assert got == want and launches == want_launches and graphed.spans["capture"] > 0
    (st,) = graphed._states.values()
    assert isinstance(st.run, GraphedStep) and st.run.graph is not None and st.run.replays == 22
    graph = st.run.graph
    again, launches = run(graphed)
    assert again == want and launches == want_launches and "capture" not in graphed.spans
    assert st.run.graph is graph and st.run.replays == 22 + 23
    assert run(graphed, "generate_ondevice") == (want, want_launches)
    assert run(eager, "generate_ondevice")[0] == want


def test_decode_graph_captures_again_after_release(graph_model):
    """After ``release_decode_states`` dropped every graph of the engine's
    pool, the next request captures its step again (into a new pool) and
    gives the same tokens."""
    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.generate import OmChatEngine

    cfg, params = graph_model
    gen = GenerationConfig(max_new_tokens=12, eos_token_id=-1)
    ids = _prompts(1, seed=3)[0]
    eng = OmChatEngine(cfg, params, image_cache_size=0)
    want = eng.generate([ids], None, gen).token_ids
    pool = eng._graph_pool
    eng.release_decode_states()
    assert not eng._states and eng._graph_pool != pool
    assert eng.generate([ids], None, gen).token_ids == want and eng.spans["capture"] > 0
    assert eng.generate([ids], None, gen).token_ids == want and "capture" not in eng.spans


@pytest.mark.parametrize("pool", ["bf16", "e4m3"])
@pytest.mark.parametrize("kernel", ["auto", "manual"], ids=["k12", "k13"])
def test_paged_rolls_graphed_give_the_eager_tokens(graph_model, kernel, pool):
    """``PagedBatchEngine`` after ``precompile`` replays a CUDA graph of each
    greedy roll (table widths 4, 8 and the capped 9) and gives every request
    the eager rolls' tokens on both decode kernels and pools; precompile
    writes nothing but the parking page; the launch counters read what the
    eager run launched; every page comes back."""
    from omchat_torch.runtime.paged_engine import PagedBatchEngine

    cfg, params = graph_model
    settings = dict(max_slots=4, num_pages=48, page_size=128, prompt_bucket=128, max_len=1024, decode_roll=4,
                    prefill_chunk=1024, image_cache_size=0, decode_kernel=kernel,
                    cache_dtype=None if pool == "bf16" else E4M3)
    decode = pa.DECODE_KERNELS[kernel]
    got = {}
    for graphs in (False, True):
        eng = PagedBatchEngine(cfg, params, decode_graphs=graphs, **settings)
        if graphs:
            assert eng.precompile() == [4, 8, 9]
            for p in (eng.k_pool, eng.v_pool):
                assert not p[:, : eng._parking].view(torch.uint8).any() and p[:, eng._parking].view(torch.uint8).any()
        decode.launches = pa.commit_rows.launches = 0
        rids = [eng.submit(p, None, max_new_tokens=12, eos_token_id=-1) for p in _prompts(6, seed=1)]
        eng.run_to_completion()
        torch.cuda.synchronize()
        got[graphs] = ([eng.result(r) for r in rids], decode.launches, pa.commit_rows.launches,
                       eng.latency_stats())
        assert eng.allocator.available == settings["num_pages"]
    (want, k_eager, c_eager, st_eager), (tokens, k_graph, c_graph, st_graph) = got[False], got[True]
    assert tokens == want and all(len(t) == 12 for t in tokens)
    assert (k_graph, c_graph) == (k_eager, c_eager) and c_eager > 0
    assert st_graph["rolls_graphed"] == st_eager["rolls_eager"] > 0 and st_graph["rolls_eager"] == 0


def test_paged_pick_modes_graphed_give_the_eager_rolls(graph_model):
    """Sampled and log-prob rolls replay their pick mode's graph after
    ``precompile`` and give the eager rolls' tokens and log-probs bit for
    bit from one generator seed; no roll runs eagerly."""
    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.paged_engine import PagedBatchEngine

    cfg, params = graph_model
    hot = GenerationConfig(max_new_tokens=12, eos_token_id=-1, do_sample=True, temperature=0.8, top_k=50)
    got = {}
    for graphs in (False, True):
        eng = PagedBatchEngine(cfg, params, decode_graphs=graphs, max_slots=4, num_pages=48, page_size=128,
                               max_len=1024, decode_roll=4, image_cache_size=0, rng_seed=5)
        eng.precompile()
        rids = [eng.submit(p, None, max_new_tokens=12, eos_token_id=-1, generation=hot if i % 2 else None,
                           logprobs=i < 3, top_logprobs=5) for i, p in enumerate(_prompts(6, seed=2))]
        eng.run_to_completion()
        torch.cuda.synchronize()
        got[graphs] = [(eng.result(r), eng.request_logprobs(r)) for r in rids], eng.latency_stats()
    (want, st_eager), (runs, st_graph) = got[False], got[True]
    assert runs == want and all(len(t) == 12 for t, _ in runs)
    assert st_graph["rolls_eager"] == 0 and st_graph["rolls_graphed"] == st_eager["rolls_eager"] > 0


@pytest.mark.parametrize("pool", ["bf16", "e4m3"])
def test_paged_verify_graphed_is_its_eager_body(graph_model, pool):
    """Speculative verify in the batch: after ``precompile`` every verify
    replays its width's CUDA graph (``verifies_eager`` 0), and the tokens,
    the speculative counts and both pools, bit for bit, are those of the
    same engine running every verify and roll eagerly."""
    from omchat_torch.runtime.paged_engine import PagedBatchEngine

    cfg, params = graph_model
    prompts = _prompts(4, seed=3)
    settings = dict(max_slots=4, num_pages=48, page_size=128, max_len=1024, decode_roll=4, image_cache_size=0,
                    cache_dtype=None if pool == "bf16" else E4M3)
    base = PagedBatchEngine(cfg, params, **settings)
    rids = [base.submit(p, None, max_new_tokens=16, eos_token_id=-1) for p in prompts]
    base.run_to_completion()
    # an oracle draft of the rolls' tokens, so that drafts accept (both runs draft alike)
    cont = {tuple(p + r[:i]): r[i:] for p, r in zip(prompts, map(base.result, rids)) for i in range(len(r))}
    del base
    got = {}
    for graphs in (False, True):
        eng = PagedBatchEngine(cfg, params, decode_graphs=graphs, speculative=True,
                               draft_fn=lambda ctx: cont.get(tuple(ctx), [])[:4], **settings)
        eng.precompile(variants=((False, False),))
        rids = [eng.submit(p, None, max_new_tokens=16, eos_token_id=-1) for p in prompts]
        eng.run_to_completion()
        torch.cuda.synchronize()
        got[graphs] = ([eng.result(r) for r in rids], eng.stats(), eng.k_pool.clone(), eng.v_pool.clone())
        assert eng.allocator.available == 48
    (want, st_e, k_e, v_e), (tokens, st_g, k_g, v_g) = got[False], got[True]
    assert tokens == want and all(len(t) == 16 for t in tokens)
    assert st_g["spec_dispatches"] == st_e["spec_dispatches"] == st_e["verifies_eager"] > 0
    assert st_g["spec_tokens"] == st_e["spec_tokens"] and st_g["verifies_eager"] == 0
    assert st_g["verifies_graphed"] == st_g["spec_dispatches"]
    assert torch.equal(k_g.view(torch.uint8), k_e.view(torch.uint8))
    assert torch.equal(v_g.view(torch.uint8), v_e.view(torch.uint8))


def test_paged_verify_kernels_match_plain(graph_model):
    """``_paged_verify`` at 2+2 layers on the kernels (K2 over the gathered
    pages, K4) against ``attn_impl="plain"`` on the same pools and tokens:
    logits within chip_smoke.py's phase-4 limits (atol 1e-1, rtol 2e-2),
    layer 0's committed rows bitwise and the same rows written in every
    layer, the rest of the pools untouched; a verify with its lengths one
    row late falls outside."""
    import numpy as np

    from omchat_torch.runtime.paged_engine import _paged_verify

    cfg, params = graph_model
    tc = cfg.text
    g = torch.Generator(device="cuda").manual_seed(11)
    s, t, ps, pages = 6, 5, 128, 48
    shape = (tc.num_hidden_layers, pages + 1, tc.num_key_value_heads, ps, tc.attn_head_dim)
    k_pool = (torch.randn(shape, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    v_pool = (torch.randn(shape, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    tokens = torch.randint(2000, 20000, (s, t), generator=g, device="cuda", dtype=torch.int32)
    lengths = torch.tensor([700, 127, 128, 1000, 3, 0], dtype=torch.int32, device="cuda")
    active = torch.tensor([True, True, True, True, True, False], device="cuda")
    perm = np.random.default_rng(0).permutation(pages)[: s * 8].reshape(s, 8)
    perm[-1] = pages  # the inactive slot parked
    tables = torch.tensor(perm, dtype=torch.int32, device="cuda")

    def run(impl, lens=lengths):
        kp, vp = k_pool.clone(), v_pool.clone()
        return _paged_verify(params, cfg, tokens, lens, active, tables, kp, vp, ps, impl), kp, vp

    (lk, kk, vk), (lp, kpl, vpl) = run(None), run("plain")
    live = active[:, None, None]
    err = ((lk - lp).abs() - (1e-1 + 2e-2 * lp.abs())).masked_fill(~live, -1)
    assert float(err.max()) <= 0, float((lk - lp).abs().max())
    # layer 0's rows are projections of the embeddings: bitwise; later layers' rows come
    # from the previous layer's attention, which the two routes round apart
    assert torch.equal(kk[0], kpl[0]) and torch.equal(vk[0], vpl[0])
    for got, ref, before in ((kk, kpl, k_pool), (vk, vpl, v_pool)):  # the same rows written, nothing else
        moved = (got[:, :pages] != before[:, :pages]).any(-1).any(2)  # [L, pages, ps]
        assert torch.equal(moved, (ref[:, :pages] != before[:, :pages]).any(-1).any(2))
        assert int(moved.any(0).sum()) == 5 * t
    bad, _, _ = run(None, lengths + 1)
    assert float(((bad - lp).abs() - (1e-1 + 2e-2 * lp.abs())).masked_fill(~live, -1).max()) > 0


def test_paged_pipelined_graphed_gives_the_unpipelined_tokens(graph_model):
    """Pipelined rolls on the graphs: each successor dispatched from the
    in-flight roll's tokens on the card, two rolls' outputs in flight at
    once; every request gets the unpipelined graphed run's tokens bit for
    bit, no roll runs eagerly after ``precompile``, nothing stays in flight
    and every page comes back."""
    from omchat_torch.runtime.paged_engine import PagedBatchEngine

    cfg, params = graph_model
    got = {}
    for pipelined in (False, True):
        eng = PagedBatchEngine(cfg, params, max_slots=4, num_pages=48, page_size=128, max_len=1024, decode_roll=4,
                               image_cache_size=0, pipeline_rolls=pipelined)
        eng.precompile(variants=((False, False),))
        extended = []
        orig = eng._extend_roll
        eng._extend_roll = lambda h: (extended.append(1), orig(h))[1]
        rids = [eng.submit(p, None, max_new_tokens=18, eos_token_id=-1) for p in _prompts(4, seed=4)]
        eng.run_to_completion()
        torch.cuda.synchronize()
        got[pipelined] = [eng.result(r) for r in rids], eng.latency_stats(), len(extended)
        assert eng._inflight is None and eng.allocator.available == 48
    (want, st, _), (tokens, st_p, n_ext) = got[False], got[True]
    assert tokens == want and all(len(t) == 18 for t in tokens)
    assert n_ext > 0 and st_p["rolls_eager"] == st["rolls_eager"] == 0 and st_p["rolls_graphed"] > 0


def test_lora_bank_decode_graph_serves_every_adapter(graph_model):
    """With a LoRA bank the graphed decode step reads each request's adapter
    from the decode state's buffer: adapters 1, 0 and 2 in turn on one state
    give the eager engine's tokens, and adapter 0 the bank-free engine's."""
    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.generate import OmChatEngine
    from omchat_torch.training.lora import build_lora_bank, init_lora

    cfg, params = graph_model
    adapters = []
    for seed in (1, 2):
        g = torch.Generator(device="cuda").manual_seed(seed)
        lora = init_lora(g, params, rank=8)
        for group in lora["layers"].values():
            for ab in group.values():
                ab["a"] = ab["a"].detach()
                ab["b"] = (torch.randn(ab["b"].shape, generator=g, device="cuda") * 0.02).to(ab["b"].dtype)
        adapters.append(lora)
    bank = build_lora_bank(adapters)
    gen = GenerationConfig(max_new_tokens=10, eos_token_id=-1)
    ids = [_prompts(1, seed=3)[0]]
    engines = {graphs: OmChatEngine(cfg, params, lora_bank=bank, image_cache_size=0, decode_graphs=graphs)
               for graphs in (False, True)}
    for adapter in (1, 0, 2):
        want = engines[False].generate(ids, None, gen, adapter_id=adapter).token_ids
        assert engines[True].generate(ids, None, gen, adapter_id=adapter).token_ids == want
    base = OmChatEngine(cfg, params, image_cache_size=0).generate(ids, None, gen).token_ids
    assert engines[True].generate(ids, None, gen, adapter_id=0).token_ids == base


# -- the single-request surface's regimes: K2 at a verify step's or a chunk's
# rows past an offset, K3 over a video's cache and at a beam search's batch,
# K7 / K11 / K10 at a verify step's 9 rows, the sampled decode step graphed.


def _fault_outside(got, faulty, tol=TOL):
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got.float(), faulty.float(), **tol)


@pytest.mark.parametrize("S", [1, 9, 64])
@pytest.mark.parametrize("q_off", [3187, 3199, 3200, 127], ids=["prompt_end", "tile_edge_minus_1", "tile_edge",
                                                                "first_tile_edge"])
def test_flash_attention_kernel_rows_past_an_offset(gen, S, q_off):
    """K2 with S query rows at ``q_offset`` (a speculative verify step: 9 rows
    at the prompt's end; a chunk) over a 3328-row cache, the causal edge
    inside a 128-row kv tile or on its boundary, keys planted on the columns
    each row's causal edge lets in and the one past it; the plain version
    with the causal edge one column further must fall outside."""
    H, KVH, D, T = 28, 4, 128, 3328
    u = (torch.randint(0, 2, (KVH, D), generator=gen, device="cuda") * 2 - 1).to(torch.bfloat16)
    q = _randn(gen, 1, S, H, D) + u.repeat_interleave(H // KVH, dim=0)
    k, v = _randn(gen, 1, KVH, T, D), _randn(gen, 1, KVH, T, D)
    k[0, :, q_off: q_off + S + 1] = 0.8 * u[:, None]
    qo = torch.tensor([q_off], dtype=torch.int32, device="cuda")
    kl = torch.tensor([q_off + S], dtype=torch.int32, device="cuda")
    out = fa.flash_attention(q, k, v, causal=True, q_offset=qo, kv_len=kl, kv_format="bntd")
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q, k, v, causal=True, q_offset=qo, kv_len=kl)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    _fault_outside(out, fa.flash_attention_plain(q, k, v, causal=True, q_offset=qo + 1, kv_len=kl + 1))


@pytest.mark.parametrize("case", ["video_B1_33k", "beams_B4"])
def test_flash_decode_stacked_at_video_length_and_beam_batch(gen, case):
    """K3 at B = 1 over a 33024-row cache (a 32-frame video prompt of ~32.9k
    rows; ``decode_splits`` cuts it into its most splits) and at B = 4 (a
    beam search) over 3328 rows, keys planted at every chunk edge and on each
    row's last valid column; the plain version with that column dropped must
    fall outside.  Two launches bitwise equal."""
    H, KVH, D = 28, 4, 128
    T, lens = (33024, [32950]) if case == "video_B1_33k" else (3328, [3187, 3187, 3187, 3187])
    q, kc, vc, cl = _decode_case(gen, H, KVH, lens, T, 2, "bf16")
    for b, n in enumerate(lens):
        kc[1, b, :, n - 1] = 1.5 * q[b, 0, ::H // KVH]  # each kv head's first q head
    kn, vn = _randn(gen, len(lens), KVH, D), _randn(gen, len(lens), KVH, D)
    splits = da.decode_splits(len(lens), KVH, T, _sms())
    out = da.flash_decode_stacked(q, kc, vc, cl, 1, kn, vn)
    again = da.flash_decode_stacked(q, kc, vc, cl, 1, kn, vn)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and splits[0] >= 1
    ref = da.flash_decode_stacked_plain(q, kc, vc, cl, 1, kn, vn)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    _fault_outside(out, da.flash_decode_stacked_plain(q, kc, vc, cl - 1, 1, kn, vn))


def _codes_far(got, faulty):
    d = (got.int() - faulty.int()).abs()
    assert int(d.max()) > 1 or float((d == 0).float().mean()) < 0.99


@pytest.mark.parametrize("kernel", ["K7", "K11", "K10"])
def test_w8a8_kernels_at_a_verify_steps_nine_rows(gen, kernel):
    """K7, K11 (Qwen2 o_proj, 3584) and K10 (3584 -> 18944) at M = 9, a
    speculative verify step's rows under w8a8: one 128-row tile of mostly
    padding.  Codes within phase 11's limits of the plain version, x'
    bitwise, row scales rtol 1e-2; a planted fault (the rows shifted by one,
    so a padding row's place is read; gate and up swapped for K10) breaks
    the codes."""
    M, D = 9, 3584
    gamma = (1 + 0.1 * _randn(gen, D).float()).bfloat16()
    if kernel == "K7":
        x = _randn(gen, M, D)
        q, rs = norms.rmsnorm_quant(x, gamma)
        torch.cuda.synchronize()
        qp, rp = norms.rmsnorm_quant_plain(x, gamma)
        _codes_close(q, qp)
        torch.testing.assert_close(rs, rp, rtol=1e-2, atol=0)
        _codes_far(q, norms.rmsnorm_quant_plain(x.roll(1, 0), gamma)[0])
    elif kernel == "K11":
        a, x = (0.5 * _randn(gen, M, D).float()).bfloat16(), _randn(gen, M, D)
        p = _qlinear(gen, D, D, False)
        xn, q, rs = qm.attn_proj_glue_quant(a, x, p, None, gamma)
        torch.cuda.synchronize()
        xp, qp, rp = qm.attn_proj_glue_quant_plain(a, x, p, None, gamma)
        assert torch.equal(xn, xp)
        _codes_close(q, qp)
        torch.testing.assert_close(rs, rp, rtol=1e-2, atol=0)
        _codes_far(q, qm.attn_proj_glue_quant_plain(a, x.roll(1, 0), p, None, gamma)[1])
    else:
        xq = torch.randint(-127, 128, (M, D), generator=gen, device="cuda", dtype=torch.int8)
        rs = torch.rand((M, 1), generator=gen, device="cuda") * 0.01 + 1e-3
        gp, up = _qlinear(gen, 18944, D, False), _qlinear(gen, 18944, D, False)
        os_ = torch.tensor(0.05, device="cuda")
        out = qm.swiglu_quant(xq, rs, gp, up, os_)
        torch.cuda.synchronize()
        _codes_close(out, qm.dense_prequant_swiglu_quant_plain(xq, rs, gp, up, os_))
        _codes_far(out, qm.dense_prequant_swiglu_quant_plain(xq, rs, up, gp, os_))


@pytest.mark.parametrize("top_k", [0, 50])
def test_sampled_decode_graph_draws_the_eager_tokens(graph_model, top_k):
    """``generate_ondevice(do_sample=True)`` replaying a CUDA graph of the
    sampled step (the decode state's generator registered with the graph)
    draws, from one seed, the tokens of the same step run eagerly, twice;
    one replay a step; another seed draws other tokens."""
    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.generate import OmChatEngine

    cfg, params = graph_model
    gen = GenerationConfig(max_new_tokens=24, eos_token_id=-1, do_sample=True, temperature=0.8, top_k=top_k)
    ids = _prompts(1)[0]
    eager = OmChatEngine(cfg, params, image_cache_size=0, decode_graphs=False)
    graphed = OmChatEngine(cfg, params, image_cache_size=0)
    want = eager.generate_ondevice([ids], None, gen, rng_key=7).token_ids
    got = [graphed.generate_ondevice([ids], None, gen, rng_key=7).token_ids for _ in range(2)]
    assert got[0] == got[1] == want and len(want[0]) == 24
    (st,) = graphed._states.values()
    run = st.runs[(True, False)]
    assert run.graph is not None and run.replays == 2 * 23 - 1
    assert graphed.generate([ids], None, gen, rng_key=7).token_ids == want
    assert graphed.generate_ondevice([ids], None, gen, rng_key=8).token_ids != want


# K2 at the towers' head widths: CLIP-L / InternViT-300M (64) and SigLIP (72).
@pytest.mark.parametrize("D", [64, 72, 8, 120])
@pytest.mark.parametrize(
    "B,H,KVH,S,T,causal,fmt",
    [(2, 16, 16, 577, 577, False, "btnd"), (1, 16, 16, 729, 729, False, "bntd"), (2, 4, 2, 200, 328, True, "bntd"),
     (1, 4, 4, 130, 130, True, "btnd")],
    ids=["clip_rows", "siglip_rows", "causal_group2", "causal_btnd"],
)
def test_flash_attention_kernel_at_narrow_head_widths(gen, D, B, H, KVH, S, T, causal, fmt):
    q = _randn(gen, B, S, H, D)
    kv_shape = (B, KVH, T, D) if fmt == "bntd" else (B, T, KVH, D)
    k, v = _randn(gen, *kv_shape), _randn(gen, *kv_shape)
    n0 = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal, kv_format=fmt)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1 and out.shape == (B, S, H, D)
    kb, vb = (k, v) if fmt == "bntd" else (k.transpose(1, 2), v.transpose(1, 2))
    ref = fa.flash_attention_plain(q, kb, vb, causal=causal, q_offset=None, kv_len=None)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


@pytest.mark.parametrize("D", [64, 72])
def test_flash_attention_kernel_reads_no_column_of_the_next_head(gen, D):
    """q, k and v as head views of one fused qkv row ([B, N, 3 H D]), the
    towers' layout: a 128-column box past column D would read the next head's
    columns; large values there must change nothing."""
    B, N, H = 2, 257, 16
    qkv = _randn(gen, B, N, 3, H, D)
    q, k, v = qkv.unbind(2)
    n0 = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    ref = fa.flash_attention_plain(q.contiguous(), k.transpose(1, 2), v.transpose(1, 2), causal=False, q_offset=None,
                                   kv_len=None)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


def test_flash_attention_refuses_widths_the_kernel_lacks(gen):
    """D = 256, a width not a multiple of 8, and e4m3 at a width not a
    multiple of 16 (an e4m3 row of 24 bytes, which TMA cannot stride) raise
    before any launch: no fallback to the plain version."""
    n0 = fa.flash_attention.launches
    for D in (256, 68):
        q, k = _randn(gen, 1, 16, 2, D), _randn(gen, 1, 2, 16, D)
        with pytest.raises(ValueError, match=f"head width {D}"):
            fa.flash_attention(q, k, k, causal=True, kv_format="bntd")
    q, k = _randn(gen, 1, 16, 2, 24), to_e4m3(_randn(gen, 1, 2, 16, 24))
    with pytest.raises(ValueError, match="head width 24 on an e4m3 cache"):
        fa.flash_attention(q, k, k, causal=True, kv_format="bntd")
    assert fa.flash_attention.launches == n0


@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
@pytest.mark.parametrize("lens", [[1900], [0, 1, 512, 1000]], ids=["moe_request", "ragged"])
def test_flash_decode_stacked_kernel_at_group_1(gen, lens, cache):
    """K3 at 16 / 16 heads (Qwen1.5-MoE-A2.7B's group of one)."""
    H = KVH = 16
    D, T, layer = 128, 2048, 2
    q, kc, vc, cl = _decode_case(gen, H, KVH, lens, T, 3, cache)
    kn, vn = _randn(gen, len(lens), KVH, D), _randn(gen, len(lens), KVH, D)
    out = da.flash_decode_stacked(q, kc, vc, cl, layer, kn, vn)
    torch.cuda.synchronize()
    ref = da.flash_decode_stacked_plain(q, kc, vc, cl, layer, kn, vn)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)


def test_paged_kernels_at_group_1(gen):
    """K12 and K14 at 16 / 16 heads, the MoE trunk's serving shapes."""
    H = KVH = 16
    D = 128
    lengths = [3, 700, 1, 1300, 128, 999]
    B, W = len(lengths), 16
    kp, vp, tables = _paged_pool(gen, sum(-(-n // 128) for n in lengths) + 2, KVH, D, lengths, W)
    q = _randn(gen, B, 1, H, D)
    kn, vn = _randn(gen, B, KVH, D), _randn(gen, B, KVH, D)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out = pa.paged_flash_decode(q, kp, vp, lens, tables, kn, vn)
    torch.cuda.synchronize()
    ref = pa.paged_flash_decode_plain(q, kp, vp, lens, tables, kn, vn)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    qo = torch.tensor([o - min(o, 100) for o in lengths], dtype=torch.int32, device="cuda")
    qc = _randn(gen, B, 128, H, D)
    out = pa.paged_flash_prefill(qc, kp, vp, lens, tables, qo)
    torch.cuda.synchronize()
    ref = pa.paged_flash_prefill_plain(qc, kp, vp, lens, tables, qo)
    for b, n in enumerate(lengths):
        rows = n - int(qo[b])
        torch.testing.assert_close(out[b, :rows].float(), ref[b, :rows].float(), **TOL)


def _packed_seg(B, S, cuts, tail):
    """[B, S] int32 segment ids: documents between ``cuts`` (row b's cuts
    shifted by 37 b), then a -1 tail of ``tail`` rows."""
    seg = torch.full((B, S), -1, dtype=torch.int32, device="cuda")
    for b in range(B):
        edges = [0] + [min(c + 37 * b, S - tail) for c in cuts] + [S - tail]
        for i in range(len(edges) - 1):
            seg[b, edges[i]:edges[i + 1]] = i
    return seg


@pytest.mark.parametrize(
    "B,S,H,KVH,D,cuts,tail,causal",
    [(1, 700, 28, 4, 128, [100, 260, 300, 511], 40, True),
     (1, 700, 28, 4, 128, [100, 260, 300, 511], 40, False),
     (2, 384, 16, 16, 64, [127, 128, 200], 1, True),
     (2, 385, 8, 1, 72, [64, 192, 320], 0, False),
     (1, 4096, 28, 4, 128, [900, 1500, 2400, 3100], 300, True)],
    ids=["causal_group7", "noncausal_group7", "causal_mha_d64_edges", "noncausal_group8_d72", "chip_smoke_shape"])
def test_flash_attention_kernel_with_segment_ids(gen, B, S, H, KVH, D, cuts, tail, causal):
    """K2's segment-ids entry against its plain version on every row: valid
    rows within the bf16 tolerance, padding rows (-1) zeros in both; a kv_len
    below the count of valid ids masks the columns past it."""
    q, k, v = _randn(gen, B, S, H, D), _randn(gen, B, S, KVH, D), _randn(gen, B, S, KVH, D)
    seg = _packed_seg(B, S, cuts, tail)
    n0, s0 = fa.flash_attention.launches, fa.flash_attention.seg_launches
    out = fa.flash_attention(q, k, v, causal=causal, segment_ids=seg)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention.seg_launches) == (n0, s0 + 1)
    kl = (seg >= 0).sum(1, dtype=torch.int32)
    ref = fa.flash_attention_plain(q, k.transpose(1, 2), v.transpose(1, 2), causal=causal, q_offset=None, kv_len=kl,
                                   segment_ids=seg)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    assert bool((out[seg < 0] == 0).all())
    short = kl - 50
    out = fa.flash_attention(q, k, v, causal=causal, segment_ids=seg, kv_len=short)
    ref = fa.flash_attention_plain(q, k.transpose(1, 2), v.transpose(1, 2), causal=causal, q_offset=None,
                                   kv_len=short, segment_ids=seg)
    for b in range(B):
        rows = int(short[b])
        torch.testing.assert_close(out[b, :rows].float(), ref[b, :rows].float(), **TOL)


def test_flash_attention_segment_ids_refusals(gen):
    """Segment ids with S != T, with an e4m3 K / V or with a q_offset raise
    before any launch."""
    s0 = fa.flash_attention.seg_launches
    q, k = _randn(gen, 1, 64, 4, 128), _randn(gen, 1, 64, 2, 128)
    seg = torch.zeros((1, 64), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="S == T"):
        fa.flash_attention(q[:, :32], k, k, causal=True, segment_ids=seg[:, :32])
    with pytest.raises(ValueError, match="bf16 K / V and no q_offset"):
        fa.flash_attention(q, to_e4m3(k), to_e4m3(k), causal=True, segment_ids=seg)
    with pytest.raises(ValueError, match="bf16 K / V and no q_offset"):
        fa.flash_attention(q, k, k, causal=True, segment_ids=seg, q_offset=0)
    assert fa.flash_attention.seg_launches == s0


# ---------------------------------------------------------------------------
# head widths other than 128: K3, K6, K12, K13, K14 and K2's e4m3 entry
# ---------------------------------------------------------------------------

# every width the rule takes (fa.head_dim_supported): multiples of 8 on bf16, of 16 on e4m3
WIDTH_CASES = [(D, "bf16") for D in range(8, 129, 8)] + [(D, "e4m3") for D in range(16, 129, 16)]
WIDTH_IDS = [f"{c}_D{D}" for D, c in WIDTH_CASES]


@pytest.mark.parametrize("D,cache", WIDTH_CASES, ids=WIDTH_IDS)
def test_decode_kernels_at_every_head_width(gen, D, cache):
    """K3 (with the self column) and K6 at Qwen2-0.5B's 14 / 2 heads over a
    3328-row cache: lengths 0, 1, a chunk's edges and T, keys planted at
    every chunk edge; one launch each, within TOL of the plain version, a
    second launch bitwise the same."""
    assert fa.head_dim_supported(D, e4m3=cache == "e4m3")
    H, KVH, T = 14, 2, 3328
    lens = _edge_lens(KVH, T)
    q, kc, vc, cl = _decode_case(gen, H, KVH, lens, T, 2, cache, D=D)
    kn, vn = _randn(gen, len(lens), KVH, D), _randn(gen, len(lens), KVH, D)
    n3, n6 = da.flash_decode_stacked.launches, da.flash_decode.launches
    out = da.flash_decode_stacked(q, kc, vc, cl, 1, kn, vn)
    again = da.flash_decode_stacked(q, kc, vc, cl, 1, kn, vn)
    k6 = da.flash_decode(q, kc[1], vc[1], cl)
    torch.cuda.synchronize()
    assert (da.flash_decode_stacked.launches, da.flash_decode.launches) == (n3 + 2, n6 + 1)
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), da.flash_decode_stacked_plain(q, kc, vc, cl, 1, kn, vn).float(), **TOL)
    torch.testing.assert_close(k6.float(), da.flash_decode_plain(q, kc[1], vc[1], cl).float(), **TOL)
    assert not k6[0].any()  # length 0: zeros


def _paged_width_case(gen, D, cache, PS=128):
    """K12 / K13 operands at head width D over a flat two-layer pool (the
    layer at page_offset P + 1): lengths 0, 1, a chunk's edges and a full
    table, at Qwen2-0.5B's heads."""
    H, KVH, W = 14, 2, 26
    chunk = pa.paged_splits(6, KVH, W * PS, _sms())[1]
    lengths = [0, 1, chunk - 1, chunk, chunk + 1, W * PS]
    kp, vp, tables = _paged_pool_ps(gen, PS, KVH, D, lengths, W, False)
    kp = torch.cat([_randn(gen, *kp.shape), kp])
    vp = torch.cat([_randn(gen, *vp.shape), vp])
    if cache == "e4m3":
        kp, vp = to_e4m3(kp), to_e4m3(vp)
    B = len(lengths)
    q, kn, vn = _randn(gen, B, 1, H, D), _randn(gen, B, KVH, D), _randn(gen, B, KVH, D)
    return q, kp, vp, torch.tensor(lengths, dtype=torch.int32, device="cuda"), tables, kn, vn, kp.shape[0] // 2


@pytest.mark.parametrize("D,cache", WIDTH_CASES, ids=WIDTH_IDS)
def test_paged_decode_kernels_at_every_head_width(gen, D, cache):
    """K12 and K13 at width D: within TOL of the plain version, K12 bitwise
    K13 (their shared chunks and arithmetic), a request of length 0 exactly
    v_new."""
    q, kp, vp, lens, tables, kn, vn, off = _paged_width_case(gen, D, cache)
    n12, n13 = pa.paged_flash_decode.launches, pa.paged_flash_decode_manual.launches
    k12 = pa.paged_flash_decode(q, kp, vp, lens, tables, kn, vn, page_offset=off)
    k13 = pa.paged_flash_decode_manual(q, kp, vp, lens, tables, kn, vn, page_offset=off)
    torch.cuda.synchronize()
    assert (pa.paged_flash_decode.launches, pa.paged_flash_decode_manual.launches) == (n12 + 1, n13 + 1)
    assert torch.equal(k12, k13)
    ref = pa.paged_flash_decode_plain(q, kp, vp, lens, tables, kn, vn, page_offset=off)
    torch.testing.assert_close(k12.float(), ref.float(), **TOL)
    assert torch.equal(k12[0, 0], vn[0].repeat_interleave(q.shape[2] // kn.shape[1], dim=0))


@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
@pytest.mark.parametrize("PS", [16, 64])
def test_paged_decode_kernels_at_head_width_64_and_page_size(gen, PS, cache):
    """K12 / K13 at D = 64 and page sizes 16 and 64: bitwise equal, within TOL."""
    q, kp, vp, lens, tables, kn, vn, off = _paged_width_case(gen, 64, cache, PS=PS)
    k12 = pa.paged_flash_decode(q, kp, vp, lens, tables, kn, vn, page_offset=off)
    k13 = pa.paged_flash_decode_manual(q, kp, vp, lens, tables, kn, vn, page_offset=off)
    torch.cuda.synchronize()
    assert torch.equal(k12, k13)
    ref = pa.paged_flash_decode_plain(q, kp, vp, lens, tables, kn, vn, page_offset=off)
    torch.testing.assert_close(k12.float(), ref.float(), **TOL)


@pytest.mark.parametrize("D,cache", WIDTH_CASES, ids=WIDTH_IDS)
def test_paged_flash_prefill_at_every_head_width(gen, D, cache):
    """K14 at width D, page size 16: ragged chunks past page-aligned offsets,
    within TOL of its plain version and of gather + K2."""
    H, KVH, PS, C = 14, 2, 16, 200
    q_offset, chunk_len = [0, 256], [200, 131]
    kv_len = [o + n for o, n in zip(q_offset, chunk_len)]
    W = -(-max(kv_len) // PS) + 1
    kp, vp, tables = _paged_pool_ps(gen, PS, KVH, D, kv_len, W, cache == "e4m3")
    q = _randn(gen, 2, C, H, D)
    qo = torch.tensor(q_offset, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    n0 = pa.paged_flash_prefill.launches
    out = pa.paged_flash_prefill(q, kp, vp, kl, tables, qo)
    torch.cuda.synchronize()
    assert pa.paged_flash_prefill.launches == n0 + 1
    ref = pa.paged_flash_prefill_plain(q, kp, vp, kl, tables, qo)
    for b in range(2):
        torch.testing.assert_close(out[b, :chunk_len[b]].float(), ref[b, :chunk_len[b]].float(), **TOL)


@pytest.mark.parametrize("D", range(16, 129, 16))
def test_flash_attention_e4m3_at_every_head_width(gen, D):
    """K2's e4m3 entry at width D: causal with offsets at group 7, within the
    e4m3 tolerance of its plain version (p rounded to e4m3 on both sides)."""
    H, KVH, S, T = 14, 2, 200, 328
    q = _randn(gen, 2, S, H, D)
    k, v = to_e4m3(_randn(gen, 2, KVH, T, D)), to_e4m3(_randn(gen, 2, KVH, T, D))
    qo = torch.tensor([0, 128], dtype=torch.int32, device="cuda")
    kl = torch.tensor([200, 328], dtype=torch.int32, device="cuda")
    n0 = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=True, q_offset=qo, kv_len=kl, kv_format="bntd")
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    ref = fa.flash_attention_plain(q, k, v, causal=True, q_offset=qo, kv_len=kl)
    torch.testing.assert_close(out.float(), ref.float(), **K2_E4M3_TOL)


def test_decode_and_paged_kernels_refuse_other_widths(gen):
    """A width the rule refuses (12, 136 on bf16; 24 on e4m3) raises before
    any launch, naming the width: no fallback to the plain version."""
    H, KVH, B = 14, 2, 2
    counters = (da.flash_decode_stacked, da.flash_decode, pa.paged_flash_decode, pa.paged_flash_decode_manual,
                pa.paged_flash_prefill)
    n0 = [f.launches for f in counters]
    lens = torch.tensor([3, 5], dtype=torch.int32, device="cuda")
    tables = torch.zeros(B, 2, dtype=torch.int32, device="cuda")
    for D, e4m3 in ((12, False), (136, False), (24, True)):
        cast = to_e4m3 if e4m3 else (lambda t: t)
        q, kn = _randn(gen, B, 1, H, D), _randn(gen, B, KVH, D)
        stack, pool = cast(_randn(gen, 2, B, KVH, 64, D)), cast(_randn(gen, 3, KVH, 16, D))
        calls = [lambda: da.flash_decode_stacked(q, stack, stack, lens, 0, kn, kn),
                 lambda: da.flash_decode(q, stack[0], stack[0], lens),
                 lambda: pa.paged_flash_decode(q, pool, pool, lens, tables, kn, kn),
                 lambda: pa.paged_flash_decode_manual(q, pool, pool, lens, tables, kn, kn),
                 lambda: pa.paged_flash_prefill(_randn(gen, B, 16, H, D), pool, pool, lens, tables, lens * 0)]
        for call in calls:
            with pytest.raises(ValueError, match=f"head width {D} on an? {'e4m3' if e4m3 else 'bfloat16'} cache"):
                call()
    assert [f.launches for f in counters] == n0
