"""The port's paged kernels on the CPU (plain versions) against the JAX
package's Pallas kernels run in interpret mode, the page allocator, and the
sampling thresholds against the JAX package's, exactly.

Same seeded numpy inputs to both sides, float32; attention tolerance atol
1e-5 (float32 round-off of differently ordered sums), page commits bitwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omchat_torch.ops import paged_attention as t_paged
from omchat_torch.ops import sampling as t_sampling

ATOL = 1e-5


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pool_and_tables(rng, B, W, P, KVH, PS, D, lengths):
    """A pool of P pages plus a parking page (index P), and tables mapping
    each request's live pages to shuffled pool pages, parking past them."""
    kp, vp = _np(rng, P + 1, KVH, PS, D), _np(rng, P + 1, KVH, PS, D)
    perm = rng.permutation(P)
    tables = np.full((B, W), P, np.int32)
    used = 0
    for b, n in enumerate(lengths):
        live = -(-int(n) // PS)
        tables[b, :live] = perm[used: used + live]
        used += live
    return kp, vp, tables


@pytest.mark.parametrize("self_col", [True, False], ids=["self_column", "no_self_column"])
def test_paged_flash_decode_matches_pallas(self_col):
    """K12: ragged lengths (0, a partial page, a page boundary, a full
    table), tables with parking entries past each length."""
    from omchat_tpu.ops.paged_attention import paged_flash_decode

    rng = np.random.default_rng(21)
    B, H, KVH, D, PS, W, P = 4, 8, 2, 128, 16, 4, 12
    lengths = np.asarray([0, 37, 32, 64], np.int32)
    kp, vp, tables = _pool_and_tables(rng, B, W, P, KVH, PS, D, lengths)
    q = _np(rng, B, 1, H, D)
    kn, vn = (_np(rng, B, KVH, D), _np(rng, B, KVH, D)) if self_col else (None, None)
    ref = paged_flash_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lengths), jnp.asarray(tables),
        None if kn is None else jnp.asarray(kn), None if vn is None else jnp.asarray(vn), interpret=True,
    )
    out = t_paged.paged_flash_decode(_t(q), _t(kp), _t(vp), _t(lengths), _t(tables),
                                     None if kn is None else _t(kn), None if vn is None else _t(vn))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    if self_col:  # the empty slot reads no page and returns v_new itself
        np.testing.assert_array_equal(out[0, 0].reshape(KVH, H // KVH, D).numpy(),
                                      np.repeat(vn[0][:, None], H // KVH, axis=1))
    else:
        assert (out[0] == 0).all()
    assert t_paged.paged_flash_decode.launches == 0  # CPU tensors never launch


def test_paged_decode_page_offset_and_plain_dispatch():
    """The flat layered pool: ``page_offset`` shifts every table entry (a
    layer's first page), and the "plain" dispatcher route agrees."""
    rng = np.random.default_rng(22)
    B, H, KVH, D, PS, W, P, L = 3, 4, 2, 32, 8, 4, 6, 3
    lengths = np.asarray([5, 17, 30], np.int32)
    kp, vp, tables = _pool_and_tables(rng, B, W, P * L + L - 1, KVH, PS, D, lengths)
    tables = tables % (P + 1)  # entries of one layer; the offset picks the layer
    q, kn, vn = _np(rng, B, 1, H, D), _np(rng, B, KVH, D), _np(rng, B, KVH, D)
    args = [_t(a) for a in (q, kp, vp, lengths)]
    off = 2 * (P + 1)
    got = t_paged.paged_decode_attention(*args, _t(tables), k_new=_t(kn), v_new=_t(vn), page_offset=off)
    want = t_paged.paged_flash_decode_plain(*args, _t(tables + off), _t(kn), _t(vn))
    assert torch.equal(got, want)
    plain = t_paged.paged_decode_attention(*args, _t(tables), impl="plain", k_new=_t(kn), v_new=_t(vn),
                                           page_offset=off)
    np.testing.assert_allclose(plain.numpy(), want.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("C", [32, 64])
def test_paged_flash_prefill_matches_pallas(C):
    """K14: two chunk widths, non-zero page-aligned q_offset, ragged kv_len
    (the last page partly filled)."""
    from omchat_tpu.ops.paged_attention import paged_flash_prefill

    rng = np.random.default_rng(23)
    B, H, KVH, D, PS, W, P = 2, 8, 2, 128, 16, 8, 16
    q_offset = np.asarray([16, 48], np.int32)
    kv_len = q_offset + np.asarray([C, C - 9], np.int32)
    kp, vp, tables = _pool_and_tables(rng, B, W, P, KVH, PS, D, kv_len)
    q = _np(rng, B, C, H, D)
    ref = paged_flash_prefill(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kv_len),
                              jnp.asarray(tables), jnp.asarray(q_offset), interpret=True)
    out = t_paged.paged_flash_prefill(_t(q), _t(kp), _t(vp), _t(kv_len), _t(tables), _t(q_offset))
    for b in range(B):
        rows = int(kv_len[b] - q_offset[b])  # rows past this are padding in both
        np.testing.assert_allclose(out[b, :rows].numpy(), np.asarray(ref)[b, :rows], atol=ATOL, rtol=0)
    routed = t_paged.paged_prefill_attention(_t(q), _t(kp), _t(vp), _t(kv_len), _t(tables), _t(q_offset))
    assert torch.equal(routed, out)  # the dispatcher's default route is K14
    plain = t_paged.paged_prefill_attention(_t(q), _t(kp), _t(vp), _t(kv_len), _t(tables), _t(q_offset),
                                            impl="plain")
    for b in range(B):
        rows = int(kv_len[b] - q_offset[b])
        np.testing.assert_allclose(plain[b, :rows].numpy(), out[b, :rows].numpy(), atol=ATOL, rtol=0)


def test_commit_pages_matches_pallas_bitwise_with_duplicate_parking():
    """K15: M whole pages written in place; two chunks go to the parking
    page (garbage by contract: it holds one of them), every other byte
    equals the Pallas commit; the strided [G, C, ...] chunk view commits the
    same as its contiguous copy."""
    from omchat_tpu.ops.paged_attention import commit_pages

    rng = np.random.default_rng(24)
    NP, KVH, PS, D = 10, 2, 8, 32
    parking = NP - 1
    kp, vp = _np(rng, NP, KVH, PS, D), _np(rng, NP, KVH, PS, D)
    pages = np.asarray([3, parking, 0, 7, parking, 5], np.int32)
    kc, vc = _np(rng, 6, KVH, PS, D), _np(rng, 6, KVH, PS, D)
    ref_k, ref_v = commit_pages(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pages), jnp.asarray(kc),
                                jnp.asarray(vc), interpret=True)
    tk, tv = _t(kp.copy()), _t(vp.copy())
    out_k, out_v = t_paged.commit_pages(tk, tv, _t(pages), _t(kc), _t(vc))
    assert out_k is tk and out_v is tv  # in place
    real = np.arange(NP) != parking
    np.testing.assert_array_equal(tk.numpy()[real], np.asarray(ref_k)[real])
    np.testing.assert_array_equal(tv.numpy()[real], np.asarray(ref_v)[real])
    assert any(np.array_equal(tk.numpy()[parking], kc[i]) for i in (1, 4))
    # the engine's layout: a scratch cache [G, KVH, C*PS, D] seen as [G, C, KVH, PS, D]
    scratch = _t(_np(rng, 2, KVH, 3 * PS, D))
    view = scratch.view(2, KVH, 3, PS, D).transpose(1, 2)
    dest = _t(np.asarray([1, 2, 4, 6, 8, 3], np.int32))
    a, b = _t(kp.copy()), _t(kp.copy())
    t_paged.commit_pages(a, a.clone(), dest, view, view)
    t_paged.commit_pages(b, b.clone(), dest, view.reshape(6, KVH, PS, D).contiguous(), view.reshape(6, KVH, PS, D))
    assert torch.equal(a, b)
    assert torch.equal(a[4], scratch[0, :, 2 * PS:3 * PS])  # chunk (g=0, c=2) → page 4


def test_page_allocator():
    a = t_paged.PageAllocator(4)
    p1, p2 = a.alloc(2), a.alloc(2)
    assert sorted(p1 + p2) == [0, 1, 2, 3]
    with pytest.raises(MemoryError):
        a.alloc(1)
    a.release(p1)
    assert a.available == 2
    from omchat_tpu.ops.paged_attention import PageAllocator

    j = PageAllocator(5)
    t = t_paged.PageAllocator(5)
    assert [j.alloc(2), j.alloc(1)] == [t.alloc(2), t.alloc(1)]  # the same pages in the same order


@pytest.mark.parametrize("which", ["paged_flash_decode", "paged_flash_prefill", "commit_pages"])
def test_paged_wrappers_never_fall_back_off_the_cpu(which):
    """A tensor that is not on the CPU launches the kernel or raises — here
    (no CUDA device) a meta tensor must raise, not take the plain version."""
    m = lambda *s: torch.empty(*s, device="meta", dtype=torch.bfloat16)  # noqa: E731
    i32 = torch.zeros((1, 1), dtype=torch.int32)
    calls = {
        "paged_flash_decode": lambda: t_paged.paged_flash_decode(
            m(1, 1, 2, 128), m(2, 2, 128, 128), m(2, 2, 128, 128), i32[0], i32, m(1, 2, 128), m(1, 2, 128)),
        "paged_flash_prefill": lambda: t_paged.paged_flash_prefill(
            m(1, 128, 2, 128), m(2, 2, 128, 128), m(2, 2, 128, 128), i32[0], i32, i32[0]),
        "commit_pages": lambda: t_paged.commit_pages(
            m(2, 2, 128, 128), m(2, 2, 128, 128), i32[0], m(1, 2, 128, 128), m(1, 2, 128, 128)),
    }
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        calls[which]()


# ---------------------------------------------------------------------------
# sampling thresholds
# ---------------------------------------------------------------------------


def _logits(seed=25, b=4, v=64):
    return (np.random.default_rng(seed).standard_normal((b, v)) * 2).astype(np.float32)


def _mid_top_p(logits: np.ndarray, temperature: float = 1.0) -> np.ndarray:
    """Per-row top-p values halfway between two consecutive cumulative
    probabilities, so float32 summation order cannot move the cut."""
    s = -np.sort(-logits.astype(np.float64) / temperature, axis=-1)
    p = np.exp(s - s.max(-1, keepdims=True))
    cum = np.cumsum(p / p.sum(-1, keepdims=True), axis=-1)
    ranks = np.arange(logits.shape[0]) % 5 + 1
    return np.asarray([(cum[i, r - 1] + cum[i, r]) / 2 for i, r in enumerate(ranks)], np.float32)


@pytest.mark.parametrize("k", [0, 1, 5])
def test_apply_top_k_matches_jax_exactly(k):
    from omchat_tpu.ops.sampling import apply_top_k

    x = _logits()
    np.testing.assert_array_equal(t_sampling.apply_top_k(_t(x), k).numpy(), np.asarray(apply_top_k(jnp.asarray(x), k)))


def test_apply_top_p_matches_jax_exactly():
    from omchat_tpu.ops.sampling import apply_top_p

    x = _logits()
    for p in list(_mid_top_p(x)) + [1.0]:
        np.testing.assert_array_equal(t_sampling.apply_top_p(_t(x), float(p)).numpy(),
                                      np.asarray(apply_top_p(jnp.asarray(x), float(p))))


def test_sample_batch_thresholds_match_jax_exactly(monkeypatch):
    """The kept set of every row (per-row temperature, top-k, top-p) equals
    the JAX package's: its categorical draw is replaced by the count of
    finite logits it was handed."""
    from omchat_tpu.ops.sampling import sample_batch

    x = _logits(b=6)
    temperature = np.asarray([1.0, 0.5, 2.0, 1.0, 0.7, 1.3], np.float32)
    top_k = np.asarray([0, 3, 0, 10, 1, 7], np.int32)
    top_p = _mid_top_p(x / temperature[:, None])
    top_p[0] = 1.0
    monkeypatch.setattr(jax.random, "categorical", lambda key, l: jnp.isfinite(l).sum().astype(jnp.int32))
    want = np.asarray(sample_batch(jnp.asarray(x), jax.random.PRNGKey(0), jnp.ones(6, bool), jnp.asarray(temperature),
                                   jnp.asarray(top_k), jnp.asarray(top_p)))
    kept = t_sampling.sample_batch_logits(_t(x), _t(temperature), _t(top_k), _t(top_p))
    np.testing.assert_array_equal(torch.isfinite(kept).sum(-1).numpy(), want)
    finite = torch.isfinite(kept)
    np.testing.assert_array_equal(kept[finite].numpy(), (x / temperature[:, None])[finite.numpy()])


def test_sample_batch_top_k1_is_greedy_and_seeded_draws_repeat():
    x = _t(_logits(b=8, v=128))
    b = x.shape[0]
    ones, zeros = torch.ones(b), torch.zeros(b, dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    top1 = t_sampling.sample_batch(x, g, torch.ones(b, dtype=torch.bool), ones * 0.8, zeros + 1, ones)
    assert torch.equal(top1, t_sampling.greedy(x))
    draws = [t_sampling.sample_batch(x, torch.Generator().manual_seed(7), torch.ones(b, dtype=torch.bool), ones,
                                     zeros, ones * 0.9) for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    mixed = t_sampling.sample_batch(x, g, torch.arange(b) % 2 == 0, ones, zeros, ones)
    assert torch.equal(mixed[1::2], t_sampling.greedy(x)[1::2])  # greedy rows take the argmax
