"""Page sizes other than 128: the paged kernels' plain versions on the CPU
against the JAX package's Pallas kernels in interpret mode at page sizes
16, 32 and 64 (K12, K13, K14 over float32 and e4m3 pools; K15 bitwise at 16
and 32), the CPU ``PagedBatchEngine`` at those page sizes against the JAX
engine, and the refusal of a page size the CUDA kernels are not built for.

Same seeded numpy inputs on both sides, float32 queries; attention
tolerance atol 1e-5 (float32 round-off of differently ordered sums), page
commits bitwise, engine tokens identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.config import OmChatConfig as TOmChatConfig
from omchat_torch.ops import paged_attention as t_paged
from omchat_torch.ops.fp8 import to_e4m3
from omchat_torch.runtime.paged_engine import PagedBatchEngine as TPagedEngine

ATOL = 1e-5
PAGE_SIZES = (16, 32, 64)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pool_and_tables(rng, B, W, PS, KVH, D, lengths):
    """A pool with a parking page (the last), tables mapping each request's
    live pages to shuffled pool pages and parking past them."""
    P = sum(-(-int(n) // PS) for n in lengths) + 2
    kp, vp = _np(rng, P + 1, KVH, PS, D), _np(rng, P + 1, KVH, PS, D)
    perm = rng.permutation(P)
    tables = np.full((B, W), P, np.int32)
    used = 0
    for b, n in enumerate(lengths):
        live = -(-int(n) // PS)
        tables[b, :live] = perm[used: used + live]
        used += live
    return kp, vp, tables


def test_the_cuda_kernels_take_these_page_sizes():
    assert t_paged.PAGE_SIZES == (16, 32, 64, 128)


@pytest.mark.parametrize("pool", ["float32", "e4m3"])
@pytest.mark.parametrize("kernel", ["auto", "manual"], ids=["k12", "k13"])
@pytest.mark.parametrize("PS", PAGE_SIZES)
def test_paged_decode_at_page_size_matches_pallas(PS, kernel, pool):
    """K12 / K13 with a self column: lengths 0, one row, a page boundary, a
    stage boundary (128) and a partly filled last page."""
    from omchat_tpu.ops.paged_attention import paged_flash_decode, paged_flash_decode_manual

    rng = np.random.default_rng(51 + PS)
    B, H, KVH, D = 5, 8, 2, 128
    lengths = np.asarray([0, 1, PS, 128, 3 * PS + 5], np.int32)
    W = max(-(-int(n) // PS) for n in lengths) + 1
    kp, vp, tables = _pool_and_tables(rng, B, W, PS, KVH, D, lengths)
    q, kn, vn = _np(rng, B, 1, H, D), _np(rng, B, KVH, D), _np(rng, B, KVH, D)
    jk, jv, tk, tv = jnp.asarray(kp), jnp.asarray(vp), _t(kp), _t(vp)
    if pool == "e4m3":
        jk, jv = jk.astype(jnp.float8_e4m3fn), jv.astype(jnp.float8_e4m3fn)
        tk, tv = to_e4m3(tk), to_e4m3(tv)
    jfn = {"auto": paged_flash_decode, "manual": paged_flash_decode_manual}[kernel]
    ref = jfn(jnp.asarray(q), jk, jv, jnp.asarray(lengths), jnp.asarray(tables), jnp.asarray(kn), jnp.asarray(vn),
              interpret=True)
    out = t_paged.DECODE_KERNELS[kernel](_t(q), tk, tv, _t(lengths), _t(tables), _t(kn), _t(vn))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("pool", ["float32", "e4m3"])
@pytest.mark.parametrize("PS", PAGE_SIZES)
def test_paged_prefill_at_page_size_matches_pallas(PS, pool):
    """K14: page-aligned q_offset, a chunk that ends inside a page, a table
    wider than the chunk needs."""
    from omchat_tpu.ops.paged_attention import paged_flash_prefill

    rng = np.random.default_rng(61 + PS)
    B, H, KVH, D, C = 2, 8, 2, 128, 64
    q_offset = np.asarray([PS, 2 * PS], np.int32)
    kv_len = q_offset + np.asarray([C, C - 9], np.int32)
    W = -(-int(kv_len.max()) // PS) + 1
    kp, vp, tables = _pool_and_tables(rng, B, W, PS, KVH, D, kv_len)
    q = _np(rng, B, C, H, D)
    jk, jv, tk, tv = jnp.asarray(kp), jnp.asarray(vp), _t(kp), _t(vp)
    if pool == "e4m3":
        jk, jv = jk.astype(jnp.float8_e4m3fn), jv.astype(jnp.float8_e4m3fn)
        tk, tv = to_e4m3(tk), to_e4m3(tv)
    ref = np.asarray(paged_flash_prefill(jnp.asarray(q), jk, jv, jnp.asarray(kv_len), jnp.asarray(tables),
                                         jnp.asarray(q_offset), block_q=32, interpret=True))
    out = t_paged.paged_flash_prefill(_t(q), tk, tv, _t(kv_len), _t(tables), _t(q_offset))
    for b in range(B):
        rows = int(kv_len[b] - q_offset[b])  # rows past this are padding in both
        np.testing.assert_allclose(out[b, :rows].numpy(), ref[b, :rows], atol=ATOL, rtol=0)


@pytest.mark.parametrize("PS", [16, 32])
def test_commit_pages_at_page_size_matches_pallas_bitwise(PS):
    """K15 at page sizes below 64: whole pages in place, the engine's strided
    [G, C, KVH, PS, D] chunk view, bitwise the Pallas commit."""
    from omchat_tpu.ops.paged_attention import commit_pages

    rng = np.random.default_rng(71 + PS)
    NP, KVH, D, G, C = 12, 2, 128, 2, 3
    kp, vp = _np(rng, NP, KVH, PS, D), _np(rng, NP, KVH, PS, D)
    scratch_k, scratch_v = _np(rng, G, KVH, C * PS, D), _np(rng, G, KVH, C * PS, D)
    pages = np.asarray([3, 0, 7, 5, 10, 1], np.int32)
    chunks = [s.reshape(G, KVH, C, PS, D).transpose(0, 2, 1, 3, 4).reshape(G * C, KVH, PS, D)
              for s in (scratch_k, scratch_v)]
    ref_k, ref_v = commit_pages(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pages), jnp.asarray(chunks[0]),
                                jnp.asarray(chunks[1]), interpret=True)
    tk, tv = _t(kp.copy()), _t(vp.copy())
    view = [_t(s).view(G, KVH, C, PS, D).transpose(1, 2) for s in (scratch_k, scratch_v)]
    t_paged.commit_pages(tk, tv, _t(pages), *view)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(ref_k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(ref_v))


MAX_NEW = 6
# the settings of tests/test_torch_paged_engine.py scaled to each page size:
# prompt buckets and chunks a whole number of pages, about as many pool rows
ENGINES = {16: dict(max_slots=4, num_pages=24, page_size=16, prompt_bucket=16, max_len=96, prefill_chunk=32),
           32: dict(max_slots=4, num_pages=14, page_size=32, prompt_bucket=32, max_len=96, prefill_chunk=32),
           64: dict(max_slots=4, num_pages=10, page_size=64, prompt_bucket=64, max_len=96, prefill_chunk=64)}


@pytest.mark.parametrize("PS", PAGE_SIZES)
def test_paged_engine_at_page_size_matches_jax(PS, monkeypatch):
    """The tiny model's mixed workload on the CPU engine (K12 / K14 / K15's
    plain versions) gives the JAX engine's greedy tokens at the same page
    size, and every page comes back."""
    from omchat_tpu.config import GenerationConfig as JGenerationConfig
    from omchat_tpu.config import OmChatConfig
    from omchat_tpu.runtime.paged_engine import PagedBatchEngine
    from tests.test_sharding import _tiny_params
    from tests.test_torch_paged_engine import _workload

    cfg = OmChatConfig.tiny()
    params = _tiny_params(cfg)
    jeng = PagedBatchEngine(cfg, params, attn_impl="xla", decode_roll=2, **ENGINES[PS])
    gen = JGenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-1)
    rids = [jeng.submit(ids, px, max_new_tokens=MAX_NEW, eos_token_id=-1, generation=gen) for ids, px in _workload()]
    jeng.run_to_completion(max_ticks=200)
    want = [jeng.result(r) for r in rids]

    seen = []
    decode = t_paged.paged_flash_decode
    monkeypatch.setattr(t_paged, "paged_flash_decode", lambda *a, **kw: seen.append(a[1].shape[2]) or decode(*a, **kw))
    monkeypatch.setitem(t_paged.DECODE_KERNELS, "auto", t_paged.paged_flash_decode)
    eng = TPagedEngine(TOmChatConfig.tiny(), from_jax_params(jax.device_get(params)), device="cpu", decode_roll=2,
                       **ENGINES[PS])
    rids = [eng.submit(ids, px, max_new_tokens=MAX_NEW, eos_token_id=-1) for ids, px in _workload()]
    assert eng.run_to_completion(max_ticks=200) < 200
    assert [eng.result(r) for r in rids] == want
    assert eng.allocator.available == ENGINES[PS]["num_pages"]
    assert seen and set(seen) == {PS}  # the decode attention read pages of this size


@pytest.mark.parametrize("page_size", [48, 8, 256])
def test_cuda_engine_refuses_other_page_sizes_before_allocating(page_size, monkeypatch):
    """A CUDA engine (the default device) refuses a page size the paged
    kernels are not built for, naming the sizes they take, before it
    touches the device — so this runs without CUDA.  A CPU engine takes any
    page size (tests/test_torch_paged_engine.py runs at 8)."""
    monkeypatch.setattr(torch, "zeros", lambda *a, **kw: pytest.fail("allocated before the page-size check"))
    params = {"language_model": {"embed_tokens": torch.empty(2, 2)}}
    for device in (None, "cuda", torch.device("cuda", 0)):
        with pytest.raises(ValueError, match=r"\(16, 32, 64, 128\)"):
            TPagedEngine(TOmChatConfig.tiny(), params, page_size=page_size, prompt_bucket=4 * page_size,
                         prefill_chunk=4 * page_size, device=device)
