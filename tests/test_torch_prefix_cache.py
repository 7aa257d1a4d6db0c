"""The port's prefix cache on the CPU against the JAX package's: the port's
own copy of ``runtime/prefix_cache.py`` gives bitwise the JAX copy's page
digests (with and without an image key), and the port's ``PagedBatchEngine``
with ``prefix_cache=True`` gives the JAX engine's tokens, hits, published
pages and free pages on every case of ``tests/test_prefix_cache.py``: a hit
and its output, concurrent twins, eviction under pressure, shared pages never
corrupted by decode, a soak, the hit suffixes batched into one chunk
dispatch, multi-turn VQA reusing the image's pages, no false hit on another
image; and on an e4m3 pool.  Both engines run ``OmChatConfig.tiny()``'s
float32 weights (XLA attention on the JAX side, the kernels' plain versions
on the port's).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.config import OmChatConfig as TOmChatConfig
from omchat_torch.constants import IMAGE_TOKEN_INDEX
from omchat_torch.ops.fp8 import E4M3
from omchat_torch.runtime import prefix_cache as tpc
from omchat_torch.runtime.paged_engine import PagedBatchEngine as TPagedEngine

# tests/test_prefix_cache.py's engine settings
ENGINE = dict(max_slots=2, num_pages=16, page_size=8, prompt_bucket=16, max_len=96, prefix_cache=True)


@pytest.fixture(scope="module")
def setup():
    from omchat_tpu.config import OmChatConfig
    from tests.test_sharding import _tiny_params

    cfg = OmChatConfig.tiny()
    params = _tiny_params(cfg)
    return cfg, params, from_jax_params(jax.device_get(params))


def _engines(setup, **kw):
    """(the JAX engine, the port's) with ``ENGINE`` updated by ``kw``."""
    from omchat_tpu.runtime.paged_engine import PagedBatchEngine

    cfg, params, tparams = setup
    opts = {**ENGINE, **kw}
    jax_kw = {**opts, "cache_dtype": jnp.float8_e4m3fn} if opts.get("cache_dtype") is not None else opts
    return (PagedBatchEngine(cfg, params, attn_impl="xla", **jax_kw),
            TPagedEngine(TOmChatConfig.tiny(), tparams, device="cpu", **opts))


def _both(setup, script, **kw):
    """Run ``script(engine)`` on both engines; returns (JAX's, the port's)
    results, each with the engine's prefix-cache stats and free pages."""
    out = []
    for eng in _engines(setup, **kw):
        got = script(eng)
        out.append((got, eng.prefix_cache.stats(), eng.allocator.available))
    return out


def _serve(eng, ids, images=None, max_new=6):
    rid = eng.submit(list(ids), images, max_new_tokens=max_new, eos_token_id=-1)
    eng.run_to_completion(max_ticks=400)
    return eng.result(rid)


# -- the digests --------------------------------------------------------------


@pytest.mark.parametrize("case", ["text", "cut_at_image", "image_key", "other_image_key", "decode_page"])
def test_page_hashes_bitwise_jax(case):
    from omchat_tpu.runtime import prefix_cache as jpc

    ids = np.arange(100, 133, dtype=np.int32)
    isi = np.array([False] * 12 + [True] * 10 + [False] * 11)
    idx = np.array([0] * 12 + list(range(10)) + [0] * 11, np.int32)
    args = {
        "text": ((ids, 33, 8), {}),
        "cut_at_image": ((ids, 33, 8, 12), {}),
        "image_key": ((ids, 33, 8, 12), dict(image_key="imgA", is_image=isi, image_index=idx)),
        "other_image_key": ((ids, 33, 8, 12), dict(image_key="imgB", is_image=isi, image_index=idx)),
        "decode_page": ((ids[:32], 32, 8), {}),
    }[case]
    got = tpc.page_hashes(*args[0], **args[1])
    assert got and got == jpc.page_hashes(*args[0], **args[1])


def test_page_cache_refcounts_match_jax():
    from omchat_tpu.runtime import prefix_cache as jpc

    seen = []
    for mod in (jpc, tpc):
        c = mod.PrefixPageCache()
        h = mod.page_hashes(list(range(24)), 24, 8)
        steps = [c.publish(h[0], 5), c.publish(h[1], 9), c.publish(h[0], 6), c.lookup(h[:2]), c.evictable]
        for p in (5, 9, 5, 9):
            c.unref(p)
        steps += [c.evictable, c.evict(1), c.lookup(h[:2]), c.stats(), c.flush(), c.stats()]
        seen.append(steps)
    assert seen[0] == seen[1]


# -- the engine ---------------------------------------------------------------


def test_second_request_hits_and_output_matches(setup):
    prefix = [int(t) for t in np.random.default_rng(0).integers(5, 60, 24)]

    def script(eng):
        a = _serve(eng, prefix + [61, 62, 63])
        cached = eng.prefix_cache.stats()["pages_cached"]
        starts = []
        orig = eng._prefill_tick
        eng._prefill_tick = lambda req: (starts.append(req.chunk_pos), orig(req))[1]
        return a, cached, _serve(eng, prefix + [64, 65]), starts[:1]

    (want, jstats, jfree), (got, stats, free) = _both(setup, script)
    assert got == want and stats == jstats and free == jfree
    assert got[1] == 3 and got[3] == [24] and stats["hits"] >= 3


def test_concurrent_twins_are_correct(setup):
    prefix = [int(t) for t in np.random.default_rng(1).integers(5, 60, 16)]

    def script(eng):
        rids = [eng.submit(prefix + [t], None, max_new_tokens=5, eos_token_id=-1) for t in (33, 44)]
        eng.run_to_completion(max_ticks=300)
        return [eng.result(r) for r in rids]

    (want, jstats, jfree), (got, stats, free) = _both(setup, script, num_pages=24)
    assert got == want and stats == jstats and free == jfree
    assert stats["pages_cached"] == 2  # one twin published each page


def test_cache_pages_evict_under_pressure(setup):
    def script(eng):
        rng = np.random.default_rng(2)
        outs = [_serve(eng, [int(t) for t in rng.integers(5, 60, 17)], max_new=2) for _ in range(3)]
        cached, free0 = eng.prefix_cache.stats()["pages_cached"], eng.allocator.available
        ids = [int(t) for t in rng.integers(5, 60, 52)]
        assert eng._n_pages_for(52 + 4 + eng.decode_roll - 1) > free0  # it needs evictions
        return outs, cached, _serve(eng, ids, max_new=4)

    (want, jstats, jfree), (got, stats, free) = _both(setup, script, num_pages=12, max_slots=1)
    assert got == want and stats == jstats and free == jfree
    assert got[1] >= 6 and stats["pages_cached"] <= got[1] + 5


def test_decode_never_corrupts_shared_pages(setup):
    prefix = [int(t) for t in np.random.default_rng(3).integers(5, 60, 16)]

    def script(eng):
        ra = eng.submit(prefix + [10], None, max_new_tokens=20, eos_token_id=-1)
        for _ in range(3):  # A prefills, publishes and decodes a few tokens
            eng.step()
        rb = eng.submit(prefix + [11, 12], None, max_new_tokens=5, eos_token_id=-1)
        eng.run_to_completion(max_ticks=400)
        return eng.result(ra), eng.result(rb)

    (want, jstats, jfree), (got, stats, free) = _both(setup, script, num_pages=24)
    assert got == want and stats == jstats and free == jfree


def test_soak_with_prefix_cache(setup):
    rng = np.random.default_rng(4)
    prefixes = [[int(t) for t in rng.integers(5, 60, n)] for n in (16, 24)]
    reqs = [(prefixes[i % 2] + [int(t) for t in rng.integers(5, 60, int(rng.integers(1, 6)))], int(rng.integers(1, 8)))
            for i in range(8)]

    def script(eng):
        rids = []
        for j, (ids, max_new) in enumerate(reqs):
            rids.append(eng.submit(ids, None, max_new_tokens=max_new, eos_token_id=-1))
            if j % 3 == 2:
                eng.step()
                eng.step()
        eng.run_to_completion(max_ticks=2000)
        out = [eng.result(r) for r in rids]
        eng.allocator.release(eng.prefix_cache.flush())
        return out, eng.allocator.available

    (want, jstats, _), (got, stats, _) = _both(setup, script, num_pages=32, max_slots=3, decode_roll=3)
    assert got == want and stats == jstats
    assert got[1] == 32 and stats["pages_cached"] == 0


def test_prefix_hit_suffixes_batch_into_one_dispatch(setup):
    shared = list(range(200, 216))
    reqs = [shared + [300 + i, 301 + i, 302 + i] for i in range(3)]

    def script(eng):
        seed = eng.submit(list(reqs[0]), None, max_new_tokens=1, eos_token_id=-1)  # the pages the wave hits
        eng.run_to_completion(max_ticks=100)
        eng.pop_result(seed)
        calls = []
        orig = eng._prefill_chunk_group
        eng._prefill_chunk_group = lambda rs: (calls.append(len(rs)), orig(rs))[1]
        rids = [eng.submit(list(ids), None, max_new_tokens=4, eos_token_id=-1) for ids in reqs]
        eng.run_to_completion(max_ticks=200)
        return [eng.result(r) for r in rids], calls

    (want, jstats, jfree), (got, stats, free) = _both(setup, script, max_slots=4, num_pages=24)
    assert got == want and stats == jstats and free == jfree
    assert got[1] and max(got[1]) >= 2  # the suffixes rode one batched dispatch


def _vqa_turns(cfg, rng):
    img = rng.standard_normal((1, 3, 56, 56)).astype(np.float32)
    turn1 = [5, 6, IMAGE_TOKEN_INDEX] + [int(t) for t in rng.integers(5, 60, 12)]
    return img, turn1, turn1 + [int(t) for t in rng.integers(5, 60, 9)]


@pytest.mark.parametrize("pool", ["bf16", "e4m3"])
def test_multiturn_vqa_reuses_image_pages(setup, pool):
    """Turn 2 resends turn 1's image and text: its prefill resumes past the
    image rows, every row of its resumed chunk a text row whose image index
    must still point into the request's features."""
    cfg = setup[0]
    img, turn1, turn2 = _vqa_turns(cfg, np.random.default_rng(0))

    def script(eng):
        a = _serve(eng, turn1, img, max_new=4)
        hits0 = eng.prefix_cache.stats()["hits"]
        b = _serve(eng, turn2, img.copy(), max_new=4)
        return a, b, eng.prefix_cache.stats()["hits"] - hits0

    kw = dict(num_pages=32, max_len=128, cache_dtype=E4M3 if pool == "e4m3" else None)
    (want, jstats, jfree), (got, stats, free) = _both(setup, script, **kw)
    assert got == want and stats == jstats and free == jfree
    assert got[2] * 8 > 3 + cfg.image_seq_len  # the hit covers the image's rows


def test_different_image_no_false_hit(setup):
    rng = np.random.default_rng(5)
    ids = [5, 6, IMAGE_TOKEN_INDEX] + [int(t) for t in rng.integers(5, 60, 12)]
    img_a, img_b = (rng.standard_normal((1, 3, 56, 56)).astype(np.float32) for _ in range(2))

    def script(eng):
        a = _serve(eng, ids, img_a, max_new=4)
        hits0 = eng.prefix_cache.stats()["hits"]
        return a, _serve(eng, ids, img_b, max_new=4), eng.prefix_cache.stats()["hits"] - hits0

    (want, jstats, jfree), (got, stats, free) = _both(setup, script, num_pages=32, max_len=128)
    assert got == want and stats == jstats and free == jfree
    assert got[2] * 8 <= 3  # at most the page before the image


def test_e4m3_pool_hit_matches_jax(setup):
    """A hit resumes on an e4m3 pool: the resumed chunk's attention (K14's
    plain version) reads e4m3 pages another request wrote and does not round
    p, as the JAX engine's XLA attention does not."""
    prefix = [int(t) for t in np.random.default_rng(6).integers(5, 60, 24)]

    def script(eng):
        return _serve(eng, prefix + [61, 62, 63]), _serve(eng, prefix + [64, 65])

    (want, jstats, jfree), (got, stats, free) = _both(setup, script, cache_dtype=E4M3)
    assert got == want and stats == jstats and free == jfree
    assert stats["hits"] >= 3


def test_prefix_cache_reaches_the_engine_stats(setup):
    _, port = _engines(setup)
    assert {"prefix_cache_pages_cached", "prefix_cache_evictable", "prefix_cache_hits",
            "prefix_cache_misses"} <= set(port.stats())
    assert port.k_pool.dtype == torch.float32
