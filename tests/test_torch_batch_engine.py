"""The port's slot continuous-batching engine on the CPU against the JAX
package's ``BatchEngine``: the same ``OmChatConfig.tiny()`` float32 weights
(``from_jax_params``), every case of ``tests/test_batch_engine.py`` run on
both engines with identical greedy token ids (interleaved with an image, a
late join, more requests than slots, a cancel freeing its slot, the e4m3
shared cache), the same ``stats()`` keys and the same refusals; one decode
step's logits, parked row included, within 1e-5 of
``_batch_decode_step_jit``'s (read under ``jax.disable_jit()``); sampled
rows deterministic by seed beside undisturbed greedy rows; ``precompile``
leaving the draws unchanged; and the serving options that wait for later
slices.
"""

import numpy as np
import pytest
import torch

import jax

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.config import GenerationConfig as TGen
from omchat_torch.config import OmChatConfig as TOmChatConfig
from omchat_torch.constants import IMAGE_TOKEN_INDEX
from omchat_torch.ops.fp8 import E4M3
from omchat_torch.runtime import batch_engine as tbe

LOGIT_TOL = 1e-5  # fp32 on both sides; the two packages sum in other orders


@pytest.fixture(scope="module")
def setup():
    """(JAX config, JAX params, the port's params)."""
    from omchat_tpu.config import OmChatConfig
    from tests.test_sharding import _tiny_params

    cfg = OmChatConfig.tiny()
    params = _tiny_params(cfg)
    return cfg, params, from_jax_params(jax.device_get(params))


def _engines(setup, impl=None, **kw):
    """(the JAX BatchEngine on XLA attention, the port's on the CPU)."""
    from omchat_tpu.runtime.batch_engine import BatchEngine

    cfg, params, tparams = setup
    return (BatchEngine(cfg, params, attn_impl="xla", **kw),
            tbe.BatchEngine(TOmChatConfig.tiny(), tparams, device="cpu", attn_impl=impl, **kw))


def _run_both(setup, reqs, max_new, impl=None, **kw):
    """Every request submitted at once on both engines, run to completion:
    (JAX tokens, the port's tokens, the port's engine)."""
    out = []
    engines = _engines(setup, impl, **kw)
    for be in engines:
        rids = [be.submit(ids, images, max_new_tokens=max_new, eos_token_id=-1) for ids, images in reqs]
        assert be.run_to_completion(max_ticks=1000) < 1000
        assert all(be.finished(r) for r in rids)
        out.append([be.result(r) for r in rids])
    return out[0], out[1], engines[1]


@pytest.mark.parametrize("impl", [None, "plain"])
def test_interleaved_with_an_image_matches_jax(setup, impl):
    rng = np.random.default_rng(0)
    reqs = [
        ([5, 6, 7, 8, 9, 10], None),
        ([11, 12, 13], None),
        ([5, 6, IMAGE_TOKEN_INDEX, 7], rng.standard_normal((1, 3, 56, 56)).astype(np.float32)),
    ]
    want, got, eng = _run_both(setup, reqs, 6, impl, max_slots=2, max_len=128, chunk_size=16)
    assert got == want and all(len(t) == 6 for t in got)
    assert eng.steps_eager > 0 and eng.steps_graphed == 0  # a CPU engine runs the step body eagerly
    assert not eng.has_work() and all(s is None for s in eng.slots)


def test_late_join_matches_jax(setup):
    a, b = [5, 6, 7, 8, 9, 10], [20, 21, 22, 23]
    got = []
    for be in _engines(setup, max_slots=2, max_len=128, chunk_size=16):
        ra = be.submit(a, None, max_new_tokens=8, eos_token_id=-1)
        for _ in range(4):  # A decodes a few tokens alone
            be.step()
        assert len(be.requests[ra].generated) >= 2
        rb = be.submit(b, None, max_new_tokens=8, eos_token_id=-1)
        be.run_to_completion(max_ticks=500)
        got.append((be.result(ra), be.result(rb)))
    assert got[1] == got[0]
    # the joiner leaves A's tokens as A alone makes them
    _, alone, _ = _run_both(setup, [(a, None)], 8, max_slots=2, max_len=128, chunk_size=16)
    assert got[1][0] == alone[0]


def test_more_requests_than_slots_matches_jax(setup):
    reqs = [([10 + i, 20 + i, 30 + i], None) for i in range(5)]
    want, got, eng = _run_both(setup, reqs, 4, max_slots=2, max_len=64, chunk_size=16)
    assert got == want and all(len(t) == 4 for t in got)
    assert not eng.queue and eng.stats()["slots_busy"] == 0


def test_cancel_frees_the_slot_like_jax(setup):
    got = []
    for be in _engines(setup, max_slots=2, max_len=64, chunk_size=16):
        r1 = be.submit([5, 6, 7, 8], None, max_new_tokens=40, eos_token_id=-1)
        r2 = be.submit([9, 10, 11], None, max_new_tokens=4, eos_token_id=-1)
        for _ in range(3):
            be.step()
        be.cancel(r1)
        be.run_to_completion(max_ticks=300)
        assert be.finished(r1) and be.finished(r2)
        assert len(be.result(r1)) < 40 and len(be.result(r2)) == 4
        r3 = be.submit([12, 13], None, max_new_tokens=3, eos_token_id=-1)
        r4 = be.submit([14, 15], None, max_new_tokens=3, eos_token_id=-1)
        be.cancel(r4)  # cancelled while queued: done at the next tick, never admitted
        be.run_to_completion(max_ticks=300)
        assert be.finished(r4) and be.result(r4) == []
        got.append([be.result(r) for r in (r1, r2, r3)])
    assert got[1] == got[0] and len(got[1][2]) == 3


def test_fp8_shared_cache_matches_jax(setup):
    import jax.numpy as jnp

    from omchat_tpu.runtime.batch_engine import BatchEngine

    cfg, params, tparams = setup
    reqs = [([5, 6, 7, 8], None), ([9, 10, 11], None)]
    runs = {}
    for name, be in (("jax", BatchEngine(cfg, params, max_slots=2, max_len=64, attn_impl="xla", chunk_size=16,
                                         cache_dtype=jnp.float8_e4m3fn)),
                     ("port", tbe.BatchEngine(TOmChatConfig.tiny(), tparams, max_slots=2, max_len=64,
                                              chunk_size=16, cache_dtype=E4M3, device="cpu"))):
        rids = [be.submit(ids, None, max_new_tokens=4, eos_token_id=-1) for ids, _ in reqs]
        be.run_to_completion(max_ticks=300)
        runs[name] = [be.result(r) for r in rids]
        if name == "port":
            assert be.cache.k.dtype == E4M3 and be.cache.v.dtype == E4M3
    assert runs["port"] == runs["jax"] and all(len(t) == 4 for t in runs["port"])
    # the JAX oracle's own check: the first token matches the bf16-cache engine's
    _, bf16, _ = _run_both(setup, reqs, 4, max_slots=2, max_len=64, chunk_size=16)
    assert [t[0] for t in runs["port"]] == [t[0] for t in bf16]


@pytest.mark.parametrize("image_cache_size", [8, 0])
def test_stats_keys_match_jax(setup, image_cache_size):
    rng = np.random.default_rng(1)
    img = rng.standard_normal((1, 3, 56, 56)).astype(np.float32)
    stats = []
    for be in _engines(setup, max_slots=2, max_len=64, chunk_size=16, image_cache_size=image_cache_size):
        for _ in range(2):  # the second submit of the image is a cache hit where there is a cache
            be.submit([5, IMAGE_TOKEN_INDEX, 6], img, max_new_tokens=2, eos_token_id=-1)
        be.submit([7, 8], None, max_new_tokens=2, eos_token_id=-1)
        be.step()
        stats.append(be.stats())
    assert stats[1] == stats[0]
    assert {"slots_busy", "slots_total", "queue_depth"} <= set(stats[1])


def test_refusals_match_jax(setup):
    for be in _engines(setup, max_slots=2, max_len=32, chunk_size=16):
        with pytest.raises(ValueError, match="exceeds max_len"):
            be.submit(list(range(5, 35)), None, max_new_tokens=4)  # 30 rows + 4 new > 32
        with pytest.raises(ValueError, match="exceeds max_len"):
            be.submit([5, 6], None, max_new_tokens=40)
        with pytest.raises(ValueError, match="adapter_id"):
            be.submit([5, 6], None, max_new_tokens=2, adapter_id=1)  # no bank
        assert not be.queue and not be.requests


def _record_lm_head(monkeypatch, module, seen, rows):
    """Wrap ``module.lm_head`` to record the decode step's logits ([rows, 1, V])."""
    orig = module.lm_head

    def spy(params, cfg, hidden):
        out = orig(params, cfg, hidden)
        if hidden.ndim == 3 and hidden.shape[0] == rows:
            seen.append(np.asarray(out)[:, 0])
        return out

    monkeypatch.setattr(module, "lm_head", spy)


def test_decode_step_logits_with_a_parked_row_match_jax(setup, monkeypatch):
    """Each decode step's logits over 3 slots, slot 2 never used (parked:
    its write at the last row, attending to its own token alone) and slot 1
    parked while its request prefills: every row within LOGIT_TOL of the
    JAX step's, and every step's tokens equal."""
    from omchat_tpu.runtime import batch_engine as jbe

    seen = {"jax": [], "port": []}
    _record_lm_head(monkeypatch, jbe, seen["jax"], 3)
    _record_lm_head(monkeypatch, tbe, seen["port"], 3)
    reqs = [([5, 6, 7, 8, 9, 10], None), (list(range(30, 50)), None)]  # the second prefills in two chunks
    toks = []
    with jax.disable_jit():
        for be in _engines(setup, max_slots=3, max_len=64, chunk_size=16):
            rids = [be.submit(ids, None, max_new_tokens=5, eos_token_id=-1) for ids, _ in reqs]
            be.run_to_completion(max_ticks=100)
            toks.append([be.result(r) for r in rids])
    assert toks[1] == toks[0]
    assert len(seen["port"]) == len(seen["jax"]) >= 5
    for got, want in zip(seen["port"], seen["jax"]):
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


def test_decode_body_parks_inactive_slots(setup):
    """The step's writes: an active slot's row at its length, an inactive
    slot's at the cache's last row, nothing else."""
    _, _, tparams = setup
    eng = tbe.BatchEngine(TOmChatConfig.tiny(), tparams, device="cpu", max_slots=2, max_len=32, chunk_size=16)
    eng.cache.k.fill_(7.0)
    eng._stage(np.array([5, 9], np.int32), np.array([3, 0], np.int32), np.array([1, 0], np.int32),
               np.zeros(2, np.int32), eng._sampling_rows([]))
    eng._decode_body(False)
    changed = (eng.cache.k != 7.0).any(dim=(0, 2, 4))  # [slots, rows]
    assert changed.nonzero().tolist() == [[0, 3], [1, 31]]


def test_sampled_rows_deterministic_and_greedy_rows_unmoved(setup):
    greedy_ids, sampled_ids = [5, 6, 7, 8, 9, 10], [11, 12, 13]
    _, alone, _ = _run_both(setup, [(greedy_ids, None)], 6, max_slots=2, max_len=128, chunk_size=16)
    _, tparams = setup[1:]
    gen = TGen(max_new_tokens=6, eos_token_id=-1, do_sample=True, temperature=0.8, top_p=0.95)

    def run(seed, precompile=False):
        be = tbe.BatchEngine(TOmChatConfig.tiny(), tparams, device="cpu", max_slots=2, max_len=128, chunk_size=16,
                             rng_seed=seed)
        if precompile:
            be.precompile()
        rg = be.submit(greedy_ids, None, max_new_tokens=6, eos_token_id=-1)
        rs = be.submit(sampled_ids, None, max_new_tokens=6, eos_token_id=-1, generation=gen)
        be.run_to_completion(max_ticks=500)
        return be.result(rg), be.result(rs)

    g1, s1 = run(0)
    g2, s2 = run(0, precompile=True)  # precompile seeds the generator again
    g3, s3 = run(1)
    assert g1 == g2 == g3 == alone[0]
    assert s1 == s2 and len(s1) == 6
    assert s3 != s1  # another seed draws other tokens


def test_later_slices_and_bad_options_refused(setup):
    _, _, tparams = setup
    cfg = TOmChatConfig.tiny()
    with pytest.raises(TypeError, match="Mesh"):  # a mesh is a parallel.mesh.Mesh (tensor-parallel serving)
        tbe.BatchEngine(cfg, tparams, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="attn_impl"):
        tbe.BatchEngine(cfg, tparams, device="cpu", attn_impl="xla")
    eng = tbe.BatchEngine(cfg, tparams, device="cpu", max_len=64)
    with pytest.raises(NotImplementedError, match="penalties"):
        eng.submit([5, 6], None, max_new_tokens=2, generation=TGen(frequency_penalty=1.0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tbe.BatchEngine(cfg, tparams)  # the default device is CUDA, with no quiet fallback
