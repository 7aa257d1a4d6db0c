"""Decode as one dispatch, on the CPU against the JAX package: the port's
``OmChatEngine.generate_ondevice`` (JAX's ``_decode_loop_jit`` semantics) and
``generate`` over the static decode state, the state's step body against the
eager ``decode_step`` loop and its LRU, ``PagedBatchEngine.precompile`` and
the rolls over the static roll buffer against today's tokens and the JAX
engine's, the serving warm-up.  ``OmChatConfig.tiny()`` in float32; the CPU
runs the step bodies that a CUDA engine captures, eagerly.  The captures and
replays themselves need the card (``tests/test_torch_cuda_kernels.py``).
"""

import gc
import weakref

import pytest
import torch

import jax

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.config import GenerationConfig as TGenerationConfig
from omchat_torch.config import OmChatConfig as TOmChatConfig
from omchat_torch.runtime import generate as tgen
from omchat_torch.runtime.generate import OmChatEngine as TEngine
from omchat_torch.runtime.paged_engine import PICK_MODES
from tests.test_torch_engine import _request
from tests.test_torch_paged_engine import ENGINE, MAX_NEW, _port, _run, reference  # noqa: F401

NEW_TOKENS = 12
_JAX = {}


def _batch():
    """Two text prompts of different lengths, and the image request."""
    ids, px = _request()
    return [([5, 6, 7, 8], None), ([9, 10, 11, 12, 13, 14], None), (ids, px)]


def _jax_ondevice():
    """The JAX engine's ``generate_ondevice`` tokens (XLA attention) on each
    request of ``_batch`` with eos never matching, and with eos set to the
    image request's fifth token (a cut mid-decode), computed once."""
    if not _JAX:
        from omchat_tpu.config import GenerationConfig, OmChatConfig
        from omchat_tpu.runtime.generate import OmChatEngine
        from tests.test_sharding import _tiny_params

        cfg = OmChatConfig.tiny()
        params = _tiny_params(cfg)
        eng = OmChatEngine(cfg, params, attn_impl="xla", image_cache_size=0)
        free = GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1)
        runs = {"none": [eng.generate_ondevice([ids], px, free).token_ids[0] for ids, px in _batch()]}
        eos = runs["none"][2][4]
        cut = GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=eos)
        runs["mid"] = [eng.generate_ondevice([ids], px, cut).token_ids[0] for ids, px in _batch()]
        _JAX.update(params=from_jax_params(jax.device_get(params)), runs=runs, eos=eos)
    return _JAX


def _engine(params, **kw):
    return TEngine(TOmChatConfig.tiny(), params, device="cpu", image_cache_size=0, **kw)


@pytest.mark.parametrize("eos", ["none", "mid"])
def test_generate_ondevice_matches_the_jax_engine_and_generate(eos):
    """Per request: the JAX engine's ``generate_ondevice`` tokens, from the
    port's ``generate_ondevice`` and its ``generate``, identical; with eos set
    to a token the decode reaches, each row is cut at it."""
    ref = _jax_ondevice()
    eng = _engine(ref["params"])
    gen = TGenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1 if eos == "none" else ref["eos"])
    for (ids, px), want in zip(_batch(), ref["runs"][eos]):
        assert eng.generate_ondevice([ids], px, gen).token_ids[0] == want
        assert eng.generate([ids], px, gen).token_ids[0] == want
    full = ref["runs"]["none"][2]
    assert len(full) == NEW_TOKENS and ref["runs"]["mid"][2] == full[: full.index(ref["eos"])]
    assert "capture" not in eng.spans  # a CPU engine captures nothing


def test_generate_ondevice_batched_rows_finish_apart():
    """A batch of two prompts whose rows reach eos at different steps: each
    row equals its request run alone, cut at its own first eos; the loop
    stops once every row is done (the host polls ``done``)."""
    ref = _jax_ondevice()
    eng = _engine(ref["params"])
    (a, _), (b, _) = _batch()[:2]
    free = TGenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1)
    alone = [eng.generate_ondevice([p], None, free).token_ids[0] for p in (a, b)]
    eos = alone[0][2]
    gen = TGenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=eos)
    want = [row[: row.index(eos)] if eos in row else row for row in alone]
    assert eng.generate_ondevice([a, b], None, gen).token_ids == want
    assert eng.generate([a, b], None, gen).token_ids == want
    if all(eos in row for row in alone):
        assert eng.spans["decode_steps"] < NEW_TOKENS - 1


def test_static_step_body_equals_the_eager_decode_step_loop():
    """The decode state's step (the body a CUDA engine captures), run
    eagerly for N steps, gives the eager ``decode_step`` loop's logits and
    greedy tokens bit for bit; two requests of different shapes keep two
    states in the LRU, and a request of a kept shape gets its state back."""
    ref = _jax_ondevice()
    eng = _engine(ref["params"])
    steps = 6
    for (ids, px), budget in ((_batch()[2], steps + 1), (_batch()[0], 200)):
        plan = eng.plan([ids])
        feats = eng.encode_images(px) if px is not None else None
        rows = eng.cache_rows(plan, budget)
        logits, cache = eng.prefill(plan, feats, budget)
        tokens = logits.argmax(-1).to(torch.int32)
        kv_len = torch.as_tensor(plan.lengths)
        want_logits, want_tokens = [], []
        for _ in range(steps):
            logits, cache = eng.decode_step(tokens, kv_len, cache)
            tokens = logits.argmax(-1).to(torch.int32)
            kv_len = kv_len + 1
            want_logits.append(logits)
            want_tokens.append(tokens)

        st = eng.decode_state(1, rows)
        first, _ = eng.prefill(plan, feats, budget, cache=st.cache)
        eng._start(st, plan.lengths, TGenerationConfig(eos_token_id=-1))
        eng._pick(st, first, tgen.GREEDY)
        for i in range(steps):
            assert torch.equal(st.run(), want_logits[i])
            assert torch.equal(st.tokens, want_tokens[i])
            assert torch.equal(st.out[:, i + 1], want_tokens[i])
        assert int(st.step) == steps + 1 and torch.equal(st.kv_len, torch.as_tensor(plan.lengths) + steps)
        assert torch.equal(st.cache.k, cache.k) and torch.equal(st.cache.v, cache.v)
    assert len(eng._states) == 2
    assert eng.decode_state(1, rows) is st and list(eng._states)[-1] == (1, rows, torch.float32)


def test_decode_state_lru_drops_the_least_recently_used():
    eng = _engine(_jax_ondevice()["params"])
    states = [eng.decode_state(1, 128 * (i + 1)) for i in range(tgen.DECODE_STATES)]
    eng.decode_state(1, 128)  # used again: the oldest is now 256 rows
    dropped = weakref.ref(states.pop(1).cache.k)
    gc.disable()
    try:
        eng.decode_state(2, 128)
        assert dropped() is None  # freed at once, without the collector
    finally:
        gc.enable()
    assert len(eng._states) == tgen.DECODE_STATES
    assert (1, 256, torch.float32) not in eng._states and eng.decode_state(1, 128) is states[0]


def test_release_decode_states_drops_every_state():
    """``release_decode_states`` empties the LRU and frees each state's
    buffers at once (no reference cycle waits for the collector); the next
    request of a shape it held makes its state anew and still gives the
    same tokens; deleting the engine frees its states at once too."""
    ref = _jax_ondevice()
    eng = _engine(ref["params"])
    ids, px = _batch()[2]
    gen = TGenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1)
    assert eng.generate_ondevice([ids], px, gen).token_ids[0] == ref["runs"]["none"][2]
    gc.disable()
    try:
        (st,) = eng._states.values()
        cache = weakref.ref(st.cache.k)
        del st
        eng.release_decode_states()
        assert not eng._states and cache() is None
    finally:
        gc.enable()
    assert eng.generate_ondevice([ids], px, gen).token_ids[0] == ref["runs"]["none"][2]
    assert len(eng._states) == 1
    cache = weakref.ref(next(iter(eng._states.values())).cache.k)
    gc.disable()
    try:
        del eng
        assert cache() is None
    finally:
        gc.enable()


def test_prefill_into_a_state_cache_equals_a_fresh_cache():
    """Prefill zeroes a reused cache first: what it holds afterwards is what a
    fresh cache holds, whatever an earlier request left in it."""
    eng = _engine(_jax_ondevice()["params"])
    ids, px = _batch()[2]
    plan = eng.plan([ids])
    feats = eng.encode_images(px)
    st = eng.decode_state(1, eng.cache_rows(plan, 4))
    st.cache.k.fill_(3.0)
    st.cache.v.fill_(-2.0)
    got, _ = eng.prefill(plan, feats, 4, cache=st.cache)
    want, fresh = eng.prefill(plan, feats, 4)
    assert torch.equal(got, want) and torch.equal(st.cache.k, fresh.k) and torch.equal(st.cache.v, fresh.v)
    with pytest.raises(ValueError, match="cache"):
        eng.prefill(plan, feats, 200, cache=st.cache)


def test_sampled_generate_ondevice_raises():
    """A sampled ``generate_ondevice`` runs on the decode state's sampled step
    (it raised before the generation options were ported): from one seed it
    draws what sampled ``generate`` draws; it raises only on an ``rng_key``
    that is neither a seed nor a generator."""
    eng = _engine(_jax_ondevice()["params"])
    gen = TGenerationConfig(max_new_tokens=6, eos_token_id=-1, do_sample=True, temperature=1.0)
    out = eng.generate_ondevice([[5, 6, 7]], None, gen, rng_key=3)
    assert len(out.token_ids[0]) == 6 and out.token_ids == eng.generate([[5, 6, 7]], None, gen, rng_key=3).token_ids
    with pytest.raises(TypeError, match="rng_key"):
        eng.generate_ondevice([[5, 6, 7]], None, gen, rng_key=3.5)


@pytest.mark.parametrize("roll", [1, 4])
def test_precompile_and_bucketed_rolls_match_per_step_rolls_and_jax(reference, roll):  # noqa: F811
    """``precompile`` runs the roll at every width bucket over parked slots,
    touching only the parking page; the rolls afterwards, over the static
    roll buffer, give the JAX engine's tokens, which are also those of
    per-step rolls (``decode_roll=1``); a deleted engine's pools are freed
    at once."""
    params, want = reference
    eng = _port(params, decode_roll=roll)
    widths = eng.precompile()
    assert widths == sorted({min(w, eng.max_pages) for w in (4, 8, 16, 32)})
    parking = eng._parking
    assert not eng.k_pool[:, :parking].any() and not eng.v_pool[:, :parking].any()
    assert set(eng._rolls) == {(w, mode, roll) for w in widths for mode in PICK_MODES}  # every width and pick mode
    assert _run(eng) == want == _run(_port(params, decode_roll=1))
    stats = eng.latency_stats()
    assert stats["rolls_graphed"] == 0 and stats["rolls_eager"] > 0  # a CPU engine rolls eagerly
    assert eng.allocator.available == ENGINE["num_pages"]
    pool = weakref.ref(eng.k_pool)
    gc.disable()
    try:
        del eng  # its rolls hold it weakly: the pools go at once
        assert pool() is None
    finally:
        gc.enable()


def test_sampled_rolls_are_counted_eager(reference):  # noqa: F811
    params, want = reference
    eng = _port(params, decode_roll=2)
    top1 = TGenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-1, do_sample=True, temperature=0.7, top_k=1)
    assert _run(eng, generation=top1) == want
    n = eng.latency_stats()["rolls_eager"]
    assert n > 0 and eng.rolls_graphed == 0
    eng.reset_latency_stats()
    assert eng.latency_stats()["rolls_eager"] == 0


def test_serving_warmup_precompiles_and_leaves_the_engine_idle(reference, capsys):  # noqa: F811
    from omchat_torch.cli.serve import main, warmup_engine

    params, want = reference
    eng = _port(params, decode_roll=2)
    assert warmup_engine(eng) >= 0
    assert not eng.has_work() and not eng.requests and eng.allocator.available == ENGINE["num_pages"]
    assert eng._rolls and eng.latency_stats() == {"requests_measured": 0, "rolls_graphed": 0, "rolls_eager": 0,
                                                  "verifies_graphed": 0, "verifies_eager": 0}
    assert _run(eng) == want
    with pytest.raises(SystemExit):
        main(["--help"])
    assert "--no-warmup" in capsys.readouterr().out


def test_counted_wrappers_cover_the_decode_kernels():
    """The graph helper re-adds a capture's launches at each replay for every
    counted wrapper: the decode path's K3, K4, K12 and K13 among them."""
    from omchat_torch.ops import decode_attention as da
    from omchat_torch.ops import paged_attention as pa
    from omchat_torch.runtime.cuda_graphs import counted_wrappers

    found = counted_wrappers()
    for w in (da.flash_decode_stacked, da.flash_decode, pa.commit_rows, pa.paged_flash_decode,
              pa.paged_flash_decode_manual, pa.commit_pages):
        assert w in found
    assert len(found) == len(set(found)) >= 18
