"""The paged engine's routes on the CPU against the JAX package's
``PagedBatchEngine``, on ``OmChatConfig.tiny()``'s float32 weights (XLA
attention on the JAX side, the kernels' plain versions on the port's): each
case of ``tests/test_paged_engine.py`` that exercises ``prefill_priority``,
streaming rolls (the roll lengths the two engines dispatch compared),
speculative verify in the batch (tokens and the ``spec_*`` counts), an
oracle draft accepted whole, pipelined rolls across mid-roll budget
releases, a second wave, a cancel in flight and log-probs, the speculative
fp8 pool, and the randomized soak of pipelined and speculative rolls.  Then
the verify function against the JAX ``_paged_verify_jit`` on the same pools
and tokens (logits, tokens and the committed rows), two pipelined rolls of
the same width and mode in flight with distinct outputs, and what
``precompile`` builds for the routes.
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
from omchat_torch.runtime import paged_engine as tpe

LP_TOL = 1e-5
ENGINE = dict(page_size=8, prompt_bucket=16, max_len=96)


@pytest.fixture(scope="module")
def setup():
    from omchat_tpu.config import OmChatConfig
    from tests.test_sharding import _tiny_params

    cfg = OmChatConfig.tiny()
    params = _tiny_params(cfg)
    return cfg, params, from_jax_params(jax.device_get(params))


def _jax_engine(setup, **kw):
    from omchat_tpu.runtime.paged_engine import PagedBatchEngine

    cfg, params, _ = setup
    if kw.get("cache_dtype") is not None:
        kw["cache_dtype"] = jnp.float8_e4m3fn
    return PagedBatchEngine(cfg, params, attn_impl="xla", **{**ENGINE, **kw})


def _port_engine(setup, **kw):
    return tpe.PagedBatchEngine(TOmChatConfig.tiny(), setup[2], device="cpu", **{**ENGINE, **kw})


def _image(seed=0):
    return np.random.default_rng(seed).standard_normal((1, 3, 56, 56)).astype(np.float32)


def _run(eng, reqs, max_new, **submit):
    rids = [eng.submit(ids, images, max_new_tokens=n if n else max_new, eos_token_id=-1, **submit)
            for ids, images, n in reqs]
    ticks = eng.run_to_completion(max_ticks=800)
    assert ticks < 800
    return [eng.result(r) for r in rids]


def _both(setup, reqs, max_new, **kw):
    return [_run(mk(setup, **kw), reqs, max_new) for mk in (_jax_engine, _port_engine)]


def test_prefill_priority_matches_jax(setup):
    reqs = [([5, 6, 7, 8], None, 0), ([5, 6, IMAGE_TOKEN_INDEX, 7], _image(), 0), ([11, 12, 13], None, 0),
            ([21, 22, 23, 24, 25], None, 0)]
    rolls = []
    want, got = (_run(eng, reqs, 5) for eng in (
        _jax_engine(setup, max_slots=2, num_pages=14, decode_roll=2, prefill_priority=True),
        _spy_rolls(_port_engine(setup, max_slots=2, num_pages=14, decode_roll=2, prefill_priority=True), rolls)))
    assert got == want
    # no roll ran while an admitted slot was mid-prefill
    assert rolls and all(not mid for _, mid in rolls)


def _spy_rolls(eng, rolls):
    """Record (roll length, any admitted slot mid-prefill) of each roll the
    port's engine dispatches."""
    orig = eng._dispatch_roll

    def spy(decoding, roll, *a, **kw):
        rolls.append((roll, any(r is not None and not r.prefilled for r in eng.slots)))
        return orig(decoding, roll, *a, **kw)

    eng._dispatch_roll = spy
    return eng


def test_streaming_roll_adaptive_and_exact(setup, monkeypatch):
    """streaming_roll=2 beside decode_roll=4: the port's rolls have the JAX
    engine's lengths in the JAX engine's order (2 while the streaming request
    decodes, 4 after), and the same greedy tokens."""
    import omchat_tpu.runtime.paged_engine as jpe

    reqs = [([5, 6, 7, 8, 9, 10], None, 0), ([11, 12, 13], None, 4),
            ([5, 6, IMAGE_TOKEN_INDEX, 7], _image(), 0)]
    opts = dict(max_slots=3, num_pages=20, decode_roll=4, streaming_roll=2)
    jax_rolls, port_rolls = [], []
    roll_jit = jpe._paged_decode_roll_jit
    monkeypatch.setattr(jpe, "_paged_decode_roll_jit",
                        lambda *a, **kw: (jax_rolls.append(a[10]), roll_jit(*a, **kw))[1])  # a[10]: steps
    out = []
    for eng in (_jax_engine(setup, **opts), _spy_rolls(_port_engine(setup, **opts), port_rolls)):
        rids = [eng.submit(ids, im, max_new_tokens=n or 9, eos_token_id=-1, streaming=(i == 1))
                for i, (ids, im, n) in enumerate(reqs)]
        eng.run_to_completion(max_ticks=500)
        out.append([eng.result(r) for r in rids])
    assert out[1] == out[0]
    assert [r for r, _ in port_rolls] == jax_rolls
    assert jax_rolls[0] == 2 and 4 in jax_rolls


def test_speculative_matches_jax(setup):
    rep = [31, 32, 33, 34, 35, 36]
    reqs = [(rep * 4 + rep[:2], None, 0), ([11, 12, 13, 14], None, 0),
            ([5, 6, IMAGE_TOKEN_INDEX, 7] + rep * 2 + rep[:2], _image(), 0)]
    opts = dict(max_slots=3, num_pages=32, max_len=128, decode_roll=4, speculative=True, draft_len=4)
    engines = (_jax_engine(setup, **opts), _port_engine(setup, **opts))
    want, got = (_run(eng, reqs, 12) for eng in engines)
    assert got == want
    stats = [{k: v for k, v in e.stats().items() if k.startswith("spec") or k == "pages_free"} for e in engines]
    assert stats[1] == stats[0] and stats[1]["spec_dispatches"] > 0 and stats[1]["pages_free"] == 32
    assert engines[1].verifies_eager == stats[1]["spec_dispatches"]  # a CPU engine runs the verify eagerly


def test_speculative_oracle_draft_full_acceptance(setup):
    ids = [41, 42, 43, 44, 45]
    opts = dict(max_slots=1, num_pages=16, decode_roll=4)
    base = _run(_jax_engine(setup, **opts), [(ids, None, 0)], 12)[0]
    cont = {tuple(ids + base[:i]): base[i:] for i in range(len(base))}

    def oracle(ctx):
        return list(cont.get(tuple(ctx), []))[:4]

    counts = []
    for mk in (_jax_engine, _port_engine):
        eng = mk(setup, speculative=True, draft_len=4, draft_fn=oracle, **opts)
        assert _run(eng, [(ids, None, 0)], 12)[0] == base
        counts.append(eng.spec_dispatches)
    assert counts[1] == counts[0] and counts[1] <= 4


def test_pipeline_rolls_matches_jax(setup):
    """Pipelined rolls across mid-roll budget releases (9 tokens, rolls of 4)
    and a second wave riding freed slots and pages."""
    reqs = [([5, 6, 7, 8, 9, 10], None, 0), ([11, 12, 13], None, 0), ([5, 6, IMAGE_TOKEN_INDEX, 7], _image(), 0),
            ([21, 22, 23, 24], None, 0), ([31, 32, 33], None, 0)]
    opts = dict(max_slots=2, num_pages=24, decode_roll=4, pipeline_rolls=True)
    jax_eng, port = _jax_engine(setup, **opts), _port_engine(setup, **opts)
    extended = []
    orig = port._extend_roll
    port._extend_roll = lambda h: (extended.append(h["roll"]), orig(h))[1]
    assert _run(port, reqs, 9) == _run(jax_eng, reqs, 9)
    assert extended  # some roll's successor was dispatched before it was read
    assert port._inflight is None and not port.has_work() and port.allocator.available == 24


def test_pipeline_rolls_cancel_mid_flight(setup):
    """Two ticks leave a successor roll in flight (``tests/test_paged_engine.py``
    steps four, after which nothing is in flight); the cancel then drops its
    surplus tokens and every page comes back."""
    out = []
    for mk in (_jax_engine, _port_engine):
        eng = mk(setup, max_slots=2, num_pages=16, decode_roll=4, pipeline_rolls=True)
        r1 = eng.submit([5, 6, 7], None, max_new_tokens=40, eos_token_id=-1)
        r2 = eng.submit([8, 9, 10], None, max_new_tokens=6, eos_token_id=-1)
        for _ in range(2):
            eng.step()
        in_flight = eng._inflight is not None
        eng.cancel(r1)
        eng.run_to_completion(max_ticks=300)
        assert eng.finished(r1) and eng.finished(r2)
        assert eng._inflight is None and eng.allocator.available == 16
        out.append((in_flight, eng.result(r1), eng.result(r2)))
    assert out[1] == out[0]
    assert out[1][0] and len(out[1][2]) == 6  # the cancel came with a roll in flight


def test_speculative_fp8_pool_matches_nonspec_fp8(setup):
    """The verify widens the e4m3 pages before attention and its commit
    rounds as the roll's does: the speculative e4m3 engine gives the e4m3
    engine's tokens without speculation, and the JAX engine's."""
    rep = [51, 52, 53, 54]
    ids = rep * 5 + rep[:2]
    opts = dict(max_slots=1, num_pages=16, cache_dtype=E4M3)
    base = _run(_port_engine(setup, **opts), [(ids, None, 0)], 8)
    spec = _port_engine(setup, speculative=True, draft_len=4, **opts)
    want = _run(_jax_engine(setup, speculative=True, draft_len=4, **opts), [(ids, None, 0)], 8)
    assert _run(spec, [(ids, None, 0)], 8) == base == want
    # prompt lookup may draft nothing on random weights: an oracle draft of
    # the tokens makes every tick a verify over the e4m3 pool
    cont = {tuple(ids + base[0][:i]): base[0][i:] for i in range(len(base[0]))}
    oracle = _port_engine(setup, speculative=True, draft_len=4, draft_fn=lambda ctx: cont.get(tuple(ctx), [])[:4],
                          **opts)
    assert _run(oracle, [(ids, None, 0)], 8) == base
    assert oracle.spec_dispatches >= 2 and oracle.k_pool.dtype == E4M3


def test_pipeline_rolls_logprobs(setup):
    out = []
    for mk in (_jax_engine, _port_engine):
        eng = mk(setup, max_slots=2, num_pages=16, decode_roll=2, pipeline_rolls=True)
        rid = eng.submit([5, 6, 7, 8], None, max_new_tokens=7, eos_token_id=-1, logprobs=True, top_logprobs=3)
        eng.run_to_completion(max_ticks=300)
        out.append((eng.result(rid), *eng.request_logprobs(rid)))
    (want, w_lp, w_top), (got, g_lp, g_top) = out
    assert got == want and len(g_lp) == len(g_top) == 7
    np.testing.assert_allclose(g_lp, w_lp, atol=LP_TOL, rtol=0)
    for g, w in zip(g_top, w_top):
        assert [t for t, _ in g] == [t for t, _ in w] and len(g) == 3
        np.testing.assert_allclose([v for _, v in g], [v for _, v in w], atol=LP_TOL, rtol=0)
    assert all(top[0][0] == t for t, top in zip(got, g_top))


def test_randomized_soak_pipeline_and_speculative(setup):
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(9):
        ids = [int(t) for t in rng.integers(5, 60, int(rng.integers(2, 14)))]
        if i % 3 == 0:  # echo structure, so that drafts fire
            ids = ids + ids[:4]
        reqs.append((ids, int(rng.integers(1, 10))))
    opts = dict(max_slots=3, num_pages=14, max_len=48, decode_roll=3, pipeline_rolls=True, speculative=True,
                draft_len=3)
    out = []
    for mk in (_jax_engine, _port_engine):
        eng = mk(setup, **opts)
        rids = []
        for j, (ids, max_new) in enumerate(reqs):
            rids.append(eng.submit(ids, None, max_new_tokens=max_new, eos_token_id=-1))
            if j % 3 == 2:
                eng.step()
                eng.step()
        eng.run_to_completion(max_ticks=2000)
        assert eng.allocator.available == 14 and eng._inflight is None
        out.append(([eng.result(r) for r in rids], eng.stats()["spec_dispatches"], eng.stats()["spec_tokens"]))
    assert out[1] == out[0]


# -- the verify function and the pipelined buffers ----------------------------


def test_paged_verify_plain_matches_jax(setup):
    """``_paged_verify`` (the kernels' plain versions) against the JAX
    ``_paged_verify_jit`` (XLA attention) on the same random pools, tokens,
    lengths, tables and an inactive slot: the logits of every row, their
    argmax and the pools after the commit (each active slot's rows at its
    positions, the inactive slot's on the parking page)."""
    import omchat_tpu.runtime.paged_engine as jpe

    cfg, params, tparams = setup
    tc = cfg.text
    rng = np.random.default_rng(7)
    s, t, ps, pages = 3, 5, 8, 12
    shape = (tc.num_hidden_layers, pages + 1, tc.num_key_value_heads, ps, tc.attn_head_dim)
    k_pool = rng.standard_normal(shape).astype(np.float32)
    v_pool = rng.standard_normal(shape).astype(np.float32)
    tokens = rng.integers(5, 60, (s, t)).astype(np.int32)
    lengths = np.array([13, 5, 0], np.int32)
    active = np.array([True, True, False])
    tables = np.array([[3, 7, 1, 0], [9, 2, 4, 5], [pages] * 4], np.int32)

    seen = []
    lm_head = jpe.lm_head
    with jax.disable_jit():  # the JAX function's lm_head output is the logits it argmaxes
        jpe.lm_head = lambda *a: (seen.append(lm_head(*a)), seen[-1])[1]
        try:
            want, jk, jv = jpe._paged_verify_jit(params, cfg, jnp.asarray(tokens), jnp.asarray(lengths),
                                                 jnp.asarray(active), jnp.asarray(tables), jnp.asarray(k_pool),
                                                 jnp.asarray(v_pool), ps, "xla")
        finally:
            jpe.lm_head = lm_head
    tk, tv = torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy())
    logits = tpe._paged_verify(tparams, TOmChatConfig.tiny(), torch.from_numpy(tokens), torch.from_numpy(lengths),
                               torch.from_numpy(active), torch.from_numpy(tables), tk, tv, ps)
    ref = np.asarray(seen[-1])
    assert logits.shape == ref.shape == (s, t, tc.vocab_size)
    np.testing.assert_allclose(logits[:2].numpy(), ref[:2], atol=1e-4, rtol=1e-4)  # the active slots
    assert (logits[:2].argmax(-1).numpy() == np.asarray(want)[:2]).all()
    # every page but the parking one: the inactive slot attends to nothing, which
    # XLA's softmax makes a mean of its columns and the kernels' version zeros,
    # so its rows past layer 0 differ, as garbage no request reads
    np.testing.assert_allclose(tk.numpy()[:, :pages], np.asarray(jk)[:, :pages], atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy()[:, :pages], np.asarray(jv)[:, :pages], atol=1e-5, rtol=0)
    np.testing.assert_allclose(tk.numpy()[0], np.asarray(jk)[0], atol=1e-5, rtol=0)
    moved = (tk.numpy() != k_pool).any(axis=(0, 2, 4))  # [P+1, ps] rows the commit wrote
    # slot 0 writes positions 13-17 (page 7 rows 5-7, page 1 rows 0-1), slot 1
    # positions 5-9 (page 9 rows 5-7, page 2 rows 0-1), the inactive slot the parking page
    written = {(7, 5), (7, 6), (7, 7), (1, 0), (1, 1), (9, 5), (9, 6), (9, 7), (2, 0), (2, 1)}
    assert {(int(p), int(r)) for p, r in zip(*np.nonzero(moved[:pages]))} == written
    assert moved[pages, :t].all()


def test_two_pipelined_rolls_keep_distinct_outputs(setup):
    """A roll in flight and its successor of the same width and pick mode:
    the successor's staged tokens are the first roll's last row (copied on
    the device), each roll's host copy is its own (the two host sets used in
    turn), and the two rolls' tokens are a sequential decode's."""
    eng = _port_engine(setup, max_slots=2, num_pages=16, decode_roll=2, pipeline_rolls=True)
    ref = _port_engine(setup, max_slots=2, num_pages=16, decode_roll=1)
    prompts = [[5, 6, 7], [8, 9, 10, 11]]
    want = _run(ref, [(p, None, 0) for p in prompts], 5)
    rids = [eng.submit(p, None, max_new_tokens=5, eos_token_id=-1) for p in prompts]
    eng.step()  # both prefills, then the first roll left in flight
    first = eng._inflight
    assert first is not None and first["roll"] == 2
    second = eng._extend_roll(first)
    assert (second["out"], second["roll"]) and second["host"] is not first["host"]
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(second["host"], first["host"]))
    assert (eng._roll_dev[:, 0] == first["host"][0][-1]).all()  # the device row staged as the successor's tokens
    eng._inflight = None
    eng._process_roll(first)
    eng._process_roll(second)
    toks = np.concatenate([first["host"][0].numpy(), second["host"][0].numpy()])
    for slot, (rid, w) in enumerate(zip(rids, want)):
        assert [eng.requests[rid].generated[0]] + toks[:, slot].tolist() == w
    eng.run_to_completion(max_ticks=50)
    assert [eng.result(r) for r in rids] == want and eng.allocator.available == 16


def test_precompile_builds_both_roll_lengths_and_the_verify(setup):
    eng = _port_engine(setup, max_slots=2, num_pages=16, decode_roll=4, streaming_roll=2, speculative=True)
    widths = eng.precompile(roll_widths=(4, 8), variants=((False, False), (True, True)))
    assert widths == [4, 8]
    assert set(eng._rolls) == {(w, m, r) for w in widths for m in ((False, False), (True, True)) for r in (2, 4)}
    assert set(eng._verifies) == {4, 8}
    assert eng.allocator.available == 16 and not eng.has_work()
    # headroom: the verify chunk (draft_len + 1 = 5) is the longest dispatch
    assert eng._max_roll == 5
    assert _port_engine(setup, decode_roll=4, pipeline_rolls=True)._max_roll == 8
