"""The paged engine's log-probs and sampled rolls on the CPU, against the JAX
package's ``PagedBatchEngine`` on the same ``OmChatConfig.tiny()`` float32
weights and workload (``tests/test_torch_paged_engine.py``'s): each token's
chosen log-prob and top-5 (``request_logprobs``) at decode_roll 1 and 4, on
the batched-shorts, lone-short and chunked prefill routes, with requests
that ask for none beside them, and across an eos mid-roll; top-5 ids equal,
values within 1e-5.  Sampled rolls: the roll body run twice from one
generator state draws the same tokens, and sampled slots leave the greedy
slots' tokens alone.
"""

import numpy as np
import pytest
import torch

import jax

from omchat_torch.config import GenerationConfig
from omchat_torch.runtime.paged_engine import LOGPROBS_K, PICK_MODES
from tests.test_torch_paged_engine import ENGINE, MAX_NEW, _port, _workload, reference  # noqa: F401

LP_TOL = 1e-5
# requests 0, 2 and 4 (a batched short, two chunked images) ask for the top
# 5, request 5 (the lone short) for the chosen log-prob alone, 1 and 3 for none
ASKS = [(True, 5), (False, 0), (True, 5), (False, 0), (True, 3), (True, 0)]


def _submit_all(eng, eos=-1, gen=None):
    return [eng.submit(ids, px, max_new_tokens=MAX_NEW, eos_token_id=eos, logprobs=lp, top_logprobs=k,
                       **({"generation": gen} if gen is not None else {}))
            for (ids, px), (lp, k) in zip(_workload(), ASKS)]


def _collect(eng, rids):
    out = []
    for rid in rids:
        lps, tops = eng.request_logprobs(rid)
        out.append((eng.result(rid), lps, tops))
    return out


_JAX = {}


def _jax_runs(roll: int, eos: int):
    """The JAX engine's tokens and log-probs on the workload (computed once
    a setting)."""
    key = (roll, eos)
    if key not in _JAX:
        from omchat_tpu.config import OmChatConfig
        from omchat_tpu.runtime.paged_engine import PagedBatchEngine
        from tests.test_sharding import _tiny_params

        cfg = OmChatConfig.tiny()
        eng = PagedBatchEngine(cfg, _tiny_params(cfg), attn_impl="xla", decode_roll=roll, **ENGINE)
        rids = _submit_all(eng, eos)
        eng.run_to_completion(max_ticks=200)
        _JAX[key] = _collect(eng, rids)
    return _JAX[key]


def _assert_logprobs_match(got, want):
    for (g_toks, g_lp, g_top), (w_toks, w_lp, w_top) in zip(got, want):
        assert g_toks == w_toks
        if w_lp is None:
            assert g_lp is None and g_top is None
            continue
        assert len(g_lp) == len(w_lp) == len(g_toks)
        np.testing.assert_allclose(g_lp, w_lp, atol=LP_TOL, rtol=0)
        if w_top is None:
            assert g_top is None
            continue
        assert len(g_top) == len(w_top) == len(g_toks)
        for g, w in zip(g_top, w_top):
            assert [t for t, _ in g] == [t for t, _ in w]
            np.testing.assert_allclose([v for _, v in g], [v for _, v in w], atol=LP_TOL, rtol=0)


@pytest.mark.parametrize("roll", [1, 4])
def test_paged_logprobs_match_jax(reference, roll):  # noqa: F811
    params, want_tokens = reference
    eng = _port(params, decode_roll=roll)
    rids = _submit_all(eng)
    eng.run_to_completion(max_ticks=200)
    got = _collect(eng, rids)
    assert [g[0] for g in got] == want_tokens
    _assert_logprobs_match(got, _jax_runs(roll, -1))
    for (toks, lps, tops), (asked, k) in zip(got, ASKS):
        if asked:
            assert all(lp <= 0 for lp in lps)
            if k:
                assert all(len(t) == k and [v for _, v in t] == sorted((v for _, v in t), reverse=True) for t in tops)
                assert all(abs(lp - t[0][1]) < LP_TOL and t[0][0] == tok for lp, t, tok in zip(lps, tops, toks))


def test_paged_logprobs_across_an_eos_mid_roll(reference):  # noqa: F811
    """eos set to the third token of the first chunked request: rolls of 4
    pass it mid-roll, and every list stays aligned with the tokens."""
    params, want_tokens = reference
    eos = want_tokens[2][2]
    eng = _port(params, decode_roll=4)
    rids = _submit_all(eng, eos)
    eng.run_to_completion(max_ticks=200)
    got = _collect(eng, rids)
    assert len(got[2][0]) == 2
    _assert_logprobs_match(got, _jax_runs(4, eos))
    assert eng.allocator.available == ENGINE["num_pages"]


def test_logprobs_roll_is_its_own_pick_mode(reference):  # noqa: F811
    """A roll with a log-prob slot runs the (greedy, log-probs) body; a roll
    without one the plain greedy body; the top values come back
    ``LOGPROBS_K`` wide and are cut to what each request asked."""
    params, _ = reference
    eng = _port(params, decode_roll=2)
    eng.precompile(variants=PICK_MODES)
    rid = eng.submit([5, 6, 7, 8], None, max_new_tokens=5, eos_token_id=-1, logprobs=True, top_logprobs=2)
    other = eng.submit([9, 10, 11], None, max_new_tokens=5, eos_token_id=-1)
    eng.run_to_completion()
    lps, tops = eng.request_logprobs(rid)
    assert len(lps) == len(tops) == 5 and all(len(t) == 2 for t in tops)
    assert len(eng.requests[rid].top_list[0]) == LOGPROBS_K
    assert eng.request_logprobs(other) == (None, None)


def test_sampled_roll_body_repeats_from_one_generator_state(reference):  # noqa: F811
    """The sampled roll's body (what a CUDA engine captures) draws the same
    tokens when run twice from one generator state over one staged batch."""
    params, _ = reference
    eng = _port(params, decode_roll=4)
    gen = GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-1, do_sample=True, temperature=1.5, top_p=0.95)
    rid = eng.submit(list(range(5, 15)), None, max_new_tokens=MAX_NEW, eos_token_id=-1, generation=gen)
    eng.step()  # prefill and the first roll
    req = eng.requests[rid]
    active = np.zeros(eng.max_slots, np.int32)
    active[req.slot] = 1
    tokens = np.zeros(eng.max_slots, np.int32)
    tokens[req.slot] = req.last_token
    lengths = eng._lengths.copy()
    tables = np.where(active[:, None] != 0, eng._tables, eng._parking)[:, :4]
    k0, v0 = eng.k_pool.clone(), eng.v_pool.clone()
    runs = []
    for _ in range(2):
        eng.k_pool.copy_(k0)
        eng.v_pool.copy_(v0)
        eng._generator.manual_seed(11)
        eng._stage_roll(tokens, lengths, active, tables, eng._sampling_rows([req]))
        runs.append(eng._roll_step(4, (True, False))()[0].clone())
    assert torch.equal(runs[0], runs[1])
    assert eng.rolls_eager >= 1 and eng.rolls_graphed == 0  # a CPU engine rolls eagerly


def test_sampled_slots_leave_greedy_slots_alone(reference):  # noqa: F811
    """Half the workload samples (temperature 1.5, top_p 0.95): the greedy
    half still gets the JAX engine's greedy tokens."""
    params, want = reference
    eng = _port(params, decode_roll=2)
    hot = GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-1, do_sample=True, temperature=1.5, top_p=0.95)
    rids = [eng.submit(ids, px, max_new_tokens=MAX_NEW, eos_token_id=-1, generation=hot if i % 2 else None)
            for i, (ids, px) in enumerate(_workload())]
    eng.run_to_completion(max_ticks=200)
    got = [eng.result(r) for r in rids]
    assert [g for i, g in enumerate(got) if i % 2 == 0] == [w for i, w in enumerate(want) if i % 2 == 0]
    assert all(len(g) == MAX_NEW for g in got)
