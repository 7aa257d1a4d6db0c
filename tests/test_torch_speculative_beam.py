"""Speculative decoding and beam search on the CPU against the JAX package:
``generate_speculative`` (prompt lookup, and an oracle draft that is the
greedy continuation) with JAX's tokens and device steps, its tokens those of
greedy ``generate``; ``beam_search`` with JAX's hypothesis, on the decode
state (the in-place cache gather the graphed step needs); and the
``OmChatModel.chat`` routes (``speculative=``, ``num_beams=``).
``OmChatConfig.tiny()`` in float32; tokens exact.
"""

import pytest

from omchat_torch.config import GenerationConfig as TGen
from omchat_torch.runtime import beam_search as tb
from omchat_torch.runtime import speculative as tsp
from tests.test_torch_engine import _request
from tests.test_torch_generate_options import _engine, _ref

NEW = 14


def _jgen(**kw):
    from omchat_tpu.config import GenerationConfig

    return GenerationConfig(**kw)


def _echo_request():
    """The image request with an echo-heavy text tail (prompt lookup finds
    drafts in it)."""
    ids, px = _request()
    return ids + [40, 41, 42, 43, 44, 45, 40, 41, 42, 43], px


def test_propose_draft_matches_jax():
    from omchat_tpu.runtime.speculative import propose_draft

    seq = [1, 2, 3, 4, 1, 2, 5, 6, 1, 2]
    for ngram, k in ((1, 3), (2, 8), (3, 2)):
        assert tsp.propose_draft(seq, ngram, k) == propose_draft(seq, ngram, k)


@pytest.mark.parametrize("draft", ["lookup", "oracle"])
def test_generate_speculative_matches_jax_and_greedy(draft):
    from omchat_tpu.runtime.speculative import generate_speculative

    ids, px = _echo_request()
    gen = dict(max_new_tokens=NEW, eos_token_id=-1)
    eng = _engine()
    greedy = eng.generate([ids], px, TGen(**gen)).token_ids[0]
    kw = {}
    if draft == "oracle":
        ctx0 = len(tsp.draft_context(ids))
        kw["draft_fn"] = lambda ctx: greedy[len(ctx) - ctx0:]
    want, want_steps = generate_speculative(_ref()["engine"], ids, px, _jgen(**gen), **kw)
    got, steps = tsp.generate_speculative(eng, ids, px, TGen(**gen), **kw)
    assert got == want == greedy and steps == want_steps
    if draft == "oracle":
        assert steps == -(-(NEW - 1) // 9)  # 1 + draft_len tokens a verify step


def test_generate_speculative_refuses_sampling():
    with pytest.raises(ValueError, match="greedy"):
        tsp.generate_speculative(_engine(), [5, 6], None, TGen(do_sample=True))


@pytest.mark.parametrize("beams,eos", [(2, -1), (4, -1), (3, "mid")])
def test_beam_search_matches_jax(beams, eos):
    """JAX's hypothesis; with eos set to a token the beams reach, finished
    hypotheses enter the pool as in JAX."""
    from omchat_tpu.runtime.beam_search import beam_search

    ids, px = _request()
    eng = _engine()
    if eos == "mid":
        eos = eng.generate([ids], px, TGen(max_new_tokens=NEW, eos_token_id=-1)).token_ids[0][3]
    want = beam_search(_ref()["engine"], ids, px, num_beams=beams, max_new_tokens=NEW, eos_token_id=eos)
    scores = []
    got = tb.beam_search(eng, ids, px, num_beams=beams, max_new_tokens=NEW, eos_token_id=eos,
                         score_callback=lambda step, s, toks: scores.append((s, toks)))
    assert got == want and scores
    assert (beams, eng.cache_rows(eng.plan([ids] * beams), NEW), eng.params["language_model"]["embed_tokens"].dtype) \
        in eng._states  # the beams rode a decode state


def test_gather_beams_is_in_place():
    import torch

    from omchat_torch.models.qwen2 import KVCache

    k = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(1, 3, 2, 4, 1).repeat(1, 1, 1, 1, 2)
    cache = KVCache(k=k.clone(), v=(-k).clone())
    ptr = cache.k.data_ptr()
    tb.gather_beams(cache, torch.tensor([2, 2, 0]))
    assert cache.k.data_ptr() == ptr
    assert torch.equal(cache.k, k[:, [2, 2, 0]]) and torch.equal(cache.v, -k[:, [2, 2, 0]])
    e4 = KVCache(k=k.to(torch.float8_e4m3fn), v=k.to(torch.float8_e4m3fn))
    tb.gather_beams(e4, torch.tensor([1, 0, 0]))
    assert torch.equal(e4.k.float(), k[:, [1, 0, 0]].to(torch.float8_e4m3fn).float())


def test_chat_routes_speculative_and_beams():
    """``OmChatModel.chat`` routes ``speculative=`` and ``num_beams=`` as the
    JAX model does, and refuses beams with sampling."""
    from tests.test_torch_constrained import _gen, make_models

    jmodel, tmodel = make_models()
    jg, tg = _gen(NEW)
    assert tmodel.chat("say it again: abab abab", speculative=True, generation=tg) == \
        jmodel.chat("say it again: abab abab", speculative=True, generation=jg)
    assert tmodel.chat("hello", num_beams=3, generation=tg) == jmodel.chat("hello", num_beams=3, generation=jg)
    with pytest.raises(ValueError, match="greedy-only"):
        tmodel.chat("hello", num_beams=2, generation=TGen(do_sample=True))

