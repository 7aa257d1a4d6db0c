"""``OmChatEngine.generate``'s options on the CPU against the JAX package:
logit bias, presence / frequency penalties, log-probs and top log-probs,
``allowed_tokens_fn`` (whose mask replaces bias and penalties, as in the
JAX package), the first token through the same pick, ``prefill_chunked``;
and sampling by distribution and against the eager step.
``OmChatConfig.tiny()`` in float32; the CPU runs the step bodies a CUDA
engine captures, eagerly.

Tolerances: tokens identical; log-probs within 1e-4 (float32, two frameworks'
softmax and matmul orders); chunked-prefill logits within 1e-4 of JAX's and
of the one-shot prefill.
"""

import numpy as np
import pytest
import torch

import jax

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.config import GenerationConfig as TGen
from omchat_torch.config import OmChatConfig as TCfg
from omchat_torch.ops import sampling as ts
from omchat_torch.runtime.generate import GREEDY, OmChatEngine as TEngine
from tests.test_torch_engine import _request

NEW = 10
LP_TOL = 1e-4
_REF = {}


def _ref():
    """The JAX engine (XLA attention) and its params in the port's layout."""
    if not _REF:
        from omchat_tpu.config import OmChatConfig
        from omchat_tpu.runtime.generate import OmChatEngine
        from tests.test_sharding import _tiny_params

        cfg = OmChatConfig.tiny()
        params = _tiny_params(cfg)
        _REF.update(engine=OmChatEngine(cfg, params, attn_impl="xla", image_cache_size=0),
                    params=from_jax_params(jax.device_get(params)))
    return _REF


def _engine(**kw):
    return TEngine(TCfg.tiny(), _ref()["params"], device="cpu", image_cache_size=0, **kw)


def _both(gen_kw, **opts):
    """The JAX and the port's ``generate`` on the image request with the same
    options."""
    from omchat_tpu.config import GenerationConfig

    ids, px = _request()
    want = _ref()["engine"].generate([ids], px, GenerationConfig(**gen_kw), **opts)
    got = _engine().generate([ids], px, TGen(**gen_kw), **opts)
    return got, want


def _greedy_tokens():
    return _both(dict(max_new_tokens=NEW, eos_token_id=-1))[1].token_ids[0]


@pytest.mark.parametrize("case", ["bias", "presence", "frequency", "bias_and_penalties"])
def test_bias_and_penalties_match_jax(case):
    """Each option gives JAX's tokens; each moves the greedy run (so the test
    sees it act), the bias from the first token on."""
    base = _greedy_tokens()
    gen = dict(max_new_tokens=NEW, eos_token_id=-1)
    opts = {}
    if case in ("bias", "bias_and_penalties"):
        opts["logit_bias"] = {base[0] + 1: 50.0, 10**6: 5.0}  # an out-of-vocab id is inert
    if case in ("presence", "bias_and_penalties"):
        gen["presence_penalty"] = -4.0  # negative: repeats are favoured, so the run moves
    if case in ("frequency", "bias_and_penalties"):
        gen["frequency_penalty"] = -2.5
    got, want = _both(gen, **opts)
    assert got.token_ids == want.token_ids
    assert got.token_ids[0] != base
    if "logit_bias" in opts:
        assert got.token_ids[0][0] == base[0] + 1


@pytest.mark.parametrize("top", [0, 3])
def test_logprobs_and_top_logprobs_match_jax(top):
    gen = dict(max_new_tokens=NEW, eos_token_id=-1, frequency_penalty=0.5)
    got, want = _both(gen, return_logprobs=True, top_logprobs=top, logit_bias={7: 2.0})
    assert got.token_ids == want.token_ids
    np.testing.assert_allclose(got.logprobs[0], want.logprobs[0], atol=LP_TOL, rtol=0)
    if top:
        for g, w in zip(got.top_logprobs[0], want.top_logprobs[0]):
            assert [t for t, _ in g] == [t for t, _ in w]
            np.testing.assert_allclose([lp for _, lp in g], [lp for _, lp in w], atol=LP_TOL, rtol=0)
        assert all(g[0][0] == t for g, t in zip(got.top_logprobs[0], got.token_ids[0]))
    else:
        assert got.top_logprobs is None


def test_allowed_tokens_fn_replaces_bias_and_penalties_as_jax_does():
    """The mask is added to the raw logits: a +100 bias on an allowed token
    and a penalty that would change the greedy run are both dropped (the JAX
    package's behaviour, pinned); the walk ends where the function returns
    None."""
    base = _greedy_tokens()
    allowed = sorted({base[0], base[1], base[2], 3, 4, 5})
    favoured = [t for t in allowed if t != base[0]][0]
    calls = []

    def fn(path):
        calls.append(list(path))
        return None if len(path) == 6 else allowed

    gen = dict(max_new_tokens=NEW, eos_token_id=-1, presence_penalty=3.0)
    got, want = _both(gen, allowed_tokens_fn=fn, logit_bias={favoured: 100.0}, return_logprobs=True)
    assert got.token_ids == want.token_ids and len(got.token_ids[0]) == 6
    assert got.token_ids[0][0] == base[0]  # the bias is not applied under the mask
    assert all(t in allowed for t in got.token_ids[0])
    np.testing.assert_allclose(got.logprobs[0], want.logprobs[0], atol=LP_TOL, rtol=0)
    assert calls[:7] == [got.token_ids[0][:i] for i in range(7)]
    with pytest.raises(ValueError, match="single-request"):
        _engine().generate([[5, 6], [7, 8]], None, TGen(max_new_tokens=2), allowed_tokens_fn=fn)


def test_adapter_id_raises_by_name():
    """An adapter asked of an engine without a LoRA bank is refused by name
    (the bank itself: tests/test_torch_lora_bank.py)."""
    with pytest.raises(ValueError, match="no LoRA bank"):
        _engine().generate([[5, 6, 7]], None, TGen(max_new_tokens=2), adapter_id=1)


@pytest.mark.parametrize("chunk", [16, 24, 256], ids=["divides", "does_not_divide", "one_chunk"])
def test_prefill_chunked_matches_jax_and_the_one_shot_prefill(chunk):
    """Last-token logits of JAX's ``prefill_chunked`` and of the port's one
    ``prefill``; the cache rows each chunk wrote equal the one-shot cache's
    over the prompt; the cache covers the padded write extent."""
    ref = _ref()["engine"]
    ids, px = _request()
    ids = ids + list(range(40, 90))  # a second chunk of text after the image
    jplan = ref.plan([ids])
    jlogits, _ = ref.prefill_chunked(jplan, ref.encode_images(px), 8, chunk_size=chunk)
    eng = _engine()
    plan = eng.plan([ids])
    feats = eng.encode_images(px)
    got, cache = eng.prefill_chunked(plan, feats, 8, chunk_size=chunk)
    one, full = eng.prefill(plan, feats, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=1e-4, rtol=0)
    n = int(plan.lengths[0])
    np.testing.assert_allclose(cache.k[:, :, :, :n].numpy(), full.k[:, :, :, :n].numpy(), atol=1e-4, rtol=0)
    assert cache.max_len >= -(-plan.max_len // chunk) * chunk + 8


def test_rope_positions_past_max_position_embeddings():
    """RoPE is computed from positions (no table): past the config's
    ``max_position_embeddings`` the angles are those of the formula."""
    from omchat_torch.ops.rope import rope_cos_sin

    pos = torch.tensor([[32767, 32768, 32900, 40000]], dtype=torch.int32)
    cos, sin = rope_cos_sin(pos, 128, theta=1e6, max_position_embeddings=32768, dtype=torch.float32)
    inv = 1.0 / (1e6 ** (np.arange(0, 128, 2, dtype=np.float64) / 128))
    ang = pos.numpy()[..., None].astype(np.float64) * inv
    np.testing.assert_allclose(cos.numpy()[..., :64].reshape(ang.shape), np.cos(ang), atol=2e-3)
    np.testing.assert_allclose(sin.numpy()[..., :64].reshape(ang.shape), np.sin(ang), atol=2e-3)


# -- sampling ---------------------------------------------------------------


def test_sample_from_buffers_is_sample_bit_for_bit():
    """The graphed step's buffer-driven pick (and ``sample``, which calls it)
    keeps the logits that temperature, ``apply_top_k`` and ``apply_top_p``
    keep in turn (each held bitwise against JAX's in
    ``test_torch_paged_kernels.py``) and draws the same tokens from the same
    generator."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 400)).astype(np.float32) * 3)
    for t, k, p in [(0.8, 50, 1.0), (1.0, 0, 0.9), (0.7, 5, 0.5), (1.3, 0, 1.0), (0.5, 1, 0.3)]:
        cfg = TGen(do_sample=True, temperature=t, top_k=k, top_p=p)
        g0, g1, g2 = (torch.Generator().manual_seed(3) for _ in range(3))
        want = [ts.categorical(ts.apply_top_p(ts.apply_top_k(x / t, k), p), g0) for _ in range(20)]
        a = [ts.sample(x, g1, cfg) for _ in range(20)]
        b = [ts.sample_from(x, g2, torch.tensor([t]), torch.tensor([k], dtype=torch.int32), torch.tensor([p]))
             for _ in range(20)]
        assert all(torch.equal(w, u) and torch.equal(w, v) for w, u, v in zip(want, a, b))


def test_sample_distribution_chi_square():
    """Draws from a fixed softmax over 8 tokens: chi-square against the
    expected counts under the 0.001 critical value (7 dof: 24.32)."""
    logits = torch.tensor([[2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -2.0]])
    n = 20000
    g = torch.Generator().manual_seed(0)
    one = torch.tensor([1.0]), torch.tensor([0], dtype=torch.int32), torch.tensor([1.0])
    draws = torch.cat([ts.sample_from(logits.expand(n, 8), g, *one)])
    counts = np.bincount(draws.numpy(), minlength=8)
    expected = torch.softmax(logits, -1)[0].numpy() * n
    assert ((counts - expected) ** 2 / expected).sum() < 24.32


def test_sample_support_top_k_top_p():
    """Top-k keeps the k largest; top-p the smallest prefix holding p of the
    mass of the top-k renormalised (the JAX package's order)."""
    logits = torch.log(torch.tensor([[0.4, 0.25, 0.15, 0.1, 0.06, 0.04]]))
    g = torch.Generator().manual_seed(1)
    n = 4000

    def support(k, p):
        d = ts.sample_from(logits.expand(n, 6), g, torch.tensor([1.0]), torch.tensor([k], dtype=torch.int32),
                           torch.tensor([p]))
        return set(d.tolist())

    assert support(3, 1.0) == {0, 1, 2}
    assert support(0, 0.5) == {0, 1}
    assert support(0, 0.8) == {0, 1, 2}
    # top-3 renormalised: 0.5, 0.3125, 0.1875, so p 0.75 keeps two (over the
    # whole vocabulary's mass, 0.4 + 0.25 < 0.75, it would keep three)
    assert support(3, 0.75) == {0, 1}
    assert support(1, 1.0) == {0}


def test_sampled_step_body_is_the_eager_step_bit_for_bit():
    """The decode state's sampled step (what a CUDA engine captures) draws
    what an eager loop of ``decode_step`` + ``sample`` draws from one seeded
    CPU generator: the same tokens at every step, first pick included."""
    eng = _engine()
    ids, px = _request()
    cfg = TGen(max_new_tokens=8, eos_token_id=-1, do_sample=True, temperature=0.8, top_k=20, top_p=0.9)
    plan = eng.plan([ids])
    feats = eng.encode_images(px)
    logits, cache = eng.prefill(plan, feats, 8)
    g = torch.Generator().manual_seed(11)
    want = [ts.sample(logits, g, cfg)]
    kv_len = torch.as_tensor(plan.lengths)
    for _ in range(6):
        logits, cache = eng.decode_step(want[-1], kv_len, cache)
        want.append(ts.sample(logits, g, cfg))
        kv_len = kv_len + 1
    out = eng.generate([ids], px, cfg, rng_key=11)
    assert out.token_ids[0][:7] == [int(t) for t in want]
    assert eng.generate_ondevice([ids], px, cfg, rng_key=11).token_ids == out.token_ids
    assert eng.generate([ids], px, cfg, rng_key=torch.Generator().manual_seed(5)).token_ids == \
        eng.generate([ids], px, cfg, rng_key=torch.Generator().manual_seed(5)).token_ids
    (st,) = eng._states.values()
    assert set(st.runs) == {GREEDY, (True, False)}


def test_sampled_top_k1_is_greedy_and_rng_key_types():
    eng = _engine()
    ids, px = _request()
    top1 = TGen(max_new_tokens=NEW, eos_token_id=-1, do_sample=True, temperature=0.7, top_k=1)
    assert eng.generate([ids], px, top1, rng_key=4).token_ids[0] == _greedy_tokens()
    with pytest.raises(TypeError, match="rng_key"):
        eng.generate([ids], px, top1, rng_key="seed")
