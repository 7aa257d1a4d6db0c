"""The calibrated w8a8 Qwen2 MLP on the CPU against the JAX package: K10's
plain version (gate and up int8 GEMMs + silu * up + static-scale quantize)
against ``dense_prequant_swiglu_quant_pallas`` in interpret mode, the
unfused chain against the JAX chain, ``calibrate_swiglu_scales``, the glue
trunk over calibrated params and the single-request engine.

Tolerances:
- K10's codes: max |Δ| <= 1 and at least 99% equal (the JAX package's own
  limit for the kernel against its chain, tests/test_llm_glue.py:89, with
  the share the port's other w8a8 kernels are held to): the kernel multiplies
  by 1 / out_scale where the chain divides, and the exp of the logistic is
  another implementation;
- the chain: equal codes (the same fp32 operations in the same order);
- calibrated scales: rtol 1e-6 in float32 (fp32 round-off of the same amax);
- the glue trunk over calibrated params: 3e-2 of max |ref| (the JAX
  package's limit for the static path, tests/test_llm_glue.py:149);
- the engine: greedy tokens identical where the logits are decisive (every
  step's top-2 margin above twice the first step's deviation from JAX), and
  first-step logits within 2e-2 of max |logit|.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.config import TextConfig as TTextConfig
from omchat_torch.models import qwen2 as tq
from omchat_torch.ops import linear as tlin
from omchat_torch.ops import quant_matmul as tqm

CODE_EQUAL = 0.99
TEXT_KW = dict(vocab_size=128, hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=2,
               num_key_value_heads=1, w8a8=True)  # gate / up 256 -> 512: K10's geometry gate holds


def _check_codes(got, want, equal=CODE_EQUAL):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1, f"codes differ by {d.max()}"
    assert (d == 0).mean() >= equal, f"only {(d == 0).mean():.4f} of the codes equal"


def _swiglu_case(seed, lead, k, n):
    """int8 activations, row scales and a gate / up pair as the JAX package
    holds them ([in, out]) and as the port does ([out, in])."""
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (*lead, k)).astype(np.int8)
    rs = (rng.random((*lead, 1)) * 0.01 + 1e-3).astype(np.float32)
    jps, tps = [], []
    for _ in range(2):
        q = rng.integers(-127, 128, (k, n)).astype(np.int8)
        s = jnp.asarray(rng.random(n) * 4e-4 + 1e-4, jnp.bfloat16)
        jps.append({"kernel_q": jnp.asarray(q), "scale": s})
        tps.append({"kernel_q": torch.from_numpy(q.T.copy()),
                    "scale": torch.from_numpy(np.asarray(s, np.float32)).bfloat16()})
    return xq, rs, jps, tps


@pytest.mark.parametrize("lead,k,n", [((2, 24), 256, 384), ((130,), 128, 256)], ids=["rows48_padded", "rows130"])
def test_swiglu_quant_matches_pallas(lead, k, n):
    from omchat_tpu.ops.linear import dense_prequant_swiglu_quant
    from omchat_tpu.ops.quant_matmul import dense_prequant_swiglu_quant_pallas

    xq, rs, (jg, ju), (tg, tu) = _swiglu_case(4, lead, k, n)
    out_scale = np.float32(0.01)
    want = dense_prequant_swiglu_quant_pallas(jnp.asarray(xq), jnp.asarray(rs), jg, ju, jnp.float32(out_scale),
                                              interpret=True)
    txq, trs = torch.from_numpy(xq), torch.from_numpy(rs)
    assert tqm.pallas_supported(k, n)
    got = tqm.swiglu_quant(txq, trs, tg, tu, torch.tensor(out_scale))
    assert got.dtype == torch.int8 and got.shape == (*lead, n)
    assert tqm.dense_prequant_swiglu_quant_cuda.launches == 0  # CPU tensors never launch
    _check_codes(got, want)
    # the chains (they divide by out_scale): the port's gives the JAX chain's codes
    chain = tlin.dense_prequant_swiglu_quant(txq, trs, tg, tu, torch.tensor(out_scale))
    want_chain = dense_prequant_swiglu_quant(jnp.asarray(xq), jnp.asarray(rs), jg, ju, jnp.float32(out_scale))
    np.testing.assert_array_equal(chain.numpy(), np.asarray(want_chain))
    _check_codes(got, chain)


def test_swiglu_quant_takes_the_chain_off_the_geometry_gate(monkeypatch):
    """K < 128 (the tiny model's 64): the dispatcher runs the chain, as JAX's."""
    xq, rs, _, (tg, tu) = _swiglu_case(5, (3, 7), 64, 128)
    assert not tqm.pallas_supported(64, 128)
    monkeypatch.setattr(tqm, "dense_prequant_swiglu_quant_cuda", lambda *a: pytest.fail("K10 off its gate"))
    got = tqm.swiglu_quant(torch.from_numpy(xq), torch.from_numpy(rs), tg, tu, torch.tensor(0.02))
    want = tlin.dense_prequant_swiglu_quant(torch.from_numpy(xq), torch.from_numpy(rs), tg, tu, torch.tensor(0.02))
    assert torch.equal(got, want)


def test_swiglu_wrapper_never_falls_back_off_the_cpu():
    """A tensor that is not on the CPU launches K10 or raises."""
    m = torch.empty((4, 128), device="meta", dtype=torch.int8)
    p = {"kernel_q": torch.empty((128, 128), device="meta", dtype=torch.int8),
         "scale": torch.empty((128,), device="meta", dtype=torch.bfloat16)}
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        tqm.dense_prequant_swiglu_quant_cuda(m, torch.empty((4, 1), device="meta"), p, p, torch.tensor(0.01))


def _text_case():
    from omchat_tpu.config import TextConfig
    from omchat_tpu.models import qwen2 as jq
    from omchat_tpu.ops.linear import quantize_tree

    cfg = TextConfig(**TEXT_KW)
    params = jq.init_params(jax.random.PRNGKey(3), cfg)
    params = {**params, "layers": quantize_tree(params["layers"])}
    rng = np.random.default_rng(7)
    B, S = 2, 16
    embeds = (rng.standard_normal((B, S, cfg.hidden_size)) * 0.1).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    return cfg, params, embeds, pos


_CALIB = {}


def _calibrated():
    """(JAX config, quantized params, JAX-calibrated params, embeds, positions), once."""
    if not _CALIB:
        from omchat_tpu.models.qwen2 import calibrate_swiglu_scales

        cfg, params, embeds, pos = _text_case()
        calib = calibrate_swiglu_scales(params, cfg, jnp.asarray(embeds), jnp.asarray(pos))
        _CALIB.update(cfg=cfg, params=jax.device_get(params), calib=jax.device_get(calib), embeds=embeds, pos=pos)
    return _CALIB


def test_calibrate_swiglu_scales_matches_jax():
    case = _calibrated()
    got = tq.calibrate_swiglu_scales(from_jax_params(case["params"]), TTextConfig(**TEXT_KW),
                                     torch.from_numpy(case["embeds"]), torch.from_numpy(case["pos"].copy()))
    scales = got["layers"]["mlp"]["swiglu_out_scale"]
    assert scales.shape == (TEXT_KW["num_hidden_layers"],) and scales.dtype == torch.float32
    assert "swiglu_out_scale" not in case["params"]["layers"]["mlp"]  # a new tree; the input is left as it was
    np.testing.assert_allclose(scales.numpy(), np.asarray(case["calib"]["layers"]["mlp"]["swiglu_out_scale"]),
                               rtol=1e-6)


def test_mlp_prequant_feeds_the_codes_to_down_proj():
    """With ``swiglu_out_scale`` set, the glue MLP returns down_proj of the
    SwiGLU codes (a [.., hidden] activation), as the JAX package's does."""
    from omchat_tpu.models.qwen2 import _dense_mlp_prequant
    from omchat_tpu.ops.linear import quantize_activations

    case = _calibrated()
    mlp = jax.tree.map(lambda a: a[0], case["calib"]["layers"]["mlp"])
    y = np.random.default_rng(9).standard_normal((2, 5, TEXT_KW["hidden_size"])).astype(np.float32)
    yq, yrs = quantize_activations(jnp.asarray(y))
    want = _dense_mlp_prequant(yq, yrs, mlp, jnp.float32, interpret=True)
    got = tq._mlp_prequant(torch.from_numpy(np.array(yq)), torch.from_numpy(np.array(yrs)),
                           from_jax_params(mlp), torch.float32)
    assert got.shape == (2, 5, TEXT_KW["hidden_size"]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6 * np.abs(np.asarray(want)).max())


def test_calibrated_glue_trunk_matches_jax(monkeypatch):
    """The prefill trunk over calibrated params: every layer's MLP takes the
    static epilogue (K10's plain version here) against the JAX glue trunk on
    its Pallas kernels (interpret)."""
    from omchat_tpu.models import qwen2 as jq

    case = _calibrated()
    want, _ = jq.qwen2_forward(case["calib"], case["cfg"], jnp.asarray(case["embeds"]), jnp.asarray(case["pos"]),
                               attn_impl=None)
    calls = []
    k10 = tqm.dense_prequant_swiglu_quant_cuda
    monkeypatch.setattr(tqm, "dense_prequant_swiglu_quant_cuda", lambda *a: calls.append(a[0].shape) or k10(*a))
    got, _ = tq.qwen2_forward(from_jax_params(case["calib"]), TTextConfig(**TEXT_KW),
                              torch.from_numpy(case["embeds"]), torch.from_numpy(case["pos"].copy()), attn_impl=None)
    assert len(calls) == TEXT_KW["num_hidden_layers"]
    want = np.asarray(want, np.float32)
    assert np.abs(got.numpy() - want).max() / (np.abs(want).max() + 1e-6) < 3e-2


NEW_TOKENS = 8


def _engine_cfgs():
    """The tiny model with a 128-wide trunk (gate / up 128 -> 256: K10's
    gate holds, o_proj square: K11), w8a8, in the JAX package and the port."""
    from omchat_tpu.config import OmChatConfig

    from omchat_torch.config import OmChatConfig as TOmChatConfig

    kw = dict(hidden_size=128, intermediate_size=256)
    jcfg = OmChatConfig.tiny()
    tcfg = TOmChatConfig.tiny()
    return (dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text, **kw)).with_w8a8(),
            dataclasses.replace(tcfg, text=dataclasses.replace(tcfg.text, **kw)).with_w8a8())


def test_engine_with_calibrated_mlp_matches_jax_engine(monkeypatch):
    from omchat_tpu.config import GenerationConfig as JGenerationConfig
    from omchat_tpu.models.qwen2 import calibrate_swiglu_scales
    from omchat_tpu.ops.linear import quantize_tree
    from omchat_tpu.runtime.generate import OmChatEngine as JEngine

    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.generate import OmChatEngine
    from tests.test_sharding import _tiny_params
    from tests.test_torch_engine import _request

    jcfg, tcfg = _engine_cfgs()
    params = quantize_tree(_tiny_params(jcfg))
    rng = np.random.default_rng(12)
    embeds = jnp.asarray(rng.standard_normal((1, 24, jcfg.text.hidden_size)) * 0.1, jnp.float32)
    pos = jnp.arange(24)[None]
    params["language_model"] = calibrate_swiglu_scales(params["language_model"], jcfg.text, embeds, pos)
    ids, px = _request()
    jeng = JEngine(jcfg, params, attn_impl=None, image_cache_size=0)
    want = jeng.generate([ids], px, JGenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1)).token_ids[0]
    first, _ = jeng.prefill(jeng.plan([ids]), jeng.encode_images(px), NEW_TOKENS)
    first = np.asarray(first[0], np.float32)

    calls = []
    k10 = tqm.dense_prequant_swiglu_quant_cuda
    monkeypatch.setattr(tqm, "dense_prequant_swiglu_quant_cuda", lambda *a: calls.append(1) or k10(*a))
    eng = OmChatEngine(tcfg, from_jax_params(jax.device_get(params)), device="cpu")
    steps = []
    out = eng.generate([ids], px, GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1),
                       logits_callback=lambda s, lg: steps.append(lg[0].numpy().copy()))
    assert len(calls) == tcfg.text.num_hidden_layers  # the prefill's MLPs; decode steps stay weight-only
    dev = float(np.abs(steps[0] - first).max())
    assert dev <= 2e-2 * np.abs(first).max()
    margins = [float(np.diff(np.sort(lg)[-2:])[0]) for lg in steps]
    assert min(margins) > 2 * dev, (margins, dev)  # decisive: no step's top two are within the deviation
    assert out.token_ids[0] == want
