"""The port's w8a8 serving mode on the CPU against the JAX package: the ViT
glue scan, the Qwen2 glue trunk, the fc1 calibration, the load path's
quantization, and both engines, on the same seeded weights.

Weights are float32 (int8 kernels, bf16 scales) on both sides, so what
differs is only where fp32 sums are taken in another order, which moves an
int8 code by one now and then; each code that moves shifts its row's
product by one weight-code step.  Tolerances:
- the ViT glue scan and the trunk: max |Δ| <= 2e-2 of max |ref| (the JAX
  package's own limit for its glue path against its unfused path,
  tests/test_llm_glue.py:109, tests/test_pallas_kernels.py:427);
- calibrated fc1 scales: rtol 1e-3;
- the decode step: no a8 and no glue kernel, so with and without
  ``quant_glue`` it is bitwise the same; against JAX atol 3e-5 / rtol 1e-4
  (float32 sums in another order);
- the engines: greedy tokens identical (the fixture's logits are decisive:
  every step's top-2 margin is checked to exceed twice the first step's
  deviation from JAX), and first-step logits within 2e-2 of max |logit|.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.config import OmChatConfig as TOmChatConfig
from omchat_torch.config import TextConfig as TTextConfig
from omchat_torch.config import VisionConfig as TVisionConfig

GLUE_TOL = 2e-2
VIT_KW = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=3, num_attention_heads=2, image_size=56,
              patch_size=14)  # head_dim 128: the packed path, so the glue scan engages
TEXT_KW = dict(vocab_size=128, hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=2,
               num_key_value_heads=1, w8a8=True)  # o_proj 256 x 256: the fused proj glue (K11)


def _rel_err(got, want) -> float:
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / (np.abs(w).max() + 1e-6))


def _spy(monkeypatch, module, names) -> dict:
    """Count the calls of functions as ``module`` sees them."""
    calls = {n: 0 for n in names}
    for n in names:
        fn = getattr(module, n)

        def wrapped(*a, _fn=fn, _n=n, **kw):
            calls[_n] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(module, n, wrapped)
    return calls


def _quantized_layers(params):
    from omchat_tpu.ops.linear import quantize_tree

    return {**params, "layers": quantize_tree(params["layers"])}


_VIT = {}


def _vit_case():
    """(JAX config, quantized params, calibrated params, pixels), once."""
    if not _VIT:
        from omchat_tpu.config import VisionConfig
        from omchat_tpu.models import intern_vit as jvit

        cfg = VisionConfig(**VIT_KW, w8a8=True)
        params = _quantized_layers(jvit.init_params(jax.random.PRNGKey(1), cfg))
        px = np.random.default_rng(2).standard_normal((2, 3, 56, 56)).astype(np.float32)
        calib = jvit.calibrate_fc1_scales(params, cfg, jnp.asarray(px))
        _VIT.update(cfg=cfg, params=jax.device_get(params), calib=jax.device_get(calib), px=px)
    return _VIT


@pytest.mark.parametrize("fc1", ["static", "dynamic"])
def test_vit_glue_scan_matches_jax(fc1, monkeypatch):
    """The glue scan on K8 / K9 / K11 (their plain versions here) against the
    JAX glue scan on its Pallas kernels (interpret)."""
    from omchat_tpu.models import intern_vit as jvit

    from omchat_torch.models import intern_vit as tvit

    case = _vit_case()
    jparams = case["calib"] if fc1 == "static" else case["params"]
    want = jvit.intern_vit_forward(jparams, case["cfg"], jnp.asarray(case["px"]), attn_impl="pallas")
    calls = _spy(monkeypatch, tvit, ["attn_proj_glue_quant", "add_rmsnorm_quant", "fc1_gelu_quant"])
    got = tvit.intern_vit_forward(from_jax_params(jparams), TVisionConfig(**VIT_KW, w8a8=True),
                                  torch.from_numpy(case["px"]))
    assert got.shape == want.shape
    layers = VIT_KW["num_hidden_layers"]
    assert calls == {"attn_proj_glue_quant": layers, "add_rmsnorm_quant": layers,
                     "fc1_gelu_quant": layers if fc1 == "static" else 0}
    assert _rel_err(got.numpy(), want) < GLUE_TOL


def test_calibrate_fc1_scales_matches_jax():
    from omchat_torch.models import intern_vit as tvit

    case = _vit_case()
    got = tvit.calibrate_fc1_scales(from_jax_params(case["params"]), TVisionConfig(**VIT_KW, w8a8=True),
                                    torch.from_numpy(case["px"]))
    want = case["calib"]["layers"]["mlp"]["fc1_out_scale"]
    scales = got["layers"]["mlp"]["fc1_out_scale"]
    assert scales.shape == (VIT_KW["num_hidden_layers"],) and scales.dtype == torch.float32
    np.testing.assert_allclose(scales.numpy(), np.asarray(want), rtol=1e-3)


def _text_case(**kw):
    from omchat_tpu.config import TextConfig
    from omchat_tpu.models import qwen2 as jq

    cfg = TextConfig(**TEXT_KW, **kw)
    return cfg, jax.device_get(_quantized_layers(jq.init_params(jax.random.PRNGKey(3), cfg)))


@pytest.mark.parametrize("oproj", ["square", "nonsquare"])
def test_llm_glue_trunk_matches_jax(oproj, monkeypatch):
    """The prefill trunk on K7 / K11 (plain versions) against the JAX glue
    trunk (interpret); a non-square o_proj (head_dim 192: [384, 256]) falls
    back to a w8a8 o_proj and K7, as in JAX."""
    from omchat_tpu.models import qwen2 as jq

    from omchat_torch.models import qwen2 as tq

    kw = {} if oproj == "square" else {"head_dim": 192}
    cfg, params = _text_case(**kw)
    rng = np.random.default_rng(5)
    B, S = 2, 19
    embeds = (rng.standard_normal((B, S, cfg.hidden_size)) * 0.1).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want, _ = jq.qwen2_forward(params, cfg, jnp.asarray(embeds), jnp.asarray(pos), attn_impl=None)
    calls = _spy(monkeypatch, tq, ["rmsnorm_quant", "attn_proj_glue_quant"])
    got, _ = tq.qwen2_forward(from_jax_params(params), TTextConfig(**TEXT_KW, **kw), torch.from_numpy(embeds),
                              torch.from_numpy(pos.copy()), attn_impl=None)
    layers = TEXT_KW["num_hidden_layers"]
    assert calls == ({"rmsnorm_quant": layers, "attn_proj_glue_quant": layers} if oproj == "square"
                     else {"rmsnorm_quant": 2 * layers, "attn_proj_glue_quant": 0})
    assert _rel_err(got.numpy(), want) < GLUE_TOL


def test_decode_step_is_weight_only_and_matches_jax(monkeypatch):
    """S == 1 takes no a8 and no glue kernel: the layer is bitwise the same
    with and without ``quant_glue``; the whole decode step matches JAX."""
    from omchat_tpu.models import qwen2 as jq

    from omchat_torch.models import qwen2 as tq
    from omchat_torch.utils.tree import layer_slice

    cfg, params = _text_case()
    tcfg = TTextConfig(**TEXT_KW)
    tparams = from_jax_params(params)
    rng = np.random.default_rng(8)
    x = torch.from_numpy((rng.standard_normal((1, 1, cfg.hidden_size)) * 0.1).astype(np.float32))
    cos, sin = tq.rope_cos_sin(torch.zeros((1, 1), dtype=torch.int32), cfg.attn_head_dim, theta=cfg.rope_theta,
                               scaling=cfg.rope_scaling, max_position_embeddings=cfg.max_position_embeddings,
                               dtype=torch.float32)
    calls = _spy(monkeypatch, tq, ["rmsnorm_quant", "dense_prequant", "attn_proj_glue_quant"])
    layer = layer_slice(tparams["layers"], 0)
    group = cfg.num_attention_heads // cfg.num_key_value_heads
    outs = [tq.decoder_layer(tcfg, x, layer, cos, sin, lambda q, k, v: v.repeat_interleave(group, dim=2),
                             quant_glue=glue) for glue in (False, True)]
    assert torch.equal(outs[0], outs[1])
    assert not any(calls.values())
    emb = (rng.standard_normal((1, 1, cfg.hidden_size)) * 0.1).astype(np.float32)
    want, _ = jq.qwen2_forward(params, cfg, jnp.asarray(emb), jnp.asarray([[0]]), jq.init_kv_cache(cfg, 1, 16), 0,
                               jnp.asarray([1]), attn_impl="xla")
    cache = tq.init_kv_cache(tcfg, 1, 16)  # bf16, as JAX's default cache
    got, _ = tq.qwen2_forward(tparams, tcfg, torch.from_numpy(emb), torch.tensor([[0]]), cache, torch.tensor([0]),
                              torch.tensor([1]), attn_impl="plain")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# The load path and the engines, on OmChatConfig.tiny()
# ---------------------------------------------------------------------------

NEW_TOKENS = 10
_ENGINE = {}


def _engine_case():
    """The tiny model in float32, quantized and calibrated by the JAX
    package (its load path's steps), and the JAX engines' runs, once."""
    if not _ENGINE:
        from omchat_tpu.config import GenerationConfig, OmChatConfig
        from omchat_tpu.models.intern_vit import calibrate_fc1_scales
        from omchat_tpu.ops.linear import quantize_tree
        from omchat_tpu.runtime.generate import OmChatEngine
        from omchat_tpu.runtime.paged_engine import PagedBatchEngine
        from tests.test_sharding import _tiny_params
        from tests.test_torch_engine import _request
        from tests.test_torch_paged_engine import ENGINE, _workload

        cfg = OmChatConfig.tiny().with_w8a8()
        raw = _tiny_params(cfg)
        params = quantize_tree(raw)
        size = cfg.vision.image_size
        pixels = jnp.asarray(np.random.default_rng(0).standard_normal((2, 3, size, size)), jnp.bfloat16)
        params["vision_tower"] = calibrate_fc1_scales(params["vision_tower"], cfg.vision, pixels)
        ids, px = _request()
        eng = OmChatEngine(cfg, params, attn_impl=None, image_cache_size=0)
        out = eng.generate([ids], px, GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1))
        first, _ = eng.prefill(eng.plan([ids]), eng.encode_images(px), NEW_TOKENS)
        peng = PagedBatchEngine(cfg, params, attn_impl=None, **ENGINE)
        rids = [peng.submit(i, p, max_new_tokens=6, eos_token_id=-1) for i, p in _workload()]
        peng.run_to_completion(max_ticks=200)
        _ENGINE.update(raw=jax.device_get(raw), params=jax.device_get(params), tokens=out.token_ids[0],
                       first=np.asarray(first[0], np.float32), paged=[peng.result(r) for r in rids])
    return _ENGINE


def test_quantize_model_matches_the_jax_load_path():
    """``api.quantize_model`` (what ``load_pretrained_model(w8a8=True)``
    runs) gives the JAX load path's int8 codes and scales exactly and its
    calibrated fc1 scales within rtol 1e-3."""
    from omchat_torch.api import quantize_model

    case = _engine_case()
    cfg, got = quantize_model(TOmChatConfig.tiny(), from_jax_params(case["raw"]), w8a8=True)
    assert cfg.vision.w8a8 and cfg.text.w8a8
    want = from_jax_params(case["params"])

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}.{k}")
            elif k == "fc1_out_scale":
                np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-3)
            else:
                assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), f"{path}.{k}"

    walk(got, want)


def test_engine_w8a8_matches_jax_engine():
    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.generate import OmChatEngine
    from tests.test_torch_engine import _request

    case = _engine_case()
    ids, px = _request()
    eng = OmChatEngine(TOmChatConfig.tiny().with_w8a8(), from_jax_params(case["params"]), device="cpu")
    steps = []
    out = eng.generate([ids], px, GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1),
                       logits_callback=lambda s, lg: steps.append(lg[0].numpy().copy()))
    dev = float(np.abs(steps[0] - case["first"]).max())
    assert dev <= GLUE_TOL * np.abs(case["first"]).max()
    margins = [float(np.diff(np.sort(lg)[-2:])[0]) for lg in steps]
    assert min(margins) > 2 * dev, (margins, dev)  # decisive: no step's top two are within the deviation
    assert out.token_ids[0] == case["tokens"]


def test_paged_engine_w8a8_matches_jax_engine(monkeypatch):
    """Every prefill route (batched shorts, lone short, chunks) runs the glue
    layer (K7 once per layer and dispatch) and the tokens are the JAX
    engine's."""
    from omchat_torch.models import qwen2 as tq
    from omchat_torch.runtime.paged_engine import PagedBatchEngine
    from tests.test_torch_paged_engine import ENGINE, _workload

    case = _engine_case()
    eng = PagedBatchEngine(TOmChatConfig.tiny().with_w8a8(), from_jax_params(case["params"]), device="cpu", **ENGINE)
    calls = _spy(monkeypatch, tq, ["rmsnorm_quant"])
    routes = {}
    for name in ("_prefill_shorts", "_run_chunk"):
        orig = getattr(eng, name)

        def wrapped(*a, _orig=orig, _name=name, **kw):
            before = calls["rmsnorm_quant"]
            out = _orig(*a, **kw)
            routes.setdefault(_name, []).append(calls["rmsnorm_quant"] - before)
            return out

        setattr(eng, name, wrapped)
    rids = [eng.submit(i, p, max_new_tokens=6, eos_token_id=-1) for i, p in _workload()]
    eng.run_to_completion(max_ticks=200)
    assert [eng.result(r) for r in rids] == case["paged"]
    assert eng.allocator.available == ENGINE["num_pages"]
    layers = TOmChatConfig.tiny().text.num_hidden_layers
    # the tiny o_proj (64 wide) takes the K7 fallback: two K7 passes per layer
    assert routes["_prefill_shorts"] and all(n == 2 * layers for n in routes["_prefill_shorts"])
    assert routes["_run_chunk"] and all(n == 2 * layers for n in routes["_run_chunk"])


def test_load_pretrained_model_w8a8_and_the_cli(tmp_path):
    """The tiny on-disk checkpoint loads quantized and calibrated on the CPU
    and chats; ``--w8a8`` on the CLI defaults to CUDA and raises without it."""
    from PIL import Image

    from omchat_torch.api import load_pretrained_model
    from omchat_torch.cli.single_inference import main
    from omchat_torch.config import GenerationConfig
    from tests.test_api_e2e import _write_tiny_checkpoint, _write_tiny_tokenizer

    d = str(tmp_path)
    _write_tiny_tokenizer(d)
    _write_tiny_checkpoint(d)
    model = load_pretrained_model(d, dtype=torch.float32, w8a8=True, device="cpu")
    p = model.engine.params
    assert model.config.text.w8a8 and p["language_model"]["layers"]["mlp"]["up_proj"]["kernel_q"].dtype == torch.int8
    assert p["vision_tower"]["layers"]["mlp"]["fc1_out_scale"].shape == (model.config.vision.num_hidden_layers,)
    assert "kernel_q" in p["projector"]["linear_1"] and "kernel_q" in p["language_model"]["lm_head"]
    img = Image.fromarray(np.random.default_rng(0).integers(0, 255, (100, 80, 3), dtype=np.uint8))
    assert isinstance(model.chat("what is this?", image=img, generation=GenerationConfig(max_new_tokens=3)), str)
    int8 = load_pretrained_model(d, dtype=torch.float32, quantize_int8=True, device="cpu")
    assert not int8.config.text.w8a8 and "fc1_out_scale" not in int8.engine.params["vision_tower"]["layers"]["mlp"]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model-path", d, "--image-path", "x.png", "--question", "q", "--w8a8"])
