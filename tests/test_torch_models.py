"""The port's models on the CPU against the JAX package's, on the same
weights carried over by ``from_jax_params``.

float32 on both sides; tolerances are float32 round-off of sums taken in
another order (the port's plain kernels vs the JAX XLA path).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.config import OmChatConfig as TOmChatConfig
from omchat_torch.config import VisionConfig as TVisionConfig

ATOL, RTOL = 3e-5, 1e-4


def _vit_case(head128: bool):
    from omchat_tpu.config import OmChatConfig, VisionConfig

    if head128:  # the packed path's geometry (tests/test_pallas_kernels.py:329-336)
        kw = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=2,
                  image_size=56, patch_size=14)
        return VisionConfig(**kw), TVisionConfig(**kw)
    return OmChatConfig.tiny().vision, TOmChatConfig.tiny().vision


_VIT_REFS = {}


def _vit_reference(head128: bool):
    """(JAX params, pixels, JAX XLA-path output), computed once per geometry."""
    if head128 not in _VIT_REFS:
        from omchat_tpu.models import intern_vit as jvit

        jcfg, _ = _vit_case(head128)
        jparams = jvit.init_params(jax.random.PRNGKey(0), jcfg)
        px = np.random.default_rng(0).standard_normal((2, 3, 56, 56)).astype(np.float32)
        ref = jvit.intern_vit_forward(jparams, jcfg, jnp.asarray(px), attn_impl="xla")
        _VIT_REFS[head128] = (jax.device_get(jparams), px, np.asarray(ref))
    return _VIT_REFS[head128]


@pytest.mark.parametrize("head128", [True, False], ids=["head_dim128_packed", "tiny_split"])
@pytest.mark.parametrize("impl", [None, "plain"], ids=["kernel_path", "plain_path"])
def test_intern_vit_matches_jax(head128, impl):
    from omchat_tpu.models import intern_vit as jvit

    from omchat_torch.models import intern_vit as tvit

    _, tcfg = _vit_case(head128)
    jparams, px, ref = _vit_reference(head128)
    out = tvit.intern_vit_forward(from_jax_params(jparams), tcfg, torch.from_numpy(px), attn_impl=impl)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tvit.feature_select(out).numpy(), np.asarray(jvit.feature_select(ref)),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("ptype", ["mlp2x_gelu", "linear"])
def test_projector_matches_jax(ptype):
    from omchat_tpu.config import ProjectorConfig
    from omchat_tpu.models import projector as jproj

    from omchat_torch.config import ProjectorConfig as TProjectorConfig
    from omchat_torch.models import projector as tproj

    jcfg, tcfg = ProjectorConfig.from_type(ptype), TProjectorConfig.from_type(ptype)
    jparams = jproj.init_params(jax.random.PRNGKey(1), jcfg, 48, 64)
    jparams = jax.tree.map(lambda a: a + 0.01, jparams)  # non-zero biases
    x = np.random.default_rng(1).standard_normal((2, 9, 48)).astype(np.float32)
    ref = jproj.projector_forward(jparams, jcfg, jnp.asarray(x))
    out = tproj.projector_forward(from_jax_params(jax.device_get(jparams)), tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


_QWEN_REF = {}


def _qwen2_reference():
    """The JAX trunk's run, computed once: prefill of two ragged sequences
    into a bucketed cache, then two decode steps.  Returns the inputs, the
    prefill hidden states, each decode step's logits and the final cache."""
    if not _QWEN_REF:
        from omchat_tpu.config import OmChatConfig
        from omchat_tpu.models import qwen2 as jq

        cfg = OmChatConfig.tiny().text
        params = jq.init_params(jax.random.PRNGKey(2), cfg)
        rng = np.random.default_rng(2)
        B, S, T = 2, 16, 32
        emb = rng.standard_normal((B, S, cfg.hidden_size)).astype(np.float32)
        lengths = np.asarray([16, 11], np.int32)
        pos = np.where(np.arange(S)[None] < lengths[:, None], np.arange(S)[None], 0).astype(np.int32)
        toks = rng.integers(0, cfg.vocab_size, (2, B)).astype(np.int32)
        cache = jq.init_kv_cache(cfg, B, T, dtype=jnp.float32)
        h, cache = jq.qwen2_forward(params, cfg, jnp.asarray(emb), jnp.asarray(pos), cache,
                                    write_pos=jnp.zeros((B,), jnp.int32), kv_len=jnp.asarray(lengths), attn_impl="xla")
        prefill_k = np.asarray(cache.k)
        kv, step_logits = lengths.copy(), []
        for tok in toks:
            e = jq.embed_tokens(params, jnp.asarray(tok)[:, None])
            hd, cache = jq.qwen2_forward(params, cfg, e, jnp.asarray(kv)[:, None], cache, write_pos=jnp.asarray(kv),
                                         kv_len=jnp.asarray(kv + 1), attn_impl="xla")
            step_logits.append(np.asarray(jq.lm_head(params, cfg, hd)))
            kv = kv + 1
        _QWEN_REF.update(params=jax.device_get(params), emb=emb, lengths=lengths, pos=pos, toks=toks, T=T,
                         hidden=np.asarray(h), prefill_k=prefill_k, step_logits=step_logits,
                         k=np.asarray(cache.k), v=np.asarray(cache.v))
    return _QWEN_REF


@pytest.mark.parametrize("impl", [None, "plain"], ids=["kernel_path", "plain_path"])
def test_qwen2_prefill_and_decode_match_jax(impl):
    """Prefill into a bucketed cache with ragged lengths, then two decode
    steps (read-only cache + self column + one row commit): hidden states,
    logits and the whole cache against ``qwen2_forward``."""
    from omchat_torch.models import qwen2 as tq

    ref = _qwen2_reference()
    cfg = TOmChatConfig.tiny().text
    params = from_jax_params(ref["params"])
    lengths = ref["lengths"]
    B = len(lengths)
    cache = tq.init_kv_cache(cfg, B, ref["T"], dtype=torch.float32)
    h, cache = tq.qwen2_forward(params, cfg, torch.from_numpy(ref["emb"]), torch.from_numpy(ref["pos"]), cache,
                                write_pos=torch.zeros(B, dtype=torch.int32), kv_len=torch.from_numpy(lengths),
                                attn_impl=impl)
    for b in range(B):
        n = int(lengths[b])
        np.testing.assert_allclose(h[b, :n].numpy(), ref["hidden"][b, :n], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(cache.k.numpy(), ref["prefill_k"], atol=ATOL, rtol=RTOL)

    kv = torch.from_numpy(lengths.copy())
    for step, tok in enumerate(ref["toks"]):
        e = tq.embed_tokens(params, torch.from_numpy(tok)[:, None])
        hd, cache = tq.qwen2_forward(params, cfg, e, kv[:, None], cache, write_pos=kv, kv_len=kv + 1, attn_impl=impl)
        np.testing.assert_allclose(tq.lm_head(params, cfg, hd).numpy(), ref["step_logits"][step], atol=ATOL,
                                   rtol=RTOL, err_msg=f"decode step {step}")
        kv = kv + 1
    np.testing.assert_allclose(cache.k.numpy(), ref["k"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(cache.v.numpy(), ref["v"], atol=ATOL, rtol=RTOL)


def test_embed_tokens_clamps_like_jax():
    from omchat_tpu.models import qwen2 as jq

    from omchat_torch.models import qwen2 as tq

    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.asarray([[-200, 0, 3, 9]], np.int32)
    ref = jq.embed_tokens({"embed_tokens": jnp.asarray(table)}, jnp.asarray(ids))
    out = tq.embed_tokens({"embed_tokens": torch.from_numpy(table)}, torch.from_numpy(ids))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_rope_dynamic_ntk_matches_jax():
    from omchat_tpu.config import RopeScalingConfig
    from omchat_tpu.ops.rope import rope_cos_sin as j_rope

    from omchat_torch.config import RopeScalingConfig as TRope
    from omchat_torch.ops.rope import rope_cos_sin as t_rope

    pos = np.stack([np.arange(40), np.arange(40) + 30]).astype(np.int32)
    for rtype in ("dynamic", "linear"):
        jc, js = j_rope(jnp.asarray(pos), 16, scaling=RopeScalingConfig(rtype, 2.0), max_position_embeddings=32)
        tc, ts = t_rope(torch.from_numpy(pos), 16, scaling=TRope(rtype, 2.0), max_position_embeddings=32)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


def test_plan_multimodal_merge_matches_jax():
    from omchat_tpu.models.omchat import plan_multimodal_merge as j_plan

    from omchat_torch.models.omchat import plan_multimodal_merge as t_plan

    batch = [[5, -200, 6, 7, -200, 8], [9, -200, 1]]
    a, b = j_plan(batch, 4, bucket=8), t_plan(batch, 4, bucket=8)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))
