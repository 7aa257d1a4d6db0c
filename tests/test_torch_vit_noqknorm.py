"""InternViT towers without qk-norm on the CPU against the JAX package: K5's
plain version (packed attention, no norm) against ``packed_self_attention``
in interpret mode; a head-128 tower without qk-norm through the port's
packed route (K5) against the JAX package's Pallas route, in float32, bf16
and under the w8a8 glue scan; and an InternViT-300M-style tower
(``layer_norm``, no qk-norm, head width 16 here) on both of the port's
routes against the JAX XLA route.

Tolerances: K5 atol 2e-5 / rtol 1e-4 (the JAX package's for this kernel,
tests/test_pallas_kernels.py:189); float32 towers atol 3e-5 / rtol 1e-4
(float32 sums in another order); the bf16 tower 2e-2 of max |ref| (bf16
rounds every activation, and the two sides round at other places); the
w8a8 glue scan 2e-2 of max |ref| (the JAX package's glue limit,
tests/test_pallas_kernels.py:427).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.config import VisionConfig as TVisionConfig
from omchat_torch.ops import flash_attention as t_flash

ATOL, RTOL = 3e-5, 1e-4
REL_TOL = 2e-2


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("B,S,SP,H,prescaled", [(2, 120, 128, 3, False), (1, 64, 64, 2, False), (2, 57, 64, 2, True)],
                         ids=["padded", "no_padding", "prescaled"])
def test_packed_self_attention_matches_pallas(B, S, SP, H, prescaled):
    from omchat_tpu.ops.flash_attention import packed_self_attention

    rng = np.random.default_rng(31)
    D = 128
    q, k, v = (_np(rng, B, SP, H * D) for _ in range(3))
    if prescaled:
        q = q * t_flash.packed_prescale(D)
    ref = packed_self_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=H, valid_len=S,
                                prescaled=prescaled, interpret=True)
    qkv = torch.from_numpy(np.concatenate([q, k, v], axis=-1))
    tq, tk, tv = qkv.chunk(3, dim=-1)  # strided views, as the ViT hands them over
    out = t_flash.packed_self_attention(tq, tk, tv, num_heads=H, valid_len=S, prescaled=prescaled)
    assert out.shape == (B, SP, H * D)
    np.testing.assert_allclose(out[:, :S].numpy(), np.asarray(ref)[:, :S], atol=2e-5, rtol=1e-4)
    assert t_flash.packed_self_attention.launches == 0  # CPU tensors never launch


def test_packed_self_attention_never_falls_back_off_the_cpu():
    m = torch.empty((1, 8, 128), device="meta", dtype=torch.bfloat16)
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        t_flash.packed_self_attention(m, m, m, num_heads=1)


def _perturbed(params, seed):
    """Non-zero biases and norm gammas away from one, so each enters the result."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        a = np.asarray(tree)
        if path[-1] == "bias" and path[-2] != "patch_embedding":
            return (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype)
        if path[-1] == "scale" and a.dtype == np.float32:
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return walk(jax.device_get(params))


HEAD128 = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=2, image_size=56,
               patch_size=14, qk_normalization=False)


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "w8a8_glue"])
def test_head128_tower_without_qk_norm_takes_k5(mode, monkeypatch):
    """The packed route (K5's plain version) against the JAX package's
    Pallas route (``packed_self_attention`` in interpret mode)."""
    from omchat_tpu.config import VisionConfig
    from omchat_tpu.models import intern_vit as jvit
    from omchat_tpu.ops.linear import quantize_tree

    from omchat_torch.models import intern_vit as tvit

    w8a8 = mode == "w8a8_glue"
    jcfg = VisionConfig(**HEAD128, w8a8=w8a8)
    params = _perturbed(jvit.init_params(jax.random.PRNGKey(5), jcfg), 5)
    px = np.random.default_rng(6).standard_normal((2, 3, 56, 56)).astype(np.float32)
    if w8a8:
        params = {**params, "layers": quantize_tree(params["layers"])}
    jdtype = jnp.bfloat16 if mode == "bfloat16" else jnp.float32
    jparams = jax.tree.map(lambda a: a.astype(jdtype) if a.dtype == np.float32 else a, params)
    want = np.asarray(jvit.intern_vit_forward(jparams, jcfg, jnp.asarray(px, jdtype), attn_impl="pallas"), np.float32)
    calls = []
    k5 = tvit.packed_self_attention
    monkeypatch.setattr(tvit, "packed_self_attention", lambda *a, **kw: calls.append(kw["valid_len"]) or k5(*a, **kw))
    glue = []
    if w8a8:
        fn = tvit._layer_forward_glue
        monkeypatch.setattr(tvit, "_layer_forward_glue", lambda *a, **kw: glue.append(1) or fn(*a, **kw))
    tparams = from_jax_params(jparams)
    got = tvit.intern_vit_forward(tparams, TVisionConfig(**HEAD128, w8a8=w8a8),
                                  torch.from_numpy(px).to(torch.bfloat16 if mode == "bfloat16" else torch.float32))
    assert calls == [(56 // 14) ** 2 + 1] * HEAD128["num_hidden_layers"]  # every layer, valid_len 17 of SP 24
    assert len(glue) == (HEAD128["num_hidden_layers"] if w8a8 else 0)
    got = got.float().numpy()
    assert got.shape == want.shape
    if mode == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    else:
        assert np.abs(got - want).max() / np.abs(want).max() < REL_TOL


@pytest.mark.parametrize("qkv_bias", [True, False], ids=["qkv_bias", "no_qkv_bias"])
@pytest.mark.parametrize("impl", [None, "plain"], ids=["kernel_path", "plain_path"])
def test_internvit_300m_style_tower_matches_jax(qkv_bias, impl):
    """``VisionConfig.internvit_300m()``'s structure (layer_norm, no qk-norm,
    qkv bias as configured) at tiny widths: head width 16 takes the split
    path on both of the port's routes (K2's plain version / the plain
    reference), against the JAX XLA route."""
    from omchat_tpu.config import VisionConfig
    from omchat_tpu.models import intern_vit as jvit

    from omchat_torch.models import intern_vit as tvit

    small = dict(hidden_size=64, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4, image_size=56,
                 patch_size=14, qkv_bias=qkv_bias)
    jcfg = dataclasses.replace(VisionConfig.internvit_300m(), **small)
    tcfg = dataclasses.replace(TVisionConfig.internvit_300m(), **small)
    assert tcfg.norm_type == "layer_norm" and not tcfg.qk_normalization
    params = _perturbed(jvit.init_params(jax.random.PRNGKey(8), jcfg), 8)
    assert ("bias" in params["layers"]["attn"]["qkv"]) == qkv_bias and "bias" in params["layers"]["norm1"]
    px = np.random.default_rng(9).standard_normal((2, 3, 56, 56)).astype(np.float32)
    want = np.asarray(jvit.intern_vit_forward(params, jcfg, jnp.asarray(px), attn_impl="xla"))
    got = tvit.intern_vit_forward(from_jax_params(params), tcfg, torch.from_numpy(px), attn_impl=impl)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
