"""The port's other vision towers on the CPU against the JAX package: CLIP,
SigLIP and CLIP-SMoE (``clip_vit``) at head widths 64 and 72 through the
plain version of K2, their HF converter, the tower dispatch, S2's
multi-scale forward (shrinking and enlarging) and the sparse-expert helpers
(``smoe``).

Both sides take the same synthetic HF state dict (float32) through their own
converter.  Tolerances: the towers atol 2e-5 of max |ref| / rtol 1e-4
(float32 sums in another order over 3 layers whose residual stream grows to
~16, the JAX XLA attention against K2's plain version); the
converters and the dispatch exactly; S2 atol 2e-5 (float32 resampling
filters computed two ways); the smoe helpers atol 1e-6 (the JAX package's
own, tests/test_smoe.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.models import clip_vit as tclip
from omchat_torch.models import smoe as tsmoe
from omchat_torch.ops import flash_attention as t_flash

REL_ATOL, RTOL = 2e-5, 1e-4
E, K = 4, 2


def _hf_state(rng, d, f, n_layers, grid, *, cls=True, experts=False, router=False, post_ln=False):
    """A HF-CLIP / SigLIP-shaped float32 state dict (torch tensors), with
    per-expert and router keys on request."""
    def w(*shape, scale=0.05):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale)

    pre = "vision_model."
    s = {pre + "embeddings.patch_embedding.weight": w(d, 3, 14, 14),
         pre + "embeddings.position_embedding.weight": w(grid * grid + int(cls), d)}
    if cls:
        s[pre + "embeddings.class_embedding"] = w(d)
        s[pre + "pre_layrnorm.weight"] = 1 + w(d)
        s[pre + "pre_layrnorm.bias"] = w(d)
    else:
        s[pre + "embeddings.patch_embedding.bias"] = w(d)
    if post_ln:
        s[pre + "post_layernorm.weight"] = 1 + w(d)
        s[pre + "post_layernorm.bias"] = w(d)
    for i in range(n_layers):
        p = f"{pre}encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            s[p + ln + ".weight"] = 1 + w(d)
            s[p + ln + ".bias"] = w(d)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s[p + f"self_attn.{proj}.weight"] = w(d, d, scale=0.2)
            s[p + f"self_attn.{proj}.bias"] = w(d)
        s[p + "mlp.fc1.weight"], s[p + "mlp.fc1.bias"] = w(f, d), w(f)
        s[p + "mlp.fc2.weight"], s[p + "mlp.fc2.bias"] = w(d, f), w(d)
        if experts:
            for e in range(E):
                q = f"{p}experts.{e}."
                s[q + "fc1.weight"], s[q + "fc1.bias"] = w(f, d), w(f)
                s[q + "fc2.weight"], s[q + "fc2.bias"] = w(d, f), w(d)
        if router:
            s[p + "router.weight"], s[p + "router.bias"] = w(E, d, scale=2.0), w(E)
    return s


def _configs(kind: str):
    """(JAX config, port config) of a tiny tower of the kind: "clip" (head
    width 64, quick-GELU, CLS), "siglip" (head width 72, tanh GELU, no CLS,
    post-LN) or "clip_smoe" (head width 64, 4 experts, top-2)."""
    from omchat_tpu.models.clip_vit import ClipVisionConfig

    if kind == "siglip":
        kw = dict(hidden_size=144, intermediate_size=200, num_hidden_layers=3, num_attention_heads=2,
                  image_size=42, patch_size=14, layer_norm_eps=1e-6, hidden_act="gelu_pytorch_tanh",
                  use_class_token=False, post_layernorm=True)
    else:
        kw = dict(hidden_size=128, intermediate_size=192, num_hidden_layers=3, num_attention_heads=2,
                  image_size=42, patch_size=14, clip_smoe=kind == "clip_smoe", num_experts=E, num_selected=K)
    return ClipVisionConfig(**kw), tclip.ClipVisionConfig(**kw)


def _state(kind, rng, experts=True, router=True):
    jcfg, _ = _configs(kind)
    smoe = kind == "clip_smoe"
    return _hf_state(rng, jcfg.hidden_size, jcfg.intermediate_size, jcfg.num_hidden_layers, jcfg.grid,
                     cls=kind != "siglip", experts=smoe and experts, router=smoe and router,
                     post_ln=kind == "siglip")


@pytest.mark.parametrize("feature_layer", [-1, -2])
@pytest.mark.parametrize("kind", ["clip", "siglip", "clip_smoe"])
def test_tower_matches_jax(kind, feature_layer):
    from omchat_tpu.models.clip_vit import clip_vit_forward, convert_hf_clip_vision

    rng = np.random.default_rng(7)
    jcfg, tcfg = _configs(kind)
    assert tcfg.head_dim == (72 if kind == "siglip" else 64)
    state = _state(kind, rng)
    pixels = rng.standard_normal((2, 3, 42, 42)).astype(np.float32)
    want = clip_vit_forward(convert_hf_clip_vision(state, jcfg, dtype=jnp.float32), jcfg, jnp.asarray(pixels),
                            feature_layer=feature_layer, attn_impl="xla")
    params = tclip.convert_hf_clip_vision(state, tcfg, dtype=torch.float32)
    n0 = t_flash.flash_attention.launches
    got = tclip.clip_vit_forward(params, tcfg, torch.from_numpy(pixels), feature_layer=feature_layer)
    assert t_flash.flash_attention.launches == n0  # CPU tensors run K2's plain version
    assert got.shape == want.shape == (2, 9 + (kind != "siglip"), jcfg.hidden_size)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=REL_ATOL * np.abs(want).max(), rtol=RTOL)


def test_clip_smoe_routes_tokens_to_different_experts():
    """The planted router spreads the tokens: each expert takes some, so the
    parity above covers the routing and not one expert alone."""
    rng = np.random.default_rng(7)
    _, tcfg = _configs("clip_smoe")
    params = tclip.convert_hf_clip_vision(_state("clip_smoe", rng), tcfg, dtype=torch.float32)
    y = torch.from_numpy(rng.standard_normal((64, tcfg.hidden_size)).astype(np.float32))
    router = {k: v[0] for k, v in params["layers"]["router"].items()}
    combine, _ = tsmoe.smoe_route(router, y, K)
    assert ((combine > 0).sum(0) > 0).all()


@pytest.mark.parametrize("kind,experts,router", [("clip", False, False), ("siglip", False, False),
                                                 ("clip_smoe", False, False), ("clip_smoe", True, False),
                                                 ("clip_smoe", True, True)],
                         ids=["clip", "siglip", "smoe_replicated", "smoe_experts", "smoe_experts_router"])
def test_convert_hf_clip_vision_matches_jax(kind, experts, router):
    """Every leaf of the port's converter equals the JAX converter's, carried
    by ``from_jax_params`` (the patch conv as OIHW), bitwise in float32."""
    from omchat_tpu.models.clip_vit import convert_hf_clip_vision

    rng = np.random.default_rng(3)
    jcfg, tcfg = _configs(kind)
    state = _state(kind, rng, experts, router)
    want = from_jax_params(jax.tree.map(np.asarray, convert_hf_clip_vision(state, jcfg, dtype=jnp.float32)))
    got = tclip.convert_hf_clip_vision(state, tcfg, dtype=torch.float32)
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_w.keys() == flat_g.keys()
    for path, leaf in flat_w.items():
        assert torch.equal(flat_g[path], leaf), path
    if kind == "clip_smoe":
        assert got["layers"]["experts"]["fc1"]["kernel"].shape == (3, E, 128, 192) and "mlp" not in got["layers"]
        if not router:
            assert not got["layers"]["router"]["kernel"].any()  # a uniform router


TOWER_NAMES = ["OpenGVLab/InternViT-6B-448px-V1-5", "internvit-300m-448px", "google/siglip-so400m-patch14-384",
               "openai/clip-vit-large-patch14-336", "intern_vit_300m", "some-other-tower"]


@pytest.mark.parametrize("name", TOWER_NAMES)
@pytest.mark.parametrize("clip_smoe", [False, True])
def test_build_vision_tower_dispatch_matches_jax(name, clip_smoe):
    from omchat_tpu.models.tower import build_vision_tower as jbuild

    from omchat_torch.models.tower import build_vision_tower

    want = jbuild(name, clip_smoe=clip_smoe, num_experts=E, num_selected=1)
    got = build_vision_tower(name, clip_smoe=clip_smoe, num_experts=E, num_selected=1)
    assert got.name == want.name and got.hidden_size == want.hidden_size
    assert type(got.config).__name__ == type(want.config).__name__
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    assert got.forward.__name__ == want.forward.__name__ and got.convert.__name__ == want.convert.__name__


def test_tower_forward_through_dispatch():
    """A tower built by name runs its forward and converter (the CLIP branch
    with a given config, as tests/test_tower_dispatch.py drives it)."""
    from omchat_torch.models.tower import build_vision_tower

    rng = np.random.default_rng(5)
    _, tcfg = _configs("clip")
    tower = build_vision_tower("clip-tiny", tcfg)
    params = tower.convert(_state("clip", rng), tcfg, torch.float32)
    out = tower.forward(params, tcfg, torch.from_numpy(rng.standard_normal((1, 3, 42, 42)).astype(np.float32)),
                        feature_layer=-1, attn_impl=None)
    assert out.shape == (1, 10, 128)


def _patch_mean_tower_np(x, patch=14):
    """The stand-in tower of tests/test_legacy_features.py: per-patch channel
    means → [B, L, 3], numpy on both sides."""
    b, c, s, _ = x.shape
    g = s // patch
    return x.reshape(b, c, g, patch, g, patch).mean(axis=(3, 5)).transpose(0, 2, 3, 1).reshape(b, g * g, c)


@pytest.mark.parametrize("side", [56, 200, 97], ids=["enlarging", "shrinking", "mixed"])
def test_multiscale_forward_matches_jax(side):
    """S2 at (56, 112, 168) over 56-pixel crops: a 56-pixel image only grows,
    a 200-pixel one shrinks at every scale (jax.image.resize antialiases
    there), a 97-pixel one does both."""
    from omchat_tpu.models.multiscale import multiscale_forward as jms

    from omchat_torch.models.multiscale import multiscale_forward

    imgs = np.random.default_rng(11).standard_normal((2, 3, side, side)).astype(np.float32)
    want = jms(lambda x: jnp.asarray(_patch_mean_tower_np(np.asarray(x))), jnp.asarray(imgs),
               img_sizes=(56, 112, 168), max_split_size=56)
    got = multiscale_forward(lambda x: torch.from_numpy(_patch_mean_tower_np(x.numpy())), torch.from_numpy(imgs),
                             img_sizes=(56, 112, 168), max_split_size=56)
    assert got.shape == want.shape == (2, 16, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# ---- smoe: the cases of tests/test_smoe.py ----------------------------------


def _router_np(rng, d_in, scale=0.02):
    return {"kernel": (rng.standard_normal((d_in, E)) * scale).astype(np.float32),
            "bias": (rng.standard_normal((E,)) * scale).astype(np.float32)}


@pytest.mark.parametrize("num_selected", [1, 2, 3])
def test_smoe_route_matches_jax(num_selected):
    from omchat_tpu.models.smoe import load_balancing_loss, smoe_route

    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 7, 16)).astype(np.float32)
    router = _router_np(rng, 16, scale=1.0)
    jc, jp = smoe_route(jax.tree.map(jnp.asarray, router), jnp.asarray(x), num_selected)
    tc, tp = tsmoe.smoe_route(from_jax_params(router), torch.from_numpy(x), num_selected)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    assert ((tc > 0).sum(-1) == num_selected).all()
    np.testing.assert_allclose(float(tsmoe.load_balancing_loss(tp, tc)), float(load_balancing_loss(jp, jc)),
                               atol=1e-6)


def test_load_balancing_loss_uniform_is_one():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((64, 16)).astype(np.float32))
    combine, probs = tsmoe.smoe_route({"kernel": torch.zeros(16, E), "bias": torch.zeros(E)}, x, K)
    assert abs(float(tsmoe.load_balancing_loss(probs, combine)) - 1.0) < 1e-5


def test_expert_bank_weighted_sum_matches_jax():
    from omchat_tpu.models.smoe import expert_bank

    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 3)).astype(np.float32)
    combine = np.array(jax.nn.softmax(jnp.asarray(rng.standard_normal((5, E)).astype(np.float32))))
    scale = np.arange(1, E + 1, dtype=np.float32)
    want = expert_bank({"scale": jnp.asarray(scale)}, jnp.asarray(x), jnp.asarray(combine), lambda p, xx: xx * p["scale"])
    got = tsmoe.expert_bank({"scale": torch.from_numpy(scale)}, torch.from_numpy(x), torch.from_numpy(combine),
                            lambda p, xx: xx * p["scale"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_replicated_experts_match_the_dense_projector():
    """Identical experts give the plain mlp2x projector for any router (the
    reference's adapter replication), and ``replicate_expert_params``
    matches the JAX package's."""
    from omchat_tpu.models.smoe import replicate_expert_params

    from omchat_torch.config import ProjectorConfig
    from omchat_torch.models.projector import init_params, projector_forward

    gen = torch.Generator().manual_seed(1)
    dense_cfg = ProjectorConfig.from_type("mlp2x_gelu")
    dense = init_params(dense_cfg, 16, 24, gen)
    bank = tsmoe.replicate_expert_params(dense, E)
    want = replicate_expert_params(jax.tree.map(lambda t: jnp.asarray(t.numpy()), dense), E)
    for name in dense:
        for leaf in ("kernel", "bias"):
            assert torch.equal(bank[name][leaf], torch.from_numpy(np.asarray(want[name][leaf])))
    params = {"router": tsmoe.init_router(16, E, gen), "experts": bank}
    x = torch.randn((3, 7, 16), generator=gen)
    smoe_cfg = ProjectorConfig.from_type("mlp2x_gelu", mlp_smoe=True, num_experts=E, num_selected=K)
    torch.testing.assert_close(projector_forward(params, smoe_cfg, x), projector_forward(dense, dense_cfg, x),
                               atol=1e-5, rtol=1e-5)
