"""The OmChat-v1 pieces of the port on the CPU against the JAX package: the
spatial merge (``unpad_image``, ``spatial_unpad_merge``) and its route
through ``OmChatEngine.generate`` and ``OmChatModel.chat``, the legacy
preprocessing (``process_images``, ``gpt4style_tiles``), the C-Abstractor
and the MoE-LLaVA sparse projector, and ``from_jax_params`` over a tree with
lists.

Tolerances: the merge, the preprocessing and the converters exactly; the
engines' greedy tokens exactly and first-step logits within 1e-4 (float32,
as tests/test_torch_engine.py); the projectors atol 2e-5 of max |ref| /
rtol 1e-4 (float32 convolutions and sums in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.config import GenerationConfig as TGen
from omchat_torch.config import OmChatConfig as TOmChatConfig
from omchat_torch.config import ProjectorConfig as TProjectorConfig

REL_ATOL, RTOL = 2e-5, 1e-4


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=REL_ATOL * np.abs(want).max(), rtol=RTOL)


# ---- the spatial merge -------------------------------------------------------


@pytest.mark.parametrize("original", [(200, 100), (100, 200), (448, 448), (90, 350), (337, 113)])
def test_unpad_image_matches_jax(original):
    from omchat_tpu.models.spatial_merge import unpad_image as junpad

    from omchat_torch.models.spatial_merge import unpad_image

    t = np.random.default_rng(0).standard_normal((8, 24, 12)).astype(np.float32)
    np.testing.assert_array_equal(unpad_image(torch.from_numpy(t), original).numpy(),
                                  np.asarray(junpad(jnp.asarray(t), original)))


@pytest.mark.parametrize("merge_type", ["spatial_unpad", "spatial"])
@pytest.mark.parametrize("image_size", [(110, 56), (56, 110), (100, 100), (56, 56)])
def test_spatial_unpad_merge_matches_jax(merge_type, image_size):
    """The merge types and sizes of tests/test_legacy_features.py, the one-tile
    image among them."""
    from omchat_tpu.models.spatial_merge import spatial_unpad_merge as jmerge
    from omchat_tpu.processing.anyres import get_anyres_image_grid_shape

    from omchat_torch.models.spatial_merge import spatial_unpad_merge

    rng = np.random.default_rng(1)
    c, hw, tile = 8, 16, 56
    pinpoints = [[56, 112], [112, 56], [112, 112]] if image_size != (56, 56) else [[56, 56]]
    gw, gh = get_anyres_image_grid_shape(image_size, pinpoints, tile)
    n = 1 if image_size == (56, 56) else 1 + gw * gh
    feats = rng.standard_normal((n, hw, c)).astype(np.float32)
    newline = rng.standard_normal((c,)).astype(np.float32)
    want = jmerge(jnp.asarray(feats), image_size, pinpoints, tile, jnp.asarray(newline), patch_merge_type=merge_type)
    got = spatial_unpad_merge(torch.from_numpy(feats), image_size, pinpoints, tile, torch.from_numpy(newline),
                              patch_merge_type=merge_type)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


_V1 = {}


def _v1_reference():
    """The JAX v1 model (tiny, spatial_unpad, an image_newline), its greedy
    run on a 110x56 image through ``engine.generate`` and its chat reply."""
    if not _V1:
        from omchat_tpu.api import OmChatModel
        from omchat_tpu.config import GenerationConfig, OmChatConfig
        from omchat_tpu.processing.image_processor import OmChatImageProcessor
        from omchat_tpu.processing.processor import OmChatProcessor
        from omchat_tpu.runtime.generate import OmChatEngine
        from omchat_tpu.utils.testing import MockTokenizer
        from tests.test_sharding import _tiny_params

        rng = np.random.default_rng(2)
        cfg = dataclasses.replace(OmChatConfig.tiny(), mm_patch_merge_type="spatial_unpad")
        params = _tiny_params(cfg)
        params["image_newline"] = jnp.asarray(rng.standard_normal((cfg.text.hidden_size,)).astype(np.float32))
        pixels = rng.standard_normal((3, 3, 56, 56)).astype(np.float32)
        ids = [5, 6, -200, 7, 8]
        eng = OmChatEngine(cfg, params, attn_impl="xla", image_cache_size=0)
        gen = GenerationConfig(max_new_tokens=6, eos_token_id=-1)
        out = eng.generate([ids], pixels, gen, num_patches=[3], image_sizes=[(110, 56)])
        feats, counts = eng.merge_spatial_features(eng.encode_images(pixels), [3], [(110, 56)])
        logits, _ = eng.prefill(eng.plan([ids], tokens_per_sentinel=counts), feats, 6)
        tok = MockTokenizer()
        ip = OmChatImageProcessor(crop_size=56, shortest_edge=56, image_grid_pinpoints=cfg.image_grid_pinpoints)
        model = OmChatModel(tok, eng, ip, OmChatProcessor(tok, ip, patch_expand=False), cfg)
        img = Image.fromarray(rng.integers(0, 255, (56, 110, 3), dtype=np.uint8))
        reply = model.chat("what?", image=img, generation=GenerationConfig(max_new_tokens=6, eos_token_id=-1))
        _V1.update(params=jax.device_get(params), pixels=pixels, ids=ids, tokens=out.token_ids,
                   prompt_len=int(out.prompt_len[0]), counts=counts, logits=np.asarray(logits), image=img,
                   reply=reply)
    return _V1


@pytest.mark.parametrize("impl", [None, "plain"], ids=["kernel_path", "plain_path"])
def test_v1_generate_matches_jax(impl):
    """One sentinel for the whole image: the merged tokens a sentinel, the
    prompt length, the first-step logits and the greedy tokens are JAX's."""
    from omchat_torch.runtime.generate import OmChatEngine

    ref = _v1_reference()
    cfg = dataclasses.replace(TOmChatConfig.tiny(), mm_patch_merge_type="spatial_unpad")
    eng = OmChatEngine(cfg, from_jax_params(ref["params"]), attn_impl=impl, image_cache_size=0, device="cpu")
    first = {}
    out = eng.generate([ref["ids"]], ref["pixels"], TGen(max_new_tokens=6, eos_token_id=-1), num_patches=[3],
                       image_sizes=[(110, 56)], logits_callback=lambda step, lg: first.setdefault(step, lg.clone()))
    _, counts = eng.merge_spatial_features(eng.encode_images(ref["pixels"]), [3], [(110, 56)])
    assert counts == ref["counts"] and int(out.prompt_len[0]) == ref["prompt_len"] == 4 + counts[0]
    np.testing.assert_allclose(first[0].numpy(), ref["logits"], atol=1e-4, rtol=0)
    assert out.token_ids == ref["tokens"]
    with pytest.raises(ValueError, match="num_patches and image_sizes"):
        eng.generate([ref["ids"]], ref["pixels"], TGen(max_new_tokens=2, eos_token_id=-1))


def test_v1_chat_matches_jax():
    """``OmChatModel.chat`` on a v1 config: one sentinel an image (the
    processor's ``patch_expand=False``), ``num_patches`` / ``image_sizes``
    handed to the engine; the reply is JAX's."""
    from omchat_torch.api import omchat_model
    from omchat_torch.runtime.generate import OmChatEngine
    from omchat_torch.utils.testing import MockTokenizer

    ref = _v1_reference()
    cfg = dataclasses.replace(TOmChatConfig.tiny(), mm_patch_merge_type="spatial_unpad")
    model = omchat_model(MockTokenizer(), OmChatEngine(cfg, from_jax_params(ref["params"]), image_cache_size=0,
                                                       device="cpu"))
    assert not model.processor.patch_expand
    inputs = model.processor("what?", images=ref["image"])
    assert int((inputs["input_ids"] == -200).sum()) == 1
    assert model.chat("what?", image=ref["image"], generation=TGen(max_new_tokens=6, eos_token_id=-1)) == ref["reply"]


def test_v1_needs_the_image_newline():
    from omchat_torch.runtime.generate import OmChatEngine

    ref = _v1_reference()
    cfg = dataclasses.replace(TOmChatConfig.tiny(), mm_patch_merge_type="spatial_unpad")
    params = {k: v for k, v in from_jax_params(ref["params"]).items() if k != "image_newline"}
    eng = OmChatEngine(cfg, params, image_cache_size=0, device="cpu")
    with pytest.raises(ValueError, match="image_newline"):
        eng.generate([ref["ids"]], ref["pixels"], TGen(max_new_tokens=2, eos_token_id=-1), num_patches=[3],
                     image_sizes=[(110, 56)])


# ---- the legacy preprocessing ----------------------------------------------


def _images(sizes):
    rng = np.random.default_rng(3)
    return [Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)) for w, h in sizes]


@pytest.mark.parametrize("aspect", ["pad", "anyres", "square"])
@pytest.mark.parametrize("sizes", [[(120, 80), (120, 80)], [(200, 90), (60, 150)]], ids=["same", "mixed"])
def test_process_images_matches_jax(aspect, sizes):
    from omchat_tpu.processing.legacy import process_images as jprocess

    from omchat_torch.processing.legacy import process_images

    imgs = _images(sizes)
    kw = dict(grid_pinpoints=((56, 112), (112, 56), (112, 112)), tile_size=56)
    want, got = jprocess(imgs, aspect, **kw), process_images(imgs, aspect, **kw)
    assert type(got) is type(want)
    for g, w in zip(got if isinstance(got, list) else [got], want if isinstance(want, list) else [want]):
        np.testing.assert_array_equal(g, w)


def test_gpt4style_tiles_and_base64_match_jax():
    import base64
    import io

    from omchat_tpu.processing.legacy import gpt4style_tiles as jtiles
    from omchat_tpu.processing.legacy import load_image_from_base64 as jload

    from omchat_torch.processing.legacy import gpt4style_tiles, load_image_from_base64

    (img,) = _images([(400, 500)])
    got, want = gpt4style_tiles(img, tile_size=56), jtiles(img, tile_size=56)
    assert len(got) == len(want) == 5 and got[0].shape == (3, 56, 56)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    data = base64.b64encode(buf.getvalue()).decode()
    np.testing.assert_array_equal(np.asarray(load_image_from_base64(data)), np.asarray(jload(data)))


# ---- the C-Abstractor and the sparse projector --------------------------------


@pytest.mark.parametrize("tokens,n_query,depth", [(1024, 144, 1), (100, 9, 2), (1024, 25, 1)],
                         ids=["n_query_144", "grid_10_to_3", "grid_32_to_5"])
def test_cabstract_projector_matches_jax(tokens, n_query, depth):
    """1024 tokens to 144 (a divisible grid), and 10 → 3 and 32 → 5, where
    the adaptive pool takes torch's overlapping bins."""
    from omchat_tpu.config import ProjectorConfig
    from omchat_tpu.models.cabstractor import init_params as jinit
    from omchat_tpu.models.projector import projector_forward as jforward

    from omchat_torch.models.projector import projector_forward

    kw = dict(projector_type="cabstract", n_query=n_query, depth=depth, mlp_depth=2)
    jcfg, tcfg = ProjectorConfig(**kw), TProjectorConfig(**kw)
    jparams = jinit(jax.random.PRNGKey(4), jcfg, 16, 24, hidden=32, num_input_tokens=tokens)
    x = np.random.default_rng(4).standard_normal((2, tokens, 16)).astype(np.float32)
    want = jforward(jparams, jcfg, jnp.asarray(x))
    got = projector_forward(from_jax_params(jax.device_get(jparams)), tcfg, torch.from_numpy(x))
    assert got.shape == want.shape == (2, n_query, 24)
    _close(got, want)


def test_cabstract_image_seq_len_is_n_query():
    cfg = dataclasses.replace(TOmChatConfig.tiny(), projector=TProjectorConfig(projector_type="cabstract", n_query=9))
    assert cfg.image_seq_len == 9


def _honeybee_state(rng, mm_hidden=16, hidden=32, out=24, depth=2):
    """A reference honeybee CAbstractor state dict (timm naming, OIHW convs)."""
    def w(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.1)

    s = {"pos_emb": w(1, 16, mm_hidden)}
    for net in (0, 2):
        for b in range(depth):
            p = f"net.{net}.b{b + 1}"
            i = mm_hidden if net == 0 and b == 0 else hidden
            rd = int(round(i * 0.25))
            s[f"{p}.conv1.conv.weight"] = w(hidden, i, 1, 1)
            s[f"{p}.conv2.conv.weight"] = w(hidden, 1, 3, 3)
            s[f"{p}.conv3.conv.weight"] = w(hidden, hidden, 1, 1)
            for c in ("conv1", "conv2", "conv3"):
                s[f"{p}.{c}.bn.weight"], s[f"{p}.{c}.bn.bias"] = 1 + w(hidden), w(hidden)
            s[f"{p}.se.fc1.weight"], s[f"{p}.se.fc1.bias"] = w(rd, hidden, 1, 1), w(rd)
            s[f"{p}.se.fc2.weight"], s[f"{p}.se.fc2.bias"] = w(hidden, rd, 1, 1), w(hidden)
            if i != hidden:
                s[f"{p}.downsample.conv.weight"] = w(hidden, i, 1, 1)
                s[f"{p}.downsample.bn.weight"], s[f"{p}.downsample.bn.bias"] = 1 + w(hidden), w(hidden)
    for j, (i, o) in enumerate([(hidden, out), (out, out)]):
        s[f"readout.{2 * j}.weight"], s[f"readout.{2 * j}.bias"] = w(o, i), w(o)
    return s


def test_convert_honeybee_state_dict_matches_jax():
    """The port's converter keeps the reference's OIHW convs; the JAX one's
    HWIO tree carried by ``from_jax_params`` lands on the same leaves, and
    both forwards agree."""
    from omchat_tpu.config import ProjectorConfig
    from omchat_tpu.models.cabstractor import cabstractor_forward as jforward
    from omchat_tpu.models.cabstractor import convert_honeybee_state_dict as jconvert

    from omchat_torch.models.cabstractor import cabstractor_forward, convert_honeybee_state_dict

    state = _honeybee_state(np.random.default_rng(5))
    kw = dict(projector_type="cabstract", n_query=4, depth=2, mlp_depth=2)
    jparams = jconvert({k: v.numpy() for k, v in state.items()}, ProjectorConfig(**kw), jnp.float32)
    got = convert_honeybee_state_dict(state, TProjectorConfig(**kw))
    want = from_jax_params(jax.device_get(jparams))
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_w.keys() == flat_g.keys() and len(got["readout"]) == 2
    for path, leaf in flat_w.items():
        assert torch.equal(flat_g[path], leaf), path
    x = np.random.default_rng(6).standard_normal((1, 16, 16)).astype(np.float32)
    _close(cabstractor_forward(got, TProjectorConfig(**kw), torch.from_numpy(x)),
           jforward(jparams, ProjectorConfig(**kw), jnp.asarray(x)))


@pytest.mark.parametrize("num_selected", [1, 2])
def test_mlp_smoe_projector_matches_jax(num_selected):
    from omchat_tpu.config import ProjectorConfig
    from omchat_tpu.models.projector import init_params as jinit
    from omchat_tpu.models.projector import projector_forward as jforward

    from omchat_torch.models.projector import init_params, projector_forward

    jcfg = ProjectorConfig.from_type("mlp2x_gelu", mlp_smoe=True, num_experts=4, num_selected=num_selected)
    tcfg = TProjectorConfig.from_type("mlp2x_gelu", mlp_smoe=True, num_experts=4, num_selected=num_selected)
    jparams = jinit(jax.random.PRNGKey(7), jcfg, 16, 24)
    x = np.random.default_rng(7).standard_normal((3, 7, 16)).astype(np.float32)
    want = jforward(jparams, jcfg, jnp.asarray(x))
    _close(projector_forward(from_jax_params(jax.device_get(jparams)), tcfg, torch.from_numpy(x)), want)
    # the port's own init builds the JAX package's tree
    mine = init_params(tcfg, 16, 24, torch.Generator().manual_seed(0))
    assert jax.tree.map(np.shape, jax.device_get(jparams)) == jax.tree.map(lambda t: tuple(t.shape), mine)


def test_from_jax_params_carries_lists():
    """Lists stay lists, their conv kernels turn HWIO → OIHW (the depthwise
    [3, 3, 1, C] one → [C, 1, 3, 3]), the rest keeps its layout."""
    rng = np.random.default_rng(8)
    tree = {"s1": [{"conv2": {"kernel": rng.standard_normal((3, 3, 1, 5)).astype(np.float32)},
                    "se": {"fc1": {"kernel": rng.standard_normal((5, 2)).astype(np.float32)}}}],
            "readout": [{"kernel": rng.standard_normal((4, 6)).astype(np.float32)}],
            "experts": {"fc1": {"kernel": rng.standard_normal((2, 3, 4, 6)).astype(np.float32)}}}
    out = from_jax_params(tree)
    assert isinstance(out["s1"], list) and isinstance(out["readout"], list)
    assert torch.equal(out["s1"][0]["conv2"]["kernel"], torch.from_numpy(tree["s1"][0]["conv2"]["kernel"]
                                                                          .transpose(3, 2, 0, 1).copy()))
    assert torch.equal(out["readout"][0]["kernel"], torch.from_numpy(tree["readout"][0]["kernel"]))
    assert torch.equal(out["s1"][0]["se"]["fc1"]["kernel"], torch.from_numpy(tree["s1"][0]["se"]["fc1"]["kernel"]))
    # a 4-D stack of expert kernels is not a conv
    assert torch.equal(out["experts"]["fc1"]["kernel"], torch.from_numpy(tree["experts"]["fc1"]["kernel"]))
