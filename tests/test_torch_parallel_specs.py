"""The port's mesh and shardings against the JAX package's, on one process
(no rank is spawned):

- the rank grids of ``create_mesh`` / ``create_cp_mesh`` /
  ``create_multislice_mesh`` against JAX's device grids on
  ``jax.devices()[:n]``, and the same refusals;
- every spec tree leaf for leaf against JAX's ``PartitionSpec``s (the tiny
  config, ``OmChatConfig()``, the MoE trunk, the projector variants, int8
  trees, fsdp on and off), ``specs_without_axis`` and ``kv_cache_specs``;
- ``shard_params`` → ``gather_params`` bitwise on every leaf, the head-wise
  ViT qkv and InternViT-6B's 25 heads split unevenly included, and each
  evenly split shard equal to the shard JAX's ``shard_params`` places on the
  device at the same mesh position.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as JP

from omchat_tpu.config import OmChatConfig, ProjectorConfig, TextConfig, VisionConfig
from omchat_tpu.parallel import mesh as jmesh
from omchat_tpu.parallel import sharding as jsh

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.config import OmChatConfig as TOmChatConfig
from omchat_torch.config import ProjectorConfig as TProjectorConfig
from omchat_torch.config import TextConfig as TTextConfig
from omchat_torch.config import VisionConfig as TVisionConfig
from omchat_torch.parallel import mesh as tmesh
from omchat_torch.parallel import sharding as tsh
from omchat_torch.utils.tree import tree_items


def _grid(m) -> list:
    return np.vectorize(lambda d: d.id)(m.devices).tolist()


@pytest.mark.parametrize("n,tp", [(1, 1), (2, 1), (2, 2), (4, 2), (8, 2), (8, 4), (8, 8)])
def test_create_mesh_grid_matches_jax(n, tp):
    got = tmesh.create_mesh(tp=tp, ranks=range(n))
    want = jmesh.create_mesh(tp=tp, devices=jax.devices()[:n])
    assert got.grid.tolist() == _grid(want)
    assert got.axis_names == tuple(want.axis_names) and got.shape == dict(want.shape)
    for r in range(n):  # rank = d * tp + m
        assert got.coords(r) == {"data": r // tp, "model": r % tp}


def test_cp_and_multislice_grids_match_jax():
    for cp in (1, 2, 4):
        got = tmesh.create_cp_mesh(cp, ranks=range(8))
        assert got.grid.tolist() == _grid(jmesh.create_cp_mesh(cp, devices=jax.devices()))
        assert got.axis_names == ("data", "context")
    devs = jax.devices()
    order = [3, 7, 1, 5, 0, 4, 2, 6]  # two slices of four, interleaved
    for tp in (1, 2, 4):
        got = tmesh.create_multislice_mesh(tp=tp, num_slices=2, ranks=order, slice_of=lambda r: r % 2)
        want = jmesh.create_multislice_mesh(tp=tp, num_slices=2, devices=[devs[i] for i in order],
                                            slice_of=lambda d: d.id % 2)
        assert got.grid.tolist() == _grid(want)
    one = tmesh.create_multislice_mesh(tp=2, num_slices=1, ranks=range(8))
    assert one.grid.tolist() == tmesh.create_mesh(tp=2, ranks=range(8)).grid.tolist()


@pytest.mark.parametrize("call,match", [
    (lambda m, r: m.create_mesh(tp=3, **r), "does not divide"),
    (lambda m, r: m.create_mesh(tp=2, dp=2, **r), "dp\\*tp"),
    (lambda m, r: m.create_cp_mesh(3, **r), "does not divide"),
    (lambda m, r: m.create_cp_mesh(2, dp=3, **r), "dp\\*cp"),
    (lambda m, r: m.create_multislice_mesh(tp=1, num_slices=3, **r), "do not split"),
    (lambda m, r: m.create_multislice_mesh(tp=3, num_slices=2, **r), "per-slice"),
    (lambda m, r: m.create_multislice_mesh(tp=2, num_slices=2, **r), "equal slices"),
])
def test_mesh_refusals_match_jax(call, match):
    with pytest.raises(ValueError, match=match):
        call(jmesh, {"devices": jax.devices()})
    with pytest.raises(ValueError, match=match):
        call(tmesh, {"ranks": range(8)})


def _flat_specs(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, prefix + (k,)))
        return out
    if isinstance(tree, tuple) and not isinstance(tree, JP) and hasattr(tree, "_fields"):  # KVCache
        return {prefix + (f,): tuple(getattr(tree, f)) for f in tree._fields}
    return {prefix: tuple(tree)}


def _both(cfg_fn):
    return cfg_fn(OmChatConfig, TextConfig, VisionConfig, ProjectorConfig), cfg_fn(
        TOmChatConfig, TTextConfig, TVisionConfig, TProjectorConfig)


MOE = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, num_experts=8, num_experts_per_tok=2, moe_intermediate_size=16,
           shared_expert_intermediate_size=32)
CONFIGS = {
    "tiny": lambda O, T, V, P: O.tiny(),
    "omchat_v2": lambda O, T, V, P: O(),
    "moe_trunk": lambda O, T, V, P: dataclasses.replace(O.tiny(), text=T(**MOE)),
    "untied_no_bias_layernorm_vit": lambda O, T, V, P: dataclasses.replace(
        O.tiny(), text=dataclasses.replace(O.tiny().text, attention_bias=False, tie_word_embeddings=True),
        vision=dataclasses.replace(O.tiny().vision, norm_type="layer_norm", qk_normalization=False, qkv_bias=True)),
}
PROJECTORS = {
    "mlp2x": {"linear_1": {}, "linear_2": {}},
    "mlp3x": {"linear_1": {}, "linear_2": {}, "linear_3": {}},
    "linear": {"linear_1": {}},
    "smoe": {"router": {"kernel": np.zeros(1), "bias": np.zeros(1)},
             "experts": {"linear_1": {}, "linear_2": {}}},
    "cabstract": {"net": {"conv": {"kernel": np.zeros(1)}}, "readout": {"kernel": np.zeros(1)}},
}


@pytest.mark.parametrize("fsdp", [False, True], ids=["replicated", "fsdp"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_param_specs_match_jax(name, fsdp):
    jcfg, tcfg = _both(CONFIGS[name])
    for proj_name, proj in PROJECTORS.items():
        params = {"projector": proj}
        if proj_name == "mlp2x":
            params["image_newline"] = np.zeros(1)
        want = _flat_specs(jsh.omchat_param_specs(jcfg, params, fsdp=fsdp))
        got = _flat_specs(tsh.omchat_param_specs(tcfg, params, fsdp=fsdp))
        assert got == want, proj_name
        # specs_without_axis, for a (data, context) mesh
        assert (_flat_specs(tsh.specs_without_axis(tsh.omchat_param_specs(tcfg, params, fsdp=fsdp), "model"))
                == _flat_specs(jsh.specs_without_axis(jsh.omchat_param_specs(jcfg, params, fsdp=fsdp), "model")))


@pytest.mark.parametrize("fsdp", [False, True], ids=["replicated", "fsdp"])
def test_quantized_specs_match_jax(fsdp):
    from omchat_tpu.ops.linear import quantize_tree

    from tests.test_sharding import _tiny_params

    jcfg = OmChatConfig.tiny()
    params = jax.device_get(_tiny_params(jcfg))
    params["language_model"]["layers"] = jax.device_get(quantize_tree(params["language_model"]["layers"]))
    want = jsh.adapt_specs_to_quantized(jsh.omchat_param_specs(jcfg, params, fsdp=fsdp), params)
    got = tsh.adapt_specs_to_quantized(tsh.omchat_param_specs(TOmChatConfig.tiny(), params, fsdp=fsdp), params)
    assert _flat_specs(got) == _flat_specs(want)


@pytest.mark.parametrize("tp,dp,batch", [(1, 8, None), (2, 4, 8), (4, 2, 3), (8, 1, 2)])
def test_kv_cache_specs_match_jax(tp, dp, batch):
    cfg = OmChatConfig().text
    want = jsh.kv_cache_specs(cfg, jmesh.create_mesh(tp=tp, dp=dp, devices=jax.devices()), batch)
    got = tsh.kv_cache_specs(TOmChatConfig().text, tmesh.create_mesh(tp=tp, dp=dp, ranks=range(8)), batch)
    assert _flat_specs({"c": got}) == _flat_specs({"c": want})


def test_split_sizes_put_the_larger_blocks_first():
    assert tsh.split_sizes(25, 2) == [13, 12]
    assert tsh.split_sizes(25, 4) == [7, 6, 6, 6]
    assert tsh.block_range(25 * 128, 4, 1, units=25) == (7 * 128, 13 * 128)


def _all_shards(params, mesh, specs) -> dict:
    return {r: tsh.shard_params(params, mesh, specs, coords=mesh.coords(r)) for r in range(mesh.size)}


@pytest.mark.parametrize("fsdp", [False, True], ids=["replicated", "fsdp"])
@pytest.mark.parametrize("tp,dp", [(2, 1), (1, 2), (2, 2), (2, 4)])
def test_shard_gather_round_trip_and_jax_shards(tp, dp, fsdp):
    from tests.test_sharding import _tiny_params

    jcfg = OmChatConfig.tiny()
    jparams = _tiny_params(jcfg)
    params = from_jax_params(jax.device_get(jparams))
    specs = tsh.omchat_param_specs(TOmChatConfig.tiny(), params, fsdp=fsdp)
    mesh = tmesh.create_mesh(tp=tp, dp=dp, ranks=range(tp * dp))
    shards = _all_shards(params, mesh, specs)
    back = tsh.gather_params(shards, mesh, specs)
    for path, t in tree_items(params):
        assert torch.equal(dict(tree_items(back))[path], t), ".".join(path)
    # JAX's own placement on the same mesh shape: every shard whose layout is
    # a contiguous block (all but the head-wise qkv) equals the port's
    jm = jmesh.create_mesh(tp=tp, dp=dp, devices=jax.devices()[: tp * dp])
    jspecs = jsh.omchat_param_specs(jcfg, jparams, fsdp=fsdp)
    placed = jsh.shard_params(jparams, jm, jspecs)
    by_device = {int(d.id): (i, j) for (i, j), d in np.ndenumerate(jm.devices)}
    flat_placed = dict(tree_items(placed))
    compared = 0
    for path, spec in tsh.leaf_specs(params, specs).items():
        if getattr(spec, "blocks", 1) > 1:
            continue
        for shard in flat_placed[path].addressable_shards:
            d, m = by_device[int(shard.device.id)]
            r = int(mesh.grid[d, m])
            want = from_jax_params({"x": np.asarray(shard.data)})["x"]
            if path == ("vision_tower", "patch_embedding", "kernel"):  # HWIO → OIHW
                want = from_jax_params({"vision_tower": {"patch_embedding": {"kernel": np.asarray(shard.data)}}})[
                    "vision_tower"]["patch_embedding"]["kernel"]
            assert torch.equal(dict(tree_items(shards[r]))[path], want), ".".join(path)
            compared += 1
    assert compared > 0


@pytest.mark.parametrize("tp", [2, 4])
def test_internvit_25_heads_split_unevenly_and_head_wise(tp):
    """A 25-head tower (head width 8): the rank's qkv shard is its heads of
    q, of k and of v; 13 + 12 heads at tp 2, 7 + 6 + 6 + 6 at tp 4; the
    round trip is bitwise; FSDP splits the other axis evenly at dp 2."""
    from omchat_torch.models.intern_vit import init_params

    cfg = TVisionConfig(hidden_size=200, intermediate_size=400, num_hidden_layers=2, num_attention_heads=25,
                        image_size=56, patch_size=14, qkv_bias=True)
    params = {"vision_tower": init_params(cfg, torch.Generator().manual_seed(0))}
    with torch.no_grad():
        params["vision_tower"]["layers"]["attn"]["qkv"]["bias"].normal_()
    specs = {"vision_tower": tsh.vision_param_specs(cfg, fsdp=True)}
    mesh = tmesh.create_mesh(tp=tp, dp=2, ranks=range(2 * tp))
    shards = _all_shards(params, mesh, specs)
    heads = tsh.split_sizes(25, tp)
    qkv = params["vision_tower"]["layers"]["attn"]["qkv"]["kernel"]
    for r in range(mesh.size):
        c = mesh.coords(r)
        lo = sum(heads[: c["model"]]) * 8
        n = heads[c["model"]] * 8
        rows = slice(c["data"] * 100, c["data"] * 100 + 100)
        want = torch.cat([qkv[:, rows, b * 200 + lo: b * 200 + lo + n] for b in range(3)], dim=-1)
        layers = shards[r]["vision_tower"]["layers"]
        assert torch.equal(layers["attn"]["qkv"]["kernel"], want)
        assert layers["attn"]["proj"]["kernel"].shape == (2, n, 100)
        assert layers["attn"]["qkv"]["bias"].shape == (2, 3 * n)
    back = tsh.gather_params(shards, mesh, specs)
    for path, t in tree_items(params):
        assert torch.equal(dict(tree_items(back))[path], t), ".".join(path)


def test_fsdp_refuses_an_uneven_data_split():
    cfg = TVisionConfig(hidden_size=24, intermediate_size=48, num_hidden_layers=1, num_attention_heads=3,
                        image_size=56, patch_size=14)
    from omchat_torch.models.intern_vit import init_params

    params = {"vision_tower": init_params(cfg, torch.Generator().manual_seed(0))}
    mesh = tmesh.create_mesh(tp=1, dp=5, ranks=range(5))
    with pytest.raises(ValueError, match="does not split evenly"):
        tsh.shard_params(params, mesh, {"vision_tower": tsh.vision_param_specs(cfg, fsdp=True)}, coords={
            "data": 0, "model": 0})


def test_trunk_tp_must_divide_both_head_counts():
    """The trainer still takes only a tp that divides both head counts;
    serving takes tp 3 / 7 / 8 too: the q heads split into whole heads
    (unevenly), k_proj / v_proj stay whole on every rank where tp does not
    divide the 4 kv heads, and the cache replicates its head axis as JAX's
    spec does; only a rank left without a q head is refused."""
    cfg = TOmChatConfig().text  # 28 q heads, 4 kv heads
    for tp in (1, 2, 4):
        tsh.check_train_tp(cfg, tp)
        tsh.check_trunk_tp(cfg, tp)
    for tp in (3, 7, 8):
        with pytest.raises(ValueError, match="ROADMAP queue A item 13"):
            tsh.check_train_tp(cfg, tp)
        tsh.check_trunk_tp(cfg, tp)
        specs = tsh.qwen2_param_specs(cfg)["layers"]["self_attn"]
        q_rows = [tsh.local_shape([1, 3584, 3584], specs["q_proj"]["kernel"], {"model": m}, {"model": tp})[2] // 128
                  for m in range(tp)]
        assert q_rows == tsh.split_sizes(28, tp)
        for m in range(tp):
            assert tsh.local_shape([1, 3584, 512], specs["k_proj"]["kernel"], {"model": m}, {"model": tp}) == \
                [1, 3584, 512]
        mesh = tmesh.create_mesh(tp=tp, ranks=range(tp))
        assert tsh.kv_cache_specs(cfg, mesh).k[2] is None
    with pytest.raises(ValueError, match="without a q head"):
        tsh.check_trunk_tp(cfg, 29)
