"""The port's HF export (``flatten_to_hf_state``, ``save_hf_safetensors``,
``export_hf_bundle``, ``cli.convert``) against the JAX package's, on the CPU.

- ``flatten_to_hf_state`` of the port's tree (``from_jax_params`` of a JAX
  tree) against JAX's of the JAX tree: the same keys, shapes, dtypes and bytes,
  for the InternViT-6B-style tiny config, an InternViT-300M-style tower
  (LayerNorm biases, qkv bias, no qk-norm) with tied embeddings, the MoE
  trunk, and a v1 tree with an ``image_newline``; float32 and bfloat16.
- Both packages' bundles of the same checkpoint: the JSON files equal, the
  code files the same code (their syntax trees without docstrings: the
  port's copies name the port in their docstrings), every safetensors file
  byte-equal; the sharded files and index at a small ``max_shard_bytes``.
- The port's loader reads the port's bundle back bitwise; the JAX loader
  reads it, and the JAX engine's greedy tokens equal the port engine's
  (float32); ``AutoModel(trust_remote_code=True)`` on the port's bundle gives
  the JAX engine's greedy tokens; ``cli.convert.main --device cpu`` writes the
  bundle ``export_hf_bundle`` writes.
"""

import ast
import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from omchat_tpu.checkpoint import loader as jloader
from omchat_tpu.checkpoint import save as jsave
from omchat_tpu.config import GenerationConfig as JGenerationConfig
from omchat_tpu.config import OmChatConfig, TextConfig, VisionConfig
from omchat_tpu.models import intern_vit, projector as jprojector, qwen2 as jqwen2, qwen2_moe as jmoe

from omchat_torch.checkpoint import loader as tloader
from omchat_torch.checkpoint import save as tsave
from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.config import GenerationConfig
from omchat_torch.utils.tree import tree_items

CODE_FILES = ("configuration_omchat.py", "modeling_omchat.py", "processing_omchat.py", "image_processing_omchat.py")
MOE_TEXT = dict(vocab_size=512, hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=1024, attention_bias=True, num_experts=4,
                num_experts_per_tok=2, moe_intermediate_size=32, shared_expert_intermediate_size=48,
                decoder_sparse_step=1)


def _perturbed(tree, seed):
    """Every float leaf plus seeded noise, so norms, biases and LayerScales
    are not all ones and zeros (a wrong transpose or a swapped key shows)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + rng.standard_normal(np.shape(a)).astype(np.float32) * 0.1,
                        jax.device_get(tree))


def _tree(variant: str):
    """(JAX config, JAX params) of one variant of the tiny model."""
    cfg = OmChatConfig.tiny()
    if variant == "internvit300m_tied":
        cfg = dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, norm_type="layer_norm", qkv_bias=True,
                                            qk_normalization=False),
            text=dataclasses.replace(cfg.text, tie_word_embeddings=True))
    if variant == "moe":
        cfg = dataclasses.replace(cfg, text=TextConfig(**MOE_TEXT))
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    text_init = jmoe.init_params if variant == "moe" else jqwen2.init_params
    params = {
        "vision_tower": intern_vit.init_params(k1, cfg.vision),
        "projector": jprojector.init_params(k2, cfg.projector, cfg.vision.hidden_size, cfg.text.hidden_size),
        "language_model": text_init(k3, cfg.text),
    }
    if variant == "v1_newline":
        params["image_newline"] = np.zeros((cfg.text.hidden_size,), np.float32)
    return cfg, _perturbed(params, 1)


VARIANTS = ["internvit6b", "internvit300m_tied", "moe", "v1_newline"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_flatten_to_hf_state_is_the_jax_writers(variant, dtype):
    _, params = _tree(variant)
    if dtype == "bfloat16":
        params = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), params)
    want = jsave.flatten_to_hf_state(params)
    got = tsave.flatten_to_hf_state(from_jax_params(params))
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        w = np.ascontiguousarray(w)
        assert tuple(g.shape) == w.shape, key
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, key
        assert g.is_contiguous(), key
        assert g.view(torch.uint8).numpy().tobytes() == w.view(np.uint8).tobytes(), key
    if variant == "internvit300m_tied":
        assert "language_model.lm_head.weight" not in got and "vision_tower.encoder.layers.1.norm2.bias" in got
    if variant == "moe":
        assert "language_model.model.layers.1.mlp.shared_expert_gate.weight" in got
        assert "language_model.model.layers.0.mlp.experts.3.down_proj.weight" in got


def test_sharded_files_and_index_are_the_jax_writers(tmp_path):
    _, params = _tree("internvit6b")
    jsave.save_hf_safetensors(params, str(tmp_path / "jax"), max_shard_bytes=40_000)
    tsave.save_hf_safetensors(from_jax_params(params), str(tmp_path / "port"), max_shard_bytes=40_000)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) > 3 and "model.safetensors.index.json" in names
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name, shallow=False), name


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """A tiny checkpoint with its tokenizer, exported by both packages in
    float32: {"src", "jax", "port"} directories, and the port's tree."""
    from tests.test_api_e2e import _write_tiny_checkpoint, _write_tiny_tokenizer

    root = tmp_path_factory.mktemp("export")
    src = root / "src"
    src.mkdir()
    _write_tiny_tokenizer(str(src))
    _write_tiny_checkpoint(str(src))
    jcfg, jparams = jloader.load_omchat_checkpoint(str(src), jnp.float32)
    jsave.export_hf_bundle(jcfg, jparams, str(root / "jax"), source_dir=str(src))
    tcfg, tparams = tloader.load_omchat_checkpoint(str(src), torch.float32, device="cpu")
    tsave.export_hf_bundle(tcfg, tparams, str(root / "port"), source_dir=str(src))
    return {"src": str(src), "jax": str(root / "jax"), "port": str(root / "port"), "params": tparams}


def _code(path):
    """The module's syntax tree without its docstrings."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    return ast.dump(tree)


def test_bundles_of_both_packages_agree(bundles):
    jax_dir, port_dir = bundles["jax"], bundles["port"]
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    for name in ("config.json", "preprocessor_config.json", "processor_config.json"):
        assert json.load(open(os.path.join(port_dir, name))) == json.load(open(os.path.join(jax_dir, name))), name
    for name in CODE_FILES:
        assert _code(os.path.join(port_dir, name)) == _code(os.path.join(jax_dir, name)), name
        assert filecmp.cmp(os.path.join(port_dir, name), os.path.join(tsave.HF_CODE_DIR, name), shallow=False)
    for name in os.listdir(jax_dir):
        if name.endswith(".safetensors") or "token" in name:
            assert filecmp.cmp(os.path.join(port_dir, name), os.path.join(jax_dir, name), shallow=False), name


def test_the_port_reads_its_bundle_back_bitwise(bundles):
    _, params = tloader.load_omchat_checkpoint(bundles["port"], torch.float32, device="cpu")
    want = dict(tree_items(bundles["params"]))
    got = dict(tree_items(params))
    assert got.keys() == want.keys()
    for path, t in want.items():
        assert torch.equal(got[path], t), path


def _prompt(model, seed):
    image = Image.fromarray(np.random.default_rng(seed).integers(0, 255, (90, 120, 3), dtype=np.uint8))
    return model.processor("What is this?", images=image)


def test_jax_engine_on_the_ports_bundle_gives_the_port_engines_tokens(bundles):
    from omchat_tpu.api import load_pretrained_model as jload

    from omchat_torch.api import load_pretrained_model as tload

    jmodel = jload(bundles["port"], dtype=jnp.float32, attn_impl="xla")
    tmodel = tload(bundles["port"], dtype=torch.float32, device="cpu")
    inputs = _prompt(jmodel, 0)
    ids = np.asarray(inputs["input_ids"][0]).tolist()
    images = np.asarray(inputs["images"], np.float32)
    want = jmodel.engine.generate([ids], images, JGenerationConfig(max_new_tokens=6, eos_token_id=-1))
    got = tmodel.engine.generate([ids], images, GenerationConfig(max_new_tokens=6, eos_token_id=-1))
    assert [int(t) for t in got.token_ids[0]] == [int(t) for t in want.token_ids[0]]


def test_automodel_on_the_ports_bundle_gives_the_jax_engines_tokens(bundles):
    from transformers import AutoModel, AutoProcessor

    from omchat_tpu.api import load_pretrained_model as jload

    bundle = bundles["port"]
    jmodel = jload(bundle, dtype=jnp.float32, attn_impl="xla")
    torch_model = AutoModel.from_pretrained(bundle, trust_remote_code=True, dtype=torch.float32).eval()
    processor = AutoProcessor.from_pretrained(bundle, trust_remote_code=True)
    image = Image.fromarray(np.random.default_rng(1).integers(0, 255, (90, 120, 3), dtype=np.uint8))
    inputs = processor("What is this?", images=image)
    with torch.no_grad():
        out = torch_model.generate(input_ids=inputs["input_ids"], images=inputs["images"], max_new_tokens=6,
                                   do_sample=False)
    torch_tokens = out[0, inputs["input_ids"].shape[1]:].tolist()
    want = jmodel.engine.generate([inputs["input_ids"].numpy()[0].tolist()], inputs["images"].numpy(),
                                  JGenerationConfig(max_new_tokens=6, eos_token_id=-1))
    assert torch_tokens == [int(t) for t in want.token_ids[0]]


def test_cli_convert_end_to_end_on_the_cpu(bundles, tmp_path, capsys):
    from omchat_torch.cli import convert

    out = tmp_path / "converted"
    convert.main(["--input", bundles["src"], "--output", str(out), "--dtype", "float32", "--device", "cpu"])
    assert f"wrote {out}" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == sorted(os.listdir(bundles["port"]))
    for name in os.listdir(out):
        assert filecmp.cmp(out / name, os.path.join(bundles["port"], name), shallow=False), name
