"""The port's whole slice on the CPU against the JAX package: greedy
generation on ``OmChatConfig.tiny()`` in float32, loading the tiny on-disk
checkpoint, the CUDA-by-default device rule, and the import boundary.
"""

import ast
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.config import GenerationConfig as TGenerationConfig
from omchat_torch.config import OmChatConfig as TOmChatConfig
from omchat_torch.runtime.generate import OmChatEngine as TEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_TOKENS = 12
_JAX_RUN = {}


def _request():
    from omchat_torch.processing.chat import image_prompt, make_context
    from omchat_torch.utils.testing import MockTokenizer

    _, ids = make_context(MockTokenizer(), image_prompt("what is in the picture?", 2), None,
                          "You are a helpful assistant.")
    px = np.random.default_rng(7).standard_normal((2, 3, 56, 56)).astype(np.float32)
    return ids, px


def _jax_run():
    """The JAX engine's greedy run and first-step logits, computed once."""
    if not _JAX_RUN:
        from omchat_tpu.config import GenerationConfig, OmChatConfig
        from omchat_tpu.runtime.generate import OmChatEngine
        from tests.test_sharding import _tiny_params

        cfg = OmChatConfig.tiny()
        params = _tiny_params(cfg)
        ids, px = _request()
        eng = OmChatEngine(cfg, params, attn_impl="xla", image_cache_size=0)
        out = eng.generate([ids], px, GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1))
        feats = eng.encode_images(px)
        logits, _ = eng.prefill(eng.plan([ids]), feats, NEW_TOKENS)
        _JAX_RUN.update(params=jax.device_get(params), tokens=out.token_ids, logits=np.asarray(logits))
    return _JAX_RUN


@pytest.mark.parametrize("impl", [None, "plain"], ids=["kernel_path", "plain_path"])
def test_tiny_generate_matches_jax_engine(impl):
    """Identical greedy tokens; first-step logits within 1e-4 (float32)."""
    ref = _jax_run()
    ids, px = _request()
    eng = TEngine(TOmChatConfig.tiny(), from_jax_params(ref["params"]), attn_impl=impl, device="cpu")
    first = {}
    out = eng.generate([ids], px, TGenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1),
                       logits_callback=lambda step, lg: first.setdefault(step, lg.clone()))
    assert out.token_ids == ref["tokens"]
    np.testing.assert_allclose(first[0].numpy(), ref["logits"], atol=1e-4, rtol=0)
    assert eng.spans["decode_steps"] == NEW_TOKENS - 1


def test_load_pretrained_model_from_tiny_checkpoint(tmp_path):
    """The port's safetensors loader reads the tiny HF-bundle checkpoint into
    the same tree the JAX loader builds (conv OIHW aside), and chat runs."""
    from omchat_tpu.checkpoint.loader import load_omchat_checkpoint
    from tests.test_api_e2e import _write_tiny_checkpoint, _write_tiny_tokenizer

    from omchat_torch.api import load_pretrained_model

    d = str(tmp_path)
    _write_tiny_tokenizer(d)
    _write_tiny_checkpoint(d)
    _, jparams = load_omchat_checkpoint(d, jnp.float32)
    model = load_pretrained_model(d, dtype=torch.float32, device="cpu")
    assert model.config.text.vocab_size == 512 and model.engine.device.type == "cpu"
    want = from_jax_params(jax.device_get(jparams))
    got = model.engine.params

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}.{k}")
            else:
                assert torch.equal(a[k], b[k]), f"{path}.{k}"

    walk(want, got)
    from PIL import Image

    img = Image.fromarray(np.random.default_rng(0).integers(0, 255, (100, 80, 3), dtype=np.uint8))
    assert isinstance(model.chat("what is this?", image=img, generation=TGenerationConfig(max_new_tokens=3)), str)


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    from omchat_torch.api import load_pretrained_model
    from omchat_torch.cli.single_inference import main

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(TOmChatConfig.tiny(), {})
    with pytest.raises(RuntimeError, match="CUDA"):
        load_pretrained_model(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model-path", str(tmp_path), "--image-path", "x.png", "--question", "q"])


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "omchat_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [(f, m) for f in files for m in _imports(f) if m.split(".")[0] in ("jax", "jaxlib", "omchat_tpu")]
    assert not bad, bad
