"""The port's parity runbook (``eval.parity``, ``cli.parity``) on a tiny
bundle written by the port's ``export_hf_bundle``, on the CPU in float32.

- Both twin sources: the bundle's own code through ``AutoModel``
  ("remote_code") and, for a copy without code files or ``auto_map``, the
  port's copy of the bundle code fed the engine's weights ("in-repo-twin").
- The port's report against the JAX runbook's on the same bundle and prompt:
  argmax match 1.0, max |Δlogit| < 1e-4 (float32 round-off through two
  stacks), no first divergence, the same twin and engine tokens.
- A planted fault, layer 0's ``q_proj`` transposed in the twin's copy of the
  weights, must show: max |Δlogit| past the limit.
- ``cli.parity.main --device cpu`` end to end.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from omchat_torch.eval import parity as tparity

LOGIT_LIMIT = 1e-4
NEW = 5


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """The tiny checkpoint exported by the port (float32), and a copy of it
    without the code files and the ``auto_map``."""
    from tests.test_api_e2e import _write_tiny_checkpoint, _write_tiny_tokenizer

    from omchat_torch.checkpoint.loader import load_omchat_checkpoint
    from omchat_torch.checkpoint.save import export_hf_bundle

    root = tmp_path_factory.mktemp("parity")
    src = root / "src"
    src.mkdir()
    _write_tiny_tokenizer(str(src))
    _write_tiny_checkpoint(str(src))
    cfg, params = load_omchat_checkpoint(str(src), torch.float32, device="cpu")
    export_hf_bundle(cfg, params, str(root / "bundle"), source_dir=str(src))
    plain = root / "plain"
    plain.mkdir()
    for name in os.listdir(root / "bundle"):
        if not name.endswith(".py"):
            shutil.copy(root / "bundle" / name, plain / name)
    cfg_json = json.load(open(plain / "config.json"))
    cfg_json.pop("auto_map")
    json.dump(cfg_json, open(plain / "config.json", "w"))
    return {"bundle": str(root / "bundle"), "plain": str(plain)}


@pytest.fixture(scope="module")
def model(bundle):
    from omchat_torch.api import load_pretrained_model

    return load_pretrained_model(bundle["bundle"], dtype=torch.float32, attn_impl="plain", device="cpu")


def _inputs(processor, seed):
    image = Image.fromarray(np.random.default_rng(seed).integers(0, 255, (70, 100, 3), dtype=np.uint8))
    inputs = processor("describe", images=image)
    return np.asarray(inputs["input_ids"][0]).tolist(), np.asarray(inputs["images"], np.float32)


def _full_match(report):
    assert report["steps"] == NEW
    assert report["argmax_match_rate"] == 1.0 and report["first_divergence_step"] is None
    assert report["engine_matches_torch"]
    assert report["max_logit_diff"] < LOGIT_LIMIT


def test_remote_code_twin_report_is_the_jax_runbooks(bundle, model):
    from omchat_tpu.api import load_pretrained_model as jload
    from omchat_tpu.eval import parity as jparity

    twin, source = tparity.load_torch_twin(bundle["bundle"], params=model.engine.params, device="cpu")
    assert source == "remote_code"
    ids, images = _inputs(model.processor, 3)
    report = tparity.run_parity(model, twin, ids, images, max_new_tokens=NEW, per_module=True)
    _full_match(report)
    assert report["per_module"]["tower_features"]["max_abs"] < LOGIT_LIMIT
    assert report["per_module"]["projector"]["max_abs"] < LOGIT_LIMIT

    jmodel = jload(bundle["bundle"], dtype=jnp.float32, attn_impl="xla")
    jtwin, jsource = jparity.load_torch_twin(bundle["bundle"], jax_params=jmodel.engine.params)
    want = jparity.run_parity(jmodel, jtwin, ids, images, max_new_tokens=NEW, per_module=True)
    assert jsource == source
    assert set(report) == set(want)
    for key in ("steps", "argmax_match_rate", "first_divergence_step", "torch_tokens", "engine_tokens",
                "engine_matches_torch"):
        assert report[key] == want[key], key
    np.testing.assert_allclose(report["per_step_max_logit_diff"], want["per_step_max_logit_diff"], atol=LOGIT_LIMIT)


def test_in_repo_twin_without_code_files(bundle):
    from omchat_torch.api import load_pretrained_model

    model = load_pretrained_model(bundle["plain"], dtype=torch.float32, attn_impl="plain", device="cpu")
    twin, source = tparity.load_torch_twin(bundle["plain"], params=model.engine.params, device="cpu")
    assert source == "in-repo-twin"
    ids = np.asarray(model.processor("hello there")["input_ids"][0]).tolist()
    _full_match(tparity.run_parity(model, twin, ids, None, max_new_tokens=NEW))
    with pytest.raises(ValueError, match="engine's params"):
        tparity.load_torch_twin(bundle["plain"], device="cpu")


def test_a_planted_fault_shows(bundle, model, tmp_path):
    """Layer 0's q_proj transposed in a copy of the bundle's weights: the
    twin loaded from it parts from the engine."""
    from safetensors.torch import load_file, save_file

    faulty = tmp_path / "faulty"
    shutil.copytree(bundle["bundle"], faulty)
    path = faulty / "model.safetensors"
    state = load_file(str(path))
    key = "language_model.model.layers.0.self_attn.q_proj.weight"
    state[key] = state[key].t().contiguous()
    save_file(state, str(path))
    twin, _ = tparity.load_torch_twin(str(faulty), device="cpu")
    ids, images = _inputs(model.processor, 4)
    report = tparity.run_parity(model, twin, ids, images, max_new_tokens=NEW)
    assert report["max_logit_diff"] > 10 * LOGIT_LIMIT  # 54 x the limit read here


def test_cli_parity_end_to_end_on_the_cpu(bundle, tmp_path, capsys):
    from omchat_torch.cli import parity as cli

    image = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(5).integers(0, 255, (64, 80, 3), dtype=np.uint8)).save(image)
    cli.main(["--model-path", bundle["bundle"], "--image", str(image), "--question", "What is this?",
              "--max-new-tokens", str(NEW), "--per-module", "--device", "cpu"])
    captured = capsys.readouterr()
    report = json.loads(captured.out.strip().splitlines()[-1])
    assert "torch twin: remote_code" in captured.err
    assert report["torch_twin"] == "remote_code" and report["attn_impl"] == "plain"
    _full_match(report)
    assert isinstance(report["engine_text"], str) and "per_module" in report
    with pytest.raises(SystemExit):
        cli.main(["--model-path", bundle["bundle"], "--attn-impl", "kernels", "--device", "cpu"])
