"""w8a8 through the serving entry points under ``--tp 2``, in a world of
two gloo ranks on the CPU, against the same entry points on one process
(the tiny on-disk checkpoint, float32):

- ``load_pretrained_model(w8a8=True, tp=2)``: each rank quantizes every
  whole layer before it keeps its shard and calibrates the ViT's fc1 scales
  on whole layers as it reads them, and the scales are bitwise the
  one-process load's (``quantize_model``'s ``calibrate_fc1_scales``); greedy
  tokens and first-step logits match the one-process load on the unfused
  chain (``attn_impl="plain"``, which the mesh runs too: its glue route is
  off), limits atol 3e-5 / rtol 1e-4;
- ``single_inference --w8a8 --tp 2``: rank 0 prints an answer, the other
  rank nothing;
- the MoE trunk's layers read one at a time (``qwen2_layers`` on a subset)
  bitwise the whole read's.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from omchat_torch.parallel.launch import run_ranks

import test_torch_parallel_ranks as ranks

ATOL, RTOL = 3e-5, 1e-4
TIMEOUT = 150
PROMPT = [5, 6, 7, 8, 9, 10]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from PIL import Image

    from tests.test_api_e2e import _write_tiny_checkpoint, _write_tiny_tokenizer

    d = tmp_path_factory.mktemp("tp_w8a8_ckpt")
    _write_tiny_tokenizer(str(d))
    _write_tiny_checkpoint(str(d))
    px = (np.random.default_rng(3).random((60, 80, 3)) * 255).astype(np.uint8)
    Image.fromarray(px).save(d / "img.png")
    return str(d)


def _one_process(ckpt: str) -> dict:
    from omchat_torch.api import load_pretrained_model
    from omchat_torch.cli import single_inference
    from omchat_torch.config import GenerationConfig

    gen = GenerationConfig(max_new_tokens=4, eos_token_id=-1)
    out = {"fc1_out_scale": load_pretrained_model(ckpt, dtype=torch.float32, device="cpu", w8a8=True)
           .engine.params["vision_tower"]["layers"]["mlp"]["fc1_out_scale"]}
    model = load_pretrained_model(ckpt, dtype=torch.float32, device="cpu", w8a8=True, attn_impl="plain")
    steps = []
    o = model.engine.generate([PROMPT], None, gen, logits_callback=lambda s, lg: steps.append(lg[0].numpy()))
    out.update(tokens=o.token_ids[0], logits=steps[0])
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        single_inference.main(["--model-path", ckpt, "--device", "cpu", "--w8a8", "--max-new-tokens", "3",
                               "--image-path", f"{ckpt}/img.png", "--question", "what is it?"])
    out["single_inference"] = text.getvalue()
    return out


@pytest.fixture(scope="module")
def world(checkpoint):
    return run_ranks(ranks.tp_remainder_cli_rank, 2, checkpoint, PROMPT, timeout=TIMEOUT), _one_process(checkpoint)


def test_load_pretrained_model_w8a8_tp2_matches_one_process(world):
    res, want = world
    for r in range(2):
        assert res[r]["w8a8"]
        assert res[r]["tokens"] == want["tokens"]
        np.testing.assert_allclose(res[r]["logits"], want["logits"], atol=ATOL, rtol=RTOL)


def test_the_fc1_scales_are_the_one_process_loads(world):
    """Calibrated on whole layers as the sharded load reads them: bitwise
    the scales ``calibrate_fc1_scales`` gives on the whole tower."""
    res, want = world
    for r in range(2):
        assert torch.equal(res[r]["fc1_out_scale"], want["fc1_out_scale"])


def test_each_rank_holds_its_int8_shard(world):
    """The tiny tower's qkv codes [L, 3 x 64 out, 64 in]: a rank holds its 2
    of the 4 heads of q, of k and of v."""
    res, _ = world
    for r in range(2):
        assert res[r]["qkv_codes"] == (2, 96, 64)


def test_single_inference_w8a8_tp2_prints_once(world):
    res, want = world
    assert res[0]["single_inference"].strip() and res[1]["single_inference"] == ""
    assert want["single_inference"].strip()


def test_moe_layers_read_one_at_a_time_are_the_whole_reads():
    """The sharded load reads the MoE trunk a layer at a time: each layer's
    tree is bitwise that layer of the whole read."""
    from omchat_torch.checkpoint.loader import qwen2_layers
    from omchat_torch.checkpoint.save import flatten_to_hf_state
    from omchat_torch.config import OmChatConfig
    from omchat_torch.models import intern_vit, projector, qwen2_moe
    from omchat_torch.utils.tree import layer_slice, tree_items

    cfg = ranks.remainder_config(OmChatConfig, "moe4")
    g = torch.Generator().manual_seed(0)
    tree = {"vision_tower": intern_vit.init_params(cfg.vision, g),
            "projector": projector.init_params(cfg.projector, cfg.vision.hidden_size, cfg.text.hidden_size, g),
            "language_model": qwen2_moe.init_params(cfg.text, g)}
    state = {k[len("language_model."):]: v for k, v in flatten_to_hf_state(tree).items()
             if k.startswith("language_model.")}
    whole = qwen2_layers(state, cfg.text, torch.float32)
    for i in range(cfg.text.num_hidden_layers):
        one = qwen2_layers(state, cfg.text, torch.float32, layers=[i])
        for (path, a), (_, b) in zip(tree_items(one), tree_items(layer_slice(whole, i))):
            assert torch.equal(a[0], b), path
