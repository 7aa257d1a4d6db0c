"""The serving entry points under ``--tp 2`` in a world of two gloo ranks on
the CPU, each against the same entry point on one process (the tiny
on-disk checkpoint, float32):

- ``load_pretrained_model(tp=2)``: each rank holds its shard (half the q
  heads, half the vocabulary), and greedy tokens and first-token logits
  match the one-process load, plain, int8 weight-only and with a LoRA
  adapter merged (limits atol 3e-5 / rtol 1e-4);
- ``single_inference --tp 2`` and ``chat --tp 2`` (stdin on rank 0): rank 0
  prints what the one-process CLI prints, the other rank prints nothing;
- ``serve --tp 2`` on the paged, the slot and the single-request route:
  rank 0 answers two HTTP requests as the one-process server does;
- the leader's replicated calls: replayed on the follower, an error on
  every rank reported once, an error on one rank only ``ReplicaDiverged``
  on both, with that rank's traceback;
- what stays refused before any weight loads: ``--tp 2`` outside a launched
  world of 2 ranks (with ``--w8a8`` too, which a launched world takes), an
  engine's mesh that is not a ``Mesh`` or has a data axis, a tp that leaves
  a rank without a q head of the trunk or of the tower.
"""

import contextlib
import dataclasses
import io
import sys

import numpy as np
import pytest
import torch

from omchat_torch.parallel.launch import run_ranks

import test_torch_parallel_ranks as ranks

ATOL, RTOL = 3e-5, 1e-4
TIMEOUT = 150
PROMPT = [5, 6, 7, 8, 9, 10]
REQUESTS = [("/v1/chat/completions", {"messages": [{"role": "user", "content": "hello there"}], "max_tokens": 3}),
            ("/v1/completions", {"prompt": "count: one two", "max_tokens": 3})]


def _answers(out: list) -> list:
    return [[c.get("message", {}).get("content", c.get("text")) for c in a["choices"]] for a in out]


def _one_process(ckpt: str, lora_dir: str) -> dict:
    """What the rank function computes, on one process without a world."""
    from omchat_torch.api import load_pretrained_model
    from omchat_torch.cli import chat, single_inference
    from omchat_torch.config import GenerationConfig

    gen = GenerationConfig(max_new_tokens=4, eos_token_id=-1)
    out = {}
    for name, kw in (("load", {}), ("int8", {"quantize_int8": True}), ("lora", {"lora_path": lora_dir})):
        model = load_pretrained_model(ckpt, dtype=torch.float32, device="cpu", **kw)
        steps = []
        o = model.engine.generate([PROMPT], None, gen, logits_callback=lambda s, lg: steps.append(lg[0].numpy()))
        out[name] = {"tokens": o.token_ids[0], "logits": steps[0]}
    base = ["--model-path", ckpt, "--device", "cpu", "--max-new-tokens", "3"]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        single_inference.main(base + ["--image-path", f"{ckpt}/img.png", "--question", "what is it?"])
    out["single_inference"] = text.getvalue()
    text, stdin = io.StringIO(), sys.stdin
    sys.stdin = io.StringIO("hello\nand then?\n\n")
    try:
        with contextlib.redirect_stdout(text):
            chat.main(base)
    finally:
        sys.stdin = stdin
    out["chat"] = text.getvalue()
    serve = ["--model-path", ckpt, "--device", "cpu", "--host", "127.0.0.1", "--port", "0"]
    small = ["--page-size", "8", "--num-pages", "64", "--max-len", "256", "--max-slots", "2"]
    for route, flags in (("paged", ["--paged", *small]), ("slots", ["--continuous-batching", *small]),
                         ("single", [])):
        out[f"serve_{route}"] = ranks.serve_and_ask(serve + flags, REQUESTS)
    return out


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from PIL import Image

    from tests.test_api_e2e import _write_tiny_checkpoint, _write_tiny_tokenizer

    from omchat_torch.checkpoint.loader import load_omchat_checkpoint
    from omchat_torch.checkpoint.save import save_lora_adapter
    from omchat_torch.training.lora import init_lora

    d = tmp_path_factory.mktemp("tp_ckpt")
    _write_tiny_tokenizer(str(d))
    _write_tiny_checkpoint(str(d))
    px = (np.random.default_rng(3).random((60, 80, 3)) * 255).astype(np.uint8)
    Image.fromarray(px).save(d / "img.png")
    _, params = load_omchat_checkpoint(str(d), torch.float32, device="cpu")
    g = torch.Generator().manual_seed(5)
    lora = init_lora(g, params, rank=4, dtype=torch.float32)
    for ab in (ab for group in lora["layers"].values() for ab in group.values()):
        ab["b"] = (0.05 * torch.randn(ab["b"].shape, generator=g)).requires_grad_()
    save_lora_adapter(str(d / "lora"), lora)
    return str(d), str(d / "lora")


@pytest.fixture(scope="module")
def world(checkpoint):
    ckpt, lora_dir = checkpoint
    res = run_ranks(ranks.tp_cli_rank, 2, ckpt, lora_dir, REQUESTS, PROMPT, timeout=TIMEOUT)
    return res, _one_process(ckpt, lora_dir)


@pytest.mark.parametrize("case", ["load", "int8", "lora"])
def test_load_pretrained_model_tp2_matches_one_process(world, case):
    res, want = world
    for r in range(2):
        assert res[r][case]["tokens"] == want[case]["tokens"]
        np.testing.assert_allclose(res[r][case]["logits"], want[case]["logits"], atol=ATOL, rtol=RTOL)


def test_each_rank_holds_its_shard(world):
    """The tiny trunk: 4 q heads of width 16 over 2 layers, a 512-row
    vocabulary; a rank holds half of each (int8 codes are [out, in])."""
    res, _ = world
    for r in range(2):
        assert res[r]["load"]["q_shape"] == (2, 64, 32)
        assert res[r]["int8"]["q_shape"] == (2, 32, 64)
        assert res[r]["load"]["embed_rows"] == 256


@pytest.mark.parametrize("cli", ["single_inference", "chat"])
def test_cli_under_two_ranks_prints_once_what_one_process_prints(world, cli):
    res, want = world
    assert res[0][cli] == want[cli] and want[cli].strip()
    assert res[1][cli] == ""


@pytest.mark.parametrize("route", ["paged", "slots", "single"])
def test_serve_tp2_answers_as_one_process(world, route):
    res, want = world
    got = res[0][f"serve_{route}"]
    assert len(got) == len(REQUESTS) and _answers(got) == _answers(want[f"serve_{route}"])
    assert res[1][f"serve_{route}"] == []


def test_a_follower_replays_the_leaders_calls_and_a_divergence_ends_both():
    lead, follow = run_ranks(ranks.replica_rank, 2, timeout=60)
    assert lead["ok"] == 6 and lead["seen"] == [3] and lead["after"] == 14
    assert lead["alike"] == "5 refused"
    assert lead["calls"] == [3, 7, 9] and follow["calls"] == [3, 7]  # 9: run on the leader, refused on rank 1
    assert "rank 1: ValueError: 9 refused" in lead["diverged"] and "Traceback" in lead["diverged"]
    assert "rank 1" in follow["diverged"]


@pytest.mark.parametrize("cli", ["single_inference", "chat", "serve"])
def test_tp_without_a_launched_world_is_a_usage_error_before_loading(cli, capsys, monkeypatch):
    import importlib

    main = importlib.import_module(f"omchat_torch.cli.{cli}").main

    def no_load(*a, **kw):
        raise AssertionError("weights loaded before the refusal")

    monkeypatch.setattr("omchat_torch.api.load_pretrained_model", no_load)
    argv = ["--model-path", "/nonexistent", "--device", "cpu", "--tp", "2"]
    if cli == "single_inference":
        argv += ["--question", "q", "--image-path", "a.png"]
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2 and "torchrun --nproc-per-node 2" in capsys.readouterr().err


def test_w8a8_with_tp_is_refused_by_name(capsys, monkeypatch):
    """``--w8a8 --tp 2`` is no longer refused in a launched world of two
    ranks; outside one it is the usage error every ``--tp`` above 1 is."""
    from omchat_torch.cli import options

    parser = __import__("argparse").ArgumentParser()
    options.add_model_flags(parser)
    args = parser.parse_args(["--model-path", "x", "--tp", "2", "--w8a8"])
    with pytest.raises(SystemExit):
        options.check_tp(parser, args)
    assert "torchrun --nproc-per-node 2" in capsys.readouterr().err
    monkeypatch.setattr("omchat_torch.parallel.launch.launched_world", lambda: 2)
    options.check_tp(parser, args)
    assert capsys.readouterr().err == ""


def test_engines_refuse_what_a_serving_mesh_does_not_serve():
    from omchat_torch.config import OmChatConfig
    from omchat_torch.parallel.mesh import Mesh, create_mesh
    from omchat_torch.parallel.serving import check_serving_mesh

    cfg = OmChatConfig.tiny()
    with pytest.raises(TypeError, match="Mesh"):
        check_serving_mesh(cfg, object())
    with pytest.raises(ValueError, match="pure tensor-parallel"):
        check_serving_mesh(cfg, create_mesh(tp=1, ranks=range(2)))
    tp8 = Mesh(np.arange(8).reshape(1, 8), ("data", "model"), rank=0)
    with pytest.raises(ValueError, match="without a q head"):
        check_serving_mesh(cfg, tp8)  # 4 q heads: four of the eight ranks would hold none
    wide = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_attention_heads=8))
    with pytest.raises(ValueError, match="vision tower"):
        check_serving_mesh(wide, tp8)  # the tower's 4 heads
    # what serves now: a kv head count tp does not divide, w8a8, the MoE trunk
    tp2 = Mesh(np.arange(2).reshape(1, 2), ("data", "model"), rank=0)
    tp4 = Mesh(np.arange(4).reshape(1, 4), ("data", "model"), rank=0)
    moe = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_experts=4))
    for ok, mesh in ((dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_key_value_heads=1)), tp2),
                     (cfg.with_w8a8(), tp2), (moe, tp2), (cfg, tp4)):
        check_serving_mesh(ok, mesh)
