"""The single-request surface on the CPU against the JAX package: video
processing (bitwise), the device preprocessing pipeline (JAX's bicubic
resize as two matmuls), ``OmChatModel.chat_video`` and ``chat`` with
history giving the JAX model's replies, and the port's CLIs: ``chat`` with
piped turns, ``single_inference --video-path`` on a GIF and on a frame
directory, ``--lora``, and ``--tp 2`` refused.  ``OmChatConfig.tiny()`` in
float32.

Tolerances: ``process_video_frames`` bitwise (the same PIL calls);
``device_preprocess_frames`` within 1e-4 of JAX's (float32 weights built
the same way, the products summed in another order) and, as the JAX
package's own test holds it, a mean |diff| under 0.05 from the PIL host
path (two bicubic resamplers).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from omchat_torch.processing import device_pipeline as tdp
from omchat_torch.processing import video as tv
from tests.test_torch_constrained import _gen, make_models


def _frames(n, h=90, w=120, seed=0):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)) for _ in range(n)]


def test_video_processing_is_bitwise_jax():
    from omchat_tpu.processing import video as jv

    frames = _frames(50)
    for n, s in ((50, 8), (50, 32), (10, 32)):
        assert tv.sample_frame_indices(n, s) == jv.sample_frame_indices(n, s)
    got = tv.process_video_frames(frames, tile_size=56, num_samples=8)
    want = jv.process_video_frames(frames, tile_size=56, num_samples=8)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert tv.video_prompt("what <image> happens?", 3) == jv.video_prompt("what <image> happens?", 3)


def test_load_video_frames_gif_and_directory(tmp_path):
    from omchat_tpu.processing import video as jv

    frames = _frames(10, 24, 32, seed=1)
    d = tmp_path / "frames"
    d.mkdir()
    for i, f in enumerate(frames):
        f.save(d / f"f{i:03d}.png")
    gif = tmp_path / "clip.gif"
    frames[0].save(gif, save_all=True, append_images=frames[1:8])
    for path in (str(d), str(gif)):
        got, want = tv.load_video_frames(path, num_samples=4), jv.load_video_frames(path, num_samples=4)
        assert len(got) == 4 and got[0].mode == "RGB"
        assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(got, want))


@pytest.mark.parametrize("h,w,tile", [(90, 120, 56), (56, 56, 56), (600, 800, 448), (300, 200, 448)])
def test_device_preprocess_frames_matches_jax(h, w, tile):
    import jax.numpy as jnp

    from omchat_tpu.processing.device_pipeline import device_preprocess_frames

    batch = np.random.default_rng(2).integers(0, 256, (3, h, w, 3), dtype=np.uint8)
    want = np.asarray(device_preprocess_frames(jnp.asarray(batch), tile_size=tile))
    got = tdp.device_preprocess_frames(batch, tile_size=tile, device="cpu")
    assert got.shape == want.shape == (3, 3, tile, tile)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_device_preprocess_frames_tracks_the_host_path():
    from omchat_tpu.processing.device_pipeline import frames_to_device_batch

    frames = _frames(6)
    host = tv.process_video_frames(frames, tile_size=56, num_samples=4)
    batch = tdp.frames_to_device_batch(frames, num_samples=4)
    assert np.array_equal(batch, frames_to_device_batch(frames, num_samples=4))
    dev = tdp.device_preprocess_frames(torch.from_numpy(batch), tile_size=56)
    assert dev.shape == host.shape and np.abs(dev.numpy() - host).mean() < 0.05


def test_chat_video_and_chat_with_history_match_jax():
    jmodel, tmodel = make_models()
    jg, tg = _gen(8)
    frames = _frames(12, 40, 60, seed=3)
    assert tmodel.chat_video("what happens?", frames, num_samples=4, generation=tg) == \
        jmodel.chat_video("what happens?", frames, num_samples=4, generation=jg)
    image = _frames(1, 100, 80, seed=4)[0]
    history = [("what is this?", "a cat"), ("and its colour?", "grey")]
    assert tmodel.chat("where is it?", image=image, history=history, generation=tg) == \
        jmodel.chat("where is it?", image=image, history=history, generation=jg)
    images = _frames(2, 70, 70, seed=5)
    assert tmodel.chat("<image> left, <image> right: differences?", image=images, generation=tg) == \
        jmodel.chat("<image> left, <image> right: differences?", image=images, generation=jg)


# -- the CLIs -----------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    from tests.test_api_e2e import _write_tiny_checkpoint, _write_tiny_tokenizer

    d = tmp_path_factory.mktemp("tiny_ckpt")
    _write_tiny_tokenizer(str(d))
    _write_tiny_checkpoint(str(d))
    frames = _frames(9, 60, 80, seed=6)
    frames[0].save(d / "img.png")
    frames[0].save(d / "clip.gif", save_all=True, append_images=frames[1:])
    (d / "frames").mkdir()
    for i, f in enumerate(frames):
        f.save(d / "frames" / f"{i:02d}.png")
    return d


@pytest.fixture
def loads(monkeypatch):
    """Records the keyword arguments of every ``load_pretrained_model`` call."""
    from omchat_torch import api

    made = []
    real = api.load_pretrained_model

    def spy(path, **kw):
        made.append(kw)
        return real(path, **kw)

    monkeypatch.setattr(api, "load_pretrained_model", spy)
    return made


@pytest.mark.parametrize("source", ["gif", "frames"])
def test_single_inference_video_path(tiny_ckpt, loads, capsys, source):
    from omchat_torch.cli.single_inference import main

    path = tiny_ckpt / ("clip.gif" if source == "gif" else "frames")
    main(["--model-path", str(tiny_ckpt), "--video-path", str(path), "--video-frames", "4", "--question", "what?",
          "--max-new-tokens", "3", "--device", "cpu"])
    assert capsys.readouterr().out.endswith("\n") and loads[0]["device"] == "cpu"


def test_single_inference_needs_one_source_and_refuses_tp(tiny_ckpt, capsys):
    from omchat_torch.cli.single_inference import main

    base = ["--model-path", str(tiny_ckpt), "--question", "q", "--device", "cpu"]
    for extra in ([], ["--image-path", "a.png", "--video-path", "b.gif"]):
        with pytest.raises(SystemExit):
            main(base + extra)
        assert "exactly one of --image-path / --video-path" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(base + ["--image-path", str(tiny_ckpt / "img.png"), "--tp", "2"])
    assert "torchrun --nproc-per-node 2" in capsys.readouterr().err  # not a launched world of 2 ranks


@pytest.mark.parametrize("route", ["--speculative", "--num-beams"])
def test_single_inference_speculative_and_beams(tiny_ckpt, capsys, route):
    from omchat_torch.cli.single_inference import main

    extra = ["--speculative"] if route == "--speculative" else ["--num-beams", "2"]
    main(["--model-path", str(tiny_ckpt), "--image-path", str(tiny_ckpt / "img.png"), "--question", "what?",
          "--max-new-tokens", "3", "--device", "cpu"] + extra)
    assert capsys.readouterr().out.endswith("\n")


def test_single_inference_lora_merges_the_adapter(tiny_ckpt, loads, tmp_path, capsys):
    from omchat_torch.checkpoint.loader import load_omchat_checkpoint
    from omchat_torch.checkpoint.save import save_lora_adapter
    from omchat_torch.cli.single_inference import main
    from omchat_torch.training.lora import init_lora

    _, params = load_omchat_checkpoint(str(tiny_ckpt), torch.float32, device="cpu")
    lora = init_lora(torch.Generator().manual_seed(0), params, rank=2, dtype=torch.float32)
    for group in lora["layers"].values():
        for leaf in group.values():
            leaf["b"].data.normal_(generator=torch.Generator().manual_seed(1))
    save_lora_adapter(str(tmp_path / "adapter"), lora)
    main(["--model-path", str(tiny_ckpt), "--image-path", str(tiny_ckpt / "img.png"), "--question", "what?",
          "--max-new-tokens", "2", "--device", "cpu", "--lora", str(tmp_path / "adapter")])
    assert loads[0]["lora_path"] == str(tmp_path / "adapter")
    capsys.readouterr()


def test_chat_cli_threads_history_over_piped_turns(tiny_ckpt, loads, monkeypatch, capsys):
    import io

    from omchat_torch.api import OmChatModel
    from omchat_torch.cli.chat import main

    seen = []
    real = OmChatModel.chat

    def spy(self, text, **kw):
        seen.append((text, kw["history"]))
        return real(self, text, **kw)

    monkeypatch.setattr(OmChatModel, "chat", spy)
    argv = ["--model-path", str(tiny_ckpt), "--max-new-tokens", "2", "--device", "cpu"]
    monkeypatch.setattr("sys.stdin", io.StringIO("hello\nand then?\n\n"))
    main(argv)
    assert [t for t, _ in seen] == ["hello", "and then?"]
    assert seen[0][1] == [] and seen[1][1][0][0] == "hello"
    out = capsys.readouterr().out
    assert out.count("assistant: ") == 2
    seen.clear()
    monkeypatch.setattr("sys.stdin", io.StringIO("one\ntwo\n"))
    main(argv + ["--no-history", "--image-path", str(tiny_ckpt / "img.png")])
    assert [h for _, h in seen] == [None, None]
    with pytest.raises(SystemExit):
        main(argv + ["--tp", "2"])
    assert "torchrun --nproc-per-node 2" in capsys.readouterr().err  # not a launched world of 2 ranks


def test_serve_cli_refuses_tp_and_takes_lora(capsys):
    from omchat_torch.cli import serve

    with pytest.raises(SystemExit):  # --tp 2 outside a launched world of 2 ranks
        serve.main(["--model-path", os.devnull, "--tp", "2"])
    assert "torchrun --nproc-per-node 2" in capsys.readouterr().err
    import argparse

    ap = argparse.ArgumentParser()
    serve.add_model_flags(ap)
    assert {"lora", "tp"} <= {a.dest for a in ap._actions}
