"""The port's HTTP server over the paged engine on the CPU: the tiny on-disk
checkpoint loaded by the port, the paged engine ticked by the scheduler
thread, ``/health`` and a text and an image chat completion on
``127.0.0.1:0``; the flags the server still refuses by name (the parity of
every route with the JAX server: ``tests/test_torch_serve.py``)."""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from tests.test_api_e2e import _write_tiny_checkpoint, _write_tiny_tokenizer

    from omchat_torch.api import load_pretrained_model, paged_batch_engine
    from omchat_torch.cli.serve import make_server

    d = str(tmp_path_factory.mktemp("tiny_ckpt"))
    _write_tiny_tokenizer(d)
    _write_tiny_checkpoint(d)
    model = load_pretrained_model(d, dtype=torch.float32, device="cpu")
    engine = paged_batch_engine(model, max_slots=2, num_pages=64, page_size=8, prompt_bucket=16, max_len=256,
                                prefill_chunk=64, decode_roll=2)
    srv, loop = make_server(model, engine, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv.server_address[1], engine
    srv.shutdown()
    srv.server_close()
    loop.close()
    thread.join(30)
    assert not thread.is_alive()


def _post(port, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_health(server):
    port, _ = server
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=30) as resp:
        assert json.loads(resp.read())["status"] == "ok"


def test_text_completion(server):
    port, engine = server
    out = _post(port, {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 4})
    assert out["object"] == "chat.completion"
    assert out["choices"][0]["message"]["role"] == "assistant"
    assert isinstance(out["choices"][0]["message"]["content"], str)
    assert 1 <= out["usage"]["completion_tokens"] <= 4 and out["usage"]["prompt_tokens"] > 10
    assert engine.allocator.available == engine.allocator.num_pages


def test_image_completion(server):
    port, engine = server
    img = Image.fromarray(np.random.default_rng(0).integers(0, 255, (100, 80, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    url = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
    out = _post(port, {
        "messages": [{"role": "user", "content": [
            {"type": "text", "text": "What is this?"}, {"type": "image_url", "image_url": {"url": url}}]}],
        "max_tokens": 3, "temperature": 0.8,
    })
    assert 1 <= out["usage"]["completion_tokens"] <= 3
    assert out["usage"]["prompt_tokens"] > 2 * 16  # at least two 16-row tiles spliced in
    assert engine.stats()["image_cache_misses"] >= 1


@pytest.mark.parametrize("flags,item", [(["--tp", "2"], "torchrun --nproc-per-node 2")], ids=["tp"])
def test_unsupported_field_is_a_client_error(flags, item, capsys, monkeypatch):
    """``--tp 2`` outside a launched world of 2 ranks is a usage error that
    says what to launch, before any weight loads."""
    from omchat_torch.cli.serve import main

    def no_load(*a, **kw):
        raise AssertionError("weights loaded before the refusal")

    monkeypatch.setattr("omchat_torch.api.load_pretrained_model", no_load)
    with pytest.raises(SystemExit) as e:
        main(["--model-path", "/nonexistent", "--device", "cpu", *flags])
    assert e.value.code == 2
    assert item in capsys.readouterr().err


def test_prompt_no_allocation_holds_is_a_client_error(server):
    port, engine = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, {"messages": [{"role": "user", "content": "hello " * 300}], "max_tokens": 4})
    assert e.value.code == 400
    assert "pages" in json.loads(e.value.read())["error"]["message"]
    assert not engine.requests


def test_failed_scheduler_cancels_and_forgets_the_request():
    """A request the scheduler can no longer serve is cancelled and its
    record dropped, so waiting clients leak nothing."""
    from omchat_torch.cli.serve import ServingLoop
    from omchat_torch.config import GenerationConfig

    class Engine:
        requests, cancelled = {}, []

        def submit(self, ids, images, **kw):
            self.requests[0] = ids
            return 0

        def finished(self, rid):
            return False

        def cancel(self, rid):
            self.cancelled.append(rid)

        def pop_result(self, rid):
            return self.requests.pop(rid), 0

    eng = Engine()
    loop = ServingLoop(eng)  # never started: the scheduler is gone
    loop.error = RuntimeError("scheduler died")
    with pytest.raises(RuntimeError, match="unavailable"):
        loop.run_n([1, 2], None, GenerationConfig(max_new_tokens=2))
    assert eng.cancelled == [0] and eng.requests == {}
