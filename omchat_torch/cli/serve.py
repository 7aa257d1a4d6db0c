"""Thin OpenAI-style HTTP server over the paged continuous-batching engine —
the port's counterpart of ``cli/serve.py --paged``.

    python -m omchat_torch.cli.serve --model-path CKPT [--port 8000] [--device cuda] [--int8 | --w8a8]

Serves ``GET /health`` and non-streaming ``POST /v1/chat/completions`` (text
and base64 ``image_url`` content parts; ``max_tokens``, ``temperature``,
``top_p``, ``top_k``).  Every request joins the one
:class:`~omchat_torch.runtime.paged_engine.PagedBatchEngine`, which a
scheduler thread ticks.  Streaming (SSE), tools, JSON mode, logprobs, stop
strings, seeds, penalties, ``n > 1`` and ``/metrics`` wait for later slices:
a request asking for one gets a 400 naming it.

Request example:
    {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "What is this?"},
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,..."}}
    ]}], "max_tokens": 256}
"""

from __future__ import annotations

import argparse
import base64
import binascii
import hashlib
import io
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from omchat_torch.config import GenerationConfig

logger = logging.getLogger("omchat_torch.serve")

# request fields whose features wait for later slices
_UNSUPPORTED = ("stream", "tools", "tool_choice", "logprobs", "top_logprobs", "response_format", "guided_json",
                "guided_choice", "seed", "logit_bias", "stop", "presence_penalty", "frequency_penalty")


class BadRequest(ValueError):
    """Client error: answered with HTTP 400 and an ``invalid_request_error``."""


def _error_body(message, err_type):
    return {"error": {"message": str(message), "type": err_type}}


def parse_generation(req: dict, default_max: int) -> GenerationConfig:
    for key in _UNSUPPORTED:
        if req.get(key):
            raise BadRequest(f"{key!r} is not supported by this server yet")
    if int(req.get("n", 1) or 1) != 1:
        raise BadRequest("'n' > 1 is not supported by this server yet")
    try:
        temperature = float(req.get("temperature", 0.0))
        gen = GenerationConfig(
            max_new_tokens=int(req.get("max_tokens", default_max)),
            do_sample=temperature > 0.0,
            temperature=temperature or 1.0,
            top_p=float(req.get("top_p", 1.0)),
            top_k=int(req.get("top_k", 0)),
        )
    except (TypeError, ValueError) as e:
        raise BadRequest(f"invalid sampling parameter: {e}") from e
    if gen.max_new_tokens < 1:
        raise BadRequest("max_tokens must be >= 1")
    return gen


def parse_messages(messages):
    """(question, history, images, system, image_key) from OpenAI-style
    messages; ``image_key`` hashes the compressed image payloads in order
    (the feature cache's identity for them)."""
    from PIL import Image

    img_hash = hashlib.blake2b(digest_size=16)
    images, history = [], []
    system = "You are a helpful assistant."
    pending_user = None
    if not isinstance(messages, list):
        raise BadRequest("messages must be a list")
    for msg in messages:
        if not isinstance(msg, dict):
            raise BadRequest("each message must be an object with role/content")
        role, content = msg.get("role"), msg.get("content", "")
        if isinstance(content, list):
            parts = []
            for part in content:
                if not isinstance(part, dict):
                    raise BadRequest("content parts must be objects")
                if part.get("type") == "text":
                    parts.append(part.get("text", ""))
                elif part.get("type") == "image_url":
                    url = (part.get("image_url") or {}).get("url", "")
                    if not url.startswith("data:"):
                        raise BadRequest("image_url must be a base64 data URL")
                    try:
                        raw = base64.b64decode(url.split(",", 1)[1])
                        images.append(Image.open(io.BytesIO(raw)).convert("RGB"))
                    except (IndexError, binascii.Error, OSError) as e:
                        raise BadRequest(f"could not decode image_url data: {e}") from e
                    img_hash.update(raw)
            text = "\n".join(parts)
        else:
            text = str(content)
        if role == "system":
            system = text
        elif role == "user":
            if pending_user is not None:
                history.append((pending_user, ""))
            pending_user = text
        elif role == "assistant":
            if msg.get("tool_calls"):
                raise BadRequest("tool calls are not supported by this server yet")
            if pending_user is not None:
                history.append((pending_user, text))
                pending_user = None
        else:
            raise BadRequest(f"unsupported message role {role!r}")
    image_key = f"req-imgs-{img_hash.hexdigest()}" if images else None
    return pending_user or "", history, images or None, system, image_key


class ServingLoop:
    """The engine, a lock that serialises it, and the scheduler thread that
    ticks it while it has work."""

    def __init__(self, engine):
        self.engine = engine
        self.lock = threading.Lock()
        self.error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="paged-scheduler")

    def start(self) -> "ServingLoop":
        self._thread.start()
        return self

    def close(self, timeout: float = 30.0) -> None:
        self._stop.set()
        self._thread.join(timeout)

    def _run(self):
        while not self._stop.is_set():
            try:
                with self.lock:
                    busy = self.engine.has_work()
                    if busy:
                        self.engine.step()
            except Exception as e:  # noqa: BLE001 — the scheduler's boundary: fail every waiting request
                logger.exception("paged scheduler died; failing in-flight requests")
                self.error = e
                return
            if not busy:
                time.sleep(0.002)

    def run(self, input_ids, images, gen: GenerationConfig, image_key=None) -> Tuple[list, int]:
        """Submit one request and wait for it: (token ids, prompt length).
        A prompt no allocation could hold is a client error."""
        with self.lock:
            try:
                rid = self.engine.submit(list(input_ids), images, max_new_tokens=gen.max_new_tokens,
                                         eos_token_id=gen.eos_token_id, generation=gen, image_cache_key=image_key)
            except ValueError as e:
                raise BadRequest(str(e)) from e
        # the JAX package's server gives a request the same deadline (cli/serve.py)
        deadline = time.time() + 60 + 0.5 * gen.max_new_tokens
        while not self.engine.finished(rid):
            if self.error is not None or time.time() > deadline:
                with self.lock:
                    # the scheduler frees the slot and pages at its next tick;
                    # the request's record goes now
                    self.engine.cancel(rid)
                    self.engine.pop_result(rid)
                raise RuntimeError("the scheduler is unavailable or the request timed out")
            time.sleep(0.005)
        with self.lock:
            return self.engine.pop_result(rid)


def make_handler(model, loop: ServingLoop):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.info("%s " + fmt, self.client_address[0], *args)

        def _json(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok" if loop.error is None else "scheduler failed"})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/chat/completions":
                self._json(404, {"error": "not found"})
                return
            try:
                t0 = time.time()
                try:
                    req = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
                except json.JSONDecodeError as e:
                    raise BadRequest(f"invalid JSON body: {e}") from e
                if not isinstance(req, dict):
                    raise BadRequest("request body must be a JSON object")
                question, history, images, system, image_key = parse_messages(req.get("messages", []))
                gen = parse_generation(req, default_max=1024)
                inputs = model.processor(question, images=images, history=history, system=system)
                tokens, prompt_len = loop.run(inputs["input_ids"][0].tolist(), inputs.get("images"), gen, image_key)
                text = model.tokenizer.decode(tokens, skip_special_tokens=True)
                self._json(200, {
                    "object": "chat.completion",
                    "model": "omchat",
                    "choices": [{
                        "index": 0,
                        "message": {"role": "assistant", "content": text},
                        "finish_reason": "length" if len(tokens) >= gen.max_new_tokens else "stop",
                    }],
                    "usage": {
                        "prompt_tokens": prompt_len,
                        "completion_tokens": len(tokens),
                        "total_tokens": prompt_len + len(tokens),
                        "latency_ms": round((time.time() - t0) * 1000, 1),
                    },
                })
            except BadRequest as e:
                self._json(400, _error_body(e, "invalid_request_error"))
            except Exception as e:  # noqa: BLE001 — one request's failure must not take the server down
                logger.exception("request failed")
                self._json(500, _error_body(e, "internal_error"))

    return Handler


def make_server(model, engine, host: str = "127.0.0.1", port: int = 8000):
    """A ready HTTP server and its started scheduler loop; the caller runs
    ``server.serve_forever()`` and, when done, ``server.shutdown()``,
    ``server.server_close()`` and ``loop.close()``."""
    loop = ServingLoop(engine).start()
    return ThreadingHTTPServer((host, port), make_handler(model, loop)), loop


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu (plain PyTorch path)")
    ap.add_argument("--int8", action="store_true", help="int8 weight-only quantization")
    ap.add_argument("--w8a8", action="store_true",
                    help="w8a8 serving mode: int8 activations and weights for the ViT encode and the prefills "
                         "(implies --int8; calibrates static fc1 scales at load)")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--num-pages", type=int, default=1024)
    ap.add_argument("--page-size", type=int, default=128)
    ap.add_argument("--max-len", type=int, default=8192)
    ap.add_argument("--decode-roll", type=int, default=1, help="decode steps per dispatch (one readback per roll)")
    ap.add_argument("--prefill-chunk", type=int, default=1024,
                    help="prompts longer than this prefill in chunks of this width, decode rolls in between")
    ap.add_argument("--image-cache", type=int, default=8, help="encoded-image LRU entries (0 disables)")
    args = ap.parse_args(argv)

    from omchat_torch.api import load_pretrained_model, paged_batch_engine

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    model = load_pretrained_model(args.model_path, quantize_int8=args.int8, w8a8=args.w8a8, device=args.device)
    engine = paged_batch_engine(
        model, max_slots=args.max_slots, num_pages=args.num_pages, page_size=args.page_size, max_len=args.max_len,
        decode_roll=args.decode_roll, prefill_chunk=args.prefill_chunk, image_cache_size=args.image_cache,
    )
    server, loop = make_server(model, engine, args.host, args.port)
    logger.info(f"serving on {args.host}:{args.port} ({args.max_slots} slots, {args.num_pages} pages)")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        loop.close()


if __name__ == "__main__":
    main()
