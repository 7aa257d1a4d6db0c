"""OpenAI-compatible HTTP server — the port's counterpart of ``cli/serve.py``.

    python -m omchat_torch.cli.serve --model-path CKPT [--port 8000] [--device cuda] [--int8 | --w8a8] \\
        [--kv-cache-dtype fp8] [--lora ADAPTER] [--paged [--decode-roll N] [--decode-kernel manual] \\
        [--prefix-cache] [--streaming-roll N] [--pipeline-rolls] [--draft-len N]] \\
        [--continuous-batching [--max-slots N] [--max-len N]] [--speculative] [--no-warmup]

Routes: ``GET /health``, ``/metrics`` (Prometheus text: request counters,
and with a batch engine its ``stats()`` and ``engine_dead``) and
``/v1/models``; ``POST /v1/chat/completions`` and ``/chat`` (text and base64
``image_url`` content parts; ``tools`` / ``tool_choice``, ``response_format``
``json_object`` / ``json_schema``, ``guided_json``, ``guided_choice``) and
``/v1/completions`` (a raw prompt, ``echo``); both take ``max_tokens``,
``temperature``, ``top_p``, ``stop`` (up to 4), ``n`` (1-8), ``seed``,
``logit_bias`` (clamped to ±100), ``presence_penalty`` /
``frequency_penalty``, ``logprobs`` / ``top_logprobs`` (at most 5) and
``stream`` (SSE, with ``stream_options.include_usage``).  Client errors get a
400 with an ``invalid_request_error``, anything else a 500.

Engines, as the JAX server routes them:

- By default every request runs the single-request engine
  (``model.engine.generate``) under the device lock; ``--speculative`` runs
  greedy ``n == 1`` requests through ``generate_speculative``.
- ``--paged`` (which implies ``--continuous-batching``) adds a
  :class:`~omchat_torch.runtime.paged_engine.PagedBatchEngine` over the same
  weights, ticked by a scheduler thread: plain, sampled and log-prob requests
  join its batch; seeded, biased, penalised and constrained requests run the
  single-request engine under the lock.  The paged engine's routes come
  from the flags, as on the JAX server: ``--prefix-cache``,
  ``--streaming-roll N`` (the roll while an SSE request decodes: SSE
  requests submit with ``streaming=True``), ``--pipeline-rolls``, and
  ``--speculative`` with ``--draft-len`` (speculative verify of the batch's
  greedy slots).
- ``--continuous-batching`` without ``--paged`` adds the slot engine
  (:class:`~omchat_torch.runtime.batch_engine.BatchEngine`: ``--max-slots``
  slots of ``--max-len`` rows in one shared cache, in the ``--kv-cache-dtype``
  dtype, ``--image-cache`` encoded images), ticked the same way: plain and
  sampled requests (SSE included) join its batch; log-prob requests run the
  single-request engine too, as the slot engine returns tokens only.

One lock serialises the card: the scheduler takes it for each tick and a
single-request generation for its whole run, so that no CUDA graph is
captured on one thread while another launches (a constrained request pauses
the batch while it runs, as it holds the lock for its whole generation).  The
two engines share one set of weights.

``--tp N`` under ``torchrun --nproc-per-node N`` (every route): each rank
loads its shard and builds the same engines; rank 0 binds the port, runs the
scheduler thread and broadcasts every engine call to the other ranks, which
replay it on their shards (:mod:`omchat_torch.parallel.serving`); ``--w8a8``
serves under it too.  Refused before any weight loads: ``--tp N`` outside a
launched world of N ranks, and a tp above the trunk's q heads.

Request example:
    {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "What is this?"},
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,..."}}
    ]}], "max_tokens": 256}
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import hashlib
import io
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

from omchat_torch.cli.options import add_model_flags, is_leader, load_model
from omchat_torch.config import GenerationConfig
from omchat_torch.runtime.generate import KeywordStopper

logger = logging.getLogger("omchat_torch.serve")

MODEL_ID = "omchat-tpu"  # the model id clients pass back: the JAX server's, so a client may use either


class BadRequest(ValueError):
    """Client error: answered with HTTP 400 and an ``invalid_request_error``."""


def _error_body(message, err_type):
    return {"error": {"message": str(message), "type": err_type}}


def _read_json_body(handler):
    raw = handler.rfile.read(int(handler.headers.get("Content-Length", 0)))
    try:
        req = json.loads(raw)
    except json.JSONDecodeError as e:
        raise BadRequest(f"invalid JSON body: {e}") from e
    if not isinstance(req, dict):
        raise BadRequest("request body must be a JSON object")
    return req


def _parse_stops(req) -> List[str]:
    """OpenAI ``stop``: a string or a list of up to 4 strings."""
    stop = req.get("stop") or []
    if isinstance(stop, str):
        stop = [stop]
    return [s for s in stop if s][:4]


def _cut_at_stop(text: str, stops) -> Tuple[str, bool]:
    """``text`` cut at the earliest occurrence of any stop string: (text, hit)."""
    pos = min((text.find(s) for s in stops if s in text), default=-1)
    return (text[:pos], True) if pos >= 0 else (text, False)


def _parse_gen(req, default_max: int):
    """(GenerationConfig, logit_bias | None) from an OpenAI-style body, as
    the JAX server reads it: ``top_k`` is not an OpenAI field and is not read;
    logit_bias keys are token ids, values clamped to ±100."""
    try:
        gen = GenerationConfig(
            max_new_tokens=int(req.get("max_tokens", default_max)),
            do_sample=float(req.get("temperature", 0.0)) > 0.0,
            temperature=float(req.get("temperature", 1.0)) or 1.0,
            top_p=float(req.get("top_p", 1.0)),
            presence_penalty=float(req.get("presence_penalty", 0.0)),
            frequency_penalty=float(req.get("frequency_penalty", 0.0)),
        )
        lb = req.get("logit_bias") or None
        if lb:
            lb = {int(k): max(-100.0, min(100.0, float(v))) for k, v in lb.items()}
    except (TypeError, ValueError, AttributeError) as e:
        raise BadRequest(f"invalid sampling parameter: {e}") from e
    if gen.max_new_tokens < 1:
        raise BadRequest("max_tokens must be >= 1")
    return gen, lb


def _parse_messages(messages):
    """(question, history, images, system, image_key) from OpenAI-style
    messages.  Assistant ``tool_calls`` and ``role: "tool"`` results render
    as the JAX server renders them (a tool result replays inside the next
    user turn); other roles are skipped.  ``image_key`` hashes the request's
    compressed image payloads in order (the encoded-image cache's identity
    for them)."""
    from PIL import Image

    from omchat_torch.runtime.tool_calls import render_assistant_tool_calls, render_tool_result

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
                    if url.startswith("data:"):
                        try:
                            raw = base64.b64decode(url.split(",", 1)[1])
                            images.append(Image.open(io.BytesIO(raw)).convert("RGB"))
                        except Exception as e:  # noqa: BLE001 — any undecodable payload is the client's
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
                text = render_assistant_tool_calls(text or None, msg["tool_calls"])
            if pending_user is not None:
                history.append((pending_user, text))
                pending_user = None
        elif role == "tool":
            rendered = render_tool_result(text)
            pending_user = rendered if pending_user is None else pending_user + "\n" + rendered
    image_key = f"req-imgs-{img_hash.hexdigest()}" if images else None
    return pending_user or "", history, images or None, system, image_key


def _constraint(model, req, tool_fns, tool_mode, forced_name):
    """The request's allowed-tokens function (or None): ``guided_choice``,
    then ``response_format`` json_object, then a schema (``json_schema`` or
    ``guided_json``); a forced tool call constrains to a ``{"name",
    "arguments"}`` object of a declared tool, by name only where the
    parameters' schema is outside the mask's subset."""
    from omchat_torch.runtime.constrained import choice_mask_fn
    from omchat_torch.runtime.json_mode import get_json_mode
    from omchat_torch.runtime.json_schema import get_json_schema_mode
    from omchat_torch.runtime.tool_calls import forced_call_schema

    allowed_fn = None
    guided = req.get("guided_choice")
    if guided:
        allowed_fn = choice_mask_fn(model.tokenizer, [str(c) for c in guided])
    rf = req.get("response_format") or {}
    if allowed_fn is None and isinstance(rf, dict) and rf.get("type") == "json_object":
        allowed_fn = get_json_mode(model.tokenizer).mask_fn()
    schema = None
    if isinstance(rf, dict) and rf.get("type") == "json_schema":
        js = rf.get("json_schema") or {}
        schema = js.get("schema") if isinstance(js, dict) else None
    if schema is None:
        schema = req.get("guided_json")
    if allowed_fn is None and schema:
        allowed_fn = get_json_schema_mode(model.tokenizer, schema).mask_fn()
    if tool_mode == "forced":
        if allowed_fn is not None:
            raise BadRequest("tool_choice 'required' cannot be combined with response_format / guided constraints")
        try:
            allowed_fn = get_json_schema_mode(model.tokenizer, forced_call_schema(tool_fns, forced_name)).mask_fn()
        except ValueError:
            names_only = forced_call_schema([{"name": f["name"]} for f in tool_fns], forced_name)
            allowed_fn = get_json_schema_mode(model.tokenizer, names_only).mask_fn()
    return allowed_fn


class ServingLoop:
    """The device lock and, with a batch engine, the scheduler thread that
    ticks it under that lock while it has work.  ``engine`` None (the
    default route): the lock alone."""

    def __init__(self, engine=None):
        self.engine = engine
        self.lock = threading.Lock()
        self.error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="batch-scheduler")

    def start(self) -> "ServingLoop":
        if self.engine is not None:
            self._thread.start()
        return self

    def close(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)

    def _run(self):
        while not self._stop.is_set():
            try:
                with self.lock:
                    busy = self.engine.has_work()
                    if busy:
                        self.engine.step()
            except Exception as e:  # noqa: BLE001 — the scheduler's boundary: fail every waiting request
                logger.exception("batch scheduler died; failing in-flight requests")
                self.error = e
                return
            if not busy:
                time.sleep(0.002)

    def submit(self, input_ids, images, gen: GenerationConfig, image_key=None, **kw) -> int:
        """Queue one request on the batch engine.  A prompt no allocation
        could hold is a client error."""
        with self.lock:
            try:
                return self.engine.submit(list(input_ids), images, max_new_tokens=gen.max_new_tokens,
                                          eos_token_id=gen.eos_token_id, generation=gen, image_cache_key=image_key,
                                          **kw)
            except ValueError as e:
                raise BadRequest(str(e)) from e

    def fail(self, rids) -> None:
        """Give up on ``rids``: the scheduler frees their slots and pages at
        its next tick; their records go now.  Raises."""
        with self.lock:
            for rid in rids:
                if rid in self.engine.requests:
                    self.engine.cancel(rid)
                    self.engine.pop_result(rid)
        raise RuntimeError("the scheduler is unavailable or the request timed out")

    def run_n(self, input_ids, images, gen: GenerationConfig, n: int = 1, image_key=None, stopper=None,
              logprobs: bool = False, top_logprobs: int = 0) -> list:
        """Submit ``n`` copies of one request and wait for them, cancelling
        any whose text reaches a stop string (``stopper``, a
        ``KeywordStopper``): [(token ids, prompt length, (log-probs, tops) |
        None)]."""
        lp_kw = {"logprobs": True, "top_logprobs": top_logprobs} if logprobs else {}
        rids = [self.submit(input_ids, images, gen, image_key, **lp_kw) for _ in range(n)]
        # the JAX package's server gives a request the same deadline (cli/serve.py)
        deadline = time.time() + 60 + 0.5 * gen.max_new_tokens
        seen = dict.fromkeys(rids, 0)
        while not all(self.engine.finished(rid) for rid in rids):
            if self.error is not None or time.time() > deadline:
                self.fail(rids)
            if stopper is not None:
                for rid in rids:
                    tokens, done = self.engine.snapshot(rid)
                    if not done and len(tokens) > seen[rid]:
                        seen[rid] = len(tokens)
                        if stopper.should_stop(tokens):
                            self.engine.cancel(rid)
            time.sleep(0.005)
        out = []
        with self.lock:
            for rid in rids:
                lp = None
                if logprobs:
                    lps, tops = self.engine.request_logprobs(rid)
                    lp = (lps, tops if top_logprobs else None)
                tokens, prompt_len = self.engine.pop_result(rid)
                out.append((tokens, prompt_len, lp))
        return out


def make_handler(model, loop: ServingLoop, speculative: bool = False):
    """The request handler over ``model`` (its single-request engine) and
    ``loop`` (the device lock, and the batch engine if any)."""
    batch = loop.engine
    lock = loop.lock
    metrics = {
        "requests_total": 0,
        "requests_failed_total": 0,
        "prompt_tokens_total": 0,
        "completion_tokens_total": 0,
        "request_latency_ms_sum": 0.0,
    }
    metrics_lock = threading.Lock()

    def count(prompt_tokens=0, completion_tokens=0, latency_ms=0.0, failed=False):
        with metrics_lock:
            metrics["requests_total"] += 1
            metrics["requests_failed_total"] += int(failed)
            metrics["prompt_tokens_total"] += prompt_tokens
            metrics["completion_tokens_total"] += completion_tokens
            metrics["request_latency_ms_sum"] += latency_ms

    def run_completions(input_ids, images, gen, stops, n, *, want_logprobs=False, n_top=0, seed=None,
                        allowed_fn=None, image_key=None, use_engine=False, logit_bias=None):
        """n completions of one prompt: [(token ids, prompt length,
        (log-probs, tops) | None)].  Plain, sampled and log-prob requests
        join the batch; the rest run the single-request engine under the
        lock (``speculative``: greedy n == 1 requests speculatively)."""
        if batch is not None and not use_engine:
            stopper = KeywordStopper(stops, model.tokenizer) if stops else None
            return loop.run_n(input_ids, images, gen, n, image_key, stopper, want_logprobs, n_top)
        if speculative and not gen.do_sample and not use_engine and n == 1:
            with lock:
                token_ids, _ = model.engine.generate_speculative(list(input_ids), images, gen)
            return [(token_ids, len(input_ids), None)]
        completions = []
        for i in range(n):
            with lock:
                out = model.engine.generate(
                    [list(input_ids)], images, gen, stop_keywords=stops, tokenizer=model.tokenizer,
                    return_logprobs=want_logprobs, top_logprobs=n_top,
                    rng_key=int(seed) + i if seed is not None else None, allowed_tokens_fn=allowed_fn,
                    logit_bias=logit_bias,
                )
            completions.append((out.token_ids[0], int(out.prompt_len[0]),
                                (out.logprobs[0], out.top_logprobs[0] if n_top else None) if want_logprobs else None))
        return completions

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
            elif self.path == "/metrics":
                self._metrics()
            elif self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [{"id": MODEL_ID, "object": "model", "created": 0,
                                                             "owned_by": MODEL_ID}]})
            else:
                self._json(404, {"error": "not found"})

        def _metrics(self):
            """Prometheus text exposition: the request counters, and with a
            batch engine its ``stats()`` gauges and ``engine_dead``."""
            with metrics_lock:
                rows = dict(metrics)
            if batch is not None:
                rows.update({f"engine_{k}": v for k, v in batch.stats().items()})
                rows["engine_dead"] = int(loop.error is not None)
            body = "".join(f"# TYPE omchat_{k} {'counter' if k in metrics else 'gauge'}\nomchat_{k} {v}\n"
                           for k, v in rows.items()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        # -- SSE ------------------------------------------------------------

        def _sse_start(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()

        def _sse_chunk(self, delta, finish_reason=None, mode="chat", usage=None):
            """One SSE event: a ``chat.completion.chunk`` delta, or with
            ``mode="text"`` a ``text_completion`` chunk (``delta`` the text
            piece, or None for the usage event)."""
            if mode == "text":
                choices = [] if delta is None and finish_reason is None else [
                    {"index": 0, "text": delta or "", "finish_reason": finish_reason}]
                payload = {"object": "text_completion", "model": MODEL_ID, "choices": choices}
            else:
                choices = [] if usage is not None else [
                    {"index": 0, "delta": delta, "finish_reason": finish_reason}]
                payload = {"object": "chat.completion.chunk", "model": MODEL_ID, "choices": choices}
            if usage is not None:
                payload["usage"] = usage
            self.wfile.write(f"data: {json.dumps(payload)}\n\n".encode())
            self.wfile.flush()

        def _stream_completion(self, input_ids, images, gen, stops=(), image_key=None, mode="chat",
                               include_usage=False):
            """SSE: a role chunk (chat only), content deltas decoded over a
            24-token window, the finish chunk, the usage chunk when asked,
            then ``[DONE]``.  On the batch route the handler polls the
            request's tokens (they arrive a roll at a time) and cancels at a
            stop string; else the single-request engine streams under the
            lock.  As on the JAX server, a stream takes only the sampling
            parameters and stops: the batch engine has no penalties, and the
            single-request stream no seed, bias or constraint."""
            t_start = time.time()
            self._sse_start()
            if mode == "chat":
                self._sse_chunk({"role": "assistant"})
            tok = model.tokenizer
            emitted, stop_hit = [], []

            def send_piece(piece):
                if mode == "text":
                    self._sse_chunk(piece, mode="text")
                else:
                    self._sse_chunk({"content": piece})

            def emit(token_id: int):
                emitted.append(token_id)
                tail = emitted[-24:]
                text = tok.decode(tail, skip_special_tokens=True)
                piece = text[len(tok.decode(tail[:-1], skip_special_tokens=True)):]
                if stops:
                    cut, hit = _cut_at_stop(text, stops)
                    if hit:  # only the characters of this piece before the stop string
                        keep = len(piece) - (len(text) - len(cut))
                        if keep > 0:
                            send_piece(piece[:keep])
                        stop_hit.append(True)
                        return
                if piece:
                    send_piece(piece)

            finish = None
            if batch is not None:
                # streaming: the paged engine shrinks its rolls to --streaming-roll while this request decodes
                stream_kw = {"streaming": True} if hasattr(batch, "streaming_roll") else {}
                rid = loop.submit(input_ids, images,
                                  dataclasses.replace(gen, presence_penalty=0.0, frequency_penalty=0.0), image_key,
                                  **stream_kw)
                deadline = time.time() + 60 + 0.5 * gen.max_new_tokens
                sent = 0
                while True:
                    tokens, done = batch.snapshot(rid)
                    for t in tokens[sent:]:
                        emit(t)
                        if stop_hit:
                            break
                    sent = len(tokens)
                    if stop_hit:
                        batch.cancel(rid)
                        finish = "stop"
                        break
                    if done:
                        break
                    if loop.error is not None:
                        finish = "error"
                        break
                    if time.time() > deadline:
                        finish = "timeout"
                        break
                    time.sleep(0.005)
                with lock:
                    batch.pop_result(rid)
                n_new = len(emitted)
            else:
                with lock:
                    out = model.engine.generate([list(input_ids)], images, gen, stream_callback=emit,
                                                stop_keywords=stops, tokenizer=tok)
                n_new = len(out.token_ids[0])
            if finish is None:
                finish = "stop" if (stop_hit or n_new < gen.max_new_tokens) else "length"
            self._sse_chunk({} if mode == "chat" else "", finish_reason=finish, mode=mode)
            n_prompt = len(input_ids)
            if include_usage:
                self._sse_chunk(None, mode=mode, usage={"prompt_tokens": n_prompt, "completion_tokens": len(emitted),
                                                        "total_tokens": n_prompt + len(emitted)})
            # counted before the last write: a client that saw the response also sees it in /metrics
            count(n_prompt, len(emitted), (time.time() - t_start) * 1000, failed=finish == "error")
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()

        # -- /v1/completions ------------------------------------------------

        def _text_completions(self):
            """OpenAI's legacy ``/v1/completions``: the prompt tokenized
            verbatim (no chat template), the continuation's text out;
            ``max_tokens``, ``temperature``, ``top_p``, ``stop``, ``n``,
            ``seed``, ``logit_bias``, penalties and ``echo``."""
            try:
                req = _read_json_body(self)
                prompt = req.get("prompt", "")
                if isinstance(prompt, list):
                    if len(prompt) != 1:
                        raise BadRequest("prompt must be a string or a 1-element list")
                    prompt = prompt[0]
                if not isinstance(prompt, str):
                    raise BadRequest("prompt must be a string")
                gen, logit_bias = _parse_gen(req, default_max=16)
                stops = _parse_stops(req)
                n = max(1, min(int(req.get("n", 1) or 1), 8))
                seed = req.get("seed")
                t0 = time.time()
                input_ids = model.tokenizer.encode(prompt)
                if req.get("stream"):
                    so = req.get("stream_options") or {}
                    self._stream_completion(input_ids, None, gen, stops, mode="text",
                                            include_usage=bool(so.get("include_usage")))
                    return
                use_engine = (seed is not None or logit_bias is not None or gen.presence_penalty != 0.0
                              or gen.frequency_penalty != 0.0)
                completions = run_completions(input_ids, None, gen, stops, n, seed=seed, use_engine=use_engine,
                                              logit_bias=logit_bias)
                choices, total_new = [], 0
                for idx, (token_ids, _, _) in enumerate(completions):
                    text = model.tokenizer.decode(token_ids, skip_special_tokens=True)
                    total_new += len(token_ids)
                    stop_cut = False
                    if stops:
                        text, stop_cut = _cut_at_stop(text, stops)
                    if req.get("echo"):
                        text = prompt + text
                    choices.append({"index": idx, "text": text, "logprobs": None,
                                    "finish_reason": "stop" if (stop_cut or len(token_ids) < gen.max_new_tokens)
                                    else "length"})
                count(len(input_ids), total_new, (time.time() - t0) * 1000)
                self._json(200, {"object": "text_completion", "model": MODEL_ID, "choices": choices, "usage": {
                    "prompt_tokens": len(input_ids), "completion_tokens": total_new,
                    "total_tokens": len(input_ids) + total_new, "latency_ms": round((time.time() - t0) * 1000, 1)}})
            except BadRequest as e:
                count(failed=True)
                self._json(400, _error_body(e, "invalid_request_error"))
            except Exception as e:  # noqa: BLE001 — one request's failure must not take the server down
                logger.exception("completions request failed")
                count(failed=True)
                self._json(500, _error_body(e, "internal_error"))

        # -- /v1/chat/completions -------------------------------------------

        def do_POST(self):
            if self.path == "/v1/completions":
                self._text_completions()
                return
            if self.path not in ("/v1/chat/completions", "/chat"):
                self._json(404, {"error": "not found"})
                return
            try:
                self._chat_completions()
            except BadRequest as e:
                count(failed=True)
                self._json(400, _error_body(e, "invalid_request_error"))
            except Exception as e:  # noqa: BLE001 — one request's failure must not take the server down
                logger.exception("request failed")
                count(failed=True)
                self._json(500, _error_body(e, "internal_error"))

        def _chat_completions(self):
            from omchat_torch.runtime.tool_calls import (
                parse_tool_calls,
                parse_tool_choice,
                render_tools_system,
                validate_tools,
                wire_tool_calls,
            )

            req = _read_json_body(self)
            question, history, images, system, image_key = _parse_messages(req.get("messages", []))
            gen, logit_bias = _parse_gen(req, default_max=1024)
            stops = _parse_stops(req)
            # tool definitions render into the system prompt; "required" or a
            # named tool constrains decoding to a valid call (the schema mask)
            tool_fns, tool_mode, forced_name = None, "none", None
            if req.get("tools") is not None:
                try:
                    tool_fns = validate_tools(req["tools"])
                    tool_mode, forced_name = parse_tool_choice(req.get("tool_choice"), tool_fns)
                except ValueError as e:
                    raise BadRequest(str(e)) from e
                if tool_mode != "none":
                    system = render_tools_system(system, tool_fns)
            t0 = time.time()
            inputs = model.processor(question, images=images, history=history, system=system)
            input_ids = inputs["input_ids"][0].tolist()
            if req.get("stream") and tool_mode == "none":
                so = req.get("stream_options") or {}
                self._stream_completion(input_ids, inputs.get("images"), gen, stops, image_key=image_key,
                                        include_usage=bool(so.get("include_usage")))
                return
            want_logprobs = bool(req.get("logprobs"))
            n_top = max(0, min(int(req.get("top_logprobs", 0) or 0), 5)) if want_logprobs else 0
            seed = req.get("seed")
            n = max(1, min(int(req.get("n", 1) or 1), 8))
            allowed_fn = _constraint(model, req, tool_fns, tool_mode, forced_name)
            # seeded, biased, penalised and constrained requests run the
            # single-request engine; log-probs stay in the paged engine's
            # batch, and leave the slot engine's
            use_engine = ((want_logprobs and not hasattr(batch, "request_logprobs")) or seed is not None
                          or allowed_fn is not None or logit_bias is not None
                          or gen.presence_penalty != 0.0 or gen.frequency_penalty != 0.0)
            completions = run_completions(input_ids, inputs.get("images"), gen, stops, n,
                                          want_logprobs=want_logprobs, n_top=n_top, seed=seed, allowed_fn=allowed_fn,
                                          image_key=image_key, use_engine=use_engine, logit_bias=logit_bias)
            choices, total_new = [], 0
            prompt_len = completions[0][1]
            for idx, (token_ids, _, lps) in enumerate(completions):
                text = model.tokenizer.decode(token_ids, skip_special_tokens=True)
                total_new += len(token_ids)
                stop_cut = False
                if stops:
                    text, stop_cut = _cut_at_stop(text, stops)
                message = {"role": "assistant", "content": text}
                finish = "stop" if (stop_cut or len(token_ids) < gen.max_new_tokens) else "length"
                if tool_mode == "forced":
                    try:
                        obj = json.loads(text)
                        calls = [{"name": obj["name"],
                                  "arguments": json.dumps(obj.get("arguments", {}), ensure_ascii=False)}]
                        message = {"role": "assistant", "content": None, "tool_calls": wire_tool_calls(calls)}
                        finish = "tool_calls"
                    except (json.JSONDecodeError, KeyError, TypeError):
                        pass  # max_tokens hit mid-object: the raw text goes back
                elif tool_mode == "auto":
                    content, calls = parse_tool_calls(text)
                    if calls:
                        message = {"role": "assistant", "content": content, "tool_calls": wire_tool_calls(calls)}
                        finish = "tool_calls"
                choices.append({"index": idx, "message": message, "logprobs": self._logprobs(token_ids, lps),
                                "finish_reason": finish})
            if req.get("stream"):
                # tools + stream: the call is parsed and validated whole, so
                # the message goes out buffered in one delta
                self._sse_start()
                ch = choices[0]
                self._sse_chunk({"role": "assistant"})
                delta = {k: v for k, v in ch["message"].items() if k != "role" and v is not None}
                if "tool_calls" in delta:
                    delta["tool_calls"] = [{"index": i, **tc} for i, tc in enumerate(delta["tool_calls"])]
                if delta:
                    self._sse_chunk(delta)
                self._sse_chunk({}, finish_reason=ch["finish_reason"])
                if (req.get("stream_options") or {}).get("include_usage"):
                    self._sse_chunk(None, usage={"prompt_tokens": prompt_len, "completion_tokens": total_new,
                                                 "total_tokens": prompt_len + total_new})
                count(prompt_len, total_new, (time.time() - t0) * 1000)
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
                return
            count(prompt_len, total_new, (time.time() - t0) * 1000)
            self._json(200, {"object": "chat.completion", "model": MODEL_ID, "choices": choices, "usage": {
                "prompt_tokens": prompt_len, "completion_tokens": total_new, "total_tokens": prompt_len + total_new,
                "latency_ms": round((time.time() - t0) * 1000, 1)}})

        def _logprobs(self, token_ids, lps):
            """OpenAI's ``logprobs`` object of a choice, or None."""
            if lps is None:
                return None
            chosen, top = lps
            dec = lambda t: model.tokenizer.decode([t], skip_special_tokens=True)  # noqa: E731
            entries = []
            for pos, (t, lp) in enumerate(zip(token_ids, chosen)):
                e = {"token": dec(t), "logprob": lp}
                if top is not None:
                    e["top_logprobs"] = [{"token": dec(tid), "logprob": tlp} for tid, tlp in top[pos]]
                entries.append(e)
            return {"content": entries}

    return Handler


def warmup_engine(engine, timeout_s: float = 600.0) -> float:
    """What the first requests would otherwise pay for, before the server
    takes traffic (the JAX server's ``warmup_engines`` on a batch engine):
    the engine's ``precompile`` (on a paged engine a CUDA graph of the
    decode roll at every table width bucket and pick mode; on the slot
    engine the greedy and the sampled decode step's), then three short text
    requests run to completion (the prefills, the kernels' first launches;
    eos -1 never matches, so each runs its four tokens).  Returns the
    seconds taken."""
    t0 = time.perf_counter()
    engine.precompile()
    rids = [engine.submit(list(p), None, max_new_tokens=4, eos_token_id=-1) for p in ([9] * 17, [9] * 9, [9] * 9)]
    deadline = time.perf_counter() + timeout_s
    while engine.has_work() and time.perf_counter() < deadline:
        engine.step()
    for rid in rids:
        if engine.finished(rid):
            engine.pop_result(rid)
        else:
            logger.warning("warm-up request %d did not finish in %.0f s; continuing", rid, timeout_s)
            engine.cancel(rid)
    engine.reset_latency_stats()
    return time.perf_counter() - t0


def warmup_engines(model, batch_engine=None, timeout_s: float = 600.0) -> float:
    """The JAX server's ``warmup_engines``: :func:`warmup_engine` on a batch
    engine, else one short ``generate`` on the single-request engine (its
    decode step's first capture).  Run before the scheduler starts.  Returns
    the seconds taken."""
    if batch_engine is not None:
        return warmup_engine(batch_engine, timeout_s)
    t0 = time.perf_counter()
    model.engine.generate([[9] * 9], None, GenerationConfig(max_new_tokens=4, eos_token_id=-1))
    return time.perf_counter() - t0


def make_server(model, engine=None, host: str = "127.0.0.1", port: int = 8000, speculative: bool = False):
    """A ready HTTP server and its started serving loop (``engine``: the
    batch engine, None for the single-request route); the caller runs
    ``server.serve_forever()`` and, when done, ``server.shutdown()``,
    ``server.server_close()`` and ``loop.close()``."""
    loop = ServingLoop(engine).start()
    return ThreadingHTTPServer((host, port), make_handler(model, loop, speculative)), loop


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_model_flags(ap)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--paged", action="store_true",
                    help="continuous batching over a paged KV pool (implies --continuous-batching)")
    ap.add_argument("--continuous-batching", action="store_true",
                    help="a batch engine shares decode steps among requests: without --paged the slot engine "
                         "(--max-slots slots of --max-len rows in one shared cache)")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--num-pages", type=int, default=1024)
    ap.add_argument("--page-size", type=int, default=128)
    ap.add_argument("--max-len", type=int, default=8192)
    ap.add_argument("--decode-roll", type=int, default=1, help="paged: decode steps per dispatch (one readback a roll)")
    ap.add_argument("--prefill-chunk", type=int, default=1024,
                    help="paged: prompts longer than this prefill in chunks of this width, decode rolls in between")
    ap.add_argument("--image-cache", type=int, default=8, help="encoded-image LRU entries (0 disables)")
    ap.add_argument("--decode-kernel", choices=["auto", "manual"], default="auto",
                    help="paged decode kernel: auto (K12) or manual (K13, pages streamed through a ring of bulk "
                         "copies); the plain CPU path ignores it")
    ap.add_argument("--speculative", action="store_true",
                    help="prompt-lookup speculative decoding: with --paged, the batch's greedy slots advance up to "
                         "draft-len + 1 tokens a verify dispatch (sampled or log-prob ticks roll); without it, "
                         "greedy n == 1 requests on the single-request engine")
    ap.add_argument("--draft-len", type=int, default=4, help="paged: speculative draft tokens a verify dispatch")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged: requests sharing a prompt prefix (system prompts, a resent image) reuse its KV pages")
    ap.add_argument("--streaming-roll", type=int, default=None, metavar="N",
                    help="paged: the decode roll while an SSE request decodes (e.g. --decode-roll 16 "
                         "--streaming-roll 4); batch traffic keeps the full roll")
    ap.add_argument("--pipeline-rolls", action="store_true",
                    help="paged: dispatch the next decode roll from the card's tokens before reading the last one "
                         "back (the host's readback overlaps the card's work)")
    ap.add_argument("--no-warmup", dest="warmup", action="store_false",
                    help="skip the start-up warm-up (with a batch engine its decode CUDA graphs, captured by "
                         "precompile, and three short requests; else one short generate); the first requests "
                         "then pay for them")
    return ap


def main(argv=None, on_ready=None):
    """The server.  ``on_ready(server)``: called on the leading rank once the
    server is bound (a caller that runs ``main`` in a thread learns the port
    there and may end it with ``server.shutdown()``)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.paged:
        args.continuous_batching = True  # --paged implies the batch scheduler

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    model = load_model(ap, args)
    engine = None
    if args.paged:
        from omchat_torch.api import paged_batch_engine

        engine = paged_batch_engine(
            model, max_slots=args.max_slots, num_pages=args.num_pages, page_size=args.page_size,
            max_len=args.max_len, decode_roll=args.decode_roll, prefill_chunk=args.prefill_chunk,
            image_cache_size=args.image_cache, decode_kernel=args.decode_kernel, prefix_cache=args.prefix_cache,
            streaming_roll=args.streaming_roll, pipeline_rolls=args.pipeline_rolls, speculative=args.speculative,
            draft_len=args.draft_len,
        )
    elif args.continuous_batching:
        from omchat_torch.api import batch_engine

        engine = batch_engine(model, max_slots=args.max_slots, max_len=args.max_len, image_cache_size=args.image_cache)
    from omchat_torch.parallel import serving

    mesh = model.engine.mesh
    if not is_leader(model):  # a follower replays the leader's engine calls until it stops
        serving.follow(mesh, model=model.engine, batch=engine)
        return
    channel = serving.lead(mesh, model=model.engine, batch=engine)
    try:
        if args.warmup:
            logger.info(f"warm-up done in {warmup_engines(model, engine):.1f} s")
        server, loop = make_server(model, engine, args.host, args.port, speculative=args.speculative)
        route = "single-request"
        if args.paged:
            route = f"paged ({args.max_slots} slots, {args.num_pages} pages)"
        elif engine is not None:
            route = f"slot engine ({args.max_slots} slots of {args.max_len} rows)"
        tp = f", tp {args.tp}" if args.tp > 1 else ""
        logger.info(f"serving on {args.host}:{args.port}, {route}{tp}")
        if on_ready is not None:
            on_ready(server)
        try:
            server.serve_forever()
        finally:
            server.server_close()
            loop.close()
    finally:
        if channel is not None:
            channel.stop()


if __name__ == "__main__":
    main()
