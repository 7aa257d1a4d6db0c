"""The port's HTTP server against the JAX package's, on the CPU: both built
over ``OmChatConfig.tiny()``'s float32 weights (``tests/test_serve.py``'s
``_tiny_model``, carried across by ``from_jax_params``) with the
``MockTokenizer``, on ``127.0.0.1:0``.  Every request body of
``tests/test_serve.py``'s server tests goes to both: equal status codes,
equal JSON apart from ``latency_ms``, equal SSE chunk sequences, log-probs
within 1e-5; on the default route (the single-request engine) and, for the
greedy and log-prob bodies, on the ``--paged`` route (JAX
``PagedBatchEngine(attn_impl="xla")`` and the port's, page size 8), and
every body of both kinds on the ``--continuous-batching`` route (the slot
engines: the JAX ``BatchEngine(attn_impl="xla")`` and the port's, 4 slots,
chunks of 16).  Seeded sampling is held within the port (equal seeds, equal
replies).  Then the warm-up on each of the port's routes, and the four
places where the port's server used to answer differently: the default
route, ``top_k``, tool and unknown roles, the ``model`` and ``logprobs``
fields.
"""

import base64
import io
import json
import re
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from omchat_torch.api import batch_engine, omchat_model, paged_batch_engine
from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.cli import serve as tserve
from omchat_torch.config import OmChatConfig as TOmChatConfig
from omchat_torch.runtime.batch_engine import BatchEngine as TBatchEngine
from omchat_torch.runtime.generate import OmChatEngine as TEngine
from omchat_torch.runtime.paged_engine import PagedBatchEngine as TPagedEngine
from omchat_torch.utils.testing import MockTokenizer
from tests.test_serve import _tiny_model

LP_TOL = 1e-5
# the paged engines of the --paged route: page size 8, small pools
PAGED = dict(max_slots=4, num_pages=96, page_size=8, prompt_bucket=16, max_len=256, prefill_chunk=64)
# the slot engines of the --continuous-batching route
SLOT = dict(max_slots=4, max_len=1024, chunk_size=16)

TOOLS = [
    {"type": "function", "function": {"name": "get_weather", "parameters": {
        "type": "object", "properties": {"city": {"type": "string"}}, "required": ["city"]}}},
    {"type": "function", "function": {"name": "search", "parameters": {
        "type": "object", "properties": {"q": {"type": "string"}}, "required": ["q"]}}},
]
SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"}}, "required": ["ok"]}


def _png(seed: int, h: int = 80, w: int = 60) -> str:
    img = Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _user(text):
    return [{"role": "user", "content": text}]


# the bodies of tests/test_serve.py's server tests, by route: (path, body)
CHAT = "/v1/chat/completions"
GREEDY_BODIES = {
    "text": (CHAT, {"messages": _user("hello"), "max_tokens": 4}),
    "image": (CHAT, {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "what is this?"}, {"type": "image_url", "image_url": {"url": _png(0)}}]}],
        "max_tokens": 4}),
    "chat_alias": ("/chat", {"messages": _user("hello"), "max_tokens": 8}),
    "stop": (CHAT, {"messages": _user("hello"), "max_tokens": 8, "stop": ["a", "e", "!", "\n"]}),
    "metrics_request": (CHAT, {"messages": _user("m"), "max_tokens": 2}),
    "logprobs": (CHAT, {"messages": _user("hello"), "max_tokens": 4, "logprobs": True}),
    "top_logprobs": (CHAT, {"messages": _user("hello"), "max_tokens": 3, "logprobs": True, "top_logprobs": 3}),
    "n_choices": (CHAT, {"messages": _user("hi"), "max_tokens": 3, "n": 2}),
    "json_mode": (CHAT, {"messages": _user("give me json"), "max_tokens": 48,
                         "response_format": {"type": "json_object"}}),
    "json_schema": (CHAT, {"messages": _user("go"), "max_tokens": 48, "response_format": {
        "type": "json_schema", "json_schema": {"name": "t", "schema": SCHEMA}}}),
    "guided_json": (CHAT, {"messages": _user("go"), "max_tokens": 48, "guided_json": SCHEMA}),
    "guided_choice": (CHAT, {"messages": _user("pick"), "max_tokens": 8, "guided_choice": ["yes", "no"]}),
    "logit_bias": (CHAT, {"messages": _user("hi"), "max_tokens": 3, "logit_bias": {"65": 100}}),
    "penalties": (CHAT, {"messages": _user("hi"), "max_tokens": 6, "logit_bias": {"65": 100},
                         "frequency_penalty": 1000.0}),
    "tool_named": (CHAT, {"messages": _user("weather in paris?"), "tools": TOOLS, "max_tokens": 64,
                          "tool_choice": {"type": "function", "function": {"name": "get_weather"}}}),
    "tool_required": (CHAT, {"messages": _user("go"), "tools": TOOLS, "tool_choice": "required",
                             "max_tokens": 64}),
    "tool_auto_history": (CHAT, {"messages": [
        {"role": "user", "content": "hi"},
        {"role": "assistant", "content": None, "tool_calls": [
            {"id": "call_0", "type": "function", "function": {"name": "f", "arguments": "{}"}}]},
        {"role": "tool", "tool_call_id": "call_0", "content": "42"}],
        "tools": [{"type": "function", "function": {"name": "f", "parameters": {"type": "object"}}}],
        "max_tokens": 4}),
    "text_completions": ("/v1/completions", {"prompt": "abcd", "max_tokens": 4}),
    "text_completions_echo": ("/v1/completions", {"prompt": ["xy"], "max_tokens": 2, "echo": True, "n": 2}),
    "text_completions_stop": ("/v1/completions", {"prompt": "abcd", "max_tokens": 6, "stop": "!"}),
}
STREAM_BODIES = {
    "stream": (CHAT, {"messages": _user("hi"), "max_tokens": 4, "stream": True}),
    "stream_usage": (CHAT, {"messages": _user("hi"), "max_tokens": 3, "stream": True,
                            "stream_options": {"include_usage": True}}),
    "stream_stop": (CHAT, {"messages": _user("hello"), "max_tokens": 8, "stream": True, "stop": ["e", "!"]}),
    "stream_text_usage": ("/v1/completions", {"prompt": "ab", "max_tokens": 4, "stream": True,
                                              "stream_options": {"include_usage": True}}),
    "stream_tools_buffered": (CHAT, {"messages": _user("go"), "max_tokens": 48, "stream": True,
                                     "tools": [{"type": "function", "function": {"name": "t", "parameters": {
                                         "type": "object", "properties": {"x": {"type": "integer"}}}}}],
                                     "tool_choice": "required", "stream_options": {"include_usage": True}}),
}
BAD_BODIES = [
    (CHAT, b"{not json"),
    (CHAT, b"[1, 2]"),
    (CHAT, json.dumps({"messages": "hi"}).encode()),
    (CHAT, json.dumps({"messages": _user("x"), "max_tokens": "lots"}).encode()),
    (CHAT, json.dumps({"messages": _user("x"), "max_tokens": 0}).encode()),
    (CHAT, json.dumps({"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,!!!"}}]}]}).encode()),
    ("/v1/completions", b"{not json"),
    ("/v1/completions", json.dumps({"prompt": ["a", "b"]}).encode()),
    ("/v1/completions", json.dumps({"prompt": 7}).encode()),
    (CHAT, json.dumps({"messages": _user("x"), "max_tokens": 4, "tools": []}).encode()),
    (CHAT, json.dumps({"messages": _user("x"), "max_tokens": 4, "tools": [{"type": "function"}]}).encode()),
    (CHAT, json.dumps({"messages": _user("x"), "max_tokens": 4,
                       "tools": [{"type": "function", "function": {"name": "a"}}],
                       "tool_choice": {"type": "function", "function": {"name": "b"}}}).encode()),
    (CHAT, json.dumps({"messages": _user("x"), "max_tokens": 4,
                       "tools": [{"type": "function", "function": {"name": "a"}}],
                       "tool_choice": "required", "response_format": {"type": "json_object"}}).encode()),
]
# the bodies a --paged server answers from its batch (greedy and log-probs)
PAGED_BODIES = ("text", "image", "stop", "logprobs", "top_logprobs", "n_choices", "text_completions",
                "text_completions_echo")


def _serve(handler):
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _jax_scheduler(engine, stop):
    """The JAX server's scheduler loop (cli/serve.py main), stoppable."""
    def run():
        while not stop.is_set():
            if engine.has_work():
                engine.step()
            else:
                time.sleep(0.002)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


@pytest.fixture(scope="module")
def models():
    """(JAX model, the port's model over the same weights)."""
    jmodel = _tiny_model()
    params = from_jax_params(jax.device_get(jmodel.engine.params))
    return jmodel, omchat_model(MockTokenizer(), TEngine(TOmChatConfig.tiny(), params, device="cpu", prompt_bucket=8))


@pytest.fixture(scope="module")
def servers(models):
    """{"default": (JAX port, the port's port), "paged": (...)}, and the
    paged engines."""
    from serve import make_handler

    from omchat_tpu.config import OmChatConfig
    from omchat_tpu.runtime.paged_engine import PagedBatchEngine
    from omchat_tpu.utils.logging import build_logger

    jmodel, tmodel = models
    logger = build_logger("test.torch_serve", "test_torch_serve.log", log_dir="/tmp")
    jpaged = PagedBatchEngine(OmChatConfig.tiny(), jmodel.engine.params, attn_impl="xla", **PAGED)
    tpaged = paged_batch_engine(tmodel, **PAGED)
    stop = threading.Event()
    jthread = _jax_scheduler(jpaged, stop)
    jservers = [_serve(make_handler(jmodel, logger)), _serve(make_handler(jmodel, logger, jpaged))]
    tservers = [tserve.make_server(tmodel, None, "127.0.0.1", 0), tserve.make_server(tmodel, tpaged, "127.0.0.1", 0)]
    for srv, _ in tservers:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    ports = {route: (j.server_address[1], t.server_address[1])
             for route, j, (t, _) in zip(("default", "paged"), jservers, tservers)}
    yield ports, jpaged, tpaged
    for srv in jservers:
        srv.shutdown()
        srv.server_close()
    for srv, loop in tservers:
        srv.shutdown()
        srv.server_close()
        loop.close()
    stop.set()
    jthread.join(30)
    assert not jthread.is_alive()


def _call(port, path, body=None):
    """(status, content type, payload): JSON without ``usage.latency_ms``,
    the SSE events (parsed, then "[DONE]"), or the text of /metrics."""
    data = body if body is None or isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, ctype, raw = resp.status, resp.headers["Content-Type"], resp.read().decode()
    except urllib.error.HTTPError as e:
        status, ctype, raw = e.code, e.headers["Content-Type"], e.read().decode()
    if ctype.startswith("text/event-stream"):
        events = [line[6:] for line in raw.split("\n") if line.startswith("data: ")]
        return status, ctype, [e if e == "[DONE]" else json.loads(e) for e in events]
    if ctype.startswith("text/plain"):
        return status, ctype, raw
    out = json.loads(raw)
    if isinstance(out, dict) and isinstance(out.get("usage"), dict):
        out["usage"].pop("latency_ms", None)
    if isinstance(out, dict) and isinstance(out.get("error"), dict):  # object addresses in exception texts
        out["error"]["message"] = re.sub(r"0x[0-9a-f]+", "0x", out["error"]["message"])
    return status, ctype, out


def _assert_same(got, want, path=""):
    """Equal structure and values; floats within LP_TOL (log-probs)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, type(want)) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)) and abs(got - want) <= LP_TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _both(servers, route, path, body=None):
    ports, _, _ = servers
    jport, tport = ports[route]
    want, got = _call(jport, path, body), _call(tport, path, body)
    _assert_same(got, want)
    return got


@pytest.mark.parametrize("path", ["/health", "/v1/models", "/nowhere"])
def test_get_routes_match_jax(servers, path):
    _both(servers, "default", path)


@pytest.mark.parametrize("name", list(GREEDY_BODIES))
def test_default_route_matches_jax(servers, name):
    path, body = GREEDY_BODIES[name]
    status, _, out = _both(servers, "default", path, body)
    assert status == 200 and out["choices"]


@pytest.mark.parametrize("name", list(STREAM_BODIES))
@pytest.mark.parametrize("route", ["default", "paged"])
def test_sse_chunks_match_jax(servers, route, name):
    path, body = STREAM_BODIES[name]
    status, ctype, events = _both(servers, route, path, body)
    assert status == 200 and events[-1] == "[DONE]" and len(events) >= 3


@pytest.mark.parametrize("case", range(len(BAD_BODIES)))
def test_bad_requests_match_jax(servers, case):
    path, body = BAD_BODIES[case]
    status, _, out = _both(servers, "default", path, body)
    assert status == 400 and out["error"]["type"] == "invalid_request_error"


@pytest.mark.parametrize("name", PAGED_BODIES)
def test_paged_route_matches_jax(servers, name):
    path, body = GREEDY_BODIES[name]
    _, _, tpaged = servers
    before = tpaged.latency_stats()["requests_measured"]
    status, _, out = _both(servers, "paged", path, body)
    assert status == 200
    assert tpaged.latency_stats()["requests_measured"] == before + len(out["choices"])  # all in the batch
    assert not tpaged.requests and tpaged.allocator.available == PAGED["num_pages"]


@pytest.mark.parametrize("route", ["default", "paged"])
def test_metrics_match_jax(servers, route):
    """/metrics after the same requests on both servers: the same counters
    (all but the latency sum), and on the paged route every one of the JAX
    engine's gauges."""
    _both(servers, route, *GREEDY_BODIES["metrics_request"])
    ports, _, _ = servers
    rows = []
    for port in ports[route]:
        status, ctype, body = _call(port, "/metrics")
        assert status == 200
        rows.append(dict(line.split(" ", 1) for line in body.splitlines() if line and not line.startswith("#")))
    jrows, trows = rows
    assert set(jrows) <= set(trows)
    for k in ("requests_total", "requests_failed_total", "prompt_tokens_total", "completion_tokens_total"):
        assert int(trows[f"omchat_{k}"]) == int(jrows[f"omchat_{k}"])
    assert int(trows["omchat_requests_total"]) >= 1
    if route == "paged":
        assert trows["omchat_engine_dead"] == "0" and int(trows["omchat_engine_pages_free"]) == PAGED["num_pages"]


@pytest.mark.parametrize("route", ["default", "paged"])
def test_seeded_and_sampled_requests(servers, route):
    """Sampling cannot reproduce JAX's draws: equal seeds give equal replies
    within the port; a sampled request (on the paged route in the batch)
    answers with JAX's shape."""
    ports, _, _ = servers
    jport, tport = ports[route]
    seeded = {"messages": _user("hi"), "max_tokens": 4, "temperature": 0.9, "seed": 7, "n": 2}
    a, b = _call(tport, CHAT, seeded), _call(tport, CHAT, seeded)
    assert a == b and a[0] == 200 and len(a[2]["choices"]) == 2
    sampled = {"messages": _user("hi"), "max_tokens": 4, "temperature": 0.8, "top_p": 0.9}
    got, want = _call(tport, CHAT, sampled), _call(jport, CHAT, sampled)
    assert got[0] == want[0] == 200
    assert set(got[2]["choices"][0]) == set(want[2]["choices"][0]) == {"index", "message", "logprobs",
                                                                      "finish_reason"}


def test_stop_helpers_match_jax():
    from serve import _cut_at_stop, _parse_stops

    for req in ({"stop": "\n"}, {"stop": ["a", "", "b", "c", "d", "e"]}, {}, {"stop": None}):
        assert tserve._parse_stops(req) == _parse_stops(req)
    for text, stops in (("hello world", ["wor"]), ("a.b,c", [",", "."]), ("plain", ["zzz"]), ("", ["x"])):
        assert tserve._cut_at_stop(text, stops) == _cut_at_stop(text, stops)


def test_paged_logprobs_over_http_match_the_single_request_engine(servers):
    """A log-prob request's chosen and top log-probs from the batch (the
    roll route) against the single-request engine's (the decode route), on
    the port's two servers: the same tokens, log-probs within 1e-5."""
    ports, _, _ = servers
    body = {"messages": _user("hello"), "max_tokens": 5, "logprobs": True, "top_logprobs": 5}
    _, _, paged = _call(ports["paged"][1], CHAT, body)
    _, _, single = _call(ports["default"][1], CHAT, body)
    _assert_same(paged["choices"], single["choices"])


def test_warmup_on_both_routes(models):
    _, tmodel = models
    assert tserve.warmup_engines(tmodel) >= 0
    engine = paged_batch_engine(tmodel, **PAGED)
    assert tserve.warmup_engines(tmodel, engine) >= 0
    assert not engine.requests and not engine.has_work() and engine.allocator.available == PAGED["num_pages"]


# -- the places the port's server used to answer differently ----------------

@pytest.mark.parametrize("paged", [False, True], ids=["default", "paged"])
def test_default_route_is_the_single_request_engine(models, monkeypatch, paged):
    """Without flags the server serves on the single-request engine, as the
    JAX server does; ``--paged`` builds the paged engine."""
    _, tmodel = models
    built = {}

    class Server:
        def serve_forever(self):
            pass

        def server_close(self):
            pass

    class Loop:
        def close(self):
            pass

    def make_server(model, engine=None, host="", port=0, speculative=False):
        built["engine"] = engine
        return Server(), Loop()

    monkeypatch.setattr(tserve, "load_model", lambda ap, args: tmodel)
    monkeypatch.setattr(tserve, "make_server", make_server)
    flags = ["--paged", "--page-size", "8", "--num-pages", "64", "--max-len", "256"] if paged else []
    tserve.main(["--model-path", "unused", "--device", "cpu", "--no-warmup", *flags])
    assert isinstance(built["engine"], TPagedEngine) if paged else built["engine"] is None


def test_top_k_is_not_read_from_the_body():
    from serve import _parse_gen

    body = {"max_tokens": 3, "temperature": 0.8, "top_k": 5, "top_p": 0.9}
    gen, _ = tserve._parse_gen(body, 16)
    want, _ = _parse_gen(body, 16)
    assert gen.top_k == want.top_k == 0
    assert (gen.do_sample, gen.temperature, gen.top_p) == (want.do_sample, want.temperature, want.top_p)


def test_tool_and_unknown_roles_render_as_jax():
    from serve import _parse_messages

    messages = [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "hi"},
        {"role": "assistant", "content": None, "tool_calls": [
            {"id": "call_0", "type": "function", "function": {"name": "f", "arguments": "{\"a\": 1}"}}]},
        {"role": "tool", "tool_call_id": "call_0", "content": "42"},
        {"role": "developer", "content": "skipped"},
        {"role": "tool", "content": "43"},
    ]
    assert tserve._parse_messages(messages) == _parse_messages(messages)


def test_model_and_logprobs_fields(servers):
    """Each choice carries ``"logprobs": null`` unless asked, and the model
    id is the JAX server's."""
    ports, _, _ = servers
    _, _, out = _call(ports["default"][1], CHAT, {"messages": _user("hello"), "max_tokens": 2})
    assert out["model"] == "omchat-tpu" and out["choices"][0]["logprobs"] is None
    _, _, models_list = _call(ports["default"][1], "/v1/models")
    assert models_list["data"][0]["id"] == "omchat-tpu"


# -- the paged engine's routes through the server ----------------------------

ROUTE_FLAGS = {
    "prefix-cache": (["--prefix-cache"], lambda e: e.prefix_cache is not None),
    "streaming-roll": (["--streaming-roll", "2"], lambda e: e.streaming_roll == 2),
    "pipeline-rolls": (["--pipeline-rolls"], lambda e: e.pipeline_rolls),
    "speculative": (["--speculative"], lambda e: e.speculative and e.draft_len == 4),
    "draft-len": (["--speculative", "--draft-len", "3"], lambda e: e.speculative and e.draft_len == 3),
}


def _main_builds(tmodel, monkeypatch, flags):
    """The paged engine ``tserve.main`` builds for ``flags`` (no server runs)."""
    built = {}

    class Server:
        def serve_forever(self):
            pass

        def server_close(self):
            pass

    class Loop:
        def close(self):
            pass

    def make_server(model, engine=None, host="", port=0, speculative=False):
        built.update(engine=engine, speculative=speculative)
        return Server(), Loop()

    monkeypatch.setattr(tserve, "load_model", lambda ap, args: tmodel)
    monkeypatch.setattr(tserve, "make_server", make_server)
    tserve.main(["--model-path", "unused", "--device", "cpu", "--no-warmup", "--paged", "--page-size", "8",
                 "--num-pages", "64", "--max-len", "256", *flags])
    return built


@pytest.mark.parametrize("flag", list(ROUTE_FLAGS))
def test_route_flags_reach_the_paged_engine(models, monkeypatch, flag):
    """Each of the paged engine's route flags is served, not refused, and
    reaches the engine as the JAX server passes it (cli/serve.py)."""
    _, tmodel = models
    flags, holds = ROUTE_FLAGS[flag]
    built = _main_builds(tmodel, monkeypatch, flags)
    assert isinstance(built["engine"], TPagedEngine) and holds(built["engine"])
    others = [f for f in ROUTE_FLAGS if f != flag and not (flag == "draft-len" and f == "speculative")]
    assert not any(ROUTE_FLAGS[f][1](built["engine"]) for f in others)


@pytest.mark.parametrize("flags,item", [(["--tp", "2"], "torchrun --nproc-per-node 2")], ids=["tp-2"])
def test_waiting_flags_still_refused_by_name(flags, item, capsys, monkeypatch):
    """``--tp 2`` outside a launched world of 2 ranks: a usage error that
    says what to launch, before any weight loads."""
    def no_load(*a, **kw):
        raise AssertionError("weights loaded before the refusal")

    monkeypatch.setattr("omchat_torch.api.load_pretrained_model", no_load)
    with pytest.raises(SystemExit) as e:
        tserve.main(["--model-path", "/nonexistent", "--device", "cpu", *flags])
    assert e.value.code == 2 and item in capsys.readouterr().err


def _spy_submits(engine, seen):
    orig = engine.submit

    def spy(*a, **kw):
        seen.append(kw.get("streaming", False))
        return orig(*a, **kw)

    return orig, spy


def test_paged_sse_submits_streaming(servers):
    """An SSE request on the paged route submits with ``streaming=True`` (so
    the engine's rolls shrink to ``--streaming-roll``), a plain one without,
    on both servers."""
    ports, jpaged, tpaged = servers
    seen = {"jax": [], "port": []}
    saved = []
    for name, eng in (("jax", jpaged), ("port", tpaged)):
        orig, spy = _spy_submits(eng, seen[name])
        saved.append((eng, orig))
        eng.submit = spy
    try:
        for path, body in (STREAM_BODIES["stream"], GREEDY_BODIES["text"]):
            _both(servers, "paged", path, body)
    finally:
        for eng, orig in saved:
            eng.submit = orig
    assert seen["port"] == seen["jax"] == [True, False]


def test_metrics_carry_the_route_counts(models):
    """With speculative verify and the prefix cache on, /metrics carries the
    engine's ``spec_*`` and ``prefix_cache_*`` gauges with the JAX server's
    values after the same two requests (the second hits the first's pages),
    and the verifies' graphed / eager counts."""
    from serve import make_handler

    from omchat_tpu.config import OmChatConfig
    from omchat_tpu.runtime.paged_engine import PagedBatchEngine
    from omchat_tpu.utils.logging import build_logger

    jmodel, tmodel = models
    opts = dict(PAGED, speculative=True, prefix_cache=True)
    jpaged = PagedBatchEngine(OmChatConfig.tiny(), jmodel.engine.params, attn_impl="xla", **opts)
    tpaged = paged_batch_engine(tmodel, **opts)
    stop = threading.Event()
    jthread = _jax_scheduler(jpaged, stop)
    jsrv = _serve(make_handler(jmodel, build_logger("test.torch_serve", "test_torch_serve.log", log_dir="/tmp"),
                               jpaged))
    tsrv, loop = tserve.make_server(tmodel, tpaged, "127.0.0.1", 0)
    threading.Thread(target=tsrv.serve_forever, daemon=True).start()
    try:
        body = {"messages": _user("abcabcabcabcabcabcabcabc hello hello"), "max_tokens": 12}
        rows = []
        for port in (jsrv.server_address[1], tsrv.server_address[1]):
            for _ in range(2):
                assert _call(port, CHAT, body)[0] == 200
            text = _call(port, "/metrics")[2]
            rows.append(dict(line.split(" ", 1) for line in text.splitlines() if line and not line.startswith("#")))
    finally:
        for srv in (jsrv, tsrv):
            srv.shutdown()
            srv.server_close()
        loop.close()
        stop.set()
        jthread.join(30)
    jrows, trows = rows
    keys = [k for k in jrows if k.startswith(("omchat_engine_spec_", "omchat_engine_prefix_cache_"))]
    assert len(keys) == 6 and {k: trows[k] for k in keys} == {k: jrows[k] for k in keys}
    assert int(trows["omchat_engine_prefix_cache_hits"]) > 0
    assert int(trows["omchat_engine_verifies_eager"]) == int(trows["omchat_engine_spec_dispatches"])
    assert trows["omchat_engine_verifies_graphed"] == "0"


# -- the slot engine's route (--continuous-batching without --paged) -------

@pytest.fixture(scope="module")
def slot_servers(models):
    """(JAX port, the port's port) of the two servers over slot engines, and
    the port's engine."""
    from serve import make_handler

    from omchat_tpu.config import OmChatConfig
    from omchat_tpu.runtime.batch_engine import BatchEngine
    from omchat_tpu.utils.logging import build_logger

    jmodel, tmodel = models
    jslot = BatchEngine(OmChatConfig.tiny(), jmodel.engine.params, attn_impl="xla", **SLOT)
    tslot = batch_engine(tmodel, **SLOT)
    stop = threading.Event()
    jthread = _jax_scheduler(jslot, stop)
    jsrv = _serve(make_handler(jmodel, build_logger("test.torch_serve", "test_torch_serve.log", log_dir="/tmp"),
                               jslot))
    tsrv, loop = tserve.make_server(tmodel, tslot, "127.0.0.1", 0)
    threading.Thread(target=tsrv.serve_forever, daemon=True).start()
    yield (jsrv.server_address[1], tsrv.server_address[1]), tslot
    for srv in (jsrv, tsrv):
        srv.shutdown()
        srv.server_close()
    loop.close()
    stop.set()
    jthread.join(30)
    assert not jthread.is_alive()


def _both_slot(slot_servers, path, body=None):
    (jport, tport), _ = slot_servers
    want, got = _call(jport, path, body), _call(tport, path, body)
    _assert_same(got, want)
    return got


# the bodies the slot route answers from its batch; the rest (log-probs,
# seeds, bias, penalties, constraints) run the single-request engine, as on
# the JAX server
SLOT_BODIES = ("text", "image", "chat_alias", "stop", "metrics_request", "n_choices", "text_completions",
               "text_completions_echo", "text_completions_stop", "tool_auto_history")


@pytest.mark.parametrize("name", list(GREEDY_BODIES))
def test_slot_route_matches_jax(slot_servers, name):
    """Every greedy body on the --continuous-batching route: the JAX server's
    reply; those of SLOT_BODIES decoded by the slot engine, one step a
    token, the others by the single-request engine."""
    path, body = GREEDY_BODIES[name]
    _, tslot = slot_servers
    before = tslot.steps_eager
    status, _, out = _both_slot(slot_servers, path, body)
    assert status == 200 and out["choices"]
    assert (tslot.steps_eager > before) == (name in SLOT_BODIES)
    assert not tslot.requests and not tslot.has_work()


@pytest.mark.parametrize("name", list(STREAM_BODIES))
def test_slot_route_sse_chunks_match_jax(slot_servers, name):
    path, body = STREAM_BODIES[name]
    status, ctype, events = _both_slot(slot_servers, path, body)
    assert status == 200 and events[-1] == "[DONE]" and len(events) >= 3


def test_slot_route_metrics_match_jax(slot_servers):
    """/metrics after the same request: the JAX server's counters and every
    one of the slot engine's gauges (slots, queue, the image cache)."""
    _both_slot(slot_servers, *GREEDY_BODIES["metrics_request"])
    rows = []
    for port in slot_servers[0]:
        status, _, body = _call(port, "/metrics")
        assert status == 200
        rows.append(dict(line.split(" ", 1) for line in body.splitlines() if line and not line.startswith("#")))
    jrows, trows = rows
    assert set(jrows) == set(trows)
    for k in jrows:
        if k != "omchat_request_latency_ms_sum":
            assert trows[k] == jrows[k], k
    assert trows["omchat_engine_slots_total"] == str(SLOT["max_slots"]) and trows["omchat_engine_dead"] == "0"


def test_continuous_batching_builds_the_slot_engine(models, monkeypatch):
    """``--continuous-batching`` without ``--paged`` is served, not refused:
    the slot engine over the model's weights with the flags' slots, rows and
    image cache, its cache in the model's cache dtype."""
    _, tmodel = models
    built = {}

    class Server:
        def serve_forever(self):
            pass

        def server_close(self):
            pass

    class Loop:
        def close(self):
            pass

    def make_server(model, engine=None, host="", port=0, speculative=False):
        built["engine"] = engine
        return Server(), Loop()

    monkeypatch.setattr(tserve, "load_model", lambda ap, args: tmodel)
    monkeypatch.setattr(tserve, "make_server", make_server)
    tserve.main(["--model-path", "unused", "--device", "cpu", "--no-warmup", "--continuous-batching",
                 "--max-slots", "3", "--max-len", "128", "--image-cache", "0"])
    eng = built["engine"]
    assert isinstance(eng, TBatchEngine) and not isinstance(eng, TPagedEngine)
    assert (eng.max_slots, eng.max_len, eng.image_cache) == (3, 128, None)
    assert eng.params is tmodel.engine.params and eng.cache.k.dtype == torch.float32


def test_warmup_on_the_slot_route(models):
    _, tmodel = models
    engine = batch_engine(tmodel, **SLOT)
    assert tserve.warmup_engines(tmodel, engine) >= 0
    assert not engine.requests and not engine.has_work() and engine.steps_eager == 0  # counts reset after it
