"""The port's copies of the constrained-decoding host modules
(``runtime/constrained.py``, ``json_mode.py``, ``json_schema.py``,
``tool_calls.py``) against the JAX package's: the same allowed-token sets at
every step of seeded random walks over the ``MockTokenizer``'s vocabulary,
the same tool-call rendering and parsing; and ``OmChatModel.chat`` /
``chat_tools`` with guided, JSON, schema and forced-tool decoding giving the
JAX model's replies on ``OmChatConfig.tiny()`` in float32.  Exact: the
modules are framework-free copies.
"""

import json

import numpy as np
import pytest

from omchat_tpu.runtime import constrained as jc
from omchat_tpu.runtime import json_mode as jm
from omchat_tpu.runtime import json_schema as js
from omchat_tpu.runtime import tool_calls as jt
from omchat_torch.runtime import constrained as tc
from omchat_torch.runtime import json_mode as tm
from omchat_torch.runtime import json_schema as tsch
from omchat_torch.runtime import tool_calls as tt
from omchat_torch.utils.testing import MockTokenizer

SCHEMA = {"type": "object", "properties": {"name": {"type": "string", "enum": ["ab", "cd"]},
                                           "n": {"type": "integer"}, "ok": {"type": "boolean"}},
          "required": ["name", "n"]}
TOOLS = [{"type": "function", "function": {"name": "get_weather", "description": "weather",
                                           "parameters": {"type": "object",
                                                          "properties": {"city": {"type": "string"}},
                                                          "required": ["city"]}}},
         {"type": "function", "function": {"name": "noop", "parameters": {"type": "object", "properties": {}}}}]


def _walk(fn_a, fn_b, seed, steps=60):
    """Walk both mask functions with the same random picks from the allowed
    set; every step's sets must be equal.  Returns the path."""
    rng = np.random.default_rng(seed)
    path = []
    for _ in range(steps):
        a, b = fn_a(list(path)), fn_b(list(path))
        if a is None or b is None:
            assert a is None and b is None, (path, a, b)
            break
        a, b = sorted(int(t) for t in a), sorted(int(t) for t in b)
        assert a == b, path
        assert a, path
        path.append(a[int(rng.integers(len(a)))])
    return path


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_choice_masks_match_jax(seed):
    choices = ["yes", "no", "maybe", "yesterday"]
    tok = MockTokenizer()
    path = _walk(jc.choice_mask_fn(tok, choices), tc.choice_mask_fn(tok, choices), seed)
    assert tok.decode(path) in choices


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_json_mode_masks_match_jax(seed):
    tok = MockTokenizer()
    path = _walk(jm.get_json_mode(tok).mask_fn(), tm.get_json_mode(tok).mask_fn(), seed)
    assert tok.decode(path).startswith("{")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_json_schema_masks_match_jax(seed):
    tok = MockTokenizer()
    _walk(js.get_json_schema_mode(tok, SCHEMA).mask_fn(), tsch.get_json_schema_mode(tok, SCHEMA).mask_fn(), seed,
          steps=120)


def test_tool_call_rendering_and_parsing_match_jax():
    fns_j, fns_t = jt.validate_tools(TOOLS), tt.validate_tools(TOOLS)
    assert fns_j == fns_t
    for choice in ("auto", "none", "required", {"type": "function", "function": {"name": "noop"}}):
        assert jt.parse_tool_choice(choice, fns_j) == tt.parse_tool_choice(choice, fns_t)
    assert jt.render_tools_system("sys", fns_j) == tt.render_tools_system("sys", fns_t)
    assert jt.forced_call_schema(fns_j, "get_weather") == tt.forced_call_schema(fns_t, "get_weather")
    text = 'ok <tool_call>{"name": "get_weather", "arguments": {"city": "Oslo"}}</tool_call>'
    assert jt.parse_tool_calls(text) == tt.parse_tool_calls(text)
    calls = tt.parse_tool_calls(text)[1]
    assert jt.wire_tool_calls(calls) == tt.wire_tool_calls(calls)
    tok = MockTokenizer()
    schema = tt.forced_call_schema(fns_t, None)
    _walk(js.get_json_schema_mode(tok, schema).mask_fn(), tsch.get_json_schema_mode(tok, schema).mask_fn(), 5,
          steps=150)


# -- the chat entry points ---------------------------------------------------


_MODELS = []


@pytest.fixture
def models():
    return make_models()


def make_models():
    """The JAX ``OmChatModel`` and the port's over the same tiny weights and
    the ``MockTokenizer``, made once."""
    if _MODELS:
        return _MODELS[0]
    import jax

    from omchat_tpu.api import OmChatModel as JModel
    from omchat_tpu.config import OmChatConfig
    from omchat_tpu.processing.image_processor import OmChatImageProcessor as JIP
    from omchat_tpu.processing.processor import OmChatProcessor as JProc
    from omchat_tpu.runtime.generate import OmChatEngine as JEngine
    from omchat_torch.api import OmChatModel as TModel
    from omchat_torch.checkpoint.convert import from_jax_params
    from omchat_torch.config import OmChatConfig as TCfg
    from omchat_torch.processing.image_processor import OmChatImageProcessor as TIP
    from omchat_torch.processing.processor import OmChatProcessor as TProc
    from omchat_torch.runtime.generate import OmChatEngine as TEngine
    from tests.test_sharding import _tiny_params

    cfg = OmChatConfig.tiny()
    params = _tiny_params(cfg)
    tok = MockTokenizer()
    size = cfg.vision.image_size
    jip = JIP(crop_size=size, shortest_edge=size, image_grid_pinpoints=cfg.image_grid_pinpoints)
    jmodel = JModel(tok, JEngine(cfg, params, attn_impl="xla"), jip, JProc(tok, jip), cfg)
    tcfg = TCfg.tiny()
    tip = TIP(crop_size=size, shortest_edge=size, image_grid_pinpoints=tcfg.image_grid_pinpoints)
    tengine = TEngine(tcfg, from_jax_params(jax.device_get(params)), device="cpu")
    _MODELS.append((jmodel, TModel(tok, tengine, tip, TProc(tok, tip), tcfg)))
    return _MODELS[0]


def _gen(n=12):
    from omchat_tpu.config import GenerationConfig as JGen
    from omchat_torch.config import GenerationConfig as TGen

    return JGen(max_new_tokens=n, eos_token_id=-1), TGen(max_new_tokens=n, eos_token_id=-1)


@pytest.mark.parametrize("option", ["guided_choices", "json_mode", "json_schema"])
def test_chat_constrained_matches_jax(models, option):
    jmodel, tmodel = models
    kw = {"guided_choices": dict(guided_choices=["yes", "no", "maybe"]), "json_mode": dict(json_mode=True),
          "json_schema": dict(json_schema=SCHEMA)}[option]
    jg, tg = _gen(40)
    want = jmodel.chat("answer", generation=jg, **kw)
    got = tmodel.chat("answer", generation=tg, **kw)
    assert got == want
    if option == "guided_choices":
        assert got in ("yes", "no", "maybe")


@pytest.mark.parametrize("choice", ["required", "auto"])
def test_chat_tools_matches_jax(models, choice):
    jmodel, tmodel = models
    jg, tg = _gen(60)
    want = jmodel.chat_tools("weather in Oslo?", TOOLS, tool_choice=choice, generation=jg)
    got = tmodel.chat_tools("weather in Oslo?", TOOLS, tool_choice=choice, generation=tg)
    assert got == want
    if choice == "required" and got["tool_calls"]:
        call = got["tool_calls"][0]["function"]
        assert call["name"] in ("get_weather", "noop") and isinstance(json.loads(call["arguments"]), dict)
