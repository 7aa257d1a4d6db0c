"""OpenAI function/tool calling for the serving front-end.

No reference counterpart — the reference stripped its serve stack and its
generation is unconstrained (reference modeling_omchat.py ``generate``); this
is the OpenAI ``tools`` / ``tool_choice`` / ``message.tool_calls`` surface,
built on the schema-guided decoder (runtime/json_schema.py):

- Tool definitions render into the system prompt Hermes-style (the convention
  Qwen2-family chat models are trained on): a ``<tools>`` block of function
  JSON schemas plus instructions to emit
  ``<tool_call>{"name": ..., "arguments": ...}</tool_call>``.
- ``tool_choice: "auto"`` trusts the model — the completion is parsed for
  ``<tool_call>`` blocks afterwards (:func:`parse_tool_calls`).
- ``tool_choice: "required"`` / ``{"function": {"name": ...}}`` CONSTRAINS
  decoding to a ``{"name": ..., "arguments": {...}}`` object via the
  schema-guided token mask, so the call is guaranteed well-formed JSON naming
  a declared tool — even an untrained model cannot emit an invalid call.
- Parameter schemas are sanitized to the mask's supported subset
  (:func:`sanitize_schema`): unsupported keywords are dropped per-subtree
  instead of rejecting the whole tool; a dropped constraint is then enforced
  only by the model, as in every unconstrained serving stack.

History rendering: assistant turns that carried ``tool_calls`` replay as
their ``<tool_call>`` blocks; ``role: "tool"`` results replay inside the next
user turn as ``<tool_response>`` blocks (Qwen chat-template convention).
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Tuple

_SUPPORTED_KEYS = {
    "type", "properties", "required", "items", "minItems", "maxItems",
    "enum", "const", "title", "description", "default",
}
_PRIMS = {"string", "integer", "number", "boolean", "null"}


def validate_tools(tools) -> List[dict]:
    """Check the OpenAI ``tools`` array shape; returns the function specs.

    Raises ``ValueError`` (mapped to HTTP 400 by the server) on anything
    malformed — silent acceptance of a typo'd tool would just produce a
    model that can never call it."""
    if not isinstance(tools, list) or not tools:
        raise ValueError("tools must be a non-empty array")
    fns = []
    for i, t in enumerate(tools):
        if not isinstance(t, dict) or t.get("type") != "function":
            raise ValueError(f"tools[{i}] must be {{'type': 'function', 'function': {{...}}}}")
        fn = t.get("function")
        if not isinstance(fn, dict) or not isinstance(fn.get("name"), str) or not fn["name"]:
            raise ValueError(f"tools[{i}].function.name must be a non-empty string")
        if '"' in fn["name"] or "\\" in fn["name"]:
            raise ValueError(f"tools[{i}].function.name contains unsupported characters")
        fns.append(fn)
    if len({f["name"] for f in fns}) != len(fns):
        raise ValueError("tool names must be unique")
    return fns


def parse_tool_choice(tool_choice, fns: List[dict]) -> Tuple[str, Optional[str]]:
    """Normalize ``tool_choice`` → ("none" | "auto" | "forced", name | None).

    "required" is a forced call with a free name choice among the declared
    tools; a ``{"function": {"name": X}}`` object forces tool X."""
    if tool_choice in (None, "auto"):
        return "auto", None
    if tool_choice == "none":
        return "none", None
    if tool_choice == "required":
        return "forced", None
    if isinstance(tool_choice, dict) and tool_choice.get("type") == "function":
        name = (tool_choice.get("function") or {}).get("name")
        if not any(f["name"] == name for f in fns):
            raise ValueError(f"tool_choice names undeclared function {name!r}")
        return "forced", name
    raise ValueError("tool_choice must be 'none', 'auto', 'required', or a function object")


def render_tools_system(system: str, fns: List[dict]) -> str:
    """Append the Hermes-style tools block to the system prompt."""
    lines = [
        system,
        "",
        "# Tools",
        "",
        "You may call one or more functions to assist with the user query.",
        "",
        "You are provided with function signatures within <tools></tools> XML tags:",
        "<tools>",
    ]
    for fn in fns:
        lines.append(json.dumps({"type": "function", "function": fn}, ensure_ascii=False))
    lines += [
        "</tools>",
        "",
        "For each function call, return a json object with function name and "
        "arguments within <tool_call></tool_call> XML tags:",
        "<tool_call>",
        '{"name": <function-name>, "arguments": <args-json-object>}',
        "</tool_call>",
    ]
    return "\n".join(lines)


def render_assistant_tool_calls(content: Optional[str], tool_calls: List[dict]) -> str:
    """Replay text of an assistant history turn that made tool calls."""
    parts = [content] if content else []
    for tc in tool_calls:
        fn = tc.get("function") or {}
        args = fn.get("arguments", "{}")
        if isinstance(args, str):
            try:
                args = json.loads(args)
            except json.JSONDecodeError:
                pass  # replay verbatim — the model said it, the model sees it
        call = {"name": fn.get("name", ""), "arguments": args}
        parts.append(f"<tool_call>\n{json.dumps(call, ensure_ascii=False)}\n</tool_call>")
    return "\n".join(parts)


def render_tool_result(content: str) -> str:
    """Replay text of a ``role: "tool"`` result message."""
    return f"<tool_response>\n{content}\n</tool_response>"


_TOOL_CALL_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.DOTALL)


def parse_tool_calls(text: str) -> Tuple[Optional[str], List[dict]]:
    """Extract ``<tool_call>`` blocks → (content | None, calls).

    Each call is ``{"name": str, "arguments": str}`` with arguments re-encoded
    as a JSON string (the OpenAI wire format).  Unparseable blocks stay in the
    content — a mangled call is the model's output, not a server error."""
    calls = []

    def _take(m):
        try:
            obj = json.loads(m.group(1))
            name = obj.get("name")
            if not isinstance(name, str):
                return m.group(0)
        except json.JSONDecodeError:
            return m.group(0)
        args = obj.get("arguments", {})
        calls.append({"name": name, "arguments": json.dumps(args, ensure_ascii=False)})
        return ""

    content = _TOOL_CALL_RE.sub(_take, text).strip()
    return (content or None), calls


def sanitize_schema(schema) -> dict:
    """Project an arbitrary JSON schema onto the subset the guided-decoding
    mask supports (json_schema.py compile_schema).  Anything unsupported is
    RELAXED, never rejected: an uncompilable subtree degrades to the loosest
    shape that still guarantees valid JSON ({} = any value)."""
    if not isinstance(schema, dict):
        return {}
    if "const" in schema:
        return {"const": schema["const"]}
    if "enum" in schema and isinstance(schema["enum"], list) and schema["enum"]:
        ok = [v for v in schema["enum"] if isinstance(v, (str, int, float, bool)) or v is None]
        if ok:
            return {"enum": ok}
        return {}
    typ = schema.get("type")
    if isinstance(typ, list):
        kept = [t for t in typ if t in _PRIMS or t in ("object", "array")]
        if not kept:
            return {}
        if len(kept) == 1:
            return sanitize_schema({**schema, "type": kept[0]})
        return {"type": kept}  # union of bare types (no per-alt constraints)
    if typ == "object":
        props = schema.get("properties")
        if isinstance(props, dict) and props:
            clean = {
                k: sanitize_schema(v)
                for k, v in props.items()
                if isinstance(k, str) and '"' not in k and "\\" not in k
                and not any(ord(c) < 0x20 for c in k)
            }
            if clean:
                req = [k for k in schema.get("required", ()) if k in clean]
                out = {"type": "object", "properties": clean}
                if req:
                    out["required"] = req
                return out
        return {"type": "object"}
    if typ == "array":
        out = {"type": "array"}
        if "items" in schema:
            out["items"] = sanitize_schema(schema["items"])
        if isinstance(schema.get("minItems"), int):
            out["minItems"] = schema["minItems"]
        if isinstance(schema.get("maxItems"), int):
            out["maxItems"] = schema["maxItems"]
        return out
    if typ in _PRIMS:
        return {"type": typ}
    return {}


def forced_call_schema(fns: List[dict], name: Optional[str] = None) -> dict:
    """Schema for a constrained tool call.

    A named choice constrains ``arguments`` to that tool's (sanitized)
    parameter schema.  "required" over several tools can only pin the name
    to the declared set and leave arguments a free-form object — per-name
    argument schemas would need oneOf, which the mask doesn't model."""
    if name is not None:
        chosen = [f for f in fns if f["name"] == name]
        name_schema: dict = {"const": name}
        args_schema = sanitize_schema(chosen[0].get("parameters") or {"type": "object"})
    elif len(fns) == 1:
        name_schema = {"const": fns[0]["name"]}
        args_schema = sanitize_schema(fns[0].get("parameters") or {"type": "object"})
    else:
        name_schema = {"enum": [f["name"] for f in fns]}
        args_schema = {"type": "object"}
    if args_schema == {}:
        args_schema = {"type": "object"}
    return {
        "type": "object",
        "properties": {"name": name_schema, "arguments": args_schema},
        "required": ["name", "arguments"],
    }


def wire_tool_calls(calls: List[dict], start: int = 0) -> List[dict]:
    """OpenAI response shape: id/type/function triplets."""
    return [
        {
            "id": f"call_{start + i}",
            "type": "function",
            "function": {"name": c["name"], "arguments": c["arguments"]},
        }
        for i, c in enumerate(calls)
    ]
