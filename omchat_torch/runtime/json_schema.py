"""Structured outputs: decode-time enforcement of a JSON schema.

The serving analogue of OpenAI structured outputs / vLLM ``guided_json``
(no reference counterpart — the reference's generation is unconstrained):
extends the JSON-object automaton (json_mode.py) with schema awareness, so
every decode step is masked to tokens that keep the output a valid prefix
of a schema-conforming document — object keys are spelled from the schema's
properties, required keys must all appear before ``}``, enums/consts are
spelled exactly, ``integer`` forbids fractions/exponents, arrays respect
``minItems``/``maxItems``.

Supported schema subset (compile-time validated, unsupported keywords are
rejected loudly rather than silently ignored):

- ``type``: object / array / string / integer / number / boolean / null,
  or a list of those (first matching alternative wins on open chars)
- object: ``properties`` (keys restricted to them; any order; no
  duplicates), ``required``; objects WITHOUT ``properties`` accept any keys
- array: ``items``, ``minItems``, ``maxItems``
- ``enum`` / ``const``: strings, numbers, booleans, null (spelled exactly,
  matching json.dumps for non-strings)
- omitted type: any JSON value

Not supported (documented limits): ``pattern``/formats, numeric ranges,
``anyOf`` across same-open-char alternatives, ``$ref``, escapes inside
constrained (key/enum) strings — unconstrained string VALUES keep full
escape support.

Mask mechanics are shared with json_mode.py: exact pushdown walks over
small vocab partitions (VocabTables), memoized per automaton configuration.
The automaton configuration carries the schema context — which node the
next value must satisfy, which keys an open object has emitted, how many
elements an open array holds — as hashable tuples, so memoization stays a
dict hit in the steady state.
"""

from __future__ import annotations

import json
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np

from omchat_torch.runtime.json_mode import _ESCAPABLE, _HEX, _WS, get_tables

__all__ = ["JsonSchemaMode", "compile_schema", "get_json_schema_mode"]

_DIGITS = set("0123456789")


# --------------------------------------------------------------------------
# schema compiler: JSON schema dict -> flat node list (ids are list indices)
# --------------------------------------------------------------------------

_PRIMS = {"string", "integer", "number", "boolean", "null"}
_IGNORED_KEYS = {
    "title", "description", "default", "examples", "$schema", "$id",
    "additionalProperties",  # properties-present objects are closed-world
}


def compile_schema(schema: dict, nodes: Optional[List[dict]] = None) -> Tuple[int, List[dict]]:
    """Compile ``schema`` into ``nodes``; returns (root_node_id, nodes)."""
    if nodes is None:
        nodes = []
    if not isinstance(schema, dict):
        raise ValueError(f"schema must be an object, got {type(schema).__name__}")
    unknown = (
        set(schema)
        - _IGNORED_KEYS
        - {"type", "properties", "required", "items", "minItems", "maxItems", "enum", "const"}
    )
    if unknown:
        raise ValueError(f"unsupported schema keywords: {sorted(unknown)}")

    nid = len(nodes)
    nodes.append({})  # reserve

    if "const" in schema or "enum" in schema:
        values = [schema["const"]] if "const" in schema else list(schema["enum"])
        strings = tuple(sorted(v for v in values if isinstance(v, str)))
        # non-strings spell exactly as json.dumps renders them
        literals = tuple(
            sorted(json.dumps(v) for v in values if not isinstance(v, str))
        )
        if not strings and not literals:
            raise ValueError("enum must be non-empty")
        nodes[nid] = {"kind": "enum", "strings": strings, "literals": literals}
        return nid, nodes

    typ = schema.get("type")
    if isinstance(typ, list):
        alts = tuple(compile_schema({**schema, "type": t}, nodes)[0] for t in typ)
        nodes[nid] = {"kind": "union", "alts": alts}
        return nid, nodes
    if typ == "object":
        props = schema.get("properties")
        if props is not None:
            keys = tuple(sorted(props))
            if not keys:
                raise ValueError("object with empty properties can never be satisfied usefully")
            children = {}
            for k in keys:
                if '"' in k or "\\" in k or any(ord(c) < 0x20 for c in k):
                    raise ValueError(f"unsupported characters in property name {k!r}")
                children[k], _ = compile_schema(props[k], nodes)
            required = frozenset(schema.get("required", ()))
            if not required <= set(keys):
                raise ValueError("required keys must appear in properties")
            nodes[nid] = {"kind": "object", "props": children, "keys": keys, "required": required}
        else:
            nodes[nid] = {"kind": "object", "props": None, "keys": None, "required": frozenset()}
        return nid, nodes
    if typ == "array":
        items = schema.get("items")
        inid = compile_schema(items, nodes)[0] if items is not None else None
        nodes[nid] = {
            "kind": "array",
            "items": inid,
            "min": int(schema.get("minItems", 0)),
            "max": int(schema["maxItems"]) if "maxItems" in schema else None,
        }
        return nid, nodes
    if typ in _PRIMS:
        nodes[nid] = {"kind": typ}
        return nid, nodes
    if typ is None:
        nodes[nid] = {"kind": "any"}
        return nid, nodes
    raise ValueError(f"unsupported type: {typ!r}")


# --------------------------------------------------------------------------
# pushdown automaton over (state, aux, stack); stack entries:
#   ("o", nid|None, emitted frozenset, cur_key|None)   open object
#   ("a", items_nid|None, count, min, max)             open array
# states: v(aux=nid|None expected-value), of/ok/oc/ac/af/colon (aux below),
#   s/ks (unconstrained string; esc/u1-u4 aux = return state),
#   kstr/estr (aux = (nid, prefix)), lit (aux = remaining),
#   elit (aux = (nid, prefix)), num (aux = (sub, int_only)), end
# --------------------------------------------------------------------------

def _close(stack):
    if not stack:
        return ("end", None, ())
    top = stack[-1]
    if top[0] == "o":
        _, nid, emitted, cur = top
        new_top = ("o", nid, emitted | ({cur} if cur else frozenset()), None)
        return ("oc", None, stack[:-1] + (new_top,))
    _, inid, count, mn, mx = top
    return ("ac", None, stack[:-1] + (("a", inid, count + 1, mn, mx),))


class JsonSchemaMode:
    """Schema-constrained mask machinery; share via
    :func:`get_json_schema_mode` (vocab tables cached per tokenizer, masks
    memoized per automaton configuration)."""

    def __init__(self, tokenizer, schema: dict):
        self.root, self.nodes = compile_schema(schema)
        t = get_tables(tokenizer)
        self.token_text = t.token_text
        self._in_string_safe = t.in_string_safe
        self._string_active = t.string_active
        self._structural = t.structural
        self._by_first = t.by_first
        self._memo: Dict[tuple, Optional[np.ndarray]] = {}
        self.START = ("v", self.root, ())

    # -- character transitions ------------------------------------------------

    def _value_start(self, nid, c, stack):
        node = self.nodes[nid] if nid is not None else {"kind": "any"}
        kind = node["kind"]
        if kind == "union":
            for alt in node["alts"]:
                out = self._value_start(alt, c, stack)
                if out is not None:
                    return out
            return None
        if kind == "any":
            if c == "{":
                return ("of", None, stack + (("o", None, frozenset(), None),))
            if c == "[":
                return ("af", None, stack + (("a", None, 0, 0, None),))
            if c == '"':
                return ("s", None, stack)
            if c == "-":
                return ("num", ("minus", False), stack)
            if c == "0":
                return ("num", ("int0", False), stack)
            if c in "123456789":
                return ("num", ("int", False), stack)
            if c == "t":
                return ("lit", "rue", stack)
            if c == "f":
                return ("lit", "alse", stack)
            if c == "n":
                return ("lit", "ull", stack)
            return None
        if kind == "object":
            if c != "{":
                return None
            return ("of", nid, stack + (("o", nid, frozenset(), None),))
        if kind == "array":
            if c != "[":
                return None
            return ("af", None, stack + (("a", node["items"], 0, node["min"], node["max"]),))
        if kind == "string":
            return ("s", None, stack) if c == '"' else None
        if kind == "enum":
            if c == '"' and node["strings"]:
                return ("estr", (nid, ""), stack)
            if any(lit.startswith(c) for lit in node["literals"]):
                return ("elit", (nid, c), stack)
            return None
        if kind == "integer" or kind == "number":
            int_only = kind == "integer"
            if c == "-":
                return ("num", ("minus", int_only), stack)
            if c == "0":
                return ("num", ("int0", int_only), stack)
            if c in "123456789":
                return ("num", ("int", int_only), stack)
            return None
        if kind == "boolean":
            if c == "t":
                return ("lit", "rue", stack)
            if c == "f":
                return ("lit", "alse", stack)
            return None
        if kind == "null":
            return ("lit", "ull", stack) if c == "n" else None
        return None

    def _obj_open_keys(self, top):
        """Keys an open object may still spell."""
        _, nid, emitted, _ = top
        if nid is None:
            return None  # unconstrained
        node = self.nodes[nid]
        if node["props"] is None:
            return None
        return [k for k in node["keys"] if k not in emitted]

    def _step(self, state, aux, stack, c):
        nodes = self.nodes
        # strings ---------------------------------------------------------
        if state in ("s", "ks"):
            if c == '"':
                if state == "ks":  # unconstrained key finished
                    top = stack[-1]
                    new_top = ("o", top[1], top[2], "\x00any")  # marker key
                    return ("colon", None, stack[:-1] + (new_top,))
                return _close(stack)
            if c == "\\":
                return ("esc", state, stack)
            if ord(c) < 0x20:
                return None
            return (state, aux, stack)
        if state == "esc":
            if c == "u":
                return ("u1", aux, stack)
            return (aux, None, stack) if c in _ESCAPABLE else None
        if state in ("u1", "u2", "u3"):
            nxt = {"u1": "u2", "u2": "u3", "u3": "u4"}[state]
            return (nxt, aux, stack) if c in _HEX else None
        if state == "u4":
            return (aux, None, stack) if c in _HEX else None
        if state == "kstr":
            nid, prefix = aux
            top = stack[-1]
            open_keys = self._obj_open_keys(top)
            if c == '"':
                if prefix not in (open_keys or ()):
                    return None
                vnid = nodes[top[1]]["props"][prefix]
                new_top = ("o", top[1], top[2], prefix)
                return ("colon", vnid, stack[:-1] + (new_top,))
            new = prefix + c
            if any(k.startswith(new) for k in (open_keys or ())):
                return ("kstr", (nid, new), stack)
            return None
        if state == "estr":
            nid, prefix = aux
            strings = nodes[nid]["strings"]
            if c == '"':
                return _close(stack) if prefix in strings else None
            new = prefix + c
            return ("estr", (nid, new), stack) if any(s.startswith(new) for s in strings) else None
        if state == "elit":
            nid, prefix = aux
            lits = nodes[nid]["literals"]
            new = prefix + c
            if any(l.startswith(new) for l in lits):
                return ("elit", (nid, new), stack)
            if prefix in lits:  # complete literal; c belongs to the container
                st, ax, sk = _close(stack)
                return self._step(st, ax, sk, c)
            return None
        # numbers -----------------------------------------------------------
        if state == "num":
            sub, int_only = aux
            if sub == "minus":
                if c == "0":
                    return ("num", ("int0", int_only), stack)
                return ("num", ("int", int_only), stack) if c in _DIGITS else None
            if sub == "dot":
                return ("num", ("frac", int_only), stack) if c in _DIGITS else None
            if sub == "e":
                if c in "+-":
                    return ("num", ("esign", int_only), stack)
                return ("num", ("exp", int_only), stack) if c in _DIGITS else None
            if sub == "esign":
                return ("num", ("exp", int_only), stack) if c in _DIGITS else None
            if sub == "int" and c in _DIGITS:
                return ("num", ("int", int_only), stack)
            if not int_only:
                if sub in ("int", "int0"):
                    if c == ".":
                        return ("num", ("dot", int_only), stack)
                    if c in "eE":
                        return ("num", ("e", int_only), stack)
                elif sub == "frac":
                    if c in _DIGITS:
                        return ("num", ("frac", int_only), stack)
                    if c in "eE":
                        return ("num", ("e", int_only), stack)
                elif sub == "exp" and c in _DIGITS:
                    return ("num", ("exp", int_only), stack)
            st, ax, sk = _close(stack)
            return self._step(st, ax, sk, c)
        if state == "lit":
            if aux and c == aux[0]:
                return _close(stack) if len(aux) == 1 else ("lit", aux[1:], stack)
            return None
        # structural (whitespace-tolerant) ----------------------------------
        if c in _WS:
            return (state, aux, stack)  # incl. trailing WS after 'end'
        if state == "v":
            return self._value_start(aux, c, stack)
        if state in ("of", "ok"):
            top = stack[-1]
            if c == '"':
                open_keys = self._obj_open_keys(top)
                if open_keys is None:
                    return ("ks", None, stack)
                return ("kstr", (top[1], ""), stack) if open_keys else None
            if c == "}" and state == "of":
                nid = top[1]
                required = nodes[nid]["required"] if nid is not None else frozenset()
                return _close(stack[:-1]) if not required else None
            return None
        if state == "colon":
            if c != ":":
                return None
            top = stack[-1]
            if top[3] == "\x00any":
                return ("v", None, stack)
            return ("v", aux, stack)
        if state == "oc":
            top = stack[-1]
            nid = top[1]
            if c == ",":
                open_keys = self._obj_open_keys(top)
                return ("ok", None, stack) if (open_keys is None or open_keys) else None
            if c == "}":
                required = nodes[nid]["required"] if nid is not None else frozenset()
                return _close(stack[:-1]) if required <= top[2] else None
            return None
        if state in ("af", "av"):
            # af: right after '[' (']' may close an empty-enough array);
            # av: right after ',' (a value is mandatory — no trailing comma)
            top = stack[-1]
            _, inid, count, mn, mx = top
            if c == "]" and state == "af":
                return _close(stack[:-1]) if count >= mn else None
            if mx is not None and count >= mx:
                return None
            return self._value_start(inid, c, stack)
        if state == "ac":
            top = stack[-1]
            _, inid, count, mn, mx = top
            if c == ",":
                return ("av", None, stack) if (mx is None or count < mx) else None
            if c == "]":
                return _close(stack[:-1]) if count >= mn else None
            return None
        return None

    def advance(self, cfg, text: str):
        for c in text:
            cfg = self._step(cfg[0], cfg[1], cfg[2], c)
            if cfg is None:
                return None
        return cfg

    # -- masks -----------------------------------------------------------------

    def _walk(self, cfg, candidates) -> List[int]:
        texts = self.token_text
        return [tid for tid in candidates if self.advance(cfg, texts[tid]) is not None]

    def _completable(self, cfg) -> bool:
        """True when the document could legally end right here (top-level
        number/enum-literal with nothing left to force)."""
        state, aux, stack = cfg
        if state == "end":
            return True
        if stack:
            return False
        if state == "num":
            return aux[0] in ("int", "int0", "frac", "exp")
        if state == "elit":
            return aux[1] in self.nodes[aux[0]]["literals"]
        return False

    def allowed_ids(self, cfg) -> Optional[np.ndarray]:
        state = cfg[0]
        if state == "end":
            return None
        hit = self._memo.get(cfg, False)
        if hit is not False:
            return hit
        if state in ("s", "ks"):
            ids = np.concatenate(
                [self._in_string_safe, np.asarray(self._walk(cfg, self._string_active), np.int64)]
            )
        elif state in ("esc", "u1", "u2", "u3", "u4"):
            firsts = _ESCAPABLE | {"u"} if state == "esc" else _HEX
            cands = sorted({t for c in firsts for t in self._by_first.get(c, [])})
            ids = np.asarray(self._walk(cfg, cands), np.int64)
        elif state in ("kstr", "estr"):
            # prefix-constrained: only tokens starting with a viable next
            # char can advance; '"' closes an exact match
            nid, prefix = cfg[1]
            if state == "kstr":
                live = [k for k in (self._obj_open_keys(cfg[2][-1]) or ()) if k.startswith(prefix)]
            else:
                live = [s for s in self.nodes[nid]["strings"] if s.startswith(prefix)]
            firsts = {k[len(prefix)] for k in live if len(k) > len(prefix)}
            if prefix in live:
                firsts.add('"')
            cands = sorted({t for c in firsts for t in self._by_first.get(c, [])})
            ids = np.asarray(self._walk(cfg, cands), np.int64)
        else:
            texts = self.token_text
            ids = np.asarray(
                [
                    t
                    for t in self._walk(cfg, self._structural)
                    + self._walk(cfg, self._string_active)
                    if self.advance(cfg, texts[t]) != cfg  # no pure-WS stalls
                ],
                np.int64,
            )
        result: Optional[np.ndarray] = ids if ids.size else None
        self._memo[cfg] = result
        return result

    def mask_fn(self):
        """``allowed_tokens_fn`` for OmChatEngine.generate (None = stop)."""
        state = {"cfg": self.START, "n": 0}

        def fn(path: List[int]) -> Optional[List[int]]:
            cfg = state["cfg"]
            if cfg is None:
                return None
            for tid in path[state["n"] :]:
                text = self.token_text[int(tid)]
                cfg = self.advance(cfg, text) if text else None
                if cfg is None:
                    state["cfg"] = None
                    return None
            state["cfg"], state["n"] = cfg, len(path)
            if self._completable(cfg):
                # top-level number/enum-literal: nothing terminates it, so
                # stop as soon as the emitted text is already a valid value
                # (otherwise greedy could extend digits until max_tokens)
                return None
            ids = self.allowed_ids(cfg)
            return None if ids is None else ids

        return fn


# Per-tokenizer (weakref) -> {canonical schema JSON: mode}.  id()-keying
# alone is unsafe: a collected tokenizer's address can be reused by a new
# one, which would receive modes built over a different vocab (see the
# get_tables note in json_mode.py).
_MODE_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_MODE_CACHE_STRONG: Dict[int, Tuple[object, dict]] = {}


def get_json_schema_mode(tokenizer, schema: dict) -> JsonSchemaMode:
    """Cache JsonSchemaMode per (tokenizer, canonical schema JSON); bounded."""
    try:
        per_tok = _MODE_CACHE.get(tokenizer)
        if per_tok is None:
            per_tok = _MODE_CACHE[tokenizer] = {}
    except TypeError:
        hit = _MODE_CACHE_STRONG.get(id(tokenizer))
        if hit is not None and hit[0] is tokenizer:
            per_tok = hit[1]
        else:
            per_tok = {}
            _MODE_CACHE_STRONG[id(tokenizer)] = (tokenizer, per_tok)
    key = json.dumps(schema, sort_keys=True)
    m = per_tok.get(key)
    if m is None:
        if len(per_tok) > 64:
            per_tok.clear()
        m = per_tok[key] = JsonSchemaMode(tokenizer, schema)
    return m
