"""JSON-constrained decoding: OpenAI ``response_format: {"type": "json_object"}``.

The serving analogue of vLLM/outlines' JSON mode (no reference counterpart —
the reference's generation is unconstrained, modeling_omchat.py generate()):
each decode step masks the logits to the tokens whose text keeps the output
a valid prefix of a JSON object, so greedy OR sampled decoding must emit
parseable JSON, and generation stops exactly when the object closes.

Design — exact pushdown walk over SMALL candidate sets, not an FSM compile:

- A character-level pushdown automaton over strict JSON (RFC 8259 value
  grammar, object root): states for value/member positions, string +
  escape/``\\uXXXX`` modes, self-terminating numbers, ``true/false/null``
  literals; the stack holds the open-container chain so multi-close tokens
  (``"}]}``) validate exactly.
- Token-level masks come from partitioning the vocab once at build time:
  ~95% of tokens contain no quote/backslash/control character — inside a
  string they are valid and leave the state unchanged, outside they are
  invalid unless every char belongs to JSON's structural charset.  So a
  string-mode mask is one precomputed id array plus a walk of the few
  thousand quote/backslash tokens, and a structural-mode mask walks only the
  tokens drawn from the structural charset.  Walks advance the full
  automaton per candidate, so nesting/stack correctness is never
  approximated; per-configuration results are memoized (shared across
  requests), so steady-state per-step cost is a dict hit.
- Byte-level BPE caveat: tokens are classified by their detokenized text;
  partial-UTF-8 pieces decode with replacement chars, which are plain
  in-string characters — i.e. raw multibyte content is only reachable
  inside strings, which is exactly JSON's rule.

On the card: like guided_choice (runtime/constrained.py), the mask rides
``allowed_tokens_fn`` on the single-request engine path — a host-built
additive bias written into the decode state's buffer each step; the captured
step is unchanged.  A copy of ``omchat_tpu/runtime/json_mode.py``.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["JsonMode", "VocabTables", "get_json_mode", "get_tables", "advance", "START"]

_WS = " \t\n\r"
_HEX = set("0123456789abcdefABCDEF")
_ESCAPABLE = set('"\\/bfnrt')
_DIGITS = set("0123456789")
# every char that can legally appear OUTSIDE a string in a JSON document
_STRUCTURAL_CHARS = set('{}[]:," \t\n\r0123456789.+-eEtrufalsn')

# cfg = (state, aux, stack); stack is a tuple of 'o'/'a' open containers.
# States: root (expect '{'), v (expect value), of (after '{'), ok (after ','
# in object: expect key), colon, oc (after object member: ',' or '}'),
# ac (after array element: ',' or ']'), af (after '['), s/ks (value/key
# string), esc, u1-u4 (aux = string state to return to), num (aux =
# substate), lit (aux = remaining chars), end (object closed).
START: Tuple[str, Optional[str], Tuple[str, ...]] = ("root", None, ())


def _close(stack):
    """A value just completed; dispatch on the enclosing container."""
    if not stack:
        return ("end", None, stack)
    return ("oc" if stack[-1] == "o" else "ac", None, stack)


def _value_start(c, stack):
    if c == "{":
        return ("of", None, stack + ("o",))
    if c == "[":
        return ("af", None, stack + ("a",))
    if c == '"':
        return ("s", None, stack)
    if c == "-":
        return ("num", "minus", stack)
    if c == "0":
        return ("num", "int0", stack)
    if c in "123456789":
        return ("num", "int", stack)
    if c == "t":
        return ("lit", "rue", stack)
    if c == "f":
        return ("lit", "alse", stack)
    if c == "n":
        return ("lit", "ull", stack)
    return None


def _step(state, aux, stack, c):
    # -- string modes ------------------------------------------------------
    if state in ("s", "ks"):
        if c == '"':
            return ("colon", None, stack) if state == "ks" else _close(stack)
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
    # -- numbers (self-terminating: a delimiter ends the number and is
    # re-dispatched in the enclosing close state) ---------------------------
    if state == "num":
        if aux == "minus":
            if c == "0":
                return ("num", "int0", stack)
            return ("num", "int", stack) if c in _DIGITS else None
        if aux == "dot":
            return ("num", "frac", stack) if c in _DIGITS else None
        if aux == "e":
            if c in "+-":
                return ("num", "esign", stack)
            return ("num", "exp", stack) if c in _DIGITS else None
        if aux == "esign":
            return ("num", "exp", stack) if c in _DIGITS else None
        # int / int0 / frac / exp: may continue or complete
        if aux == "int" and c in _DIGITS:
            return ("num", "int", stack)
        if aux in ("int", "int0"):
            if c == ".":
                return ("num", "dot", stack)
            if c in "eE":
                return ("num", "e", stack)
        elif aux == "frac":
            if c in _DIGITS:
                return ("num", "frac", stack)
            if c in "eE":
                return ("num", "e", stack)
        elif aux == "exp" and c in _DIGITS:
            return ("num", "exp", stack)
        st, ax, sk = _close(stack)
        return _step(st, ax, sk, c)  # number done; c belongs to the container
    # -- literals -----------------------------------------------------------
    if state == "lit":
        if aux and c == aux[0]:
            return _close(stack) if len(aux) == 1 else ("lit", aux[1:], stack)
        return None
    # -- structural states (whitespace-tolerant) ----------------------------
    if c in _WS:
        return (state, aux, stack)
    if state == "root":
        return ("of", None, ("o",)) if c == "{" else None
    if state == "v":
        return _value_start(c, stack)
    if state == "of":
        if c == '"':
            return ("ks", None, stack)
        return _close(stack[:-1]) if c == "}" else None
    if state == "ok":
        return ("ks", None, stack) if c == '"' else None
    if state == "colon":
        return ("v", None, stack) if c == ":" else None
    if state == "oc":
        if c == ",":
            return ("ok", None, stack)
        return _close(stack[:-1]) if c == "}" else None
    if state == "af":
        if c == "]":
            return _close(stack[:-1])
        return _value_start(c, stack)
    if state == "ac":
        if c == ",":
            return ("v", None, stack)
        return _close(stack[:-1]) if c == "]" else None
    # end: nothing but whitespace (handled above)
    return None


def advance(cfg, text: str):
    """Run ``text`` through the automaton from ``cfg``; None = invalid."""
    for c in text:
        cfg = _step(cfg[0], cfg[1], cfg[2], c)
        if cfg is None:
            return None
    return cfg


class VocabTables:
    """Per-tokenizer token-text tables and vocab partitions, shared by every
    guided-decoding mode (JSON mode here, JSON-schema mode in
    json_schema.py).  Build once (~1-2 s for a 152k vocab); cache via
    :func:`get_tables`."""

    def __init__(self, tokenizer):
        v = len(tokenizer)
        special = set(int(i) for i in getattr(tokenizer, "all_special_ids", []) or [])
        self.token_text: List[Optional[str]] = []
        in_string_safe: List[int] = []
        string_active: List[int] = []  # contain '"' or '\' (may exit/escape)
        structural: List[int] = []  # every char in the structural charset
        for tid in range(v):
            if tid in special:
                self.token_text.append(None)
                continue
            try:
                text = tokenizer.decode([tid])
            except Exception:
                text = ""
            if not text:  # empty pieces would stall the automaton forever
                self.token_text.append(None)
                continue
            self.token_text.append(text)
            has_ctl = any(ord(c) < 0x20 for c in text)
            has_q = '"' in text or "\\" in text
            if not has_q and not has_ctl:
                in_string_safe.append(tid)
            elif has_q:
                # may close/open/escape strings; exact walk decides, in BOTH
                # string and structural states (e.g. the BPE piece `{"name`
                # enters a key string from a structural position)
                string_active.append(tid)
            if all(c in _STRUCTURAL_CHARS for c in text):
                structural.append(tid)
        self.in_string_safe = np.asarray(in_string_safe, np.int64)
        self.string_active = string_active
        self.structural = structural
        # first-char index for the rare mid-escape / prefix-constrained states
        self.by_first: Dict[str, List[int]] = {}
        for tid, text in enumerate(self.token_text):
            if text:
                self.by_first.setdefault(text[0], []).append(tid)


# Keyed on the live tokenizer object (weakref), NOT id(): a bare id() key
# goes stale when the tokenizer is garbage-collected and a new tokenizer
# reuses the address — the cache would then hand out tables built for a
# different vocab (observed as corrupted schema masks in the test suite).
_TABLES_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_TABLES_CACHE_STRONG: Dict[int, Tuple[object, VocabTables]] = {}


def get_tables(tokenizer) -> VocabTables:
    try:
        t = _TABLES_CACHE.get(tokenizer)
        if t is None:
            t = _TABLES_CACHE[tokenizer] = VocabTables(tokenizer)
        return t
    except TypeError:
        # Non-weakref-able tokenizer: hold a strong reference alongside the
        # tables so its id can never be reused while the entry lives.
        hit = _TABLES_CACHE_STRONG.get(id(tokenizer))
        if hit is not None and hit[0] is tokenizer:
            return hit[1]
        t = VocabTables(tokenizer)
        _TABLES_CACHE_STRONG[id(tokenizer)] = (tokenizer, t)
        return t


class JsonMode:
    """JSON-object mask machinery over shared :class:`VocabTables`.
    ``mask_fn()`` returns a fresh ``allowed_tokens_fn`` closure per request;
    the per-configuration mask memo is shared across requests."""

    def __init__(self, tokenizer):
        t = get_tables(tokenizer)
        self.token_text = t.token_text
        self._in_string_safe = t.in_string_safe
        self._string_active = t.string_active
        self._structural = t.structural
        self._by_first = t.by_first
        self._memo: Dict[tuple, Optional[np.ndarray]] = {}

    # -- mask computation ----------------------------------------------------

    def _walk(self, cfg, candidates) -> List[int]:
        out = []
        texts = self.token_text
        for tid in candidates:
            if advance(cfg, texts[tid]) is not None:
                out.append(tid)
        return out

    def allowed_ids(self, cfg) -> Optional[np.ndarray]:
        """Token ids legal at ``cfg``; None = generation complete (state
        'end', or a dead end — stop rather than emit garbage)."""
        state = cfg[0]
        if state == "end":
            return None
        key = cfg
        hit = self._memo.get(key, False)
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
        else:
            # structural candidates PLUS quote-bearing tokens (they may step
            # into a string: `{"name`), exact-walked either way.  Pure-
            # whitespace tokens (cfg unchanged) are disallowed here: an
            # untrained/waffling model would otherwise emit formatting
            # forever without ever progressing the object — the constrained
            # output is compact-leaning JSON, which is always valid JSON.
            texts = self.token_text
            ids = np.asarray(
                [
                    t
                    for t in self._walk(cfg, self._structural)
                    + self._walk(cfg, self._string_active)
                    if advance(cfg, texts[t]) != cfg
                ],
                np.int64,
            )
        result: Optional[np.ndarray] = ids if ids.size else None
        self._memo[key] = result
        return result

    # -- per-request closure --------------------------------------------------

    def mask_fn(self):
        """``allowed_tokens_fn`` for OmChatEngine.generate: maps the
        generated-so-far token ids to allowed next ids (None = stop).
        Stateful: advances the automaton incrementally over new tokens."""
        state = {"cfg": START, "n": 0}

        def fn(path: List[int]) -> Optional[List[int]]:
            cfg = state["cfg"]
            if cfg is None:
                return None
            for tid in path[state["n"] :]:
                text = self.token_text[int(tid)]
                cfg = advance(cfg, text) if text else None
                if cfg is None:  # sampled an illegal token anyway? stop clean
                    state["cfg"] = None
                    return None
            state["cfg"], state["n"] = cfg, len(path)
            ids = self.allowed_ids(cfg)
            return None if ids is None else ids

        return fn


_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_CACHE_STRONG: Dict[int, Tuple[object, JsonMode]] = {}


def get_json_mode(tokenizer) -> JsonMode:
    """Process-wide JsonMode per tokenizer instance (table build is ~1-2 s
    on a 152k vocab; serve.py calls this per request).  Weakref-keyed on the
    tokenizer object itself — see the ``get_tables`` cache note."""
    try:
        jm = _CACHE.get(tokenizer)
        if jm is None:
            jm = _CACHE[tokenizer] = JsonMode(tokenizer)
        return jm
    except TypeError:
        hit = _CACHE_STRONG.get(id(tokenizer))
        if hit is not None and hit[0] is tokenizer:
            return hit[1]
        jm = JsonMode(tokenizer)
        _CACHE_STRONG[id(tokenizer)] = (tokenizer, jm)
        return jm
