"""Constrained decoding: restrict generation to one of N candidate strings.

The serving analogue of vLLM's ``guided_choice`` (no reference counterpart —
the reference's generation is unconstrained, modeling_omchat.py generate()):
a token-level trie over the tokenized candidates; each decode step masks the
logits to the tokens that extend some candidate, so greedy OR sampled decoding
must walk the trie and lands on exactly one full choice.

On the card: the host writes the allowed set into the decode state's [V]
additive-bias buffer once a step (``OmChatEngine.generate``), which the
graphed step reads; the allowed set is tiny (trie fan-out), so the mask is
built by index assignment, never a vocab scan.  A copy of
``omchat_tpu/runtime/constrained.py`` (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


class ChoiceTrie:
    """Token-id trie over tokenized choice strings.

    ``allowed(path)`` returns the token ids that extend ``path`` toward at
    least one choice, or ``None`` when ``path`` already spells a complete
    choice (generation must stop there — choices that are prefixes of other
    choices stop at the shorter match, first-match-wins like a greedy lexer).
    """

    def __init__(self, tokenized_choices: Sequence[Sequence[int]]):
        if not tokenized_choices:
            raise ValueError("guided_choice needs at least one choice")
        if any(len(c) == 0 for c in tokenized_choices):
            raise ValueError("every choice must tokenize to >= 1 token")
        root: Dict = {}
        for toks in tokenized_choices:
            node = root
            for t in toks:
                node = node.setdefault(int(t), {})
            node["__end__"] = True
        self.root = root

    def node(self, path: Sequence[int]) -> Optional[Dict]:
        node = self.root
        for t in path:
            node = node.get(int(t))
            if node is None:
                return None
        return node

    def allowed(self, path: Sequence[int]) -> Optional[List[int]]:
        node = self.node(path)
        if node is None:
            raise ValueError(f"generated path {list(path)} is not in the trie")
        if node.get("__end__"):
            return None  # complete choice: stop
        return [t for t in node.keys() if t != "__end__"]


def choice_mask_fn(tokenizer, choices: Sequence[str]):
    """Build the ``allowed_tokens_fn`` for OmChatEngine.generate from choice
    strings: tokenize each choice, return a closure mapping the generated-so-
    far suffix to the allowed next token ids (None = stop now)."""
    trie = ChoiceTrie([tokenizer.encode(c) for c in choices])
    return trie.allowed
