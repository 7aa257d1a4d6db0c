"""ChatML prompt construction and image-sentinel tokenization.

Bit-parity contract with the reference:

- :func:`tokenizer_image_token` — split on ``<image>`` (or indexed ``<image_N>``)
  and interleave ``-200`` sentinels (omchat/mm_utils.py:197-230).
- :func:`make_context` — ChatML assembly with hardcoded ``<|im_start|>``/``<|im_end|>``
  ids 151644/151645 and a 6144-token history budget filled newest-first
  (omchat/make_context.py:66-148).
- :func:`get_context` — the single-image prompt template
  ``"<image>\\npatch:<image>×(n−1)\\n{question}"`` (make_context.py:14-43); the
  reference's text-only branch crashes on an undefined name (make_context.py:37),
  fixed here.

Works with any tokenizer exposing ``encode(str) -> List[int]`` (HF tokenizers do).
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

from omchat_torch.constants import (
    DEFAULT_IMAGE_TOKEN,
    IM_END_TOKEN_ID,
    IM_START_TOKEN_ID,
    IMAGE_TOKEN_INDEX,
    MAX_WINDOW_SIZE,
)

_INDEXED_IMAGE_RE = re.compile(r"<image_(\d+)>")


def _encode(tokenizer, text: str) -> List[int]:
    ids = tokenizer.encode(text)
    # Some tokenizers return objects with .ids
    return list(ids.ids) if hasattr(ids, "ids") else list(ids)


def tokenizer_image_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
) -> List[int]:
    """Tokenize ``prompt`` splicing ``image_token_index`` at each ``<image>``.

    Handles the indexed ``<image_N>`` form too (reference mm_utils.py:198-209:
    every indexed tag also maps to the single ``-200`` sentinel).
    """
    if "<image_0>" in prompt:
        pieces = re.split(r"<image_[0-9]+>", prompt)
        n_tags = len(_INDEXED_IMAGE_RE.findall(prompt))
        ids: List[int] = []
        for i, piece in enumerate(pieces):
            ids.extend(_encode(tokenizer, piece))
            if i < n_tags:
                ids.append(IMAGE_TOKEN_INDEX)
        return ids

    chunks = [_encode(tokenizer, part) for part in prompt.split(DEFAULT_IMAGE_TOKEN)]

    # Sentencepiece-style tokenizers prepend BOS to *every* encode call; keep
    # it once up front and drop it from each chunk (the reference handles this
    # with an offset-sliced separator interleave, mm_utils.py:211-229 — the
    # token stream here is identical).
    bos = getattr(tokenizer, "bos_token_id", None)
    has_bos = bool(chunks and chunks[0]) and bos is not None and chunks[0][0] == bos
    ids = [bos] if has_bos else []
    for i, chunk in enumerate(chunks):
        if i:
            ids.append(image_token_index)
        ids.extend(chunk[1:] if has_bos else chunk)
    return ids


def make_context(
    tokenizer,
    query: str,
    history: Optional[List[Tuple[str, str]]] = None,
    system: str = "",
    max_window_size: int = MAX_WINDOW_SIZE,
    chat_format: str = "chatml",
) -> Tuple[str, List[int]]:
    """Build the ChatML prompt → ``(raw_text, context_tokens)``.

    Token-stream parity with reference make_context.py:66-148, including the
    newest-first history fill under the ``max_window_size`` budget and the
    hardcoded im_start/im_end ids.
    """
    if history is None:
        history = []

    if chat_format == "raw":
        return query, _encode(tokenizer, query)
    if chat_format != "chatml":
        raise NotImplementedError(f"Unknown chat format {chat_format!r}")

    nl = _encode(tokenizer, "\n")

    def turn(role: str, content: str) -> Tuple[str, List[int]]:
        """One ``<|im_start|>role\\ncontent<|im_end|>`` block as (text, tokens);
        ``<image>`` in the content splices the −200 sentinel."""
        if DEFAULT_IMAGE_TOKEN in content:
            body = tokenizer_image_token(content, tokenizer, IMAGE_TOKEN_INDEX)
        else:
            body = _encode(tokenizer, content)
        text = f"<|im_start|>{role}\n{content}<|im_end|>"
        tokens = [IM_START_TOKEN_ID] + _encode(tokenizer, role) + nl + body + [IM_END_TOKEN_ID]
        return text, tokens

    sys_text, sys_tokens = turn("system", system)

    # History fills newest-first until the budget would overflow (reference
    # semantics: a turn is kept only while system+history stays strictly under
    # max_window_size, make_context.py:106-126).
    hist_text, hist_tokens = "", []
    for past_query, past_reply in reversed(history):
        q_text, q_tokens = turn("user", past_query)
        a_text, a_tokens = turn("assistant", past_reply)
        block = nl + q_tokens + nl + a_tokens
        if len(sys_tokens) + len(block) + len(hist_tokens) >= max_window_size:
            break
        hist_tokens = block + hist_tokens
        hist_text = f"\n{q_text}\n{a_text}" + hist_text

    user_text, user_tokens = turn("user", query)
    context_tokens = (
        sys_tokens
        + hist_tokens
        + nl
        + user_tokens
        + nl
        + [IM_START_TOKEN_ID]
        + _encode(tokenizer, "assistant")
        + nl
    )
    raw_text = sys_text + hist_text + f"\n{user_text}\n<|im_start|>assistant\n"
    return raw_text, context_tokens


def image_prompt(text: str, num_patches: int) -> str:
    """The single-image prompt body: ``<image>`` + (n−1) ``patch:<image>`` lines.

    Reference: make_context.py:30, processing_omchat.py:230-235.
    """
    return (
        DEFAULT_IMAGE_TOKEN
        + "\n"
        + "\n".join(["patch:" + DEFAULT_IMAGE_TOKEN] * (num_patches - 1))
        + "\n"
        + text.replace(DEFAULT_IMAGE_TOKEN, "").strip()
    )


def interleave_image_prompt(text: str, num_patches_list: Sequence[int]) -> str:
    """Multi-image interleave: per-image tile expansion at each ``<image>``.

    Reference: processing_omchat.py:237-244.
    """
    texts = text.split(DEFAULT_IMAGE_TOKEN)
    final = texts[0]
    for i, n in enumerate(num_patches_list):
        final += DEFAULT_IMAGE_TOKEN + "\n" + "\n".join(["patch:" + DEFAULT_IMAGE_TOKEN] * (n - 1))
        if i + 1 < len(texts):
            final += texts[i + 1]
    return final.strip()


def get_context(
    text: str,
    tokenizer,
    initial_prompt: str = "You are a helpful assistant.",
    image=None,
    grid_pinpoints=None,
    tile_size: int = 448,
):
    """Single-shot context builder → ``(raw_text, context_tokens, image_tiles)``.

    Behavioral equivalent of reference make_context.py:14-43 (with its text-only
    NameError fixed).  ``image_tiles`` is a float32 ``[N, 3, tile, tile]`` numpy
    array or None.
    """
    from omchat_torch.constants import DEFAULT_GRID_PINPOINTS
    from omchat_torch.processing.image_processor import process_anyres_image

    if image is not None:
        tiles = process_anyres_image(
            image, grid_pinpoints if grid_pinpoints is not None else DEFAULT_GRID_PINPOINTS, tile_size
        )
        n = tiles.shape[0]
        inp, context_tokens = make_context(tokenizer, image_prompt(text, n), None, initial_prompt)
        return inp, context_tokens, tiles

    inp, context_tokens = make_context(
        tokenizer, text.replace(DEFAULT_IMAGE_TOKEN, "").strip(), None, initial_prompt
    )
    return inp, context_tokens, None
