"""OmChat `trust_remote_code` processor — standalone.

Shipped inside checkpoints exported by omchat-tpu (see modeling_omchat.py
header).  Combines the anyres image processor with ChatML prompt assembly:

- single image → `"<image>\\npatch:<image>×(n−1)\\n{text}"`,
- multi image  → per-image tile expansion interleaved at each `<image>`,
- `-200` sentinel spliced at every `<image>` during tokenization,
- ChatML framing with the hardcoded `<|im_start|>`/`<|im_end|>` ids
  151644/151645 (the OmChat checkpoint contract).

`__call__(text, images)` returns `{"input_ids": [1, T], "images":
[ΣN, 3, crop, crop]}` — the key is `images`, matching the model forward
kwarg.  Behaviorally identical to omchat_torch.processing (golden-tested
against the reference's hf/processing_omchat.py:167-257).
"""

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from PIL import Image
from transformers.feature_extraction_utils import BatchFeature
from transformers.processing_utils import ProcessorMixin

IMAGE_TOKEN = "<image>"
IMAGE_TOKEN_INDEX = -200
IM_START_ID = 151644
IM_END_ID = 151645
MAX_WINDOW_SIZE = 6144


def _encode(tokenizer, text: str) -> List[int]:
    # plain encode() — the same call omchat_torch.processing.chat makes, so the
    # token streams are identical for any given tokenizer
    ids = tokenizer.encode(text)
    return list(ids.ids) if hasattr(ids, "ids") else list(ids)


def tokenizer_image_token(prompt: str, tokenizer, image_token_index=IMAGE_TOKEN_INDEX) -> List[int]:
    chunks = [_encode(tokenizer, part) for part in prompt.split(IMAGE_TOKEN)]
    bos = getattr(tokenizer, "bos_token_id", None)
    has_bos = bool(chunks and chunks[0]) and bos is not None and chunks[0][0] == bos
    ids: List[int] = [bos] if has_bos else []
    for i, chunk in enumerate(chunks):
        if i:
            ids.append(image_token_index)
        ids.extend(chunk[1:] if has_bos else chunk)
    return ids


def make_context(
    tokenizer,
    query: str,
    history: Optional[List[Tuple[str, str]]] = None,
    system: str = "You are a helpful assistant.",
    max_window_size: int = MAX_WINDOW_SIZE,
) -> Tuple[str, List[int]]:
    history = history or []
    nl = _encode(tokenizer, "\n")

    def turn(role, content):
        body = (
            tokenizer_image_token(content, tokenizer)
            if IMAGE_TOKEN in content
            else _encode(tokenizer, content)
        )
        text = f"<|im_start|>{role}\n{content}<|im_end|>"
        tokens = [IM_START_ID] + _encode(tokenizer, role) + nl + body + [IM_END_ID]
        return text, tokens

    sys_text, sys_tokens = turn("system", system)
    hist_text, hist_tokens = "", []
    for past_q, past_a in reversed(history):
        q_text, q_tokens = turn("user", past_q)
        a_text, a_tokens = turn("assistant", past_a)
        block = nl + q_tokens + nl + a_tokens
        if len(sys_tokens) + len(block) + len(hist_tokens) >= max_window_size:
            break
        hist_tokens = block + hist_tokens
        hist_text = f"\n{q_text}\n{a_text}" + hist_text
    user_text, user_tokens = turn("user", query)
    context_tokens = (
        sys_tokens + hist_tokens + nl + user_tokens + nl
        + [IM_START_ID] + _encode(tokenizer, "assistant") + nl
    )
    raw = sys_text + hist_text + f"\n{user_text}\n<|im_start|>assistant\n"
    return raw, context_tokens


def _image_prompt(text: str, num_patches: int) -> str:
    return (
        IMAGE_TOKEN + "\n"
        + "\n".join(["patch:" + IMAGE_TOKEN] * (num_patches - 1))
        + "\n" + text.replace(IMAGE_TOKEN, "").strip()
    )


def _interleave_prompt(text: str, num_patches_list: Sequence[int]) -> str:
    texts = text.split(IMAGE_TOKEN)
    final = texts[0]
    for i, n in enumerate(num_patches_list):
        final += IMAGE_TOKEN + "\n" + "\n".join(["patch:" + IMAGE_TOKEN] * (n - 1))
        if i + 1 < len(texts):
            final += texts[i + 1]
    return final.strip()


class OmChatProcessor(ProcessorMixin):
    attributes = ["image_processor", "tokenizer"]
    image_processor_class = "AutoImageProcessor"
    tokenizer_class = "AutoTokenizer"

    def __init__(self, image_processor=None, tokenizer=None, **kwargs):
        super().__init__(image_processor, tokenizer, **kwargs)

    def __call__(
        self,
        text: str,
        images: Union[None, Image.Image, Sequence[Image.Image]] = None,
        system: str = "You are a helpful assistant.",
        history=None,
        return_tensors="pt",
    ) -> BatchFeature:
        if images is None:
            _, tokens = make_context(
                self.tokenizer, text.replace(IMAGE_TOKEN, "").strip(), history, system
            )
            return BatchFeature({"input_ids": torch.tensor([tokens], dtype=torch.long)})
        if isinstance(images, Image.Image):
            images = [images]
        feat = self.image_processor.preprocess(list(images))
        pixel_values, num_patches = feat["pixel_values"], feat["num_patches"]
        per_image = [pixel_values[i, : int(n)] for i, n in enumerate(num_patches)]
        counts = [int(n) for n in num_patches]
        if len(per_image) == 1:
            prompt = _image_prompt(text.replace(IMAGE_TOKEN, "").strip(), counts[0])
        else:
            prompt = _interleave_prompt(text, counts)
        _, tokens = make_context(self.tokenizer, prompt, history, system)
        return BatchFeature(
            {
                "input_ids": torch.tensor([tokens], dtype=torch.long),
                "images": torch.from_numpy(np.concatenate(per_image, axis=0)),
            }
        )

    def decode(self, *args, **kwargs):
        return self.tokenizer.decode(*args, **kwargs)

    def batch_decode(self, *args, **kwargs):
        return self.tokenizer.batch_decode(*args, **kwargs)
