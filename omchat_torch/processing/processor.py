"""OmChatProcessor — the combined text+image front-end.

Behavioral equivalent of the HF bundle's ``OmChatProcessor.__call__``
(omchat/hf/processing_omchat.py:167-257):

- single image → ``"<image>\\npatch:<image>×(n−1)\\n{text}"`` prompt
- multi image  → per-image tile expansion interleaved at each ``<image>``
- text only    → plain ChatML context (the reference returns a malformed bare
  tensor here, :255; we return a proper dict)

Returns numpy arrays: ``input_ids [1, T]`` (int32, with −200 sentinels) and
``images [ΣN, 3, 448, 448]`` (float32) — the key is ``images`` to match the
model forward kwarg, exactly like the reference.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
from PIL import Image

from omchat_torch.constants import DEFAULT_IMAGE_TOKEN
from omchat_torch.processing.chat import image_prompt, interleave_image_prompt, make_context
from omchat_torch.processing.image_processor import OmChatImageProcessor, split_pixel_values


class OmChatProcessor:
    def __init__(
        self,
        tokenizer,
        image_processor: Optional[OmChatImageProcessor] = None,
        patch_expand: bool = True,
    ):
        """``patch_expand=False`` is the OmChat-v1 prompt shape
        (mm_patch_merge_type spatial/spatial_unpad): ONE ``<image>`` sentinel
        per image — the engine expands it to the spatial-merged token count —
        instead of the v2 per-tile ``patch:<image>`` expansion."""
        self.tokenizer = tokenizer
        self.image_processor = image_processor or OmChatImageProcessor()
        self.patch_expand = patch_expand

    def __call__(
        self,
        text: str,
        images: Union[None, Image.Image, Sequence[Image.Image]] = None,
        system: str = "You are a helpful assistant.",
        history=None,
    ) -> dict:
        if images is None:
            _, context_tokens = make_context(
                self.tokenizer, text.replace(DEFAULT_IMAGE_TOKEN, "").strip(), history, system
            )
            return {"input_ids": np.asarray([context_tokens], dtype=np.int32)}

        if isinstance(images, Image.Image):
            images = [images]
        image_inputs = self.image_processor.preprocess(list(images))
        per_image = split_pixel_values(image_inputs["pixel_values"], image_inputs["num_patches"])
        num_patches = [int(n) for n in image_inputs["num_patches"]]

        if not self.patch_expand:
            # v1: one sentinel per image, in place when the text has markers,
            # else prepended
            missing = len(per_image) - text.count(DEFAULT_IMAGE_TOKEN)
            prompt = "\n".join([DEFAULT_IMAGE_TOKEN] * max(missing, 0) + [text]).strip()
        elif len(per_image) == 1:
            prompt = image_prompt(text.replace(DEFAULT_IMAGE_TOKEN, "").strip(), num_patches[0])
        else:
            prompt = interleave_image_prompt(text, num_patches)

        _, context_tokens = make_context(self.tokenizer, prompt, history, system)
        return {
            "input_ids": np.asarray([context_tokens], dtype=np.int32),
            "images": np.concatenate(per_image, axis=0),
            "num_patches": np.asarray(num_patches, dtype=np.int32),
            "image_sizes": [im.size for im in images],
        }

    def decode(self, token_ids, **kwargs) -> str:
        return self.tokenizer.decode(token_ids, **kwargs)

    def batch_decode(self, sequences, **kwargs):
        return self.tokenizer.batch_decode(sequences, **kwargs)
