"""High-level API — PyTorch port of ``omchat_tpu/api.py`` (the plain chat
turn and ``load_pretrained_model``, bf16 weights, one device), plus
:func:`paged_batch_engine`, the serving engine over a loaded model (what
``cli/serve.py --paged`` builds).

``load_pretrained_model`` mirrors the reference's builder.py:22 (tokenizer +
model + image processor + context length) and returns a ready engine.  int8,
w8a8, tensor parallelism, LoRA merging and the guided / speculative / beam
chat variants come with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from omchat_torch.checkpoint.loader import load_omchat_checkpoint
from omchat_torch.config import GenerationConfig, OmChatConfig
from omchat_torch.processing.image_processor import OmChatImageProcessor
from omchat_torch.processing.processor import OmChatProcessor
from omchat_torch.runtime.generate import OmChatEngine
from omchat_torch.runtime.paged_engine import PagedBatchEngine
from omchat_torch.utils.device import resolve_device


@dataclass
class OmChatModel:
    """Bundled tokenizer + engine + processors."""

    tokenizer: object
    engine: OmChatEngine
    image_processor: OmChatImageProcessor
    processor: OmChatProcessor
    config: OmChatConfig
    context_len: int = 8192

    def chat(self, text: str, image=None, history=None, generation: Optional[GenerationConfig] = None,
             stream_callback=None) -> str:
        """One chat turn: build the anyres context, generate greedily, decode."""
        inputs = self.processor(text, images=image, history=history)
        out = self.engine.generate(
            [inputs["input_ids"][0].tolist()],
            inputs.get("images"),
            generation or GenerationConfig(),
            stream_callback=stream_callback,
            tokenizer=self.tokenizer,
        )
        return self.tokenizer.decode(out.token_ids[0], skip_special_tokens=True)


def load_pretrained_model(
    model_path: str,
    dtype: torch.dtype = torch.bfloat16,
    *,
    attn_impl: Optional[str] = None,
    device=None,
) -> OmChatModel:
    """Load an OmChat checkpoint directory (HF-bundle or repo-native key
    layout) onto ``device`` (default CUDA; raises without it)."""
    from transformers import AutoTokenizer

    dev = resolve_device(device)
    tokenizer = AutoTokenizer.from_pretrained(model_path, use_fast=True)
    config, params = load_omchat_checkpoint(model_path, dtype, device=dev)
    engine = OmChatEngine(config, params, attn_impl=attn_impl, device=dev)
    image_processor = OmChatImageProcessor(
        crop_size=config.vision.image_size,
        shortest_edge=config.vision.image_size,
        image_grid_pinpoints=config.image_grid_pinpoints,
    )
    if config.mm_patch_merge_type != "flat":
        raise NotImplementedError("the OmChat-v1 spatial patch merge waits for a later slice")
    processor = OmChatProcessor(tokenizer, image_processor)
    return OmChatModel(tokenizer, engine, image_processor, processor, config,
                       config.tokenizer_model_max_length or 8192)


def paged_batch_engine(model: OmChatModel, **options) -> PagedBatchEngine:
    """A paged continuous-batching engine serving ``model``'s weights, by
    default on its device with its attention route (``options``:
    PagedBatchEngine's keyword arguments — max_slots, num_pages, page_size,
    max_len, decode_roll, prefill_chunk, image_cache_size, ...)."""
    options = {"attn_impl": model.engine.attn_impl, "device": model.engine.device, **options}
    return PagedBatchEngine(model.config, model.engine.params, **options)
