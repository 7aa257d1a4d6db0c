"""High-level API — PyTorch port of ``omchat_tpu/api.py`` (the plain chat
turn and ``load_pretrained_model`` with bf16, int8 weight-only or w8a8
weights on one device), plus :func:`paged_batch_engine`, the serving engine
over a loaded model (what ``cli/serve.py --paged`` builds).

``load_pretrained_model`` mirrors the reference's builder.py:22 (tokenizer +
model + image processor + context length) and returns a ready engine.
``lora_path`` merges a trained LoRA adapter at load, which closes train →
serve.  Tensor parallelism and the guided / speculative / beam chat variants
come with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from omchat_torch.checkpoint.loader import load_lora_adapter, load_omchat_checkpoint
from omchat_torch.config import GenerationConfig, OmChatConfig
from omchat_torch.models.intern_vit import calibrate_fc1_scales
from omchat_torch.ops.linear import quantize_tree
from omchat_torch.processing.image_processor import OmChatImageProcessor
from omchat_torch.processing.processor import OmChatProcessor
from omchat_torch.runtime.generate import OmChatEngine
from omchat_torch.runtime.paged_engine import PagedBatchEngine
from omchat_torch.training.lora import merge_lora
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


def quantize_model(config: OmChatConfig, params: dict, *, w8a8: bool, attn_impl: Optional[str] = None):
    """int8 weights for a loaded model: every linear kernel quantized per
    output channel, on the params' device, one layer at a time (no fp32 copy
    of a whole stack is held).  ``w8a8`` also switches the config to the
    w8a8 serving mode and calibrates the ViT's static fc1 output scales with
    one forward over two seeded standard-normal images (the JAX package's
    calibration input).  Returns (config, params)."""
    params = quantize_tree(params)
    if w8a8:
        config = config.with_w8a8()
        size = config.vision.image_size
        dev = params["vision_tower"]["patch_embedding"]["kernel"].device
        pixels = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, size, size)))
        pixels = pixels.to(torch.bfloat16).to(dev)
        params["vision_tower"] = calibrate_fc1_scales(params["vision_tower"], config.vision, pixels,
                                                      attn_impl=attn_impl)
    return config, params


def load_pretrained_model(
    model_path: str,
    dtype: torch.dtype = torch.bfloat16,
    *,
    quantize_int8: bool = False,
    w8a8: bool = False,
    attn_impl: Optional[str] = None,
    device=None,
    lora_path: Optional[str] = None,
    cache_dtype: Optional[torch.dtype] = None,
) -> OmChatModel:
    """Load an OmChat checkpoint directory (HF-bundle or repo-native key
    layout) onto ``device`` (default CUDA; raises without it).

    ``quantize_int8``: int8 weight-only linears.  ``w8a8``: the serving mode
    with int8 x int8 products on the compute-bound paths (ViT encode and LLM
    prefill; decode stays weight-only int8); implies ``quantize_int8`` and
    calibrates the ViT's static fc1 scales at load (:func:`quantize_model`).
    ``lora_path``: a LoRA adapter directory (either package's
    ``save_lora_adapter``), merged in bf16 before any quantization, so the
    int8 scales cover the fine-tuned weights.  ``cache_dtype``: the KV
    cache's storage dtype (``torch.float8_e4m3fn``: the fp8 cache), also the
    page pool's of :func:`paged_batch_engine`."""
    from transformers import AutoTokenizer

    dev = resolve_device(device)
    tokenizer = AutoTokenizer.from_pretrained(model_path, use_fast=True)
    config, params = load_omchat_checkpoint(model_path, dtype, device=dev)
    if lora_path is not None:
        params = merge_lora(params, load_lora_adapter(lora_path, dtype, device=dev))
    if quantize_int8 or w8a8:
        config, params = quantize_model(config, params, w8a8=w8a8, attn_impl=attn_impl)
    engine = OmChatEngine(config, params, attn_impl=attn_impl, cache_dtype=cache_dtype, device=dev)
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
    default on its device with its attention route and cache dtype
    (``options``: PagedBatchEngine's keyword arguments — max_slots,
    num_pages, page_size, max_len, decode_roll, prefill_chunk,
    image_cache_size, cache_dtype, decode_kernel, ...)."""
    options = {"attn_impl": model.engine.attn_impl, "device": model.engine.device,
               "cache_dtype": model.engine.cache_dtype, **options}
    return PagedBatchEngine(model.config, model.engine.params, **options)
