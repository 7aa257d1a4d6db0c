"""High-level API — PyTorch port of ``omchat_tpu/api.py`` (the plain chat
turn and ``load_pretrained_model`` with bf16, int8 weight-only or w8a8
weights on one device), plus :func:`paged_batch_engine` and
:func:`batch_engine`, the serving engines over a loaded model (what
``cli/serve.py --paged`` and ``--continuous-batching`` build).

``load_pretrained_model`` mirrors the reference's builder.py:22 (tokenizer +
model + image processor + context length) and returns a ready engine.
``lora_path`` merges a trained LoRA adapter at load, which closes train →
serve.  ``OmChatModel`` carries the JAX package's single-request surface:
``chat`` (history, beams, speculative, guided / JSON / schema decoding),
``chat_tools`` and ``chat_video``.  The server (``cli/serve.py``) builds the
model and, with ``--paged``, :func:`paged_batch_engine` over its weights
(``--continuous-batching`` alone: :func:`batch_engine`).

``load_pretrained_model(tp=N)`` in a launched world of N ranks (``torchrun
--nproc-per-node N``) loads this rank's shard of the weights over a pure
tensor-parallel mesh, one layer at a time, and the engines it and the two
factories build serve over that mesh (:mod:`omchat_torch.parallel.serving`).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from omchat_torch.checkpoint.loader import (load_lora_adapter, load_omchat_checkpoint,
                                            load_omchat_checkpoint_sharded)
from omchat_torch.config import GenerationConfig, OmChatConfig
from omchat_torch.models.intern_vit import calibrate_fc1_scales, calibration_layer, fc1_scale
from omchat_torch.models.intern_vit import embeddings as vit_embeddings
from omchat_torch.ops.linear import quantize_tree
from omchat_torch.parallel.serving import check_serving_mesh, serving_mesh
from omchat_torch.processing.chat import make_context
from omchat_torch.processing.image_processor import OmChatImageProcessor
from omchat_torch.processing.processor import OmChatProcessor
from omchat_torch.processing.video import process_video_frames, video_prompt
from omchat_torch.runtime.batch_engine import BatchEngine
from omchat_torch.runtime.constrained import choice_mask_fn
from omchat_torch.runtime.generate import OmChatEngine
from omchat_torch.runtime.json_mode import get_json_mode
from omchat_torch.runtime.json_schema import get_json_schema_mode
from omchat_torch.runtime.paged_engine import PagedBatchEngine
from omchat_torch.runtime.tool_calls import (
    forced_call_schema,
    parse_tool_calls,
    parse_tool_choice,
    render_tools_system,
    validate_tools,
    wire_tool_calls,
)
from omchat_torch.training.lora import merge_lora
from omchat_torch.utils.device import resolve_device
from omchat_torch.utils.tree import layer_slice, tree_map


@dataclass
class OmChatModel:
    """Bundled tokenizer + engine + processors."""

    tokenizer: object
    engine: OmChatEngine
    image_processor: OmChatImageProcessor
    processor: OmChatProcessor
    config: OmChatConfig
    context_len: int = 8192

    def chat(
        self,
        text: str,
        image=None,
        history=None,
        generation: Optional[GenerationConfig] = None,
        stream_callback=None,
        speculative: bool = False,
        guided_choices=None,
        json_mode: bool = False,
        json_schema: Optional[dict] = None,
        num_beams: int = 1,
    ) -> str:
        """One chat turn: build the anyres context, generate, decode.

        ``speculative=True`` (greedy only) decodes with prompt-lookup
        speculation (runtime/speculative.py): greedy tokens, fewer device
        steps on echo-heavy continuations.  ``guided_choices``: restrict the
        reply to one of these strings by trie-masked decoding
        (runtime/constrained.py).  ``json_mode``: a valid JSON object
        (runtime/json_mode.py).  ``json_schema``: a reply conforming to the
        schema (runtime/json_schema.py).  ``num_beams > 1``: beam search
        (runtime/beam_search.py), greedy-only and unconstrained.  Precedence,
        as in the JAX package: beams, then speculative (greedy and
        unconstrained only), then the guided mask, the schema mask, the JSON
        mask."""
        inputs = self.processor(text, images=image, history=history)
        gen = generation or GenerationConfig()
        ids = inputs["input_ids"][0].tolist()
        if num_beams > 1:
            if gen.do_sample or guided_choices or json_mode or json_schema is not None:
                raise ValueError("num_beams > 1 is greedy-only (no sampling/constrained decoding)")
            out = self.engine.beam_search(ids, inputs.get("images"), num_beams=num_beams,
                                          max_new_tokens=gen.max_new_tokens, eos_token_id=gen.eos_token_id)
            return self.tokenizer.decode(out, skip_special_tokens=True)
        if speculative and not gen.do_sample and not guided_choices and not json_mode and json_schema is None:
            out, _ = self.engine.generate_speculative(ids, inputs.get("images"), gen, stream_callback=stream_callback)
            return self.tokenizer.decode(out, skip_special_tokens=True)
        allowed_fn = None
        if guided_choices:
            allowed_fn = choice_mask_fn(self.tokenizer, list(guided_choices))
        elif json_schema is not None:
            allowed_fn = get_json_schema_mode(self.tokenizer, json_schema).mask_fn()
        elif json_mode:
            allowed_fn = get_json_mode(self.tokenizer).mask_fn()
        extra = {}
        if self.config.mm_patch_merge_type.startswith("spatial") and "images" in inputs:
            # the OmChat-v1 assembly: one sentinel an image, its merged tokens vary
            extra = {"num_patches": inputs["num_patches"].tolist(), "image_sizes": inputs["image_sizes"]}
        out = self.engine.generate(
            [ids],
            inputs.get("images"),
            gen,
            stream_callback=stream_callback,
            tokenizer=self.tokenizer,
            allowed_tokens_fn=allowed_fn,
            **extra,
        )
        return self.tokenizer.decode(out.token_ids[0], skip_special_tokens=True)

    def chat_tools(
        self,
        text: str,
        tools: list,
        image=None,
        history=None,
        tool_choice="auto",
        generation: Optional[GenerationConfig] = None,
        system: str = "You are a helpful assistant.",
    ) -> dict:
        """One chat turn with OpenAI-style tool calling (runtime/tool_calls.py).

        Returns ``{"content": str | None, "tool_calls": [{"id", "type",
        "function": {"name", "arguments"}}, ...]}``.  ``tool_choice``
        "required" or ``{"type": "function", "function": {"name": ...}}``
        constrains decoding via the schema-guided mask, so the call is
        well-formed JSON naming a declared tool; "auto" parses
        ``<tool_call>`` blocks out of an unconstrained completion."""
        fns = validate_tools(tools)
        mode, forced_name = parse_tool_choice(tool_choice, fns)
        if mode != "none":
            system = render_tools_system(system, fns)
        inputs = self.processor(text, images=image, history=history, system=system)
        gen = generation or GenerationConfig()
        allowed_fn = None
        if mode == "forced":
            schema = forced_call_schema(fns, forced_name)
            try:
                allowed_fn = get_json_schema_mode(self.tokenizer, schema).mask_fn()
            except ValueError:
                schema = forced_call_schema([{"name": f["name"]} for f in fns], forced_name)
                allowed_fn = get_json_schema_mode(self.tokenizer, schema).mask_fn()
        out = self.engine.generate(
            [inputs["input_ids"][0].tolist()],
            inputs.get("images"),
            gen,
            tokenizer=self.tokenizer,
            allowed_tokens_fn=allowed_fn,
        )
        reply = self.tokenizer.decode(out.token_ids[0], skip_special_tokens=True)
        if mode == "forced":
            try:
                obj = json.loads(reply)
                calls = [{"name": obj["name"],
                          "arguments": json.dumps(obj.get("arguments", {}), ensure_ascii=False)}]
                return {"content": None, "tool_calls": wire_tool_calls(calls)}
            except (json.JSONDecodeError, KeyError, TypeError):
                return {"content": reply, "tool_calls": []}
        content, calls = parse_tool_calls(reply)
        return {"content": content, "tool_calls": wire_tool_calls(calls)}

    def chat_video(
        self,
        text: str,
        frames,
        num_samples: int = 32,
        generation: Optional[GenerationConfig] = None,
        stream_callback=None,
    ) -> str:
        """Video QA: uniform frame sampling, one ViT tile + sentinel per frame
        (the 32-frame MMBench-Video configuration), on the host PIL path
        (``processing/video.py``)."""
        pixel_values = process_video_frames(frames, tile_size=self.config.vision.image_size, num_samples=num_samples)
        prompt = video_prompt(text, pixel_values.shape[0])
        _, context_tokens = make_context(self.tokenizer, prompt, None, "You are a helpful assistant.")
        out = self.engine.generate(
            [context_tokens],
            pixel_values,
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
        dev = params["vision_tower"]["patch_embedding"]["kernel"].device
        params["vision_tower"] = calibrate_fc1_scales(params["vision_tower"], config.vision,
                                                      calibration_pixels(config.vision, dev), attn_impl=attn_impl)
    return config, params


def calibration_pixels(cfg, device) -> torch.Tensor:
    """The fc1 calibration's input: two seeded standard-normal images in
    bf16 (the JAX package's)."""
    size = cfg.image_size
    return torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, size, size))).to(torch.bfloat16).to(device)


class _Fc1Calibration:
    """:func:`calibrate_fc1_scales` run by the sharded load on whole layers
    as it reads them (the JAX package calibrates the whole tower before it
    shards it): the embeddings of :func:`calibration_pixels` from the
    "rest" piece, then each whole quantized tower layer moved to ``device``
    for its forward, its fc1 scale stored in the layer before it is split.
    The same forward as the one-device load's, so the same scales."""

    def __init__(self, cfg, attn_impl, device):
        self.cfg, self.attn_impl, self.device, self.x = cfg, attn_impl, device, None

    @torch.no_grad()
    def __call__(self, tree: dict, where: str) -> dict:
        on_device = lambda t: tree_map(lambda a: a.to(self.device), t)  # noqa: E731
        if where == "rest":
            self.x = vit_embeddings(on_device(tree["vision_tower"]), self.cfg, calibration_pixels(self.cfg, self.device))
        elif where == "vision_layer":
            self.x, amax = calibration_layer(self.cfg, self.x, on_device(layer_slice(tree, 0)), self.attn_impl)
            scale = fc1_scale(amax).reshape(1).to(tree["norm1"]["scale"].device)
            tree = {**tree, "mlp": {**tree["mlp"], "fc1_out_scale": scale}}
        return tree


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
    tp: int = 1,
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
    page pool's of :func:`paged_batch_engine`.

    ``tp`` above 1: tensor-parallel serving over the launched world, which
    must be exactly ``tp`` ranks, each on its device (``device``; ranks may
    share one card).  Each rank reads and keeps only its shard, built one
    layer at a time (:func:`~omchat_torch.checkpoint.loader.
    load_omchat_checkpoint_sharded`): the LoRA merge and the int8
    quantization see each whole layer before it is split, as the JAX package
    merges and quantizes before it shards; ``w8a8`` calibrates the ViT's
    fc1 scales on each whole layer as it is read (:class:`_Fc1Calibration`).
    A tp that would leave a rank without a q head is refused before any
    weight loads."""
    from transformers import AutoTokenizer

    dev = resolve_device(device)
    mesh = serving_mesh(tp)
    if mesh is not None:
        config = OmChatConfig.from_json(os.path.join(model_path, "config.json"))
        config = config.with_w8a8() if w8a8 else config
        check_serving_mesh(config, mesh, what="load_pretrained_model")
    tokenizer = AutoTokenizer.from_pretrained(model_path, use_fast=True)
    if mesh is not None:
        lora = load_lora_adapter(lora_path, dtype) if lora_path is not None else None
        calibrate = _Fc1Calibration(config.vision, attn_impl, dev) if w8a8 else None
        config, params = load_omchat_checkpoint_sharded(model_path, mesh, dtype, config, dev,
                                                        _whole_layer_transform(lora, quantize_int8 or w8a8,
                                                                               calibrate))
        return omchat_model(tokenizer, OmChatEngine(config, params, attn_impl=attn_impl, cache_dtype=cache_dtype,
                                                    device=dev, mesh=mesh))
    config, params = load_omchat_checkpoint(model_path, dtype, device=dev)
    if lora_path is not None:
        params = merge_lora(params, load_lora_adapter(lora_path, dtype, device=dev))
    if quantize_int8 or w8a8:
        config, params = quantize_model(config, params, w8a8=w8a8, attn_impl=attn_impl)
    return omchat_model(tokenizer, OmChatEngine(config, params, attn_impl=attn_impl, cache_dtype=cache_dtype,
                                                device=dev))


def _whole_layer_transform(lora: Optional[dict], quantize_int8: bool, calibrate=None):
    """What the sharded load applies to each whole piece before splitting
    it: the LoRA merge on each trunk layer (the adapter's slice of that
    layer), then the int8 quantization (per output channel: a row-parallel
    kernel must be quantized whole), then w8a8's fc1 calibration
    (``calibrate``, a :class:`_Fc1Calibration`)."""

    def transform(tree: dict, where: str, index) -> dict:
        if where == "text_layer" and lora is not None:
            piece = {"layers": tree_map(lambda t: t[index: index + 1], lora["layers"]), "scale": lora["scale"]}
            anchor = tree["input_layernorm"]["scale"]  # merge_lora reads the activations' dtype off the embedding
            tree = merge_lora({"language_model": {"layers": tree, "embed_tokens": anchor}}, piece)
            tree = tree["language_model"]["layers"]
        tree = quantize_tree(tree) if quantize_int8 else tree
        return calibrate(tree, where) if calibrate is not None else tree

    return transform


def omchat_model(tokenizer, engine: OmChatEngine) -> OmChatModel:
    """An :class:`OmChatModel` over a ready engine (its config and params):
    the image processor and processor ``load_pretrained_model`` builds, for a
    model whose weights are already in memory."""
    config = engine.cfg
    image_processor = OmChatImageProcessor(
        crop_size=config.vision.image_size,
        shortest_edge=config.vision.image_size,
        image_grid_pinpoints=config.image_grid_pinpoints,
    )
    processor = OmChatProcessor(tokenizer, image_processor,
                                patch_expand=not config.mm_patch_merge_type.startswith("spatial"))
    return OmChatModel(tokenizer, engine, image_processor, processor, config,
                       config.tokenizer_model_max_length or 8192)


def paged_batch_engine(model: OmChatModel, **options) -> PagedBatchEngine:
    """A paged continuous-batching engine serving ``model``'s weights, by
    default on its device with its attention route and cache dtype
    (``options``: PagedBatchEngine's keyword arguments — max_slots,
    num_pages, page_size, max_len, decode_roll, prefill_chunk,
    image_cache_size, cache_dtype, decode_kernel, ...); under the model's
    mesh when it has one."""
    options = {"attn_impl": model.engine.attn_impl, "device": model.engine.device,
               "cache_dtype": model.engine.cache_dtype, "mesh": model.engine.mesh, **options}
    return PagedBatchEngine(model.config, model.engine.params, **options)


def batch_engine(model: OmChatModel, **options) -> BatchEngine:
    """A slot continuous-batching engine (one shared contiguous cache)
    serving ``model``'s weights, by default on its device with its attention
    route and cache dtype (``options``: BatchEngine's keyword arguments —
    max_slots, max_len, chunk_size, image_cache_size, cache_dtype,
    lora_bank, ...); under the model's mesh when it has one."""
    options = {"attn_impl": model.engine.attn_impl, "device": model.engine.device,
               "cache_dtype": model.engine.cache_dtype, "mesh": model.engine.mesh, **options}
    return BatchEngine(model.config, model.engine.params, **options)
