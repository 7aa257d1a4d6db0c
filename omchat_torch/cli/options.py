"""The model-loading flags the port's three serving CLIs share
(``single_inference``, ``chat``, ``serve``) and the load they drive."""

from __future__ import annotations

import argparse


def add_model_flags(parser: argparse.ArgumentParser) -> None:
    """--model-path, --int8, --w8a8, --kv-cache-dtype, --lora, --device and
    --tp (refused above 1 by :func:`load_model`)."""
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--int8", action="store_true", help="int8 weight-only quantization")
    parser.add_argument("--w8a8", action="store_true",
                        help="w8a8 serving mode: int8 activations and weights for the ViT encode and the prefill "
                             "(implies --int8; calibrates static fc1 scales at load)")
    parser.add_argument("--kv-cache-dtype", choices=["bf16", "fp8"], default="bf16",
                        help="KV-cache storage dtype; fp8 (e4m3) halves the cache's bytes, the kernels widen on load")
    parser.add_argument("--lora", type=str, default=None,
                        help="LoRA adapter directory to merge into the base weights at load")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu (plain PyTorch path)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree (multi-device: waits for ROADMAP queue A item 13)")


def refuse_waiting(parser: argparse.ArgumentParser, waiting: dict) -> None:
    """A usage error (exit code 2) for the first of ``waiting`` ({flag:
    (asked, ROADMAP queue A item)}) that was asked for, naming the item that
    will bring it; run before any weight loads."""
    for flag, (asked, item) in waiting.items():
        if asked:
            parser.error(f"{flag}: not ported yet (ROADMAP queue A item {item}); the port refuses it rather than "
                         "ignoring it")


def load_model(parser: argparse.ArgumentParser, args):
    """``api.load_pretrained_model`` per the flags; ``--tp`` above 1 is a
    usage error naming the queue item it waits for."""
    refuse_waiting(parser, {"--tp above 1 (tensor parallelism; the port serves on one device)": (args.tp > 1, "13")})
    from omchat_torch.api import load_pretrained_model
    from omchat_torch.ops.fp8 import E4M3

    return load_pretrained_model(args.model_path, quantize_int8=args.int8, w8a8=args.w8a8, device=args.device,
                                 cache_dtype=E4M3 if args.kv_cache_dtype == "fp8" else None, lora_path=args.lora)
