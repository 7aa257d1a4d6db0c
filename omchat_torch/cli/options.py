"""The model-loading flags the port's three serving CLIs share
(``single_inference``, ``chat``, ``serve``) and the load they drive.

``--tp N`` serves over N ranks launched by ``torchrun --nproc-per-node N``
(each rank holds its share of the weights and of the KV cache, every kv
head where N does not divide them; ranks that share one card meet over
gloo on ``cuda:0``, ranks with a card each over NCCL), with or without
``--int8`` / ``--w8a8`` / ``--lora``, on the dense or the MoE trunk.
``--tp N`` in a process that is not one of exactly N launched ranks is a
usage error before any weight loads.
"""

from __future__ import annotations

import argparse
import datetime
import logging

# the collectives' timeout in a serving world: a rank lost mid-call ends the others' wait
WORLD_TIMEOUT = datetime.timedelta(minutes=10)


def add_model_flags(parser: argparse.ArgumentParser) -> None:
    """--model-path, --int8, --w8a8, --kv-cache-dtype, --lora, --device and
    --tp."""
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
                        help="tensor-parallel degree: launch with torchrun --nproc-per-node N; each rank holds about "
                             "1/N of the weights and of the KV cache (every kv head where N does not divide them); "
                             "int8, w8a8, LoRA merges and the MoE trunk serve under it")


def check_tp(parser: argparse.ArgumentParser, args) -> None:
    """The usage errors of ``--tp``, before any weight loads: a tp below 1
    and a world that is not exactly ``--tp`` launched ranks."""
    from omchat_torch.parallel.launch import launched_world

    if args.tp < 1:
        parser.error("--tp must be at least 1")
    if args.tp == 1:
        return
    world = launched_world()
    if world != args.tp:
        parser.error(f"--tp {args.tp} serves over {args.tp} launched ranks: run it under torchrun --nproc-per-node "
                     f"{args.tp} (this process is a world of {world})")


def join_world(args):
    """This rank's device: for ``--tp`` above 1 after joining the launched
    world (NCCL with a card a rank, else gloo on ``cuda:0``, gloo on the
    CPU; a finite collective timeout); else ``--device``."""
    if args.tp == 1:
        return args.device
    import torch

    from omchat_torch.parallel.launch import init_world

    return init_world(torch.device(args.device), logging.getLogger("omchat_torch.cli"), WORLD_TIMEOUT)[0]


def load_model(parser: argparse.ArgumentParser, args):
    """``api.load_pretrained_model`` per the flags (under ``--tp`` this
    rank's shard over the launched world; :func:`check_tp` first)."""
    check_tp(parser, args)
    device = join_world(args)
    from omchat_torch.api import load_pretrained_model
    from omchat_torch.ops.fp8 import E4M3

    return load_pretrained_model(args.model_path, quantize_int8=args.int8, w8a8=args.w8a8, device=device,
                                 cache_dtype=E4M3 if args.kv_cache_dtype == "fp8" else None, lora_path=args.lora,
                                 tp=args.tp)


def is_leader(model) -> bool:
    """Whether this process speaks for the model: always on one rank; under
    a mesh, the model axis's first rank (it reads stdin, prints, serves
    HTTP)."""
    mesh = model.engine.mesh
    return mesh is None or mesh.axis_index("model") == 0
