"""Checkpoint conversion — the port's counterpart of ``cli/convert.py``.

    python -m omchat_torch.cli.convert --input CKPT --output BUNDLE [--dtype bfloat16] [--device cuda]

Reads a checkpoint in either key layout (repo-native ``model.vision_tower...``
or HF-bundle ``vision_tower...``) through the port's
``load_omchat_checkpoint`` and writes the canonical HF bundle through its
``export_hf_bundle``: sharded safetensors, ``config.json`` with the
``auto_map``, the ``trust_remote_code`` code files, the processor configs and
the source's tokenizer files.  The weights are loaded on the card unless
``--device cpu``.  (int8 quantization happens at load time, as in JAX:
quantized tensors do not round-trip through the HF key layout.)
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--input", required=True, help="checkpoint dir (either key layout)")
    parser.add_argument("--output", required=True)
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float16", "float32"])
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    args = parser.parse_args(argv)

    from omchat_torch.checkpoint.loader import load_omchat_checkpoint
    from omchat_torch.checkpoint.save import export_hf_bundle
    from omchat_torch.utils.device import resolve_device

    config, params = load_omchat_checkpoint(args.input, getattr(torch, args.dtype),
                                            device=resolve_device(args.device))
    export_hf_bundle(config, params, args.output, source_dir=args.input)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
