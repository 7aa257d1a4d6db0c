"""One-command checkpoint parity runbook — the port's counterpart of
``cli/parity.py`` (the BASELINE.json north star).

    python -m omchat_torch.cli.parity --model-path CKPT [--image img.jpg] [--question "What is this?"] \\
        [--max-new-tokens 32] [--per-module] [--attn-impl plain|kernels] [--device cuda]

Runs the fp32 reference twin (the checkpoint's own ``trust_remote_code``
bundle when present, else the port's copy of the bundle code loaded with the
same weights) and the port's engine side by side on the same prompt and image
and prints a JSON report: per-step argmax-match rate, first divergence, max
logit diff, engine-vs-twin greedy tokens; ``--per-module`` adds tower /
projector deltas.  ``--attn-impl plain`` (the default, as the JAX runbook
defaults to ``xla``) runs the engine on the plain route in fp32, the truth
comparison; ``kernels`` runs it on the hand-written kernels in bf16.  Both
sides run on the card unless ``--device cpu`` (which takes the plain route:
the kernels need the card).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

ROUTES = {"plain": ("plain", torch.float32), "kernels": (None, torch.bfloat16)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--image", default=None, help="image path (omit for text-only parity)")
    parser.add_argument("--question", default="What is shown in this image?")
    parser.add_argument("--max-new-tokens", type=int, default=32)
    parser.add_argument("--per-module", action="store_true", help="also report tower/projector max deltas")
    parser.add_argument("--attn-impl", default="plain", choices=sorted(ROUTES),
                        help="the engine's route: plain (default; fp32, the truth comparison) or kernels (bf16, "
                        "the hand-written CUDA kernels)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu (plain PyTorch path)")
    args = parser.parse_args(argv)
    if args.attn_impl == "kernels" and args.device == "cpu":
        parser.error("--attn-impl kernels needs the card: the CPU runs the plain route")

    from omchat_torch.api import load_pretrained_model
    from omchat_torch.eval.parity import load_torch_twin, run_parity

    attn_impl, dtype = ROUTES[args.attn_impl]
    model = load_pretrained_model(args.model_path, dtype=dtype, attn_impl=attn_impl, device=args.device)
    torch_model, source = load_torch_twin(args.model_path, params=model.engine.params, device=args.device)
    print(f"[parity] torch twin: {source}", file=sys.stderr)

    image = None
    if args.image:
        from PIL import Image

        image = Image.open(args.image).convert("RGB")
    inputs = model.processor(args.question, images=image)
    images = np.asarray(inputs["images"], np.float32) if "images" in inputs else None

    report = run_parity(model, torch_model, np.asarray(inputs["input_ids"][0]).tolist(), images,
                        max_new_tokens=args.max_new_tokens, per_module=args.per_module)
    report["torch_twin"] = source
    report["attn_impl"] = args.attn_impl
    report["torch_text"] = model.tokenizer.decode(report["torch_tokens"], skip_special_tokens=True)
    report["engine_text"] = model.tokenizer.decode(report["engine_tokens"], skip_special_tokens=True)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
