"""Interactive multi-turn chat on the GPU — the port's counterpart of
``cli/chat.py``: history is threaded through ``make_context`` each turn
(``--no-history`` drops it, the reference's per-turn-independent behaviour).

    printf "hello\\nand then?\\n\\n" | python -m omchat_torch.cli.chat --model-path CKPT [--image-path IMG] \\
        [--int8 | --w8a8] [--kv-cache-dtype fp8] [--lora ADAPTER] [--speculative]

An empty line or end of input exits.
"""

from __future__ import annotations

import argparse

from omchat_torch.cli.options import add_model_flags, load_model


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_model_flags(parser)
    parser.add_argument("--image-path", type=str, default=None)
    parser.add_argument("--max-new-tokens", type=int, default=1024)
    parser.add_argument("--no-history", action="store_true", help="drop the history each turn")
    parser.add_argument("--speculative", action="store_true",
                        help="prompt-lookup speculative decoding (greedy; pays off where replies echo the context)")
    args = parser.parse_args(argv)

    from PIL import Image

    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.generate import make_stdout_streamer

    model = load_model(parser, args)
    image = Image.open(args.image_path).convert("RGB") if args.image_path else None
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens)
    history = []
    print("omchat chat — empty line to exit")
    while True:
        try:
            question = input("user: ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not question:
            break
        print("assistant: ", end="", flush=True)
        answer = model.chat(question, image=image, history=None if args.no_history else list(history),
                            generation=gen, stream_callback=make_stdout_streamer(model.tokenizer),
                            speculative=args.speculative)
        print()
        history.append((question, answer))


if __name__ == "__main__":
    main()
