"""Interactive multi-turn chat on the GPU — the port's counterpart of
``cli/chat.py``: history is threaded through ``make_context`` each turn
(``--no-history`` drops it, the reference's per-turn-independent behaviour).

    printf "hello\\nand then?\\n\\n" | python -m omchat_torch.cli.chat --model-path CKPT [--image-path IMG] \\
        [--int8 | --w8a8] [--kv-cache-dtype fp8] [--lora ADAPTER] [--speculative]

An empty line or end of input exits.  Under ``torchrun --nproc-per-node N
... --tp N`` rank 0 reads each line and broadcasts it; every rank runs the
turn on its shard, and only rank 0 prints.
"""

from __future__ import annotations

import argparse

from omchat_torch.cli.options import add_model_flags, is_leader, load_model


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

    from omchat_torch.parallel.serving import agreed

    model = load_model(parser, args)
    lead = is_leader(model)
    say = print if lead else (lambda *a, **kw: None)
    image = Image.open(args.image_path).convert("RGB") if args.image_path else None
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens)
    history = []
    say("omchat chat — empty line to exit")
    read = agreed(model.engine.mesh, _read_question)  # rank 0 reads stdin; every rank gets the line
    while True:
        question = read()
        if not question:
            break
        say("assistant: ", end="", flush=True)
        answer = model.chat(question, image=image, history=None if args.no_history else list(history),
                            generation=gen, stream_callback=make_stdout_streamer(model.tokenizer) if lead else None,
                            speculative=args.speculative)
        say()
        history.append((question, answer))


def _read_question() -> str:
    """The next line of stdin, stripped; "" at its end."""
    try:
        return input("user: ").strip()
    except (EOFError, KeyboardInterrupt):
        return ""


if __name__ == "__main__":
    main()
