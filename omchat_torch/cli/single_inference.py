"""Single-shot image Q&A on the GPU — the port's counterpart of
``cli/single_inference.py`` (same prompt construction, streamed greedy
decode with eos 151645).

    python -m omchat_torch.cli.single_inference --model-path CKPT \\
        --image-path IMG --question "What is in the picture?"
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--image-path", type=str, required=True)
    parser.add_argument("--question", type=str, required=True)
    parser.add_argument("--max-new-tokens", type=int, default=1024)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu (plain PyTorch path)")
    args = parser.parse_args(argv)

    from PIL import Image

    from omchat_torch.api import load_pretrained_model
    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.generate import make_stdout_streamer

    model = load_pretrained_model(args.model_path, device=args.device)
    image = Image.open(args.image_path).convert("RGB")
    model.chat(args.question, image=image, generation=GenerationConfig(max_new_tokens=args.max_new_tokens),
               stream_callback=make_stdout_streamer(model.tokenizer))
    print()


if __name__ == "__main__":
    main()
