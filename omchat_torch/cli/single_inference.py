"""Single-shot image or video Q&A on the GPU — the port's counterpart of
``cli/single_inference.py`` (same prompt construction, streamed greedy
decode with eos 151645).

    python -m omchat_torch.cli.single_inference --model-path CKPT \\
        (--image-path IMG | --video-path VIDEO [--video-frames 32]) --question "What is in the picture?" \\
        [--int8 | --w8a8] [--kv-cache-dtype fp8] [--lora ADAPTER] [--speculative | --num-beams N]

Under ``torchrun --nproc-per-node N ... --tp N`` every rank runs the request
on its shard; only rank 0 prints.  ``--video-path`` takes an animated GIF / WebP, a directory of frame images
or (with imageio installed) a video container.
"""

from __future__ import annotations

import argparse

from omchat_torch.cli.options import add_model_flags, is_leader, load_model


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_model_flags(parser)
    parser.add_argument("--image-path", type=str, default=None)
    parser.add_argument("--video-path", type=str, default=None,
                        help="video QA: an animated GIF / WebP, a directory of frame images, or a container file "
                             "(imageio); uniform frame sampling")
    parser.add_argument("--video-frames", type=int, default=32,
                        help="frames sampled from --video-path (MMBench-Video uses 32)")
    parser.add_argument("--question", type=str, required=True)
    parser.add_argument("--max-new-tokens", type=int, default=1024)
    parser.add_argument("--speculative", action="store_true",
                        help="prompt-lookup speculative decoding (greedy; fewer device steps on echo-heavy outputs)")
    parser.add_argument("--num-beams", type=int, default=1,
                        help="beam search width (>1 disables streaming)")
    args = parser.parse_args(argv)
    if (args.image_path is None) == (args.video_path is None):
        parser.error("exactly one of --image-path / --video-path is required")

    from PIL import Image

    from omchat_torch.config import GenerationConfig
    from omchat_torch.processing.video import load_video_frames
    from omchat_torch.runtime.generate import make_stdout_streamer

    model = load_model(parser, args)
    lead = is_leader(model)
    stream = make_stdout_streamer(model.tokenizer) if lead else None
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens)
    if args.video_path is not None:
        frames = load_video_frames(args.video_path, num_samples=args.video_frames)
        model.chat_video(args.question, frames, num_samples=args.video_frames, generation=gen, stream_callback=stream)
    elif args.num_beams > 1:
        image = Image.open(args.image_path).convert("RGB")
        answer = model.chat(args.question, image=image, generation=gen, num_beams=args.num_beams)
        if lead:
            print(answer, end="")
    else:
        image = Image.open(args.image_path).convert("RGB")
        model.chat(args.question, image=image, generation=gen, stream_callback=stream, speculative=args.speculative)
    if lead:
        print()


if __name__ == "__main__":
    main()
