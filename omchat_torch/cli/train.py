"""Multimodal fine-tuning entry point — the port's counterpart of ``cli/train.py``.

LLaVA-style JSONL data (``{"image": ..., "conversations": [{"from": "human" /
"gpt", "value": ...}]}``), anyres tiling, ChatML targets with -100 on prompt
and image rows, an AdamW step with per-layer remat, train-state checkpoints
with auto-resume, JSONL metrics.  Runs on one device: CUDA by default (the
hand-written training attention kernels), ``--device cpu`` for the plain
PyTorch path.

    python -m omchat_torch.cli.train --synthetic 20 --device cpu    # the tiny random model
    python -m omchat_torch.cli.train --synthetic 2 --warmup 0    # the tiny random model on the card
    python -m omchat_torch.cli.train --model-path CKPT --data train.jsonl --image-root IMGS --lora-rank 16

Modes: stage-1 (``--tune-mm-mlp-adapter``, the projector alone, saved as
``mm_projector.safetensors``), stage-2 (every weight; ``--pretrain-mm-mlp-
adapter`` warm-starts the projector), LoRA / QLoRA (``--lora-rank``,
``--qlora``; the adapter is saved under ``<output-dir>/adapter``), text-only
packing (``--pack``).

Several ranks (``torchrun``, one process a rank): the batch splits over the
data-parallel ranks, ``--tp N`` shards the model Megatron-style over N ranks
(any N up to the q heads; k_proj / v_proj stay whole where N does not divide
the kv heads), ``--sequence-parallel`` adds Megatron sequence parallelism to
it, ``--cp N`` splits the sequence over N ranks with ring attention and
``--ulysses P`` with Ulysses' all-to-alls, and ``--fsdp`` shards the layer
kernels over the data ranks
(:func:`omchat_torch.training.train_step.make_sharded_train_step`);
``--pp N`` splits the trunk's layers into N GPipe stages, one a rank, and
streams ``--pp-microbatches`` microbatches through them
(:func:`omchat_torch.training.train_step.make_pp_train_step`):

    torchrun --standalone --nproc-per-node 2 -m omchat_torch.cli.train --synthetic 20 --device cpu --tp 2
    torchrun --standalone --nproc-per-node 4 -m omchat_torch.cli.train --synthetic 20 --tp 2 --fsdp
    torchrun --standalone --nproc-per-node 2 -m omchat_torch.cli.train --synthetic 3 --cp 2
    torchrun --standalone --nproc-per-node 2 -m omchat_torch.cli.train --synthetic 3 --device cpu --pp 2

Each rank takes ``cuda:LOCAL_RANK`` over NCCL when every rank has a card of
its own, else shares ``cuda:0`` over gloo (NCCL refuses two ranks on one
card); on the CPU the backend is gloo.  Checkpoints hold the canonical,
gathered tree (rank 0 writes them), so a run resumes at any world size;
under ``--pp`` the tree is JAX's staged one ([S, L/S, ...] trunk layers),
which resumes at the same ``--pp`` only.  ``ckpt/TRAIN_META.json`` records
the degree on every run, and a resume at another one is refused.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import threading
import time

import numpy as np
import torch

from omchat_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from omchat_torch.parallel.launch import init_world, launched_world

EOS = 151645


def pack_batch(cfg, batch_ids, batch_label_spans, pixels) -> dict:
    """ids + (answer_start, answer_end) spans → batch dict of CPU tensors."""
    from omchat_torch.models.omchat import plan_multimodal_merge

    plan = plan_multimodal_merge(batch_ids, cfg.image_seq_len, bucket=128)
    labels = np.full_like(plan.token_ids, IGNORE_INDEX)
    for i, (a0, a1) in enumerate(batch_label_spans):
        labels[i, a0:a1] = plan.token_ids[i, a0:a1]
    labels[plan.is_image] = IGNORE_INDEX
    out = {
        "token_ids": torch.from_numpy(plan.token_ids),
        "is_image": torch.from_numpy(plan.is_image),
        "image_index": torch.from_numpy(plan.image_index),
        "positions": torch.from_numpy(plan.positions),
        "labels": torch.from_numpy(labels),
    }
    if pixels is not None:
        out["pixel_values"] = torch.from_numpy(np.asarray(pixels, np.float32))
    return out


def synthetic_batch(cfg, batch: int, rng: np.random.Generator) -> dict:
    n_text = 48
    ids = [5, 6, IMAGE_TOKEN_INDEX] + rng.integers(10, cfg.text.vocab_size, n_text).tolist()
    merged_len = 2 + cfg.image_seq_len + n_text  # the sentinel expands to image_seq_len rows
    spans = [(merged_len - 16, merged_len)] * batch  # loss on the tail tokens
    pixels = rng.standard_normal((batch, 3, cfg.vision.image_size, cfg.vision.image_size)).astype(np.float32)
    return pack_batch(cfg, [ids] * batch, spans, pixels)


def _turns(rec):
    convs = rec["conversations"]
    turns = [(convs[i]["value"], convs[i + 1]["value"]) for i in range(0, len(convs) - 1, 2)]
    return turns[:-1], turns[-1]


def jsonl_batches(path, image_root, tokenizer, cfg, batch_size, epochs=1000000):
    """LLaVA-style SFT data → batches; loss on the final assistant turn
    (earlier turns enter as ChatML history)."""
    from PIL import Image

    from omchat_torch.processing.chat import image_prompt, make_context
    from omchat_torch.processing.image_processor import process_anyres_image

    records = [json.loads(line) for line in open(path) if line.strip()]
    for _ in range(epochs):
        batch_ids, spans, tiles = [], [], []
        for rec in records:
            history, (q, answer) = _turns(rec)
            sample_tiles = None
            if rec.get("image"):
                img = Image.open(os.path.join(image_root, rec["image"])).convert("RGB")
                sample_tiles = process_anyres_image(img, cfg.image_grid_pinpoints, cfg.vision.image_size)
                q = image_prompt(q, sample_tiles.shape[0])
            else:
                q = q.replace("<image>", "").strip()
            history = [(hq.replace("<image>", "").strip(), ha) for hq, ha in history]
            _, context = make_context(tokenizer, q, history, "You are a helpful assistant.")
            target = tokenizer.encode(answer) + [EOS]
            ids = context + target
            n_img = sum(1 for t in ids if t == IMAGE_TOKEN_INDEX)
            merged_len = len(ids) + n_img * (cfg.image_seq_len - 1)
            spans.append((merged_len - len(target), merged_len))
            batch_ids.append(ids)
            if sample_tiles is not None:
                tiles.append(sample_tiles)
            if len(batch_ids) == batch_size:
                pixels = np.concatenate(tiles, axis=0) if tiles else None
                yield pack_batch(cfg, batch_ids, spans, pixels)
                batch_ids, spans, tiles = [], [], []


def pack_rows(rows, seq_len) -> dict:
    """[[(ids, target_len), ...] per row] → padded packed batch (CPU tensors).

    Positions restart at 0 per segment, segment_ids isolate attention, labels
    cover each sample's target span only; padding carries segment -1 and
    IGNORE labels.  The loss shift is boundary-safe: position (segment_end - 1)
    is labelled with the next sample's first context token, always IGNORE."""
    b = len(rows)
    tok = np.zeros((b, seq_len), np.int32)
    pos = np.zeros((b, seq_len), np.int32)
    seg = np.full((b, seq_len), -1, np.int32)
    lab = np.full((b, seq_len), IGNORE_INDEX, np.int32)
    for i, row in enumerate(rows):
        off = 0
        for s_idx, (ids, tlen) in enumerate(row):
            n = len(ids)
            tok[i, off : off + n] = ids
            pos[i, off : off + n] = np.arange(n)
            seg[i, off : off + n] = s_idx
            lab[i, off + n - tlen : off + n] = ids[n - tlen :]
            off += n
    return {
        "token_ids": torch.from_numpy(tok),
        "is_image": torch.zeros((b, seq_len), dtype=torch.bool),
        "image_index": torch.zeros((b, seq_len), dtype=torch.int32),
        "positions": torch.from_numpy(pos),
        "labels": torch.from_numpy(lab),
        "segment_ids": torch.from_numpy(seg),
    }


def jsonl_packed_batches(path, tokenizer, cfg, batch_size, seq_len, epochs=1000000, logger=None):
    """Text-only SFT with sequence packing: samples concatenated into fixed
    [batch, seq_len] rows (greedy first-fit in file order).  Samples longer
    than seq_len are skipped (counted, reported once)."""
    from omchat_torch.processing.chat import make_context

    records = [json.loads(line) for line in open(path) if line.strip()]
    samples, skipped = [], 0
    for rec in records:
        if rec.get("image"):
            raise ValueError("--pack supports text-only datasets; train image data unpacked (drop --pack)")
        history, (q, answer) = _turns(rec)
        _, context = make_context(
            tokenizer, q.replace("<image>", "").strip(),
            [(hq.replace("<image>", "").strip(), ha) for hq, ha in history],
            "You are a helpful assistant.",
        )
        target = tokenizer.encode(answer) + [EOS]
        ids = context + target
        if len(ids) > seq_len:
            skipped += 1
            continue
        samples.append((ids, len(target)))
    if not samples:
        raise ValueError(f"no sample fits --pack {seq_len}")
    if skipped and logger is not None:
        logger.warning("packing: skipped %d/%d samples longer than %d tokens", skipped, len(records), seq_len)
    batch_rows, row, row_len = [], [], 0
    for _ in range(epochs):
        for ids, tlen in samples:
            if row_len + len(ids) > seq_len:
                batch_rows.append(row)
                row, row_len = [], 0
                if len(batch_rows) == batch_size:
                    yield pack_rows(batch_rows, seq_len)
                    batch_rows = []
            row.append((ids, tlen))
            row_len += len(ids)
        # the epoch's open row carries into the next pass (no samples lost)


def prefetch(iterator, depth: int = 2):
    """Host preprocessing (tokenize, tile, pack) in a background thread; a
    failure there is raised in the caller."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    error: list = []

    def feeder():
        try:
            for b in iterator:
                q.put(b)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            error.append(e)
        finally:
            q.put(None)

    threading.Thread(target=feeder, daemon=True, name="data-prefetch").start()
    while True:
        b = q.get()
        if b is None:
            if error:
                raise RuntimeError("data prefetch thread failed") from error[0]
            return
        yield b


def to_device(batch: dict, device, dtype) -> dict:
    """Batch tensors onto the device; pixels in the model's dtype."""
    return {k: v.to(device=device, dtype=dtype if k == "pixel_values" else v.dtype, non_blocking=True)
            for k, v in batch.items()}


def random_model_spec(device: torch.device):
    """(cfg, dtype) of the random model on ``device``: the tiny test model
    (``OmChatConfig.tiny()``, as JAX's CLI builds without ``--model-path``),
    in fp32 on the CPU and in bf16, the dtype the CUDA kernels take, on CUDA."""
    from omchat_torch.config import OmChatConfig

    return OmChatConfig.tiny(), torch.float32 if device.type == "cpu" else torch.bfloat16


def random_model(device: torch.device, seed: int = 0):
    """(cfg, params) of :func:`random_model_spec`'s model from a seeded generator."""
    from omchat_torch.models import intern_vit, projector, qwen2

    cfg, dtype = random_model_spec(device)
    g = torch.Generator(device=device).manual_seed(seed)
    return cfg, {
        "vision_tower": intern_vit.init_params(cfg.vision, g, dtype, device),
        "projector": projector.init_params(cfg.projector, cfg.vision.hidden_size, cfg.text.hidden_size, g, dtype,
                                           device),
        "language_model": qwen2.init_params(cfg.text, g, dtype, device),
    }


def _data_iter(args, cfg, logger):
    if not args.data:
        return None
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(args.model_path, use_fast=True)
    if args.pack:
        raw = jsonl_packed_batches(args.data, tokenizer, cfg, args.batch_size, args.pack, logger=logger)
    else:
        raw = jsonl_batches(args.data, args.image_root, tokenizer, cfg, args.batch_size)
    return prefetch(raw)


def _train_lora(args, cfg, params, total, logger, device, dtype):
    """LoRA / QLoRA: rank-sized adapters over the frozen base, periodic
    checkpoints with auto-resume, the adapter written at the end."""
    from omchat_torch.checkpoint.save import TrainCheckpointer, save_lora_adapter
    from omchat_torch.ops.linear import quantize_tree
    from omchat_torch.training.lora import init_lora, lora_leaves, lora_train_step
    from omchat_torch.training.schedules import warmup_cosine_schedule
    from omchat_torch.training.train_step import AdamW
    from omchat_torch.utils.logging import JsonlMetricsWriter, MetricLogger

    if args.qlora:
        lm = dict(params["language_model"])
        lm["layers"] = quantize_tree(lm["layers"])
        params = {**params, "language_model": lm}
    targets = tuple(t.strip() for t in args.lora_targets.split(",") if t.strip())
    lora = init_lora(torch.Generator(device=device).manual_seed(0), params, rank=args.lora_rank,
                     alpha=args.lora_alpha, targets=targets)
    schedule = warmup_cosine_schedule(args.lr, total_steps=total, warmup_steps=args.warmup)
    optimizer = AdamW(schedule, grad_clip=args.grad_clip if args.grad_clip > 0 else None, grad_accum=args.grad_accum)
    opt_state = optimizer.init(lora_leaves(lora))

    ckpt = TrainCheckpointer(os.path.join(args.output_dir, "ckpt"))
    state, resumed = ckpt.restore({"lora": lora, "opt": opt_state})
    lora, opt_state = state["lora"], state["opt"]
    start_step = resumed + 1 if resumed is not None else 0
    if resumed is not None:
        logger.info(f"auto-resumed LoRA training from step {resumed}")

    metrics = JsonlMetricsWriter(os.path.join(args.output_dir, "metrics.jsonl"))
    meter = MetricLogger()
    rng = np.random.default_rng(0)
    data_iter = _data_iter(args, cfg, logger)
    for step in range(start_step, total):
        batch = next(data_iter) if data_iter is not None else synthetic_batch(cfg, args.batch_size, rng)
        batch = to_device(batch, device, dtype)
        t0 = time.time()
        lora, opt_state, loss = lora_train_step(lora, opt_state, params, cfg, batch, optimizer)
        loss_f = float(loss)
        meter.update(loss=loss_f, step_time=time.time() - t0)
        metrics.update(step, loss=loss_f, lr=float(schedule(step)))
        if step % 10 == 0:
            logger.info(f"step {step}: {meter}")
        if step > 0 and step % 50 == 0:
            ckpt.save(step, {"lora": lora, "opt": opt_state})
    adapter_dir = os.path.join(args.output_dir, "adapter")
    save_lora_adapter(adapter_dir, lora, base_model=args.model_path)
    logger.info(f"adapter saved to {adapter_dir}")


LAUNCH = "torchrun --standalone --nproc-per-node N -m omchat_torch.cli.train ..."


def _train_meta(args, parser, world: int) -> None:
    """JAX's ``ckpt/TRAIN_META.json``: the pipeline degree the checkpoints
    were written with (a ``--pp`` checkpoint holds the staged [S, L/S, ...]
    layers).  A resume at another degree is refused with JAX's message; a
    run without the file writes it (rank 0, after every rank has looked)."""
    import torch.distributed as dist

    path = os.path.join(args.output_dir, "ckpt", "TRAIN_META.json")
    if os.path.exists(path):
        with open(path) as f:
            saved_pp = json.load(f).get("pp", 1)
        if saved_pp != args.pp:
            parser.error(f"checkpoints in {args.output_dir}/ckpt were written with --pp {saved_pp} (staged "
                         f"[S, L/S, ...] param layout); resume with --pp {saved_pp} or start a fresh --output-dir")
        return
    if world > 1:
        dist.barrier()
    if not dist.is_initialized() or dist.get_rank() == 0:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"pp": args.pp}, f)


def _train_sharded(args, cfg, params, total, logger, device, parser):
    """Full or stage-1 training over a (data, model) mesh of the launched
    ranks, a (data, context) mesh under ``--cp`` / ``--ulysses``, or a
    ``("stage",)`` mesh of the first ``--pp`` ranks (the others hold no
    stage and leave); rank 0 writes the metrics, the checkpoints (the tree
    gathered from every rank: the canonical one, or under ``--pp`` JAX's
    staged one) and the stage-1 projector."""
    import torch.distributed as dist

    from omchat_torch.checkpoint.save import TrainCheckpointer, save_mm_projector
    from omchat_torch.parallel.mesh import create_cp_mesh, create_mesh, create_pp_mesh
    from omchat_torch.parallel.sharding import (canonical_shapes, check_trunk_tp, omchat_param_specs,
                                                specs_without_axis)
    from omchat_torch.training.schedules import warmup_cosine_schedule
    from omchat_torch.training.train_step import (AdamW, gather_state, init_train_state, make_pp_train_step,
                                                  make_sharded_train_step, pp_param_specs, shard_state, stage_params)
    from omchat_torch.utils.logging import JsonlMetricsWriter, MetricLogger

    world = launched_world()
    cp = max(args.cp, args.ulysses)
    shapes = canonical_shapes(params)
    if args.pp > 1:
        mesh = create_pp_mesh(args.pp)
        if not mesh.holds_rank:
            logger.info(f"rank {dist.get_rank()} holds no stage: --pp {args.pp} runs on ranks 0-{args.pp - 1} of "
                        f"{world}, and this rank stays idle")
            return
        staged = stage_params(params, args.pp)
        specs, shapes = pp_param_specs(staged), canonical_shapes(staged)
        del staged
    elif cp > 1:
        if args.ulysses > 1 and cfg.text.num_attention_heads % args.ulysses != 0:
            parser.error(f"--ulysses {args.ulysses} must divide the attention head count "
                         f"{cfg.text.num_attention_heads}")
        if world % cp:
            parser.error(f"--{'cp' if args.cp > 1 else 'ulysses'} {cp} does not divide the world of {world} ranks")
        mesh = create_cp_mesh(cp=cp)
        specs = specs_without_axis(omchat_param_specs(cfg, params, fsdp=args.fsdp), "model")
    else:
        if world % args.tp:
            parser.error(f"--tp {args.tp} does not divide the world of {world} ranks")
        try:
            check_trunk_tp(cfg.text, args.tp)
        except ValueError as e:
            parser.error(f"--tp {args.tp}: {e}")
        mesh = create_mesh(tp=args.tp)
        specs = omchat_param_specs(cfg, params, fsdp=args.fsdp)
    if args.batch_size % mesh.dp != 0:
        parser.error(f"--batch-size {args.batch_size} must be divisible by the data-parallel degree {mesh.dp} "
                     f"(= devices/{'cp' if cp > 1 else 'tp'})")
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    schedule = warmup_cosine_schedule(args.lr, total_steps=total, warmup_steps=args.warmup)
    optimizer = AdamW(schedule, grad_clip=args.grad_clip if args.grad_clip > 0 else None, grad_accum=args.grad_accum)
    trainable = (lambda path: path[0] == "projector") if args.tune_mm_mlp_adapter else None
    pp_micro = args.pp_microbatches or args.batch_size
    if args.pp > 1:
        step_fn, shard_batch, place = make_pp_train_step(cfg, mesh, optimizer, microbatches=pp_micro)
    else:
        step_fn, shard_batch, place = make_sharded_train_step(cfg, mesh, specs, optimizer,
                                                              sequence_parallel=args.sequence_parallel,
                                                              context_parallel=args.cp > 1, ulysses=args.ulysses > 1)
    ckpt = TrainCheckpointer(os.path.join(args.output_dir, "ckpt"))
    saved, resumed = ckpt.load_latest()
    if saved is None:
        state = init_train_state(place(params), optimizer, trainable)
    else:
        state = shard_state(saved, mesh, specs, optimizer, trainable, device)
    del saved, params
    start_step = resumed + 1 if resumed is not None else 0
    state.step = start_step
    if resumed is not None:
        logger.info(f"auto-resumed from step {resumed} (" + ("a staged checkpoint, each stage taken by its rank)"
                                                              if args.pp > 1 else
                                                              "a canonical checkpoint, re-sharded for this mesh)"))
    if args.pp > 1:
        logger.info(f"GPipe pipeline: {args.pp} stages x {cfg.text.num_hidden_layers // args.pp} layers, "
                    f"{pp_micro} microbatches/step")
    else:
        split = "ring" if args.cp > 1 else "ulysses" if args.ulysses > 1 else "sequence-parallel" \
            if args.sequence_parallel else "none"
        logger.info(f"mesh {mesh.shape}: tp {mesh.tp}, dp {mesh.dp}, fsdp {args.fsdp}, sequence split {split}")

    def save(step):
        full = gather_state(state, mesh, specs, shapes)
        if rank0:
            ckpt.save(step, full)
        if dist.is_initialized():
            dist.barrier(group=mesh.world_group)
        return full

    metrics = JsonlMetricsWriter(os.path.join(args.output_dir, "metrics.jsonl")) if rank0 else None
    meter = MetricLogger()
    rng = np.random.default_rng(0)
    data_iter = _data_iter(args, cfg, logger)
    dtype = state.params["language_model"]["embed_tokens"].dtype
    for step in range(start_step, total):
        batch = next(data_iter) if data_iter is not None else synthetic_batch(cfg, args.batch_size, rng)
        batch = to_device(shard_batch(batch), device, dtype)
        t0 = time.time()
        state, loss = step_fn(state, cfg, batch)
        loss_f = float(loss)
        meter.update(loss=loss_f, step_time=time.time() - t0)
        if metrics is not None:
            metrics.update(step, loss=loss_f, lr=float(schedule(step)))
        if step % 10 == 0:
            logger.info(f"step {step}: {meter}")
        if step > 0 and step % 50 == 0:
            save(step)
    if ckpt.latest_step() != total - 1 and total > start_step:
        full = save(total - 1)
        if args.tune_mm_mlp_adapter and rank0:
            path = save_mm_projector(args.output_dir, full["params"]["projector"])
            logger.info(f"projector-only checkpoint saved to {path}")
    logger.info("done")


def main(argv=None):
    parser = argparse.ArgumentParser(description="OmChat fine-tuning (PyTorch port): one device, or the ranks "
                                                 "that torchrun launches")
    parser.add_argument("--model-path", default=None,
                        help="checkpoint to fine-tune (None = the tiny test model's random weights from seed 0: "
                             "fp32 on the CPU, bf16 on CUDA)")
    parser.add_argument("--data", default=None, help="LLaVA-style JSONL dataset")
    parser.add_argument("--image-root", default="", help="image directory for --data")
    parser.add_argument("--synthetic", type=int, default=0, help="run N synthetic steps (smoke mode)")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--warmup", type=int, default=10)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--grad-clip", type=float, default=1.0,
                        help="global-norm gradient clipping (HF Trainer max_grad_norm default); 0 disables")
    parser.add_argument("--grad-accum", type=int, default=1, help="micro-batches per optimizer update")
    parser.add_argument("--pack", type=int, default=0, metavar="SEQ_LEN",
                        help="text-only sequence packing into [batch, SEQ_LEN] rows with segment-isolated "
                             "attention (the training kernels skip cross-document tiles)")
    parser.add_argument("--lora-rank", type=int, default=0,
                        help="train rank-r LoRA adapters over a frozen base instead of full fine-tuning (0 = off)")
    parser.add_argument("--lora-alpha", type=float, default=None, help="LoRA scale numerator (default: rank)")
    parser.add_argument("--lora-targets", default="q_proj,k_proj,v_proj,o_proj",
                        help="comma-separated linears to adapt (add gate_proj,up_proj,down_proj for MLP)")
    parser.add_argument("--qlora", action="store_true", help="hold the frozen trunk in int8 (QLoRA)")
    parser.add_argument("--tune-mm-mlp-adapter", action="store_true",
                        help="stage-1: train only the multimodal projector and save mm_projector.safetensors")
    parser.add_argument("--pretrain-mm-mlp-adapter", default=None, metavar="PATH",
                        help="load projector weights from a stage-1 checkpoint before training")
    parser.add_argument("--output-dir", default="./train_out")
    parser.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor parallelism: shard the model Megatron-style over N ranks of a launched world "
                             f"({LAUNCH}); the other ranks' factor is data parallelism")
    parser.add_argument("--cp", type=int, default=1,
                        help="context parallelism: shard the sequence axis over a 'context' mesh axis with ring "
                             "attention (long-context training; requires merged seq len %% cp == 0; incompatible "
                             "with --tp/--sequence-parallel)")
    parser.add_argument("--ulysses", type=int, default=1, metavar="P",
                        help="Ulysses sequence parallelism: shard the sequence axis over a 'context' mesh axis; "
                             "attention re-shards head-wise via all-to-all so each rank runs full-sequence "
                             "attention on H/P heads (requires merged seq len %% P == 0 and attention heads %% P "
                             "== 0; incompatible with --tp/--cp/--sequence-parallel)")
    parser.add_argument("--sequence-parallel", action="store_true",
                        help="Megatron sequence parallelism: the trunk's norms and residual stream on each "
                             "tensor-parallel rank's block of the sequence (with --tp)")
    parser.add_argument("--pp", type=int, default=1,
                        help="GPipe pipeline parallelism: split the decoder trunk into N contiguous layer stages "
                             "(params one stage per rank over a 'stage' mesh of a launched world) and stream "
                             "microbatches through them with point-to-point handoffs; the backward runs the "
                             "fill-drain schedule mirrored. For models beyond TP reach; requires layers %% pp == 0; "
                             "incompatible with --tp/--fsdp/--cp/--sequence-parallel/--lora-rank")
    parser.add_argument("--pp-microbatches", type=int, default=0, metavar="M",
                        help="microbatches per --pp step (default: batch size, i.e. one-row microbatches for the "
                             "smallest pipeline bubble; must divide --batch-size)")
    parser.add_argument("--fsdp", action="store_true",
                        help="shard the layer kernels over the data-parallel ranks (gathered layer by layer)")
    args = parser.parse_args(argv)

    world = launched_world()
    if args.lora_rank > 0 and (args.tp != 1 or args.fsdp or args.sequence_parallel or args.cp > 1
                               or args.ulysses > 1 or args.pp > 1):
        parser.error("--lora-rank trains single-device adapters; drop --tp/--fsdp/--cp/--pp/--ulysses/"
                     "--sequence-parallel")
    if args.lora_rank > 0 and world > 1:
        parser.error("--lora-rank trains single-device adapters; launch one process")
    if (args.cp > 1 or args.ulysses > 1) and (args.tp != 1 or args.sequence_parallel
                                              or (args.cp > 1 and args.ulysses > 1)):
        parser.error("--cp/--ulysses are incompatible with --tp/--sequence-parallel and each other")
    if args.pp > 1:
        if args.tp != 1 or args.sequence_parallel or args.fsdp or args.cp > 1 or args.ulysses > 1:
            parser.error("--pp is incompatible with --tp/--fsdp/--cp/--ulysses/--sequence-parallel")
        if args.tune_mm_mlp_adapter:
            parser.error("--pp does not support --tune-mm-mlp-adapter (stage-1 trains only the projector; PP "
                         "splits the trunk)")
        pp_micro = args.pp_microbatches or args.batch_size
        if args.batch_size % pp_micro != 0:
            parser.error(f"--pp-microbatches {pp_micro} must divide --batch-size {args.batch_size}")
    for flag, n, what in (("--tp", args.tp, "shards the model"), ("--cp", args.cp, "splits the sequence"),
                          ("--ulysses", args.ulysses, "splits the sequence"), ("--pp", args.pp, "splits the trunk")):
        if n > 1 and world == 1:
            parser.error(f"{flag} {n} {what} over {n} ranks: launch them with {LAUNCH}")
    if 1 < world < args.pp:
        parser.error(f"--pp {args.pp} needs {args.pp} devices; {world} available (launch {args.pp} ranks with "
                     f"{LAUNCH})")
    total = args.synthetic or args.steps
    if args.warmup >= total:
        parser.error(f"--warmup {args.warmup} must be < total steps {total}")
    if not args.data and not args.synthetic:
        parser.error("pass --data (JSONL dataset) or --synthetic N (smoke mode)")
    if args.pack and not args.data:
        parser.error("--pack packs a JSONL dataset; pass --data")
    if args.qlora and args.lora_rank <= 0:
        parser.error("--qlora requires --lora-rank")

    from omchat_torch.utils.device import resolve_device
    from omchat_torch.utils.logging import JsonlMetricsWriter, MetricLogger, build_logger

    device = resolve_device(args.device)
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", "0"))
    logger = build_logger("omchat.train", "train.log" if rank == 0 else f"train.rank{rank}.log",
                          log_dir=args.output_dir)
    created = False
    if world > 1:
        device, created = init_world(device, logger)

    if args.model_path:
        from omchat_torch.checkpoint.loader import load_omchat_checkpoint

        cfg, params = load_omchat_checkpoint(args.model_path, torch.bfloat16, device=device)
    else:
        cfg, params = random_model(device)
    dtype = params["language_model"]["embed_tokens"].dtype

    if args.pretrain_mm_mlp_adapter:
        from omchat_torch.checkpoint.loader import load_mm_projector

        params["projector"] = load_mm_projector(args.pretrain_mm_mlp_adapter, dtype, device=device)
        logger.info(f"projector warm-started from {args.pretrain_mm_mlp_adapter}")

    if args.lora_rank > 0:
        _train_lora(args, cfg, params, total, logger, device, dtype)
        return
    if cfg.text.num_hidden_layers % args.pp:
        parser.error(f"--pp {args.pp} must divide the decoder layer count {cfg.text.num_hidden_layers}")
    _train_meta(args, parser, world)
    if world > 1 or args.fsdp:  # --fsdp in a world of one: a mesh of one rank
        try:
            _train_sharded(args, cfg, params, total, logger, device, parser)
        finally:
            if created:
                dist.destroy_process_group()
        return

    from omchat_torch.checkpoint.save import TrainCheckpointer, save_mm_projector
    from omchat_torch.training.schedules import warmup_cosine_schedule
    from omchat_torch.training.train_step import AdamW, init_train_state, train_step

    schedule = warmup_cosine_schedule(args.lr, total_steps=total, warmup_steps=args.warmup)
    optimizer = AdamW(schedule, grad_clip=args.grad_clip if args.grad_clip > 0 else None, grad_accum=args.grad_accum)
    # stage-1 (the reference's tune_mm_mlp_adapter): only the projector trains
    trainable = (lambda path: path[0] == "projector") if args.tune_mm_mlp_adapter else None
    state = init_train_state(params, optimizer, trainable)

    ckpt = TrainCheckpointer(os.path.join(args.output_dir, "ckpt"))
    saved, resumed = ckpt.restore({"params": state.params, "opt_state": state.opt_state})
    state.params, state.opt_state = saved["params"], saved["opt_state"]
    # a checkpoint at step N holds the state after step N: resume at N + 1
    start_step = resumed + 1 if resumed is not None else 0
    state.step = start_step
    if resumed is not None:
        logger.info(f"auto-resumed from step {resumed}")

    metrics = JsonlMetricsWriter(os.path.join(args.output_dir, "metrics.jsonl"))
    meter = MetricLogger()
    rng = np.random.default_rng(0)
    data_iter = _data_iter(args, cfg, logger)
    for step in range(start_step, total):
        batch = next(data_iter) if data_iter is not None else synthetic_batch(cfg, args.batch_size, rng)
        batch = to_device(batch, device, dtype)
        t0 = time.time()
        state, loss = train_step(state, cfg, batch, optimizer)
        loss_f = float(loss)
        meter.update(loss=loss_f, step_time=time.time() - t0)
        metrics.update(step, loss=loss_f, lr=float(schedule(step)))
        if step % 10 == 0:
            logger.info(f"step {step}: {meter}")
        if step > 0 and step % 50 == 0:
            ckpt.save(step, {"params": state.params, "opt_state": state.opt_state})
    if ckpt.latest_step() != total - 1 and total > start_step:
        ckpt.save(total - 1, {"params": state.params, "opt_state": state.opt_state})
    if args.tune_mm_mlp_adapter:
        path = save_mm_projector(args.output_dir, state.params["projector"])
        logger.info(f"projector-only checkpoint saved to {path}")
    logger.info("done")


if __name__ == "__main__":
    main()
