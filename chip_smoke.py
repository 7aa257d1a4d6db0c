#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                 # all phases, one card

1. Header: the card's name and power limit, torch / CUDA versions, and the
   time to build the hand-written kernels from ``omchat_torch/csrc``.
2. Kernel phases: each kernel of the main path (K1-K4) at the main path's
   shapes, in bf16, held against its plain PyTorch version; kernel, plain,
   library (one PyTorch call computing the same function) and bound times.
3. End to end: ``OmChatConfig()`` at full width and depth (InternViT-6B +
   Qwen2-7B, random bf16 weights from a seeded generator), one 448x448 image
   (3 anyres tiles) and a question, greedy decode of 32 tokens through
   ``OmChatEngine.generate``; every kernel must have launched.
4. Kernel vs plain: the same model at full width and reduced depth, prefill
   through the kernels and through ``attn_impl="plain"``; first-token logits
   compared.

Prints one JSON line of per-kernel numbers before the last line, and as the
last line ``{"ok": true, "device": {...}}``.  Exits non-zero (printing no
result) when CUDA is unavailable, when the package is missing beside this
file, or when any phase fails.  Imports nothing of JAX or of omchat_tpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3

# Tolerances, bf16 on the card.  K1-K3 against their plain versions: the inputs
# plant high-scoring keys at the mask boundaries (phase 2), so outputs are O(1)
# there and a bf16 ulp is 0.0078 at |x| in [1, 2): rtol 1e-2 is about one ulp,
# atol covers the small outputs.  Each phase also checks that the plain version
# with a planted fault (a boundary column dropped or let in) falls outside.
ATTN_TOL = {"K1": (4e-3, 1e-2), "K2": (8e-3, 1e-2), "K3": (4e-3, 1e-2)}  # (atol, rtol)
NEW_TOKENS = 32
# phase 4, first-token logits through 2+2 layers, kernels vs the plain reference
# attention: the logits are bf16 values (ulp 0.031 at |x| in [4, 8)) and the two
# paths round softmax and q differently, so a few ulps at the largest logits.
LOGITS_ATOL, LOGITS_RTOL = 1e-1, 2e-2


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_close(name, got, ref, atol, rtol) -> float:
    import torch

    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside atol={atol} rtol={rtol}; "
                             f"max_abs_err={float(err.max()):.4g}")
    return float(err.max())


def check_fault_caught(name, fault, faulty, ref, atol, rtol) -> float:
    """The plain version with a planted fault must fall outside the tolerance,
    or the tolerance would pass a kernel with that fault."""
    dev = (faulty.float() - ref.float()).abs()
    if not (dev > atol + rtol * ref.float().abs()).any():
        raise AssertionError(f"{name}: the tolerance would pass a kernel that has {fault} (max dev {float(dev.max()):.4g})")
    return float(dev.max())


# ---------------------------------------------------------------------------
# Phase 2: kernels at the main path's shapes
# ---------------------------------------------------------------------------


def main_path_shapes(seed: int) -> dict:
    """The attention shapes of the phase-3 request, from its own tiles and merge plan."""
    from omchat_torch.config import OmChatConfig
    from omchat_torch.models.omchat import plan_multimodal_merge, round_up_to_bucket
    from omchat_torch.runtime.generate import PROMPT_BUCKET

    cfg = OmChatConfig()
    ids, tiles = make_request(cfg, seed)
    plan = plan_multimodal_merge([ids], cfg.image_seq_len, bucket=PROMPT_BUCKET,
                                 max_length=cfg.tokenizer_model_max_length)
    valid = cfg.vision.seq_len
    kvl = int(plan.lengths[0])
    return {
        "tiles": int(tiles.shape[0]), "vit_valid": valid, "vit_sp": (valid + 7) // 8 * 8,
        "prompt_rows": int(plan.max_len), "prompt_len": kvl,
        "cache_rows": int(plan.max_len) + round_up_to_bucket(NEW_TOKENS, PROMPT_BUCKET),
        # decode step j attends over kvl + j cached rows and commits row kvl + j
        "decode_lens": [kvl + j for j in range(NEW_TOKENS - 1)],
    }


def kernel_phases(gen, shapes: dict) -> list:
    import torch
    import torch.nn.functional as F

    from omchat_torch.config import OmChatConfig
    from omchat_torch.ops import decode_attention as da
    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    bf = torch.bfloat16
    cfg = OmChatConfig()
    rows = []

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(bf)

    def direction(*shape):
        """±1 vectors: a query direction shared by q and the planted keys."""
        return (torch.randint(0, 2, shape, generator=gen, device=dev) * 2 - 1).to(bf)

    # K1 — ViT packed qk-norm attention over the 3 tiles, padded rows SP, valid rows VALID.
    # q carries a per-head direction u; the keys at the last valid column (VALID-1)
    # and the first pad column (VALID) are 0.8 u + 0.6 noise, so after the qk-norm
    # each takes about a quarter of every row's softmax when it is let in.
    B, SP, VALID = shapes["tiles"], shapes["vit_sp"], shapes["vit_valid"]
    H, D = cfg.vision.num_attention_heads, cfg.vision.head_dim
    HD = H * D
    u = direction(HD)
    qkv = randn(B, SP, 3 * HD)
    qkv[..., :HD] += u
    for col in (VALID - 1, VALID):
        qkv[:, col, HD:2 * HD] = 0.8 * u + 0.6 * randn(B, HD)
    qg = (1.0 + 0.1 * randn(HD).float()).to(bf) * fa.packed_prescale(D)
    kg = (1.0 + 0.1 * randn(HD).float()).to(bf)
    eps = 1e-6
    out = fa.packed_qkv_norm_attention(qkv, num_heads=H, q_gamma=qg, k_gamma=kg, eps=eps, valid_len=VALID)
    torch.cuda.synchronize()
    rq, rk, gq32, gk32 = fa.qk_norm_stats(qkv, qg, kg, eps)

    def k1_plain(valid):
        return fa.packed_qkv_norm_attention_plain(qkv, rq, rk, gq32, gk32, num_heads=H, valid_len=valid)[:, :VALID]

    ref = k1_plain(VALID)
    err = check_close("K1 packed_qkv_norm_attention", out[:, :VALID], ref, *ATTN_TOL["K1"])
    faults = {"last valid column dropped": check_fault_caught("K1", "the last valid column dropped",
                                                              k1_plain(VALID - 1), ref, *ATTN_TOL["K1"]),
              "first pad column let in": check_fault_caught("K1", "the first pad column let in",
                                                            k1_plain(VALID + 1), ref, *ATTN_TOL["K1"])}
    ref_mag = float(ref.float().abs().mean())
    k_ms = time_ms(lambda: fa.packed_qkv_norm_attention(qkv, num_heads=H, q_gamma=qg, k_gamma=kg, eps=eps,
                                                        valid_len=VALID))
    p_ms = time_ms(lambda: fa.packed_qkv_norm_attention_plain(qkv, rq, rk, gq32, gk32, num_heads=H,
                                                              valid_len=VALID), iters=5, warmup=1)
    # library yardstick: SDPA over the already-normalised heads (no qk-norm)
    qn = (qkv[:, :VALID, :HD].float() * rq[:, :VALID, None] * gq32).to(bf).view(B, VALID, H, D).transpose(1, 2)
    kn = (qkv[:, :VALID, HD:2 * HD].float() * rk[:, :VALID, None] * gk32).to(bf).view(B, VALID, H, D).transpose(1, 2)
    vn = qkv[:, :VALID, 2 * HD:].reshape(B, VALID, H, D).transpose(1, 2)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qn, kn, vn))
    flops = 4.0 * B * H * VALID * VALID * D
    nbytes = qkv.numel() * 2 + 2 * B * SP * 4 + 2 * HD * 4 + B * SP * HD * 2
    rows.append(dict(name="packed_qkv_norm_attention", source="omchat_torch/csrc/packed_qkv_norm_attention.cu",
                     replaces="omchat_tpu/ops/flash_attention.py:559", max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                     library_ms=lib_ms, flops=flops, bytes=nbytes, ref_mean_abs=ref_mag, faults=faults))
    del qkv, out, ref, qn, kn, vn

    # K2 — causal GQA prefill over the bntd cache layer: the merged prompt's S rows
    # (KVL valid) against a cache of T rows.  q carries its kv head's direction u; a
    # sink key 0.6 u at column 0 is seen by every row, and the last valid column
    # (KVL-1) holds 0.8 u, about half of row KVL-1's softmax.
    S, T, KVL = shapes["prompt_rows"], shapes["cache_rows"], shapes["prompt_len"]
    H, KVH, D = cfg.text.num_attention_heads, cfg.text.num_key_value_heads, cfg.text.attn_head_dim
    u = direction(KVH, D)
    q = randn(1, S, H, D) + u.repeat_interleave(H // KVH, dim=0)
    k = randn(1, KVH, T, D)
    v = randn(1, KVH, T, D)
    k[0, :, 0] = 0.6 * u
    k[0, :, KVL - 1] = 0.8 * u
    q_off = torch.zeros(1, dtype=torch.int32, device=dev)
    kvl = torch.full((1,), KVL, dtype=torch.int32, device=dev)
    kw = dict(causal=True, q_offset=q_off, kv_len=kvl, kv_format="bntd")
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()

    def k2_plain(q_offset, kv_len):
        return fa.flash_attention_plain(q, k, v, causal=True, q_offset=q_offset, kv_len=kv_len)[:, :KVL]

    ref = k2_plain(q_off, kvl)
    err = check_close("K2 flash_attention", out[:, :KVL], ref, *ATTN_TOL["K2"])
    faults = {"last valid column dropped": check_fault_caught("K2", "the last valid column dropped",
                                                              k2_plain(q_off, kvl - 1), ref, *ATTN_TOL["K2"]),
              "diagonal shifted by one": check_fault_caught("K2", "the causal diagonal shifted by one",
                                                            k2_plain(q_off + 1, kvl), ref, *ATTN_TOL["K2"])}
    ref_mag = float(ref.float().abs().mean())
    k_ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw))
    p_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True, q_offset=q_off, kv_len=kvl),
                   iters=3, warmup=1)
    qt = q[:, :KVL].transpose(1, 2)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, k[:, :, :KVL], v[:, :, :KVL], is_causal=True,
                                                            enable_gqa=True))
    cols = sum(min(i + 1, KVL) for i in range(S))  # causal columns this data needs
    flops = 4.0 * H * D * cols
    nbytes = (q.numel() + 2 * KVH * KVL * D + q.numel()) * 2
    rows.append(dict(name="flash_attention", source="omchat_torch/csrc/flash_attention.cu",
                     replaces="omchat_tpu/ops/flash_attention.py:246", max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                     library_ms=lib_ms, flops=flops, bytes=nbytes, ref_mean_abs=ref_mag, faults=faults))
    del q, k, v, out, ref, qt

    # K3 — decode against the stacked cache [L, B=1, KVH, T, D] at the decode steps'
    # lengths.  Checked at the first step's length LEN: a sink at row 0, 0.8 u at the
    # last valid row (LEN-1), at the first row past it (LEN) and in the self column.
    L, lens = cfg.text.num_hidden_layers, shapes["decode_lens"]
    LEN = lens[0]
    kc = randn(L, 1, KVH, T, D)
    vc = randn(L, 1, KVH, T, D)
    qd = randn(1, 1, H, D) + u.repeat_interleave(H // KVH, dim=0)
    kc[:, 0, :, 0] = 0.6 * u
    kc[:, 0, :, LEN - 1] = 0.8 * u
    kc[:, 0, :, LEN] = 0.8 * u
    kn_ = (0.8 * u)[None]
    vn_ = randn(1, KVH, D)
    clen = torch.full((1,), LEN, dtype=torch.int32, device=dev)
    out = da.flash_decode_stacked(qd, kc, vc, clen, L - 1, kn_, vn_)
    torch.cuda.synchronize()
    ref = da.flash_decode_stacked_plain(qd, kc, vc, clen, L - 1, kn_, vn_)
    err = check_close("K3 flash_decode_stacked", out, ref, *ATTN_TOL["K3"])
    faults = {
        f"cache_len{d:+d}": check_fault_caught("K3", f"cache_len{d:+d}", da.flash_decode_stacked_plain(
            qd, kc, vc, clen + d, L - 1, kn_, vn_), ref, *ATTN_TOL["K3"]) for d in (-1, 1)}
    # a self key of -8 u gets weight exp(-90): the self column dropped
    faults["self column dropped"] = check_fault_caught(
        "K3", "the self column dropped", da.flash_decode_stacked_plain(qd, kc, vc, clen, L - 1, -10 * kn_, vn_),
        ref, *ATTN_TOL["K3"])
    ref_mag = float(ref.float().abs().mean())
    # walk the layers and the decode lengths, so every launch reads its cache from HBM, as decode does
    clens = [torch.full((1,), n, dtype=torch.int32, device=dev) for n in lens]
    it = iter(range(10**9))

    def walk(fn):
        i = next(it)
        return fn(qd, kc, vc, clens[i % len(lens)], i % L, kn_, vn_)

    # warm up over every length: the library call plans once per shape
    k_ms = time_ms(lambda: walk(da.flash_decode_stacked), iters=2 * len(lens), warmup=len(lens))
    p_ms = time_ms(lambda: walk(da.flash_decode_stacked_plain), iters=len(lens), warmup=len(lens))
    qs = qd.transpose(1, 2)

    def library_decode():
        i = next(it)
        li, n = i % L, lens[i % len(lens)]
        return F.scaled_dot_product_attention(qs, kc[li][:, :, :n], vc[li][:, :, :n], enable_gqa=True)

    lib_ms = time_ms(library_decode, iters=2 * len(lens), warmup=len(lens))
    mean_len = sum(lens) / len(lens)
    flops = 4.0 * H * D * (mean_len + 1)
    nbytes = (2 * KVH * (mean_len + 1) * D + 2 * H * D) * 2
    rows.append(dict(name="flash_decode_stacked", source="omchat_torch/csrc/flash_decode_stacked.cu",
                     replaces="omchat_tpu/ops/decode_attention.py:109", max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                     library_ms=lib_ms, flops=flops, bytes=nbytes, ref_mean_abs=ref_mag, faults=faults))

    # K4 — commit the L new rows into the cache seen as [L*B, KVH, T, D] at the first step's row
    kf = kc.view(L, KVH, T, D)
    vf = vc.view(L, KVH, T, D)
    pages = torch.arange(L, dtype=torch.int32, device=dev)
    offs = torch.full((L,), LEN, dtype=torch.int32, device=dev)
    k_rows = randn(L, KVH, D)
    v_rows = randn(L, KVH, D)
    k_ref, v_ref = kf.clone(), vf.clone()
    pa.commit_rows(kf, vf, pages, offs, k_rows, v_rows)
    torch.cuda.synchronize()
    pa.commit_rows_plain(k_ref, v_ref, pages, offs, k_rows, v_rows)
    if not (torch.equal(kf.view(torch.int16), k_ref.view(torch.int16))
            and torch.equal(vf.view(torch.int16), v_ref.view(torch.int16))):
        raise AssertionError("K4 commit_rows: cache differs from the plain commit (bitwise, all rows)")
    k_ms = time_ms(lambda: pa.commit_rows(kf, vf, pages, offs, k_rows, v_rows), iters=100)
    p_ms = time_ms(lambda: pa.commit_rows_plain(k_ref, v_ref, pages, offs, k_rows, v_rows), iters=100)
    idx = (pages.long()[:, None], torch.arange(KVH, device=dev)[None, :], offs.long()[:, None])

    def library_commit():
        kf.index_put_(idx, k_rows)
        vf.index_put_(idx, v_rows)

    lib_ms = time_ms(library_commit, iters=100)
    nbytes = 2 * (2 * L * KVH * D * 2) + 2 * L * 4
    rows.append(dict(name="commit_rows", source="omchat_torch/csrc/commit_rows.cu",
                     replaces="omchat_tpu/ops/paged_attention.py:619", max_abs_err=0.0, ms=k_ms, plain_ms=p_ms,
                     library_ms=lib_ms, flops=0.0, bytes=nbytes, ref_mean_abs=None, faults={}))
    del kc, vc, kf, vf, k_ref, v_ref

    for r in rows:
        r["bound_ms"], r["bound_by"] = bound_ms(r.pop("flops"), r.pop("bytes"))
        mag = "" if r["ref_mean_abs"] is None else f" ref_mean_abs={r['ref_mean_abs']:.3g}"
        caught = "".join(f"; fault '{f}' max_dev={d:.3g} (caught)" for f, d in r["faults"].items())
        log(f"kernel {r['name']}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"max_abs_err={r['max_abs_err']:.3g}{mag}{caught}")
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phases 3 and 4: end to end
# ---------------------------------------------------------------------------


def build_model(cfg, seed: int):
    import torch

    from omchat_torch.models import intern_vit, projector, qwen2

    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    return {
        "vision_tower": intern_vit.init_params(cfg.vision, g, bf),
        "projector": projector.init_params(cfg.projector, cfg.vision.hidden_size, cfg.text.hidden_size, g, bf),
        "language_model": qwen2.init_params(cfg.text, g, bf),
    }


def make_request(cfg, seed: int):
    import numpy as np
    from PIL import Image

    from omchat_torch.processing.chat import image_prompt, make_context
    from omchat_torch.processing.image_processor import process_anyres_image
    from omchat_torch.utils.testing import MockTokenizer

    rng = np.random.default_rng(seed)
    image = Image.fromarray(rng.integers(0, 256, (448, 448, 3), dtype=np.uint8))
    tiles = process_anyres_image(image, cfg.image_grid_pinpoints, cfg.vision.image_size)
    _, ids = make_context(MockTokenizer(), image_prompt("What is shown in this picture? Describe it.", len(tiles)),
                          None, "You are a helpful assistant.")
    return ids, tiles


def counters():
    from omchat_torch.ops import decode_attention as da
    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.ops import paged_attention as pa

    return {
        "packed_qkv_norm_attention": fa.packed_qkv_norm_attention,
        "flash_attention": fa.flash_attention,
        "flash_decode_stacked": da.flash_decode_stacked,
        "commit_rows": pa.commit_rows,
    }


def end_to_end(seed: int, new_tokens: int = NEW_TOKENS) -> dict:
    import torch

    from omchat_torch.config import GenerationConfig, OmChatConfig
    from omchat_torch.runtime.generate import OmChatEngine

    cfg = OmChatConfig()  # omchat-v2.0-13B: InternViT-6B (45 layers) + Qwen2-7B (28 layers)
    t0 = time.perf_counter()
    params = build_model(cfg, seed)
    torch.cuda.synchronize()
    log(f"e2e: built full-width full-depth weights in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    ids, tiles = make_request(cfg, seed)
    engine = OmChatEngine(cfg, params)
    gen = GenerationConfig(max_new_tokens=new_tokens, eos_token_id=-1)  # no early stop on random weights

    bad = []

    def finite(step, logits):
        if logits.shape != (1, cfg.text.vocab_size) or not torch.isfinite(logits).all():
            bad.append(step)

    # warm-up (cuBLAS / allocator first calls), and the logits check: kept out of the timed run
    warm = engine.generate([ids], tiles, gen, logits_callback=finite)
    torch.cuda.reset_peak_memory_stats()
    for c in counters().values():
        c.launches = 0
    out = engine.generate([ids], tiles, gen)
    launches = {name: c.launches for name, c in counters().items()}
    sp = engine.spans
    res = {
        "tiles": int(tiles.shape[0]),
        "merged_len": int(out.prompt_len[0]),
        "cache_len": sp["cache_len"],
        "new_tokens": len(out.token_ids[0]),
        "vit_ms": sp["encode_images"] * 1e3,
        "vit_images_per_s": tiles.shape[0] / sp["encode_images"],
        "prefill_ms": sp["prefill"] * 1e3,
        "ttft_ms": sp["ttft"] * 1e3,
        "decode_tokens_per_s": sp["decode_steps"] / sp["decode"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches,
    }
    log("e2e: " + json.dumps(res))
    if bad:
        raise AssertionError(f"e2e: non-finite or mis-shaped logits at steps {bad}")
    if out.token_ids != warm.token_ids:
        raise AssertionError("e2e: the timed run's tokens differ from the checked warm-up run's")
    if len(out.token_ids[0]) != new_tokens:
        raise AssertionError(f"e2e: generated {len(out.token_ids[0])} tokens, expected {new_tokens}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"e2e: kernels never launched on the main path: {missing}")
    del engine, params
    torch.cuda.empty_cache()
    return res


def kernel_vs_plain(seed: int) -> dict:
    import torch

    from omchat_torch.config import OmChatConfig
    from omchat_torch.runtime.generate import OmChatEngine

    full = OmChatConfig()
    cfg = dataclasses.replace(
        full,
        vision=dataclasses.replace(full.vision, num_hidden_layers=2),
        text=dataclasses.replace(full.text, num_hidden_layers=2),
    )
    params = build_model(cfg, seed)
    ids, tiles = make_request(cfg, seed)
    logits = {}
    for impl in (None, "plain"):
        eng = OmChatEngine(cfg, params, attn_impl=impl)
        feats = eng.encode_images(tiles)
        plan = eng.plan([ids])
        logits[impl], _ = eng.prefill(plan, feats, 32)
    torch.cuda.synchronize()
    got, ref = logits[None], logits["plain"]
    diff = float((got - ref).abs().max())
    res = {"logits_max_abs_diff": diff, "logits_max_abs": float(ref.abs().max()),
           "argmax_equal": bool(torch.equal(got.argmax(-1), ref.argmax(-1)))}
    log("kernel-vs-plain (2 ViT + 2 LLM layers, full width): " + json.dumps(res))
    check_close("kernel-vs-plain logits", got, ref, LOGITS_ATOL, LOGITS_RTOL)
    del params
    torch.cuda.empty_cache()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights, inputs and image")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "omchat_torch")):
        print(f"chip_smoke: no omchat_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from omchat_torch.ops import kernel_lib

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi failed"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    build_s = kernel_lib.build_all()
    log(f"kernel build: {build_s:.1f} s ({len(kernel_lib.SOURCES)} sources, parallel nvcc)")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    shapes = main_path_shapes(args.seed)
    log("main-path shapes: " + json.dumps({k: v for k, v in shapes.items() if k != "decode_lens"})
        + f" decode_lens {shapes['decode_lens'][0]}..{shapes['decode_lens'][-1]}")
    rows = kernel_phases(gen, shapes)
    e2e = end_to_end(args.seed)
    if (e2e["tiles"], e2e["merged_len"], e2e["cache_len"]) != (shapes["tiles"], shapes["prompt_len"],
                                                                 shapes["cache_rows"]):
        raise AssertionError(f"e2e: the request's shapes differ from those phase 2 measured: {shapes}")
    kernel_vs_plain(args.seed)

    launches = e2e["launches"]
    kernels = [{
        "name": r["name"], "route": "cuda", "source": r["source"], "replaces": r["replaces"],
        "launches": launches[r["name"]], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
    } for r in rows]
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
