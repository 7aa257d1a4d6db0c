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
5. Serving: ``PagedBatchEngine`` at full width and depth on the repo's mixed
   workload (``dev/bench_serving.py:27-47`` rebuilt from
   ``numpy.random.default_rng(0)``: 16 requests of 64-512 text tokens, a 2-tile
   image on every 4th, 64 new tokens each); a warm-up at 4 new tokens, then
   the timed run: tokens/s, TTFT and inter-token percentiles, the wall time of
   a decode step and of the ViT, short-prefill and chunk dispatches on the
   card's timeline; every request must return 64 tokens, every page must come
   back, and K12, K14 and K15 must launch.  The run records what each paged
   kernel was handed.  The four image prompts then prefill again, alternately
   with K14 and with the gather + K2 chunk attention it replaced: the chunk
   dispatch time on each, and first-token logits that must agree.
6. Paged kernel phases: K12, K14 and K15 (and K2 at its batched-prefill
   shape) at what the timed serving run handed them, held against their plain
   versions with planted boundary keys and planted faults, as in phase 2;
   K14 is also timed against gather + K2.
7. Paged vs single-request engine at full width and 2+2 layers: 4 requests
   (1 image, 3 text); first-token logits within phase 4's limits, greedy
   tokens identical up to the first step whose reference top-2 margin is
   under 0.1.
8. w8a8: the full-width full-depth random model quantized to int8 and its
   ViT fc1 scales calibrated (``api.quantize_model``, what
   ``load_pretrained_model(w8a8=True)`` runs): int8 weight GiB, quantize and
   calibrate seconds.
9. w8a8 end to end: phase 3's request on the quantized model (TTFT, ViT,
   prefill and decode spans, peak memory); K7, K8, K9 and K11 must launch.
   The run records what each w8a8 kernel was handed.
10. w8a8 serving: phase 5's workload through ``PagedBatchEngine`` on the
    quantized model; the glue kernels must launch on the short-prefill and
    chunk routes.
11. w8a8 kernel phases: K7, K8, K9 and K11 at the shapes phase 9 handed
    them, held against their plain versions (int8 codes, x', row scales) with
    planted faults that must fall outside the limits; kernel, plain, library
    (``torch._int_mm`` on the same GEMM, for K9 and K11) and bound times.
12. w8a8 kernels vs plain at full width and 2+2 layers: first-token logits
    through the glue kernels and through ``attn_impl="plain"`` (the unfused
    chain), no further apart than w8a8 moves the plain chain from bf16.

Prints one JSON line of per-kernel numbers before the last line, and as the
last line ``{"ok": true, "device": {...}}``.  Exits non-zero (printing no
result) when CUDA is unavailable, when the package is missing beside this
file, or when any phase fails.  Imports nothing of JAX or of omchat_tpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3

# Tolerances, bf16 on the card.  K1-K3 against their plain versions: the inputs
# plant high-scoring keys at the mask boundaries (phase 2), so outputs are O(1)
# there and a bf16 ulp is 0.0078 at |x| in [1, 2): rtol 1e-2 is about one ulp,
# atol covers the small outputs.  Each phase also checks that the plain version
# with a planted fault (a boundary column dropped or let in) falls outside.
# K12 and K14 take the limits of their contiguous siblings K3 and K2.
ATTN_TOL = {"K1": (4e-3, 1e-2), "K2": (8e-3, 1e-2), "K3": (4e-3, 1e-2),
            "K12": (4e-3, 1e-2), "K14": (8e-3, 1e-2)}  # (atol, rtol)
NEW_TOKENS = 32
# phase 4, first-token logits through 2+2 layers, kernels vs the plain reference
# attention: the logits are bf16 values (ulp 0.031 at |x| in [4, 8)) and the two
# paths round softmax and q differently, so a few ulps at the largest logits.
LOGITS_ATOL, LOGITS_RTOL = 1e-1, 2e-2
# phases 5-7: the serving engine's settings (dev/bench_serving.py's, with the
# engine's default prefill chunk, which sends the image prompts through the
# chunked route) and its workload
SERVING = dict(max_slots=16, num_pages=192, page_size=128, prompt_bucket=128, max_len=4096, decode_roll=16,
               prefill_chunk=1024, prefill_batch_tokens=8192)
SERVING_REQUESTS, SERVING_NEW_TOKENS, SERVING_WORKLOAD_SEED = 16, 64, 0
PARITY_NEW_TOKENS, PARITY_MARGIN = 16, 0.1
DEVICE = "cuda"  # phases 5-12 place their tensors and engines here
# phase 11, the w8a8 kernels against their plain versions: int8 codes within one
# and at least 99% equal (fp32 sums in another order move a code next to a
# rounding boundary), x' within one bf16 ulp, row scales rtol 1e-2 (the JAX
# package's limit, tests/test_pallas_kernels.py:314).  Each planted fault must
# break one of them.
CODE_MAX_DIFF, CODE_EQUAL_SHARE, X_ULPS, SCALE_RTOL = 1, 0.99, 1.0, 1e-2
# Phase 12, w8a8 prefill through the glue kernels vs attn_impl="plain" (the
# unfused chain): the first-token logits may differ by no more than w8a8
# quantization itself moves the plain chain's from the bf16 model's, measured in
# the same phase.  (The JAX package's trunk limit, 2e-2 of max |logit|,
# tests/test_llm_glue.py:109, holds at its tiny widths and in the CPU tests;
# at full width on random weights any ±1 code moves these small logits by
# 4-6% of their max, whatever the path: 0.048 kernels vs plain, 0.049 static vs
# dynamic fc1 scales, 0.056 w8a8 vs bf16; bf16 kernels vs plain 0.009.)


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


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
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


def _randn(gen, *shape, scale=1.0):
    import torch

    return (torch.randn(shape, generator=gen, device=DEVICE, dtype=torch.float32) * scale).to(torch.bfloat16)


def _direction(gen, *shape):
    """±1 vectors: a query direction shared by q and the planted keys."""
    import torch

    return (torch.randint(0, 2, shape, generator=gen, device=DEVICE) * 2 - 1).to(torch.bfloat16)


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
        return _randn(gen, *shape, scale=scale)

    def direction(*shape):
        return _direction(gen, *shape)

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

    g = torch.Generator(device=DEVICE).manual_seed(seed)
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


def end_to_end(seed: int, new_tokens: int = NEW_TOKENS, model=None, counted=None, label: str = "e2e") -> dict:
    """Phase 3 (bf16, its own model) or, with ``model`` = (cfg, params) and
    the kernels that must launch in ``counted``, phase 9 (w8a8)."""
    import torch

    from omchat_torch.config import GenerationConfig, OmChatConfig
    from omchat_torch.runtime.generate import OmChatEngine

    if model is None:
        cfg = OmChatConfig()  # omchat-v2.0-13B: InternViT-6B (45 layers) + Qwen2-7B (28 layers)
        t0 = time.perf_counter()
        params = build_model(cfg, seed)
        torch.cuda.synchronize()
        log(f"e2e: built full-width full-depth weights in {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    else:
        cfg, params = model
    counted = counted or counters()
    ids, tiles = make_request(cfg, seed)
    engine = OmChatEngine(cfg, params, image_cache_size=0)  # the timed run encodes its image again
    gen = GenerationConfig(max_new_tokens=new_tokens, eos_token_id=-1)  # no early stop on random weights

    bad = []

    def finite(step, logits):
        if logits.shape != (1, cfg.text.vocab_size) or not torch.isfinite(logits).all():
            bad.append(step)

    # warm-up (cuBLAS / allocator first calls), and the logits check: kept out of the timed run
    warm = engine.generate([ids], tiles, gen, logits_callback=finite)
    torch.cuda.reset_peak_memory_stats()
    for c in counted.values():
        c.launches = 0
    out = engine.generate([ids], tiles, gen)
    launches = {name: c.launches for name, c in counted.items()}
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
    log(f"{label}: " + json.dumps(res))
    if bad:
        raise AssertionError(f"{label}: non-finite or mis-shaped logits at steps {bad}")
    if out.token_ids != warm.token_ids:
        raise AssertionError(f"{label}: the timed run's tokens differ from the checked warm-up run's")
    if len(out.token_ids[0]) != new_tokens:
        raise AssertionError(f"{label}: generated {len(out.token_ids[0])} tokens, expected {new_tokens}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the main path: {missing}")
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
        eng = OmChatEngine(cfg, params, attn_impl=impl, image_cache_size=0)
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


# ---------------------------------------------------------------------------
# Phases 5-7: the paged serving engine
# ---------------------------------------------------------------------------


def serving_workload(cfg) -> list:
    """``dev/bench_serving.py:27-47``'s mixed workload rebuilt from the same
    seed: SERVING_REQUESTS text prompts of 64-512 tokens, two image sentinels
    and a 2-tile image (standard_normal pixels) on every 4th.  [(ids, tiles)]."""
    import numpy as np

    from omchat_torch.constants import IMAGE_TOKEN_INDEX

    rng = np.random.default_rng(SERVING_WORKLOAD_SEED)
    lengths = [int(rng.integers(64, 513)) for _ in range(SERVING_REQUESTS)]
    work = []
    for i, n in enumerate(lengths):
        ids = [151644] + [int(t) for t in rng.integers(2000, 20000, n - 1)]
        tiles = None
        if i % 4 == 0:
            ids = ids[:2] + [IMAGE_TOKEN_INDEX, IMAGE_TOKEN_INDEX] + ids[2:]
            size = cfg.vision.image_size
            tiles = rng.standard_normal((2, 3, size, size)).astype(np.float32)
        work.append((ids, tiles))
    return work


def gather_k2_attention(q, k_pages, v_pages, kv_len, page_tables, q_offset, *, impl=None):
    """The chunk attention K14 replaced on the engine's path (the JAX
    engine's default route): the page-mapped K/V gathered contiguous, then
    K2.  Phases 5 and 6 time it beside K14."""
    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.ops import paged_attention as pa

    k, v = pa._gather_pages(k_pages, v_pages, page_tables)
    return fa.flash_attention(q, k, v, causal=True, q_offset=q_offset, kv_len=kv_len, kv_format="bntd")


def record_dispatches(eng) -> tuple:
    """Wrap the serving engine's dispatch points so that a run records what
    each paged kernel is handed — the decode rolls' lengths and sliced tables
    (K12), the chunk dispatches' starts, lengths and tables (K14), the page
    commits' scratch shapes, tables and page counts (K15), the contiguous
    prefills' plans (K2) — and CUDA events around the ViT dispatch, the
    short prefills, the chunk dispatches and the decode rolls.  Each entry
    carries ``rec["label"]`` at its time.  Returns the record and a function
    that restores the module's functions."""
    import numpy as np
    import torch

    from omchat_torch.runtime import paged_engine as pe

    rec = {"label": None, "rolls": [], "chunks": [], "commits": [], "prefills": [], "spans": []}
    saved = {n: getattr(pe, n) for n in ("_paged_prefill_chunk", "_commit_pages", "paged_prefill_attention")}

    def spanned(kind, fn, extra=lambda *a, **kw: None):
        def wrapped(*a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            rec["spans"].append(dict(label=rec["label"], kind=kind, start=start, end=end, extra=extra(*a, **kw)))
            return out
        return wrapped

    def on_roll(decoding, roll, active, tables):
        rec["rolls"].append(dict(label=rec["label"], n=len(decoding), tables=np.array(tables),
                                 lengths=np.where(active, eng._lengths, 0).astype(np.int32)))
        return len(decoding), roll

    def chunk(params, cfg, token_ids, is_image, image_index, feats, positions, start, clen, tables, *rest):
        rec["chunks"].append(dict(label=rec["label"], shape=tuple(token_ids.shape), start=np.array(start),
                                  len=np.array(clen), tables=np.array(tables)))
        return saved["_paged_prefill_chunk"](params, cfg, token_ids, is_image, image_index, feats, positions, start,
                                             clen, tables, *rest)

    def commit(slot_k, slot_v, k_pool, v_pool, tables, n_pages, *a):
        rec["commits"].append(dict(label=rec["label"], shape=tuple(slot_k.shape), tables=np.array(tables),
                                   n_pages=np.array(n_pages)))
        return saved["_commit_pages"](slot_k, slot_v, k_pool, v_pool, tables, n_pages, *a)

    prefill = eng._prefiller.prefill

    def on_prefill(plan, feats, new_tokens):
        rec["prefills"].append(dict(label=rec["label"], lengths=[int(n) for n in plan.lengths],
                                    rows=int(plan.max_len)))
        return prefill(plan, feats, new_tokens)

    pe._paged_prefill_chunk, pe._commit_pages = chunk, commit
    eng._prefiller.prefill = on_prefill
    eng._encode_pending = spanned("vit", eng._encode_pending)
    eng._prefill_shorts = spanned("shorts", eng._prefill_shorts)
    eng._run_chunk = spanned("chunk", eng._run_chunk)
    eng._dispatch_roll = spanned("roll", eng._dispatch_roll, on_roll)

    def undo():
        for n, f in saved.items():
            setattr(pe, n, f)

    return rec, undo


def span_ms(rec, label, kind) -> list:
    """Elapsed ms of the recorded spans (call after a synchronize)."""
    return [s["start"].elapsed_time(s["end"]) for s in rec["spans"] if s["label"] == label and s["kind"] == kind]


def paged_counters():
    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.ops import paged_attention as pa

    return {
        "packed_qkv_norm_attention": fa.packed_qkv_norm_attention,
        "flash_attention": fa.flash_attention,
        "commit_rows": pa.commit_rows,
        "paged_flash_decode": pa.paged_flash_decode,
        "paged_flash_prefill": pa.paged_flash_prefill,
        "commit_pages": pa.commit_pages,
    }


def capture_first_logits(engine) -> dict:
    """Record, per request id, the fp32 logits the engine picks each
    request's first token from (every prefill route ends in
    ``_finish_with_token``)."""
    store = {}
    finish = engine._finish_with_token

    def wrapped(req, first, logits_row=None):
        store[req.request_id] = logits_row.float()
        finish(req, first, logits_row)

    engine._finish_with_token = wrapped
    return store


def drive(engine, work, new_tokens: int) -> list:
    rids = [engine.submit(ids, tiles, max_new_tokens=new_tokens, eos_token_id=-1) for ids, tiles in work]
    engine.run_to_completion()
    return rids


def timed_serving(eng, work, rec, counts: dict, label: str) -> dict:
    """A warm-up at 4 new tokens, then the timed run of ``work`` at
    SERVING_NEW_TOKENS with the kernels in ``counts`` counted: tokens/s,
    latency percentiles, decode-step and dispatch wall times.  Every request
    must return all its tokens, every page come back and every counted
    kernel launch."""
    import torch

    rec["label"] = "warm-up"
    drive(eng, work, 4)  # cuBLAS plans, the allocator, the kernels' first launches
    eng.reset_latency_stats()
    for c in counts.values():
        c.launches = 0
    rec["label"] = "timed"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = drive(eng, work, SERVING_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counts.items()}
    done = [eng.pop_result(r) for r in rids]  # (tokens, prompt length)
    rolls = [(s["extra"][0], s["start"].elapsed_time(s["end"]) / s["extra"][1])
             for s in rec["spans"] if s["label"] == "timed" and s["kind"] == "roll"]
    full = [ms for n, ms in rolls if n == SERVING["max_slots"]]
    res = {
        "requests": len(work), "images": sum(t is not None for _, t in work),
        "prompt_tokens": sum(p for _, p in done), "generated_tokens": sum(len(t) for t, _ in done),
        "wall_s": wall, "tokens_per_s": sum(len(t) for t, _ in done) / wall, **eng.latency_stats(),
        # CUDA events around each host-dispatched roll / step count: the
        # card's timeline, host launch gaps included
        "decode_step_wall_ms_16_slots": sum(full) / len(full) if full else None, "rolls_at_16_slots": len(full),
        "decode_step_wall_ms_all_rolls": [round(ms, 3) for _, ms in rolls],
        "span_ms": {k: sum(span_ms(rec, "timed", k)) for k in ("vit", "shorts", "chunk", "roll")},
        "chunk_dispatches": len(span_ms(rec, "timed", "chunk")),
        "pages_free": eng.allocator.available, "launches": launches,
    }
    log(f"{label}: " + json.dumps(res))
    short = [i for i, (t, _) in enumerate(done) if len(t) != SERVING_NEW_TOKENS]
    if short:
        raise AssertionError(f"{label}: requests {short} did not return {SERVING_NEW_TOKENS} tokens")
    if eng.allocator.available != SERVING["num_pages"]:
        raise AssertionError(f"{label}: {SERVING['num_pages'] - eng.allocator.available} pages never came back")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the serving path: {missing}")
    return res


def serving(seed: int) -> tuple:
    """Phase 5: the paged engine at full width and depth on the mixed
    workload, recording what each paged kernel is handed; then the image
    prompts again, first tokens only, alternately on the engine's K14 route
    and on gather + K2, to time a chunk dispatch on each and compare their
    first-token logits.  Returns (results, the timed run's record)."""
    import torch

    from omchat_torch.config import OmChatConfig
    from omchat_torch.runtime import paged_engine as pe

    cfg = OmChatConfig()
    params = build_model(cfg, seed)
    work = serving_workload(cfg)
    # no image cache: the timed run encodes its images again, as the warm-up did
    eng = pe.PagedBatchEngine(cfg, params, image_cache_size=0, device=DEVICE, **SERVING)
    first = capture_first_logits(eng)
    rec, undo = record_dispatches(eng)
    try:
        res = timed_serving(eng, work, rec, paged_counters(), "serving")

        # The two chunk-attention routes differ only there, so the image
        # prompts' first-token logits carry the whole difference.
        images = [w for w in work if w[1] is not None]
        routes = {"k14": pe.paged_prefill_attention, "gather_k2": gather_k2_attention}
        reruns = []
        for route in ("k14", "gather_k2", "gather_k2", "k14"):
            pe.paged_prefill_attention = routes[route]
            rec["label"] = f"{route}-{len(reruns)}"
            reruns.append((route, rec["label"], drive(eng, images, 1)))
    finally:
        undo()
    torch.cuda.synchronize()
    chunk_ms = {r: [sum(span_ms(rec, label, "chunk")) for rr, label, _ in reruns if rr == r] for r in routes}
    n_chunks = {len(span_ms(rec, label, "chunk")) for _, label, _ in reruns}
    (_, _, k14_rids), (_, _, gk_rids) = reruns[0], reruns[1]
    diffs = [check_close(f"K14 vs gather + K2 first-token logits (image request {i})", first[a], first[b],
                         LOGITS_ATOL, LOGITS_RTOL) for i, (a, b) in enumerate(zip(k14_rids, gk_rids))]
    res["routes"] = {"chunk_dispatches_per_rerun": sorted(n_chunks), "chunk_ms_per_rerun": chunk_ms,
                     "first_token_logits_max_abs_diff": max(diffs)}
    log("serving, chunk-attention routes on the image prompts: " + json.dumps(res["routes"]))
    if len(n_chunks) != 1:
        raise AssertionError(f"serving: the reruns made different chunk dispatch counts {n_chunks}")
    del eng, params
    torch.cuda.empty_cache()
    timed = {k: [e for e in rec[k] if e["label"] == "timed"] for k in ("rolls", "chunks", "commits", "prefills")}
    log("serving dispatches (timed run): rolls (slots decoding, table width) "
        f"{[(r['n'], r['tables'].shape[1]) for r in timed['rolls']]}; chunks (B, C, start, len) "
        f"{[(*c['shape'], c['start'].tolist(), c['len'].tolist()) for c in timed['chunks']]}; commits "
        f"{[c['shape'][:2] + (c['shape'][3],) for c in timed['commits']]}; contiguous prefills (lengths, rows) "
        f"{[(p['lengths'], p['rows']) for p in timed['prefills']]}")
    return res, timed


def paged_kernel_phases(gen, timed: dict) -> list:
    """Phase 6: K12, K14 and K15 (and K2 at the batched-prefill shape,
    printed only) at what the timed serving run handed them, against their
    plain versions; returns their rows.  Keys are planted at the length and
    causal boundaries as in phase 2, and each check shows that a faulted
    plain version falls outside it."""
    import itertools

    import numpy as np
    import torch
    import torch.nn.functional as F

    from omchat_torch.config import OmChatConfig
    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.ops import paged_attention as pa
    from omchat_torch.runtime.paged_engine import commit_page_ids

    dev = torch.device(DEVICE)
    i32 = dict(dtype=torch.int32, device=dev)
    tc = OmChatConfig().text
    L, H, KVH, D = tc.num_hidden_layers, tc.num_attention_heads, tc.num_key_value_heads, tc.attn_head_dim
    G = H // KVH
    PS, P = SERVING["page_size"], SERVING["num_pages"]
    NP = P + 1  # pages per layer, the parking page last
    LI = L - 1  # the layer checked; timing walks all of them, as the engine does
    rows = []
    # the layered pool [L, P+1, KVH, PS, D], seen flat by K12 and K15 and per layer by K14
    pool_k, pool_v = _randn(gen, L, NP, KVH, PS, D), _randn(gen, L, NP, KVH, PS, D)
    kflat, vflat = pool_k.view(L * NP, KVH, PS, D), pool_v.view(L * NP, KVH, PS, D)
    u = _direction(gen, KVH, D)
    uq = u.repeat_interleave(G, dim=0)
    it = itertools.count()

    def plant(table_row, layer, pos, scale):
        kflat[layer * NP + int(table_row[pos // PS]), :, pos % PS] = scale * u

    # K12 — the middle one of the decode rolls with the most slots decoding:
    # its lengths (0 for idle slots) and its sliced table.  A sink at column
    # 0, 0.8 u at the last valid column, at the first one past it and in the
    # self column.
    busiest = max(r["n"] for r in timed["rolls"])
    full = [r for r in timed["rolls"] if r["n"] == busiest]
    roll = full[len(full) // 2]
    tab_np, lens_np = roll["tables"], roll["lengths"]
    S, W = tab_np.shape
    for b, n in enumerate(lens_np):
        if n:
            for pos, scale in ((0, 0.6), (n - 1, 0.8), (n, 0.8)):
                plant(tab_np[b], LI, pos, scale)
    tab = torch.as_tensor(tab_np, device=dev)
    lens = torch.as_tensor(lens_np, device=dev)
    q = _randn(gen, S, 1, H, D) + uq
    kn = (0.8 * u)[None].expand(S, KVH, D).contiguous()
    vn = _randn(gen, S, KVH, D)
    out = pa.paged_flash_decode(q, kflat, vflat, lens, tab, kn, vn, page_offset=LI * NP)
    torch.cuda.synchronize()

    def k12_plain(lengths, k_new):
        return pa.paged_flash_decode_plain(q, kflat, vflat, lengths, tab, k_new, vn, page_offset=LI * NP)

    ref = k12_plain(lens, kn)
    err = check_close("K12 paged_flash_decode", out, ref, *ATTN_TOL["K12"])
    live = lens > 0
    faults = {f"lengths{d:+d}": check_fault_caught("K12", f"lengths{d:+d}", k12_plain(lens + d * live, kn), ref,
                                                   *ATTN_TOL["K12"]) for d in (-1, 1)}
    faults["self column dropped"] = check_fault_caught("K12", "the self column dropped", k12_plain(lens, -10 * kn),
                                                       ref, *ATTN_TOL["K12"])
    ref_mag = float(ref.float().abs().mean())

    def walk(fn):
        return fn(q, kflat, vflat, lens, tab, kn, vn, page_offset=(next(it) % L) * NP)

    k_ms = time_ms(lambda: walk(pa.paged_flash_decode), iters=2 * L, warmup=L)
    p_ms = time_ms(lambda: walk(pa.paged_flash_decode_plain), iters=L // 4, warmup=1)
    qs = q.transpose(1, 2)
    cols = torch.arange(W * PS + 1, device=dev)
    mask = ((cols[None] < lens[:, None]) | (cols[None] == W * PS))[:, None, None, :]

    def k12_library():  # the pages gathered by index_select, the self column appended, SDPA
        idx = (tab.long() + (next(it) % L) * NP).reshape(-1)
        kv = [torch.cat([p.index_select(0, idx).view(S, W, KVH, PS, D).transpose(1, 2).reshape(S, KVH, W * PS, D),
                         n[:, :, None]], dim=2) for p, n in ((kflat, kn), (vflat, vn))]
        return F.scaled_dot_product_attention(qs, *kv, attn_mask=mask, enable_gqa=True)

    lib_ms = time_ms(k12_library, iters=2 * L, warmup=L)
    cached = int(lens_np.sum())
    rows.append(dict(name="paged_flash_decode", source="omchat_torch/csrc/paged_flash_decode.cu",
                     replaces="omchat_tpu/ops/paged_attention.py:110", max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                     library_ms=lib_ms, flops=4.0 * H * D * (cached + S),
                     bytes=2 * KVH * cached * D * 2 + 2 * S * H * D * 2 + 2 * S * KVH * D * 2 + S * 4 + S * W * 4,
                     ref_mean_abs=ref_mag, faults=faults, shape=f"S={S} decoding={busiest} cached={cached} W={W}"))
    del out, ref, qs, mask

    # K14 — the timed run's chunk dispatch with the most causal columns: its
    # rows' page-aligned starts, chunk lengths and full-width tables.  A sink
    # at column 0 and 0.8 u at each row's last valid column.
    def causal_cols(c):
        return sum(int(n) * int(s) + int(n) * (int(n) + 1) // 2 for s, n in zip(c["start"], c["len"]))

    c14 = max(timed["chunks"], key=causal_cols)
    (B, C), starts, clen, t14_np = c14["shape"], c14["start"], c14["len"], c14["tables"]
    kv14 = starts + clen
    for b in range(B):
        for pos, scale in ((0, 0.6), (int(kv14[b]) - 1, 0.8)):
            plant(t14_np[b], LI, pos, scale)
    t14 = torch.as_tensor(t14_np, device=dev)
    q14 = _randn(gen, B, C, H, D) + uq
    qo, kl = torch.as_tensor(starts, **i32), torch.as_tensor(kv14, **i32)
    out = pa.paged_flash_prefill(q14, pool_k[LI], pool_v[LI], kl, t14, qo)
    torch.cuda.synchronize()
    rowmask = (torch.arange(C, device=dev)[None] < torch.as_tensor(clen, device=dev)[:, None])[..., None, None]

    def k14_plain(q_offset, kv_len):  # rows past a row's chunk length are padding
        return pa.paged_flash_prefill_plain(q14, pool_k[LI], pool_v[LI], kv_len, t14, q_offset) * rowmask

    ref = k14_plain(qo, kl)
    err = check_close("K14 paged_flash_prefill", out * rowmask, ref, *ATTN_TOL["K14"])
    faults = {"last valid column dropped": check_fault_caught("K14", "the last valid column dropped",
                                                              k14_plain(qo, kl - 1), ref, *ATTN_TOL["K14"]),
              "diagonal shifted by one": check_fault_caught("K14", "the causal diagonal shifted by one",
                                                            k14_plain(qo + 1, kl), ref, *ATTN_TOL["K14"])}
    ref_mag = float(ref.float().abs().mean())

    def walk14(fn):
        li = next(it) % L
        return fn(q14, pool_k[li], pool_v[li], kl, t14, qo)

    k_ms = time_ms(lambda: walk14(pa.paged_flash_prefill), iters=L, warmup=3)
    p_ms = time_ms(lambda: walk14(pa.paged_flash_prefill_plain), iters=3, warmup=1)
    gk_ms = time_ms(lambda: walk14(gather_k2_attention), iters=L, warmup=3)
    T14 = t14_np.shape[1] * PS
    idx14 = t14.long().reshape(-1)
    ar = torch.arange(T14, device=dev)
    mask14 = ((ar[None, None] <= qo[:, None, None] + torch.arange(C, device=dev)[None, :, None])
              & (ar[None, None] < kl[:, None, None]))[:, None]
    q14t = q14.transpose(1, 2)

    def k14_library():  # the pages gathered, SDPA with an explicit offset-causal mask
        li = next(it) % L
        kv = [p[li].index_select(0, idx14).view(B, -1, KVH, PS, D).transpose(1, 2).reshape(B, KVH, T14, D)
              for p in (pool_k, pool_v)]
        return F.scaled_dot_product_attention(q14t, *kv, attn_mask=mask14, enable_gqa=True)

    lib_ms = time_ms(k14_library, iters=L, warmup=3)
    rows.append(dict(name="paged_flash_prefill", source="omchat_torch/csrc/paged_flash_prefill.cu",
                     replaces="omchat_tpu/ops/paged_attention.py:442", max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                     library_ms=lib_ms, flops=4.0 * H * D * causal_cols(c14),
                     bytes=2 * B * C * H * D * 2 + 2 * KVH * int(kv14.sum()) * D * 2 + t14_np.size * 4 + 8 * B,
                     ref_mean_abs=ref_mag, faults=faults, gather_k2_ms=gk_ms,
                     shape=f"B={B} C={C} q_offset={starts.tolist()} kv_len={kv14.tolist()}"))
    del out, ref, q14, q14t, mask14, rowmask

    # K15 — the timed run's largest page commit: the scratch cache
    # [L, B, KVH, T, D] into its requests' pages, chunks past a prompt and
    # replica pad rows onto the parking page (the engine's own page ids).
    c15 = max(timed["commits"], key=lambda c: c["shape"][1] * c["shape"][3])
    _, B, _, T, _ = c15["shape"]
    CH = T // PS
    pages15 = torch.as_tensor(commit_page_ids(c15["tables"], c15["n_pages"], L, CH, NP), device=dev)
    scratch_k, scratch_v = _randn(gen, L, B, KVH, T, D), _randn(gen, L, B, KVH, T, D)
    view_k = scratch_k.view(L * B, KVH, CH, PS, D).transpose(1, 2)
    view_v = scratch_v.view(L * B, KVH, CH, PS, D).transpose(1, 2)
    ref_k, ref_v = kflat.clone(), vflat.clone()
    pa.commit_pages(kflat, vflat, pages15, view_k, view_v)
    torch.cuda.synchronize()
    pa.commit_pages_plain(ref_k, ref_v, pages15, view_k, view_v)
    # the parking pages take duplicate writes in no defined order: each of their
    # 16-byte vectors must come from one of the chunks sent there
    for got, want, chunks in ((kflat, ref_k, view_k), (vflat, ref_v, view_v)):
        flat_chunks = chunks.reshape(-1, KVH * PS * D // 8, 8)
        for li in range(L):
            park = li * NP + P
            sent = (pages15 == park).nonzero()[:, 0]
            if len(sent) and not bool((got[park].reshape(1, -1, 8) == flat_chunks[sent]).all(-1).any(0).all()):
                raise AssertionError(f"K15 commit_pages: parking page {park} holds a vector no chunk sent there")
            want[park] = got[park]
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError("K15 commit_pages: the pool differs from the plain commit (bitwise, all pages)")
    k_ms = time_ms(lambda: pa.commit_pages(kflat, vflat, pages15, view_k, view_v), iters=20)
    p_ms = time_ms(lambda: pa.commit_pages_plain(ref_k, ref_v, pages15, view_k, view_v), iters=20)
    src_k, src_v = view_k.reshape(-1, KVH, PS, D), view_v.reshape(-1, KVH, PS, D)
    idx15 = pages15.long()

    def k15_library():
        kflat.index_copy_(0, idx15, src_k)
        vflat.index_copy_(0, idx15, src_v)

    lib_ms = time_ms(k15_library, iters=20)
    M = int(pages15.numel())
    rows.append(dict(name="commit_pages", source="omchat_torch/csrc/commit_pages.cu",
                     replaces="omchat_tpu/ops/paged_attention.py:695", max_abs_err=0.0, ms=k_ms, plain_ms=p_ms,
                     library_ms=lib_ms, flops=0.0, bytes=4 * M * KVH * PS * D * 2 + M * 4, ref_mean_abs=None,
                     faults={}, shape=f"M={M} (L={L} x B={B} x {CH} pages)"))
    del ref_k, ref_v, scratch_k, scratch_v, view_k, view_v, src_k, src_v, pool_k, pool_v, kflat, vflat

    # K2 at the timed run's largest batched contiguous prefill: its plan's
    # rows and lengths (pad rows replicate the first prompt), bntd scratch
    # cache; a sink at column 0 and 0.8 u at each row's last valid column.
    p2 = max((p for p in timed["prefills"] if len(p["lengths"]) > 1), key=lambda p: len(p["lengths"]) * p["rows"])
    kvl2, width = p2["lengths"], p2["rows"]
    B = len(kvl2)
    q2 = _randn(gen, B, width, H, D) + uq
    k2, v2 = _randn(gen, B, KVH, width, D), _randn(gen, B, KVH, width, D)
    for b, n in enumerate(kvl2):
        k2[b, :, 0] = 0.6 * u
        k2[b, :, n - 1] = 0.8 * u
    q0, kl2 = torch.zeros(B, **i32), torch.as_tensor(kvl2, **i32)
    out = fa.flash_attention(q2, k2, v2, causal=True, q_offset=q0, kv_len=kl2, kv_format="bntd")
    torch.cuda.synchronize()
    valid = (torch.arange(width, device=dev)[None] < kl2[:, None])[..., None, None]

    def k2_plain(q_offset, kv_len):
        return fa.flash_attention_plain(q2, k2, v2, causal=True, q_offset=q_offset, kv_len=kv_len) * valid

    ref = k2_plain(q0, kl2)
    err = check_close("K2 flash_attention (batched prefill)", out * valid, ref, *ATTN_TOL["K2"])
    faults = {"last valid column dropped": check_fault_caught("K2 batched", "the last valid column dropped",
                                                              k2_plain(q0, kl2 - 1), ref, *ATTN_TOL["K2"]),
              "diagonal shifted by one": check_fault_caught("K2 batched", "the causal diagonal shifted by one",
                                                            k2_plain(q0 + 1, kl2), ref, *ATTN_TOL["K2"])}
    ref_mag = float(ref.float().abs().mean())
    k_ms = time_ms(lambda: fa.flash_attention(q2, k2, v2, causal=True, q_offset=q0, kv_len=kl2, kv_format="bntd"))
    p_ms = time_ms(lambda: fa.flash_attention_plain(q2, k2, v2, causal=True, q_offset=q0, kv_len=kl2),
                   iters=3, warmup=1)
    ar = torch.arange(width, device=dev)
    mask2 = ((ar[None, :] <= ar[:, None])[None] & (ar[None, None, :] < kl2[:, None, None]))[:, None]
    q2t = q2.transpose(1, 2)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q2t, k2, v2, attn_mask=mask2, enable_gqa=True))
    cols2 = sum(n * (n + 1) // 2 for n in kvl2)  # the causal columns of the valid rows
    k2_batched = dict(name="flash_attention", source="omchat_torch/csrc/flash_attention.cu",
                      replaces="omchat_tpu/ops/flash_attention.py:246", max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                      library_ms=lib_ms, flops=4.0 * H * D * cols2,
                      bytes=(2 * q2.numel() + 2 * KVH * sum(kvl2) * D) * 2 + 8 * B, ref_mean_abs=ref_mag,
                      faults=faults, shape=f"B={B} width={width} kv_len={kvl2}")
    del q2, k2, v2, q2t, mask2, out, ref

    for r in rows + [k2_batched]:
        r["bound_ms"], r["bound_by"] = bound_ms(r.pop("flops"), r.pop("bytes"))
        mag = "" if r["ref_mean_abs"] is None else f" ref_mean_abs={r['ref_mean_abs']:.3g}"
        caught = "".join(f"; fault '{f}' max_dev={d:.3g} (caught)" for f, d in r["faults"].items())
        gk = f" gather_k2_ms={r['gather_k2_ms']:.4f}" if "gather_k2_ms" in r else ""
        log(f"kernel {r['name']} [{r['shape']}]: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f}{gk} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"max_abs_err={r['max_abs_err']:.3g}{mag}{caught}")
    torch.cuda.empty_cache()
    return rows


def paged_parity(seed: int) -> dict:
    """Phase 7: the first 4 workload requests (1 image, 3 text) through the
    paged engine and, one at a time, the single-request engine, both on
    kernels, at full width and 2 ViT + 2 LLM layers."""
    import torch

    from omchat_torch.config import GenerationConfig, OmChatConfig
    from omchat_torch.runtime.generate import OmChatEngine
    from omchat_torch.runtime.paged_engine import PagedBatchEngine

    full = OmChatConfig()
    cfg = dataclasses.replace(full, vision=dataclasses.replace(full.vision, num_hidden_layers=2),
                              text=dataclasses.replace(full.text, num_hidden_layers=2))
    params = build_model(cfg, seed)
    work = serving_workload(cfg)[:4]
    eng = PagedBatchEngine(cfg, params, image_cache_size=0, device=DEVICE, **SERVING)
    first = capture_first_logits(eng)
    rids = drive(eng, work, PARITY_NEW_TOKENS)
    ref = OmChatEngine(cfg, params, image_cache_size=0, device=DEVICE)
    gen = GenerationConfig(max_new_tokens=PARITY_NEW_TOKENS, eos_token_id=-1)
    out = []
    for i, ((ids, tiles), rid) in enumerate(zip(work, rids)):
        steps = []
        want = ref.generate([ids], tiles, gen, logits_callback=lambda s, lg: steps.append(lg[0].float())).token_ids[0]
        diff = check_close(f"paged vs single-request first-token logits (request {i})", first[rid][0], steps[0],
                           LOGITS_ATOL, LOGITS_RTOL)
        margins = [float(t[0] - t[1]) for t in (torch.topk(lg, 2).values for lg in steps)]
        upto = next((j for j, m in enumerate(margins) if m < PARITY_MARGIN), len(margins))
        got = eng.result(rid)
        if got[:upto] != want[:upto]:
            raise AssertionError(f"paged parity, request {i}: tokens {got[:upto]} != {want[:upto]} "
                                 f"(compared up to step {upto}, the first top-2 margin under {PARITY_MARGIN})")
        out.append({"image": tiles is not None, "logits_max_abs_diff": diff, "tokens_compared": upto,
                    "tokens_equal_beyond": got == want})
    log("paged vs single-request (2 ViT + 2 LLM layers, full width): " + json.dumps(out))
    del eng, ref, params
    torch.cuda.empty_cache()
    return {"requests": out}


# ---------------------------------------------------------------------------
# Phases 8-12: the w8a8 serving mode
# ---------------------------------------------------------------------------


def w8a8_counters():
    from omchat_torch.ops import norms
    from omchat_torch.ops import quant_matmul as qm

    return {
        "rmsnorm_quant": norms.rmsnorm_quant,
        "add_rmsnorm_quant": norms.add_rmsnorm_quant,
        "dense_prequant_gelu_quant": qm.dense_prequant_gelu_quant_cuda,
        "attn_proj_glue_quant": qm.attn_proj_glue_quant,
    }


# the C entry point of each w8a8 kernel, and where its sizes sit among its launch arguments
W8A8_ENTRY = {"omchat_rmsnorm_quant": ("rmsnorm_quant", slice(4, 6)),
              "omchat_add_rmsnorm_quant": ("add_rmsnorm_quant", slice(7, 9)),
              "omchat_fc1_gelu_quant": ("dense_prequant_gelu_quant", slice(7, 10)),
              "omchat_proj_glue_quant": ("attn_proj_glue_quant", slice(10, 12))}


def record_w8a8_launches():
    """Wrap ``kernel_lib.launch`` so a run records the sizes each w8a8
    kernel was handed (rows, D / M, N, K / M, N); returns the record (name →
    {sizes: count}) and a function that restores the launcher."""
    from omchat_torch.ops import kernel_lib

    rec = {name: {} for name, _ in W8A8_ENTRY.values()}
    launch = kernel_lib.launch

    def recording(source, fn_name, argtypes, *args):
        if fn_name in W8A8_ENTRY:
            name, sizes = W8A8_ENTRY[fn_name]
            key = tuple(args[sizes])
            rec[name][key] = rec[name].get(key, 0) + 1
        return launch(source, fn_name, argtypes, *args)

    kernel_lib.launch = recording

    def undo():
        kernel_lib.launch = launch

    return rec, undo


def quantize_full_model(seed: int):
    """Phase 8: the random full model in bf16, then ``api.quantize_model``
    (per-layer int8 quantization on the card, fc1 calibration); returns
    (cfg, params, results)."""
    import torch

    from omchat_torch import api
    from omchat_torch.config import OmChatConfig

    gc.collect()  # earlier phases' engines hold their models through reference cycles (wrapped methods)
    torch.cuda.empty_cache()
    cfg = OmChatConfig()
    params = build_model(cfg, seed)
    torch.cuda.synchronize()
    calibrate = api.calibrate_fc1_scales
    spans = {}

    def timed_calibrate(*a, **kw):
        t = time.perf_counter()
        out = calibrate(*a, **kw)
        torch.cuda.synchronize()
        spans["calibrate_s"] = time.perf_counter() - t
        return out

    api.calibrate_fc1_scales = timed_calibrate
    try:
        t0 = time.perf_counter()
        cfg8, qparams = api.quantize_model(cfg, params, w8a8=True)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        api.calibrate_fc1_scales = calibrate
    del params
    torch.cuda.empty_cache()

    def nbytes(tree, int8_only):
        if isinstance(tree, dict):
            return sum(nbytes(v, int8_only) for v in tree.values())
        return tree.numel() * tree.element_size() if (tree.dtype == torch.int8 or not int8_only) else 0

    scales = qparams["vision_tower"]["layers"]["mlp"]["fc1_out_scale"]
    res = {"int8_weights_gib": nbytes(qparams, True) / 2**30, "all_weights_gib": nbytes(qparams, False) / 2**30,
           "quantize_s": total - spans["calibrate_s"], "calibrate_s": spans["calibrate_s"],
           "fc1_out_scale_min_max": [float(scales.min()), float(scales.max())],
           "memory_allocated_gib": torch.cuda.memory_allocated() / 2**30}
    log("w8a8 quantize + calibrate: " + json.dumps(res))
    if not (torch.isfinite(scales).all() and (scales > 0).all()):
        raise AssertionError("w8a8: calibrated fc1 scales are not finite and positive")
    return cfg8, qparams, res


def w8a8_serving(cfg, params) -> dict:
    """Phase 10: phase 5's workload on the w8a8 model; the glue kernels must
    launch on the short-prefill and the chunk routes."""
    import torch

    from omchat_torch.runtime import paged_engine as pe

    work = serving_workload(cfg)
    eng = pe.PagedBatchEngine(cfg, params, image_cache_size=0, device=DEVICE, **SERVING)
    rec, undo = record_dispatches(eng)
    counts = {**paged_counters(), **w8a8_counters()}
    per_route = {"shorts": {}, "chunk": {}}  # launches inside the short-prefill and chunk dispatches
    for kind, name in (("shorts", "_prefill_shorts"), ("chunk", "_run_chunk")):
        fn = getattr(eng, name)

        def counted(*a, _fn=fn, _kind=kind, **kw):
            before = {n: c.launches for n, c in counts.items()}
            out = _fn(*a, **kw)
            if rec["label"] == "timed":
                for n, c in counts.items():
                    if c.launches > before[n]:
                        per_route[_kind][n] = per_route[_kind].get(n, 0) + c.launches - before[n]
            return out

        setattr(eng, name, counted)
    try:
        res = timed_serving(eng, work, rec, counts, "w8a8 serving")
    finally:
        undo()
    res["launches_by_route"] = per_route
    log("w8a8 serving, launches by prefill route: " + json.dumps(per_route))
    for route in ("shorts", "chunk"):
        missing = [n for n in ("rmsnorm_quant", "attn_proj_glue_quant") if not per_route[route].get(n)]
        if missing:
            raise AssertionError(f"w8a8 serving: {missing} never launched on the {route} route")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def quant_compare(got: dict, ref: dict) -> dict:
    """Codes, x' and row scales of a w8a8 kernel against a reference."""
    import torch

    d = (got["codes"].int() - ref["codes"].int()).abs()
    st = {"code_max_diff": int(d.max()), "code_equal": float((d == 0).float().mean())}
    if "rs" in ref:
        st["scale_rel"] = float(((got["rs"] - ref["rs"]).abs() / ref["rs"].abs()).max())
    if "x" in ref:
        ulp = torch.exp2(torch.floor(torch.log2(ref["x"].float().abs().clamp(min=1e-30))) - 7)
        st["x_ulps"] = float(((got["x"].float() - ref["x"].float()).abs() / ulp).max())
    return st


def quant_ok(st: dict) -> bool:
    return (st["code_max_diff"] <= CODE_MAX_DIFF and st["code_equal"] >= CODE_EQUAL_SHARE
            and st.get("scale_rel", 0.0) <= SCALE_RTOL and st.get("x_ulps", 0.0) <= X_ULPS)


def check_quant(name, got, ref) -> dict:
    st = quant_compare(got, ref)
    if not quant_ok(st):
        raise AssertionError(f"{name}: outside the limits (codes ±{CODE_MAX_DIFF} on all, equal on "
                             f"{CODE_EQUAL_SHARE:.0%}, x' {X_ULPS} ulp, scales rtol {SCALE_RTOL}): {st}")
    return st


def quant_fault_caught(name, fault, faulty, ref) -> dict:
    st = quant_compare(faulty, ref)
    if quant_ok(st):
        raise AssertionError(f"{name}: the limits would pass a kernel that has {fault}: {st}")
    return st


def w8a8_kernel_phases(gen, shapes: dict) -> list:
    """Phase 11: K7, K8, K9 and K11 at the shapes the w8a8 request handed
    them (``shapes``: name → {sizes: launches}), on inputs drawn like the
    path's (unit-normal activations, int8 weights quantized from
    normal(0, 0.02), LayerScale near 0.1), against their plain versions."""
    import torch

    from omchat_torch.config import OmChatConfig
    from omchat_torch.ops import linear as lin
    from omchat_torch.ops import norms
    from omchat_torch.ops import quant_matmul as qm

    rows_out = []
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, off=0.0):
        return (torch.randn(shape, generator=gen, device=DEVICE) * scale + off).to(bf)

    def qlinear(n, k):
        return lin.quantize_linear({"kernel": randn(k, n, scale=0.02)})

    def top(name):  # the most launched shape
        return max(shapes[name].items(), key=lambda kv: kv[1])[0]

    def unfused(xn, gamma):  # the chain: the norm rounded to bf16, then quantized
        q, rs = lin.quantize_activations(norms.rms_norm(xn, gamma))
        return {"codes": q, "rs": rs}

    def row(name, source, replaces, stats, faults, ms, plain_ms, lib_ms, ops, nbytes, shape, peak=PEAK_INT8_OPS):
        b, by = bound_ms(ops, nbytes, peak)
        r = dict(name=name, source=source, replaces=replaces, max_abs_err=float(stats["code_max_diff"]), ms=ms,
                 plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b, bound_by=by, stats=stats, faults=faults,
                 shape=shape)
        rows_out.append(r)
        caught = "".join(f"; fault '{f}' {json.dumps(d)} (caught)" for f, d in faults.items())
        lib = "—" if lib_ms is None else f"{lib_ms:.4f} (torch._int_mm, the GEMM alone)"
        log(f"kernel {name} [{shape}]: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib} "
            f"bound_ms={b:.4f} ({by}) {json.dumps(stats)}{caught}")

    # K7 — the LLM prefill's input norm + quantize
    rows, D = top("rmsnorm_quant")
    x, gamma = randn(rows, D), randn(D, scale=0.1, off=1.0)
    q, rs = norms.rmsnorm_quant(x, gamma)
    torch.cuda.synchronize()
    rq, rrs = norms.rmsnorm_quant_plain(x, gamma)
    ref = {"codes": rq, "rs": rrs}
    st = check_quant("K7 rmsnorm_quant", {"codes": q, "rs": rs}, ref)
    faults = {"gamma dropped": quant_fault_caught("K7", "gamma dropped", dict(zip(
        ("codes", "rs"), norms.rmsnorm_quant_plain(x, torch.ones_like(gamma)))), ref),
        "the bf16-rounded norm quantized (the unfused chain)": quant_fault_caught(
            "K7", "the unfused chain", unfused(x, gamma), ref)}
    row("rmsnorm_quant", "omchat_torch/csrc/norm_quant.cu", "omchat_tpu/ops/norms.py:98", st, faults,
        time_ms(lambda: norms.rmsnorm_quant(x, gamma), iters=50), time_ms(lambda: norms.rmsnorm_quant_plain(x, gamma)),
        None, 0.0, rows * D * 3 + D * 2 + rows * 4, f"rows={rows} D={D}")
    del x, q, rq

    # K8 — the ViT MLP glue: x' = x + y * ls2, then the next layer's norm1 + quantize
    rows, D = top("add_rmsnorm_quant")
    x, delta, ls, gamma = randn(rows, D), randn(rows, D), randn(D, scale=0.02, off=0.1), randn(D, scale=0.1, off=1.0)
    xn, q, rs = norms.add_rmsnorm_quant(x, delta, ls, gamma)
    torch.cuda.synchronize()
    ref = dict(zip(("x", "codes", "rs"), norms.add_rmsnorm_quant_plain(x, delta, ls, gamma)))
    st = check_quant("K8 add_rmsnorm_quant", {"x": xn, "codes": q, "rs": rs}, ref)
    faults = {f: quant_fault_caught("K8", f, dict(zip(("x", "codes", "rs"), fn())), ref) for f, fn in (
        ("LayerScale dropped", lambda: norms.add_rmsnorm_quant_plain(x, delta, None, gamma)),
        ("residual skipped", lambda: norms.add_rmsnorm_quant_plain(torch.zeros_like(x), delta, ls, gamma)))}
    faults["the bf16-rounded norm quantized (the unfused chain)"] = quant_fault_caught(
        "K8", "the unfused chain", {"x": ref["x"], **unfused(ref["x"], gamma)}, ref)
    row("add_rmsnorm_quant", "omchat_torch/csrc/norm_quant.cu", "omchat_tpu/ops/norms.py:148", st, faults,
        time_ms(lambda: norms.add_rmsnorm_quant(x, delta, ls, gamma), iters=50),
        time_ms(lambda: norms.add_rmsnorm_quant_plain(x, delta, ls, gamma)), None,
        0.0, rows * D * 7 + 2 * D * 2 + rows * 4, f"rows={rows} D={D}")
    del x, delta, xn, q, ref

    # K9 — the ViT fc1: codes of a unit-normal activation, a bias near h's
    # spread and the static scale a calibration would set (max |gelu(h)| / 127)
    M, N, K = top("dense_prequant_gelu_quant")
    xq, rs = lin.quantize_activations(randn(M, K))
    p = qlinear(N, K)
    h = lin.int8_matmul(xq, p["kernel_q"].t()).float() * rs * p["scale"].float()
    p["bias"] = randn(N, scale=float(h.std()))
    os_ = lin.div127(lin.gelu_tanh(h + p["bias"].float()).abs().amax())
    del h
    out = qm.dense_prequant_gelu_quant_cuda(xq, rs, p, os_)
    torch.cuda.synchronize()
    ref = {"codes": qm.dense_prequant_gelu_quant_plain(xq, rs, p, os_)}
    st = check_quant("K9 fc1_gelu_quant", {"codes": out}, ref)
    nobias = {k: v for k, v in p.items() if k != "bias"}
    faults = {"bias dropped": quant_fault_caught("K9", "bias dropped", {
        "codes": qm.dense_prequant_gelu_quant_plain(xq, rs, nobias, os_)}, ref),
        "row scales shifted by one row": quant_fault_caught("K9", "row scales shifted by one row", {
            "codes": qm.dense_prequant_gelu_quant_plain(xq, rs.roll(1, 0), p, os_)}, ref)}
    row("dense_prequant_gelu_quant", "omchat_torch/csrc/fc1_gelu_quant.cu", "omchat_tpu/ops/quant_matmul.py:62", st,
        faults, time_ms(lambda: qm.dense_prequant_gelu_quant_cuda(xq, rs, p, os_)),
        time_ms(lambda: qm.dense_prequant_gelu_quant_plain(xq, rs, p, os_), iters=5, warmup=1),
        time_ms(lambda: torch._int_mm(xq, p["kernel_q"].t())), 2.0 * M * N * K,
        M * K + N * K + M * 4 + 2 * N * 2 + 4 + M * N, f"M={M} N={N} K={K}")
    del xq, out, ref, p

    # K11 — at each shape the path gave it (the ViT proj with bias and LayerScale
    # ls1; the Qwen2 o_proj with neither), reported as one row weighted by launches
    parts = []
    vit_width = OmChatConfig().vision.hidden_size
    for (M, N), n_launch in sorted(shapes["attn_proj_glue_quant"].items()):
        vit = N == vit_width  # the ViT proj (bias, LayerScale); else the Qwen2 o_proj
        a, x, gamma = randn(M, N, scale=0.5), randn(M, N), randn(N, scale=0.1, off=1.0)
        p = qlinear(N, N)
        ls = randn(N, scale=0.02, off=0.1) if vit else None
        if vit:
            aq, sa = lin.quantize_activations(a)
            y = lin.int8_matmul(aq, p["kernel_q"].t()).float() * sa * p["scale"].float()
            p["bias"] = randn(N, scale=float(y.std()))
            del y
        xn, q, rs = qm.attn_proj_glue_quant(a, x, p, ls, gamma)
        torch.cuda.synchronize()
        ref = dict(zip(("x", "codes", "rs"), qm.attn_proj_glue_quant_plain(a, x, p, ls, gamma)))
        tag = f"K11 attn_proj_glue_quant M={M} N={N}"
        st = check_quant(tag, {"x": xn, "codes": q, "rs": rs}, ref)
        cases = [("residual skipped", lambda: qm.attn_proj_glue_quant_plain(a, torch.zeros_like(x), p, ls, gamma))]
        if vit:
            nob = {k: v for k, v in p.items() if k != "bias"}
            cases += [("LayerScale dropped", lambda: qm.attn_proj_glue_quant_plain(a, x, p, None, gamma)),
                      ("bias dropped", lambda: qm.attn_proj_glue_quant_plain(a, x, nob, ls, gamma))]
        faults = {f: quant_fault_caught(tag, f, dict(zip(("x", "codes", "rs"), fn())), ref) for f, fn in cases}
        faults["the bf16-rounded norm quantized"] = quant_fault_caught(
            tag, "the bf16-rounded norm quantized", {"x": ref["x"], **unfused(ref["x"], gamma)}, ref)
        aq, _ = lin.quantize_activations(a)
        parts.append(dict(
            launches=n_launch, stats=st, faults=faults, shape=f"M={M} N=K={N}",
            ms=time_ms(lambda: qm.attn_proj_glue_quant(a, x, p, ls, gamma)),
            plain_ms=time_ms(lambda: qm.attn_proj_glue_quant_plain(a, x, p, ls, gamma), iters=5, warmup=1),
            library_ms=time_ms(lambda: torch._int_mm(aq, p["kernel_q"].t())),
            ops=2.0 * M * N * N, nbytes=M * N * 2 * 3 + N * N + M * N + 4 * N * 2 + M * 4))
        del a, x, xn, q, ref, aq, p
    total = sum(pt["launches"] for pt in parts)

    def mean(key):
        return sum(pt[key] * pt["launches"] for pt in parts) / total

    worst = max((pt["stats"] for pt in parts), key=lambda st: (st["code_max_diff"], -st["code_equal"]))
    row("attn_proj_glue_quant", "omchat_torch/csrc/proj_glue_quant.cu", "omchat_tpu/ops/quant_matmul.py:255",
        worst, {f"{pt['shape']}: {f}": d for pt in parts for f, d in pt["faults"].items()}, mean("ms"),
        mean("plain_ms"), mean("library_ms"), mean("ops"), mean("nbytes"),
        "; ".join(f"{pt['shape']} x{pt['launches']}: {pt['ms']:.4f} ms, plain {pt['plain_ms']:.4f}, "
                  f"_int_mm {pt['library_ms']:.4f}, bound {bound_ms(pt['ops'], pt['nbytes'], PEAK_INT8_OPS)[0]:.4f}"
                  for pt in parts) + " (launch-weighted means)")
    torch.cuda.empty_cache()
    return rows_out


def w8a8_kernel_vs_plain(seed: int) -> dict:
    """Phase 12: the model at full width and 2 ViT + 2 LLM layers; first-token
    logits of the w8a8 model through the glue kernels and through
    ``attn_impl="plain"`` (the unfused w8a8 chain, plain attention), and of
    the bf16 model through the plain route."""
    import torch

    from omchat_torch import api
    from omchat_torch.config import OmChatConfig
    from omchat_torch.runtime.generate import OmChatEngine

    full = OmChatConfig()
    cfg = dataclasses.replace(full, vision=dataclasses.replace(full.vision, num_hidden_layers=2),
                              text=dataclasses.replace(full.text, num_hidden_layers=2))
    bf16 = build_model(cfg, seed)
    cfg8, params = api.quantize_model(cfg, bf16, w8a8=True)
    ids, tiles = make_request(cfg, seed)
    logits = {}
    for key, c, p, impl in (("kernels", cfg8, params, None), ("plain", cfg8, params, "plain"),
                            ("bf16_plain", cfg, bf16, "plain")):
        eng = OmChatEngine(c, p, attn_impl=impl, image_cache_size=0)
        logits[key], _ = eng.prefill(eng.plan([ids]), eng.encode_images(tiles), 32)
    torch.cuda.synchronize()
    got, ref = logits["kernels"], logits["plain"]
    diff, top = float((got - ref).abs().max()), float(ref.abs().max())
    quant = float((ref - logits["bf16_plain"]).abs().max())
    res = {"logits_max_abs_diff": diff, "logits_max_abs": top, "rel": diff / top,
           "w8a8_vs_bf16_max_abs_diff": quant, "argmax_equal": bool(torch.equal(got.argmax(-1), ref.argmax(-1)))}
    log("w8a8 kernels vs plain (2 ViT + 2 LLM layers, full width): " + json.dumps(res))
    if not torch.isfinite(got).all() or diff > quant:
        raise AssertionError(f"w8a8 kernels vs plain: logits differ by {diff:.4g}, more than w8a8 moves the plain "
                             f"chain from bf16 ({quant:.4g})")
    del params, bf16
    gc.collect()
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

    serve, timed = serving(args.seed)
    paged_rows = paged_kernel_phases(gen, timed)
    paged_parity(args.seed)

    cfg8, params8, _ = quantize_full_model(args.seed)
    shapes8, undo = record_w8a8_launches()
    try:
        e2e8 = end_to_end(args.seed, model=(cfg8, params8), counted={**counters(), **w8a8_counters()},
                          label="w8a8 e2e")
    finally:
        undo()
    log("w8a8 kernel shapes (timed and warm-up runs, launches per shape): "
        + json.dumps({n: {str(k): v for k, v in d.items()} for n, d in shapes8.items()}))
    bf16_vs_w8a8 = {k: [e2e[k], e2e8[k]] for k in ("ttft_ms", "vit_ms", "prefill_ms", "decode_tokens_per_s",
                                                   "peak_mem_gib")}
    log("bf16 vs w8a8, single request (this call): " + json.dumps(bf16_vs_w8a8))
    w8a8_serving(cfg8, params8)
    del params8
    w8a8_rows = w8a8_kernel_phases(gen, shapes8)
    w8a8_kernel_vs_plain(args.seed)

    # each kernel's launches on its own main path: K1-K4 on the single-image
    # request (phase 3), K12, K14 and K15 in the timed serving run (phase 5),
    # K7, K8, K9 and K11 on the w8a8 single-image request (phase 9)
    launches = {**e2e["launches"], **{n: serve["launches"][n] for n in
                                      ("paged_flash_decode", "paged_flash_prefill", "commit_pages")},
                **{n: e2e8["launches"][n] for n in w8a8_counters()}}
    kernels = [{
        "name": r["name"], "route": "cuda", "source": r["source"], "replaces": r["replaces"],
        "launches": launches[r["name"]], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
    } for r in rows + paged_rows + w8a8_rows]
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
