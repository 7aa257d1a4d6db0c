"""The fp8 (e4m3) KV cache on the CPU against the JAX package.

- The store's rounding (``ops.fp8.to_e4m3``) on every bf16 bit pattern,
  bitwise, NaN signs included.
- K4 and K15 plain on e4m3 pools against the Pallas kernels in interpret
  mode, bitwise, with a value past 464 that both sides store as NaN.
- K3, K12, K13 and K14 plain on e4m3 caches against the Pallas kernels in
  interpret mode: float32 q, so the widened K/V are exact and p is not
  rounded; their float32 limits (atol 1e-5, K3 3e-5 / rtol 1e-4, as in
  tests/test_torch_paged_kernels.py and tests/test_torch_kernels_ref.py).
- K2 plain on an e4m3 cache, whose p is rounded to e4m3 on both sides: an fp32
  p that sits at an e4m3 rounding midpoint may round the other way on the other
  side (its scores are summed in another order), one e4m3 ulp (1/16 of p);
  limit atol 2e-3, the card's K2 limit (8e-3) scaled to these O(0.1) outputs.
- A control: the plain K12 as it was before the repair (self column and p
  rounded to the pool's dtype) falls outside K12's limit on an e4m3 pool.
- Both engines on ``OmChatConfig.tiny()`` float32 with an e4m3 cache against
  the JAX engines with ``cache_dtype=float8_e4m3fn`` (XLA attention):
  identical greedy tokens on every paged prefill route, at decode_roll 1 and
  4, on K12's and K13's route, and on the plain route; the single-request
  engine's kernel route by first-step logits (its K2 rounds p to e4m3 where
  XLA keeps fp32: limit 2e-3, about 10x the gap measured here).
- ``--kv-cache-dtype fp8`` (and ``--decode-kernel manual``) on both CLIs.
"""

import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.config import GenerationConfig as TGenerationConfig
from omchat_torch.config import OmChatConfig as TOmChatConfig
from omchat_torch.ops import decode_attention as t_decode
from omchat_torch.ops import flash_attention as t_flash
from omchat_torch.ops import paged_attention as t_paged
from omchat_torch.ops.fp8 import E4M3, to_e4m3
from omchat_torch.runtime.generate import OmChatEngine as TEngine
from omchat_torch.runtime.paged_engine import PagedBatchEngine as TPagedEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5  # K12, K13, K14 (float32 q, widened e4m3 K/V)
K3_ATOL, K3_RTOL = 3e-5, 1e-4
K2_E4M3_ATOL = 2e-3  # p rounded to e4m3 on both sides
ENGINE_LOGITS_ATOL = 2e-3


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _e4m3(a: np.ndarray):
    """One float32 array as the same e4m3 values on both sides: (jax, torch)."""
    j = jnp.asarray(a).astype(jnp.float8_e4m3fn)
    t = torch.from_numpy(np.asarray(j).view(np.uint8).copy()).view(E4M3)
    return j, t


def _bits(x) -> np.ndarray:
    return (x.view(torch.uint8).numpy() if isinstance(x, torch.Tensor) else np.asarray(x).view(np.uint8))


# ---------------------------------------------------------------------------
# the store's rounding
# ---------------------------------------------------------------------------


def test_to_e4m3_matches_jax_on_every_bf16_pattern():
    """All 65536 bf16 bit patterns: subnormals, the 448 / 464 boundary,
    overflow, +-inf and NaNs of both signs; NaN compared by its bits too."""
    pats = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    want = _bits(jnp.asarray(pats).view(jnp.bfloat16).astype(jnp.float8_e4m3fn))
    got = _bits(to_e4m3(torch.from_numpy(pats.view(np.int16).copy()).view(torch.bfloat16)))
    np.testing.assert_array_equal(got, want)
    f = torch.from_numpy(pats.view(np.int16).copy()).view(torch.bfloat16).float().numpy()
    nan = (got & 0x7F) == 0x7F
    assert nan[np.isfinite(f) & (np.abs(f) > 464)].all() and not nan[np.abs(f) <= 464].any()


def test_to_e4m3_matches_jax_on_float32():
    """float32 inputs (the tiny test model's): ties at every scale, the
    subnormal range and the overflow edge."""
    rng = np.random.default_rng(0)
    edges = np.asarray([448.0, 449.0, 463.99, 464.0, 464.01, 480.0, 1e30, 2.0**-9, 2.0**-10, 1.5 * 2.0**-10,
                        3 * 2.0**-11, 0.0, -0.0, 0.0625 * 1.0625, 1.0 + 1 / 16, 1.0 + 3 / 16], np.float32)
    x = np.concatenate([edges, -edges, rng.standard_normal(20000).astype(np.float32) * 40,
                        rng.standard_normal(20000).astype(np.float32) * 1e-2])
    np.testing.assert_array_equal(_bits(to_e4m3(torch.from_numpy(x))), _bits(jnp.asarray(x).astype(jnp.float8_e4m3fn)))


# ---------------------------------------------------------------------------
# K4 and K15 into e4m3 pools
# ---------------------------------------------------------------------------


def test_commit_rows_e4m3_matches_pallas_bitwise():
    """K4: float32 rows into an e4m3 pool, one row holding 500 and -1000,
    which both sides store as NaN of their sign."""
    from omchat_tpu.ops.paged_attention import commit_rows

    rng = np.random.default_rng(5)
    P, KVH, PS, D, N = 6, 2, 16, 128, 4
    jk, tk = _e4m3(_np(rng, P, KVH, PS, D))
    jv, tv = _e4m3(_np(rng, P, KVH, PS, D))
    pages = np.asarray([0, 3, 5, 2], np.int32)
    offsets = np.asarray([0, 7, 15, 9], np.int32)
    kr, vr = _np(rng, N, KVH, D) * 8, _np(rng, N, KVH, D) * 8
    kr[1, 0, :2] = (500.0, -1000.0)
    ref_k, ref_v = commit_rows(jk, jv, jnp.asarray(pages), jnp.asarray(offsets), jnp.asarray(kr), jnp.asarray(vr),
                               interpret=True)
    t_paged.commit_rows(tk, tv, _t(pages), _t(offsets), _t(kr), _t(vr))
    np.testing.assert_array_equal(_bits(tk), _bits(ref_k))
    np.testing.assert_array_equal(_bits(tv), _bits(ref_v))
    assert list(_bits(tk)[3, 0, 7, :2]) == [0x7F, 0xFF]


def test_commit_pages_e4m3_matches_pallas_bitwise():
    """K15: float32 chunks into an e4m3 pool (the paged engine's scratch cache
    is the weights' dtype, the pool e4m3), one value past 464, and the strided
    [G, C, ...] view of a scratch cache."""
    from omchat_tpu.ops.paged_attention import commit_pages

    rng = np.random.default_rng(24)
    NP, KVH, PS, D = 10, 2, 8, 32
    jk, tk = _e4m3(_np(rng, NP, KVH, PS, D))
    jv, tv = _e4m3(_np(rng, NP, KVH, PS, D))
    pages = np.asarray([3, 0, 7, 5], np.int32)
    kc, vc = _np(rng, 4, KVH, PS, D) * 8, _np(rng, 4, KVH, PS, D) * 8
    kc[2, 1, 3, 4] = 470.0
    ref_k, ref_v = commit_pages(jk, jv, jnp.asarray(pages), jnp.asarray(kc), jnp.asarray(vc), interpret=True)
    t_paged.commit_pages(tk, tv, _t(pages), _t(kc), _t(vc))
    np.testing.assert_array_equal(_bits(tk), _bits(ref_k))
    np.testing.assert_array_equal(_bits(tv), _bits(ref_v))
    assert _bits(tk)[7, 1, 3, 4] == 0x7F
    scratch = _t(_np(rng, 2, KVH, 2 * PS, D))
    view = scratch.view(2, KVH, 2, PS, D).transpose(1, 2)
    a = torch.zeros(NP, KVH, PS, D, dtype=E4M3)
    t_paged.commit_pages(a, a.clone(), _t(np.asarray([1, 2, 4, 6], np.int32)), view, view)
    np.testing.assert_array_equal(_bits(a[4]), _bits(to_e4m3(scratch[1, :, :PS])))


# ---------------------------------------------------------------------------
# attention on e4m3 caches
# ---------------------------------------------------------------------------


def _paged_case(rng, B=4, H=8, KVH=2, D=128, PS=16, W=4, P=12):
    lengths = np.asarray([0, 37, 32, 64], np.int32)[:B]
    kp, vp = _np(rng, P + 1, KVH, PS, D), _np(rng, P + 1, KVH, PS, D)
    perm = rng.permutation(P)
    tables = np.full((B, W), P, np.int32)
    used = 0
    for b, n in enumerate(lengths):
        live = -(-int(n) // PS)
        tables[b, :live] = perm[used: used + live]
        used += live
    return lengths, kp, vp, tables, _np(rng, B, 1, H, D), _np(rng, B, KVH, D), _np(rng, B, KVH, D)


@pytest.mark.parametrize("self_col", [True, False], ids=["self_column", "no_self_column"])
def test_paged_flash_decode_e4m3_matches_pallas(self_col):
    """K12 on an e4m3 pool: ragged lengths, parked table entries; the self
    column in q's dtype, unrounded, as the Pallas kernel folds it."""
    from omchat_tpu.ops.paged_attention import paged_flash_decode

    lengths, kp, vp, tables, q, kn, vn = _paged_case(np.random.default_rng(21))
    (jk, tk), (jv, tv) = _e4m3(kp), _e4m3(vp)
    extra_j = (jnp.asarray(kn), jnp.asarray(vn)) if self_col else ()
    extra_t = (_t(kn), _t(vn)) if self_col else ()
    ref = paged_flash_decode(jnp.asarray(q), jk, jv, jnp.asarray(lengths), jnp.asarray(tables), *extra_j,
                             interpret=True)
    out = t_paged.paged_flash_decode(_t(q), tk, tv, _t(lengths), _t(tables), *extra_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("pool", ["bf16", "e4m3"])
def test_paged_flash_decode_manual_matches_pallas(pool):
    """K13's plain version against the manual-copy Pallas kernel, on a bf16
    and an e4m3 pool, with the self column."""
    from omchat_tpu.ops.paged_attention import paged_flash_decode_manual

    lengths, kp, vp, tables, q, kn, vn = _paged_case(np.random.default_rng(31))
    if pool == "e4m3":
        (jk, tk), (jv, tv) = _e4m3(kp), _e4m3(vp)
    else:
        jk, jv = jnp.asarray(kp).astype(jnp.bfloat16), jnp.asarray(vp).astype(jnp.bfloat16)
        tk, tv = _t(kp).bfloat16(), _t(vp).bfloat16()
    ref = paged_flash_decode_manual(jnp.asarray(q), jk, jv, jnp.asarray(lengths), jnp.asarray(tables),
                                    jnp.asarray(kn), jnp.asarray(vn), interpret=True)
    out = t_paged.paged_flash_decode_manual(_t(q), tk, tv, _t(lengths), _t(tables), _t(kn), _t(vn))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    routed = t_paged.paged_decode_attention(_t(q), tk, tv, _t(lengths), _t(tables), k_new=_t(kn), v_new=_t(vn),
                                            kernel="manual")
    assert torch.equal(routed, out)
    assert t_paged.paged_flash_decode_manual.launches == 0  # CPU tensors never launch


def _pre_repair_k12(q, k_pages, v_pages, lengths, page_tables, k_new, v_new):
    """The plain K12 as it was before the fp8 cache: the self column and p
    rounded to the pool's dtype (right for a bf16 pool, not for e4m3)."""
    B, _, H, D = q.shape
    _, KVH, PS, _ = k_pages.shape
    k, v = t_paged._gather_pages(k_pages, v_pages, page_tables)
    T = k.shape[2]
    qg = q[:, 0].reshape(B, KVH, H // KVH, D).float()
    s = torch.einsum("bngd,bntd->bngt", qg, k.float()) * (D**-0.5 * t_flash.LOG2E)
    s = torch.where((torch.arange(T)[None, :] < lengths[:, None])[:, None, None, :], s, torch.tensor(float("-inf")))
    s_self = torch.einsum("bngd,bnd->bng", qg, to_e4m3(k_new).float()) * (D**-0.5 * t_flash.LOG2E)
    s = torch.cat([s, s_self[..., None]], dim=-1)
    v = torch.cat([v, to_e4m3(v_new)[:, :, None]], dim=2)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bngt,bntd->bngd", to_e4m3(p).float(), v.float()) / p.sum(dim=-1, keepdim=True)
    return o.reshape(B, 1, H, D)


def test_pre_repair_plain_k12_falls_outside_the_limit():
    """The control: on the e4m3 pool where the repaired plain K12 meets the
    Pallas kernel within ATOL, the pre-repair one does not."""
    from omchat_tpu.ops.paged_attention import paged_flash_decode

    lengths, kp, vp, tables, q, kn, vn = _paged_case(np.random.default_rng(21))
    (jk, tk), (jv, tv) = _e4m3(kp), _e4m3(vp)
    ref = np.asarray(paged_flash_decode(jnp.asarray(q), jk, jv, jnp.asarray(lengths), jnp.asarray(tables),
                                        jnp.asarray(kn), jnp.asarray(vn), interpret=True))
    args = (_t(q), tk, tv, _t(lengths), _t(tables), _t(kn), _t(vn))
    np.testing.assert_allclose(t_paged.paged_flash_decode_plain(*args).numpy(), ref, atol=ATOL, rtol=0)
    assert np.abs(_pre_repair_k12(*args).numpy() - ref).max() > 100 * ATOL


@pytest.mark.parametrize("C", [32, 64])
def test_paged_flash_prefill_e4m3_matches_pallas(C):
    """K14 on an e4m3 pool: page-aligned q_offset, ragged kv_len; p in q's
    dtype, as the Pallas kernel casts the pages to it."""
    from omchat_tpu.ops.paged_attention import paged_flash_prefill

    rng = np.random.default_rng(23)
    B, H, KVH, D, PS, W, P = 2, 8, 2, 128, 16, 8, 16
    q_offset = np.asarray([16, 48], np.int32)
    kv_len = q_offset + np.asarray([C, C - 9], np.int32)
    (jk, tk), (jv, tv) = _e4m3(_np(rng, P, KVH, PS, D)), _e4m3(_np(rng, P, KVH, PS, D))
    tables = rng.permutation(P)[:B * W].reshape(B, W).astype(np.int32)
    q = _np(rng, B, C, H, D)
    ref = np.asarray(paged_flash_prefill(jnp.asarray(q), jk, jv, jnp.asarray(kv_len), jnp.asarray(tables),
                                         jnp.asarray(q_offset), interpret=True))
    out = t_paged.paged_flash_prefill(_t(q), tk, tv, _t(kv_len), _t(tables), _t(q_offset)).numpy()
    for b in range(B):
        rows = int(kv_len[b] - q_offset[b])
        np.testing.assert_allclose(out[b, :rows], ref[b, :rows], atol=ATOL, rtol=0)


def test_flash_attention_e4m3_matches_pallas():
    """K2 on an e4m3 bntd cache: both sides round p to e4m3 for the PV
    product (flash_attention.py:145,162 in the JAX package)."""
    from omchat_tpu.ops.flash_attention import flash_attention

    rng = np.random.default_rng(2)
    B, S, T, H, KVH, D = 2, 64, 128, 14, 2, 128
    q = _np(rng, B, S, H, D)
    (jk, tk), (jv, tv) = _e4m3(_np(rng, B, KVH, T, D)), _e4m3(_np(rng, B, KVH, T, D))
    qo, kl = np.asarray([0, 40], np.int32), np.asarray([64, 100], np.int32)
    ref = np.asarray(flash_attention(jnp.asarray(q), jk, jv, causal=True, q_offset=jnp.asarray(qo),
                                     kv_len=jnp.asarray(kl), kv_format="bntd", block_q=64, block_k=64,
                                     interpret=True))
    out = t_flash.flash_attention(_t(q), tk, tv, causal=True, q_offset=_t(qo), kv_len=_t(kl), kv_format="bntd")
    for b in range(B):
        rows = min(S, int(kl[b]) - int(qo[b]))
        np.testing.assert_allclose(out[b, :rows].numpy(), ref[b, :rows], atol=K2_E4M3_ATOL, rtol=0)
    # the rounding of p is what the limit allows for: with p in fp32 the gap is far larger
    p32 = t_flash.flash_attention_plain(_t(q), tk.float(), tv.float(), causal=True, q_offset=_t(qo), kv_len=_t(kl))
    assert float((p32 - out).abs().max()) > 2 * float(np.abs(out.numpy() - ref)[0, :64].max())


@pytest.mark.parametrize("cache_len", [[0, 0], [37, 200]], ids=["empty", "ragged"])
def test_flash_decode_stacked_e4m3_matches_pallas(cache_len):
    """K3 on an e4m3 stacked cache, the self column in q's dtype."""
    from omchat_tpu.ops.decode_attention import flash_decode_stacked

    rng = np.random.default_rng(4)
    L, B, H, KVH, T, D = 3, 2, 28, 4, 256, 128
    q = _np(rng, B, 1, H, D)
    (jk, tk), (jv, tv) = _e4m3(_np(rng, L, B, KVH, T, D)), _e4m3(_np(rng, L, B, KVH, T, D))
    kn, vn = _np(rng, B, KVH, D), _np(rng, B, KVH, D)
    lens = np.asarray(cache_len, np.int32)
    ref = flash_decode_stacked(jnp.asarray(q), jk, jv, jnp.asarray(lens), jnp.int32(1), jnp.asarray(kn),
                               jnp.asarray(vn), block_k=128, interpret=True)
    out = t_decode.flash_decode_stacked(_t(q), tk, tv, _t(lens), 1, _t(kn), _t(vn))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=K3_ATOL, rtol=K3_RTOL)


@pytest.mark.parametrize("which", ["paged_flash_decode_manual", "commit_rows_e4m3", "commit_pages_e4m3"])
def test_fp8_wrappers_never_fall_back_off_the_cpu(which):
    """A tensor that is not on the CPU launches the kernel or raises."""
    m = lambda *s, dt=torch.bfloat16: torch.empty(*s, device="meta", dtype=dt)  # noqa: E731
    i32 = torch.zeros((1, 1), dtype=torch.int32)
    calls = {
        "paged_flash_decode_manual": lambda: t_paged.paged_flash_decode_manual(
            m(1, 1, 2, 128), m(2, 2, 128, 128, dt=E4M3), m(2, 2, 128, 128, dt=E4M3), i32[0], i32, m(1, 2, 128),
            m(1, 2, 128)),
        "commit_rows_e4m3": lambda: t_paged.commit_rows(
            m(2, 2, 8, 128, dt=E4M3), m(2, 2, 8, 128, dt=E4M3), i32[0], i32[0], m(1, 2, 128), m(1, 2, 128)),
        "commit_pages_e4m3": lambda: t_paged.commit_pages(
            m(2, 2, 128, 128, dt=E4M3), m(2, 2, 128, 128, dt=E4M3), i32[0], m(1, 2, 128, 128), m(1, 2, 128, 128)),
    }
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        calls[which]()


# ---------------------------------------------------------------------------
# engines on the tiny float32 checkpoint
# ---------------------------------------------------------------------------

NEW_TOKENS = 12
_JAX_SINGLE = {}


def _request():
    from omchat_torch.processing.chat import image_prompt, make_context
    from omchat_torch.utils.testing import MockTokenizer

    _, ids = make_context(MockTokenizer(), image_prompt("what is in the picture?", 2), None,
                          "You are a helpful assistant.")
    return ids, np.random.default_rng(7).standard_normal((2, 3, 56, 56)).astype(np.float32)


def _jax_single():
    """The JAX engine with an e4m3 cache (XLA attention): greedy tokens and
    first-step logits, computed once."""
    if not _JAX_SINGLE:
        from omchat_tpu.config import GenerationConfig, OmChatConfig
        from omchat_tpu.runtime.generate import OmChatEngine
        from tests.test_sharding import _tiny_params

        cfg = OmChatConfig.tiny()
        params = _tiny_params(cfg)
        ids, px = _request()
        eng = OmChatEngine(cfg, params, attn_impl="xla", image_cache_size=0, cache_dtype=jnp.float8_e4m3fn)
        out = eng.generate([ids], px, GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1))
        logits, _ = eng.prefill(eng.plan([ids]), eng.encode_images(px), NEW_TOKENS)
        _JAX_SINGLE.update(params=jax.device_get(params), tokens=out.token_ids, logits=np.asarray(logits))
    return _JAX_SINGLE


@pytest.mark.parametrize("impl", ["plain", None], ids=["plain_path", "kernel_path"])
def test_single_request_e4m3_cache_matches_jax_engine(impl):
    """The plain route: identical greedy tokens.  The kernel route: first-step
    logits within ENGINE_LOGITS_ATOL (K2's p in e4m3, XLA's in fp32)."""
    ref = _jax_single()
    ids, px = _request()
    eng = TEngine(TOmChatConfig.tiny(), from_jax_params(ref["params"]), attn_impl=impl, cache_dtype=E4M3,
                  device="cpu")
    first = {}
    out = eng.generate([ids], px, TGenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_id=-1),
                       logits_callback=lambda step, lg: first.setdefault(step, lg.clone()))
    np.testing.assert_allclose(first[0].numpy(), ref["logits"], atol=ENGINE_LOGITS_ATOL if impl is None else 1e-4,
                               rtol=0)
    if impl == "plain":
        assert out.token_ids == ref["tokens"]
    feats = eng.encode_images(px)
    _, cache = eng.prefill(eng.plan([ids]), feats, NEW_TOKENS)
    assert cache.k.dtype == E4M3 and cache.v.dtype == E4M3


PAGED = dict(max_slots=4, num_pages=40, page_size=8, prompt_bucket=16, max_len=96, prefill_chunk=32)
PAGED_NEW = 6


@pytest.fixture(scope="module")
def paged_reference():
    """The JAX paged engine with an e4m3 pool on test_torch_paged_engine's
    workload (batched shorts, chunked and grouped image prompts, a lone
    short), run once."""
    from omchat_tpu.config import GenerationConfig, OmChatConfig
    from omchat_tpu.runtime.paged_engine import PagedBatchEngine
    from tests.test_sharding import _tiny_params
    from tests.test_torch_paged_engine import _workload

    cfg = OmChatConfig.tiny()
    params = _tiny_params(cfg)
    eng = PagedBatchEngine(cfg, params, attn_impl="xla", cache_dtype=jnp.float8_e4m3fn, **PAGED)
    gen = GenerationConfig(max_new_tokens=PAGED_NEW, eos_token_id=-1)
    rids = [eng.submit(ids, px, max_new_tokens=PAGED_NEW, eos_token_id=-1, generation=gen) for ids, px in _workload()]
    eng.run_to_completion(max_ticks=200)
    return from_jax_params(jax.device_get(params)), [eng.result(r) for r in rids], _workload()


def _paged_port(params, **kw):
    return TPagedEngine(TOmChatConfig.tiny(), params, device="cpu", cache_dtype=E4M3, **{**PAGED, **kw})


def _drive(eng, work):
    rids = [eng.submit(ids, px, max_new_tokens=PAGED_NEW, eos_token_id=-1) for ids, px in work]
    assert eng.run_to_completion(max_ticks=200) < 200
    return [eng.result(r) for r in rids]


@pytest.mark.parametrize("roll,kernel,impl", [(1, "auto", None), (4, "auto", None), (1, "manual", None),
                                              (4, "manual", None), (4, "manual", "plain")],
                         ids=["roll1_k12", "roll4_k12", "roll1_k13", "roll4_k13", "plain_roll4"])
def test_paged_engine_e4m3_pool_matches_jax(paged_reference, roll, kernel, impl, monkeypatch):
    """Identical greedy tokens on every prefill route; the decode goes
    through the kernel ``decode_kernel`` names (none on the plain route), the
    pool is e4m3 and every page comes back."""
    params, want, work = paged_reference
    calls = {"auto": 0, "manual": 0}
    for name, fn in list(t_paged.DECODE_KERNELS.items()):
        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setitem(t_paged.DECODE_KERNELS, name, counted)
    eng = _paged_port(params, decode_roll=roll, decode_kernel=kernel, attn_impl=impl)
    assert eng.k_pool.dtype == E4M3
    assert _drive(eng, work) == want
    assert eng.allocator.available == PAGED["num_pages"]
    other = "auto" if kernel == "manual" else "manual"
    assert calls[other] == 0 and (calls[kernel] == 0) == (impl == "plain")


def test_paged_engine_e4m3_pages_return_after_cancel(paged_reference):
    params, want, work = paged_reference
    eng = _paged_port(params, decode_roll=2, decode_kernel="manual")
    assert _drive(eng, work) == want
    rid = eng.submit(list(range(5, 40)), None, max_new_tokens=40, eos_token_id=-1)
    eng.step()
    eng.step()
    assert eng.stats()["pages_free"] < PAGED["num_pages"] and not eng.finished(rid)
    eng.cancel(rid)
    eng.step()
    assert eng.finished(rid) and not eng.has_work()
    assert eng.allocator.available == PAGED["num_pages"]


def test_unknown_decode_kernel_raises():
    with pytest.raises(ValueError, match="decode_kernel"):
        TPagedEngine(TOmChatConfig.tiny(), {"language_model": {"embed_tokens": torch.zeros(2)}}, device="cpu",
                     decode_kernel="fast")


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    from PIL import Image

    from tests.test_api_e2e import _write_tiny_checkpoint, _write_tiny_tokenizer

    d = tmp_path_factory.mktemp("tiny_ckpt")
    _write_tiny_tokenizer(str(d))
    _write_tiny_checkpoint(str(d))
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (120, 90, 3), dtype=np.uint8)).save(d / "img.png")
    return d


def test_single_inference_cli_fp8_cache(tiny_ckpt, capsys, monkeypatch):
    from omchat_torch.cli.single_inference import main
    from omchat_torch.runtime import generate

    made = []
    init = generate.OmChatEngine.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(generate.OmChatEngine, "__init__", spy)
    main(["--model-path", str(tiny_ckpt), "--image-path", str(tiny_ckpt / "img.png"), "--question", "what?",
          "--max-new-tokens", "3", "--kv-cache-dtype", "fp8", "--device", "cpu"])
    assert capsys.readouterr().out.endswith("\n")
    assert [e.cache_dtype for e in made] == [E4M3]


def test_serve_cli_fp8_cache_and_manual_decode(tiny_ckpt):
    """``python -m omchat_torch.cli.serve --kv-cache-dtype fp8 --decode-kernel
    manual --device cpu`` answers /health and a chat completion."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-m", "omchat_torch.cli.serve", "--model-path", str(tiny_ckpt), "--device", "cpu",
         "--host", "127.0.0.1", "--port", str(port), "--kv-cache-dtype", "fp8", "--decode-kernel", "manual",
         "--num-pages", "64", "--page-size", "16", "--max-len", "512", "--prefill-chunk", "128", "--max-slots", "2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5) as r:
                    assert b"ok" in r.read()
                break
            except OSError:
                if proc.poll() is not None or time.time() > deadline:
                    raise AssertionError(f"server did not come up: {proc.communicate()[0][-2000:]}")
                time.sleep(0.5)
        import json

        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/chat/completions",
            data=json.dumps({"messages": [{"role": "user", "content": "hello"}], "max_tokens": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert 1 <= out["usage"]["completion_tokens"] <= 3
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
