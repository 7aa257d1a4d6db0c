"""Decode and paged attention at head widths other than 128, on the CPU
against the JAX package.

- K3 (``flash_decode_stacked``), K6 (``flash_decode``), K12
  (``paged_flash_decode``), K13 (``paged_flash_decode_manual``) and K14
  (``paged_flash_prefill``) plain against the Pallas kernels in interpret
  mode at head widths 16, 64 and 72, over bf16 and e4m3 caches, at GQA
  groups 7 and 1, with keys planted at the rows on both sides of a split-KV
  chunk's edge (K3, K6) or a page's (K12, K13, K14); K2 on an e4m3 cache
  (``flash_attention``) likewise.  float32 queries, so the widened caches
  are exact; each kernel at the float32 limit of its 128-wide test: K3
  atol 3e-5 / rtol 1e-4 (tests/test_torch_kernels_ref.py), K6 2e-5 / 1e-4
  (tests/test_torch_flash_decode.py), K12 / K13 / K14 atol 1e-5
  (tests/test_torch_paged_kernels.py), K2 on e4m3 atol 2e-3
  (tests/test_torch_fp8.py: p rounded to e4m3 on both sides).
- The one width rule of the CUDA entries (``head_dim_supported``): which
  (D, cache dtype) each wrapper hands its C entry, recorded instead of
  launched, and the message of each refusal; ``decode_splits`` /
  ``paged_splits`` and the split scratch at D = 64.
- A model of the new geometry (Qwen2-0.5B's head width 64 and group 7,
  InternViT-300M's head width 64 without qk-norm; 2 + 2 layers, narrow
  elsewhere, float32 weights) through ``OmChatEngine``,
  ``PagedBatchEngine`` (K12 and K13) and ``BatchEngine`` against the JAX
  engines on the same weights (``from_jax_params``, XLA attention there):
  greedy ids equal and first-token logits within ENGINE_LOGITS_REL of max
  |logit|, on bf16 and e4m3 caches.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.ops import decode_attention as t_decode
from omchat_torch.ops import flash_attention as t_flash
from omchat_torch.ops import paged_attention as t_paged
from omchat_torch.ops.fp8 import E4M3

WIDTHS = (16, 64, 72)
GROUPS = {"group7": (14, 2), "group1": (2, 2)}  # (q heads, kv heads)
K3_TOL = dict(atol=3e-5, rtol=1e-4)
K6_TOL = dict(atol=2e-5, rtol=1e-4)
PAGED_TOL = dict(atol=1e-5, rtol=0)
K2_E4M3_TOL = dict(atol=2e-3, rtol=0)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cache(a: np.ndarray, cache: str):
    """One float32 array stored in the cache's dtype, the same values on both
    sides: (jax, torch)."""
    if cache == "e4m3":
        j = jnp.asarray(a).astype(jnp.float8_e4m3fn)
        return j, torch.from_numpy(np.asarray(j).view(np.uint8).copy()).view(E4M3)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, _t(a).bfloat16()


def _directions(rng, KVH, D):
    """±1 vectors, one a kv head: q carries its kv head's, a planted key 0.8 of it."""
    return (rng.integers(0, 2, (KVH, D)) * 2 - 1).astype(np.float32)


def _query(rng, B, S, H, KVH, D, u):
    return _np(rng, B, S, H, D) + np.repeat(u, H // KVH, axis=0)


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
@pytest.mark.parametrize("D", WIDTHS)
def test_flash_decode_stacked_at_head_width(D, cache, group):
    """K3: keys planted on both sides of the CUDA kernel's chunk edges (the
    cut ``decode_splits`` makes of this cache on an H100), a request of
    length 0 and one past an edge, the self column."""
    from omchat_tpu.ops.decode_attention import flash_decode_stacked

    H, KVH = GROUPS[group]
    rng = np.random.default_rng(D)
    L, B, T = 2, 2, 256
    u = _directions(rng, KVH, D)
    k, v = _np(rng, L, B, KVH, T, D), _np(rng, L, B, KVH, T, D)
    rows = t_decode.decode_splits(B, KVH, T, 132)[1]
    for e in range(rows, T, rows):
        k[:, :, :, e - 1] = k[:, :, :, e] = 0.8 * u[None, None]
    q, kn, vn = _query(rng, B, 1, H, KVH, D, u), _np(rng, B, KVH, D), _np(rng, B, KVH, D)
    lens = np.asarray([0, rows + 1], np.int32)
    (jk, tk), (jv, tv) = _cache(k, cache), _cache(v, cache)
    ref = flash_decode_stacked(jnp.asarray(q), jk, jv, jnp.asarray(lens), jnp.int32(1), jnp.asarray(kn),
                               jnp.asarray(vn), block_k=128, interpret=True)
    out = t_decode.flash_decode_stacked(_t(q), tk, tv, _t(lens), 1, _t(kn), _t(vn))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **K3_TOL)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
@pytest.mark.parametrize("D", WIDTHS)
def test_flash_decode_at_head_width(D, cache, group):
    """K6 over a per-layer cache holding the new token: keys planted at the
    chunk edges, lengths 0, 1 and one past an edge."""
    from omchat_tpu.ops.decode_attention import flash_decode

    H, KVH = GROUPS[group]
    rng = np.random.default_rng(100 + D)
    B, T = 3, 256
    u = _directions(rng, KVH, D)
    k, v = _np(rng, B, KVH, T, D), _np(rng, B, KVH, T, D)
    rows = t_decode.decode_splits(B, KVH, T, 132)[1]
    for e in range(rows, T, rows):
        k[:, :, e - 1] = k[:, :, e] = 0.8 * u[None]
    q = _query(rng, B, 1, H, KVH, D, u)
    lens = np.asarray([0, 1, rows + 1], np.int32)
    (jk, tk), (jv, tv) = _cache(k, cache), _cache(v, cache)
    ref = flash_decode(jnp.asarray(q), jk, jv, jnp.asarray(lens), block_k=128, interpret=True)
    out = t_decode.flash_decode(_t(q), tk, tv, _t(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **K6_TOL)
    assert not out[0].any()  # a request of length 0 writes zeros


def _paged_case(rng, H, KVH, D, PS=16, W=8):
    """A pool of pages plus the parking page, shuffled tables, keys planted on
    both sides of every page edge below each length, and q, k_new, v_new."""
    lengths = np.asarray([0, 37, 32, 2 * PS + 1], np.int32)
    B, P = len(lengths), 2 * W
    u = _directions(rng, KVH, D)
    kp, vp = _np(rng, P + 1, KVH, PS, D), _np(rng, P + 1, KVH, PS, D)
    perm = rng.permutation(P)
    tables = np.full((B, W), P, np.int32)
    used = 0
    for b, n in enumerate(lengths):
        live = -(-int(n) // PS)
        tables[b, :live] = perm[used: used + live]
        used += live
        for e in range(PS, int(n), PS):
            for pos in (e - 1, e):
                kp[tables[b, pos // PS], :, pos % PS] = 0.8 * u
    q = _query(rng, B, 1, H, KVH, D, u)
    return lengths, kp, vp, tables, q, _np(rng, B, KVH, D), _np(rng, B, KVH, D)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("kernel", ["paged_flash_decode", "paged_flash_decode_manual"], ids=["k12", "k13"])
def test_paged_decode_at_head_width(kernel, D, cache, group):
    """K12 and K13 against their Pallas kernels: lengths 0, a partial page, a
    page boundary and one past two pages, keys at the page edges, the self
    column."""
    import omchat_tpu.ops.paged_attention as j_paged

    H, KVH = GROUPS[group]
    lengths, kp, vp, tables, q, kn, vn = _paged_case(np.random.default_rng(200 + D), H, KVH, D)
    (jk, tk), (jv, tv) = _cache(kp, cache), _cache(vp, cache)
    ref = getattr(j_paged, kernel)(jnp.asarray(q), jk, jv, jnp.asarray(lengths), jnp.asarray(tables),
                                   jnp.asarray(kn), jnp.asarray(vn), interpret=True)
    out = getattr(t_paged, kernel)(_t(q), tk, tv, _t(lengths), _t(tables), _t(kn), _t(vn))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **PAGED_TOL)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
@pytest.mark.parametrize("D", WIDTHS)
def test_paged_flash_prefill_at_head_width(D, cache, group):
    """K14: page-aligned q_offset, ragged kv_len, keys on both sides of each
    page edge below kv_len."""
    from omchat_tpu.ops.paged_attention import paged_flash_prefill

    H, KVH = GROUPS[group]
    rng = np.random.default_rng(300 + D)
    B, C, PS, W, P = 2, 32, 16, 8, 16
    u = _directions(rng, KVH, D)
    q_offset = np.asarray([16, 48], np.int32)
    kv_len = q_offset + np.asarray([C, C - 9], np.int32)
    kp, vp = _np(rng, P, KVH, PS, D), _np(rng, P, KVH, PS, D)
    tables = rng.permutation(P)[:B * W].reshape(B, W).astype(np.int32)
    for b in range(B):
        for e in range(PS, int(kv_len[b]), PS):
            for pos in (e - 1, e):
                kp[tables[b, pos // PS], :, pos % PS] = 0.8 * u
    q = _query(rng, B, C, H, KVH, D, u)
    (jk, tk), (jv, tv) = _cache(kp, cache), _cache(vp, cache)
    ref = np.asarray(paged_flash_prefill(jnp.asarray(q), jk, jv, jnp.asarray(kv_len), jnp.asarray(tables),
                                         jnp.asarray(q_offset), interpret=True))
    out = t_paged.paged_flash_prefill(_t(q), tk, tv, _t(kv_len), _t(tables), _t(q_offset)).numpy()
    for b in range(B):
        rows = int(kv_len[b] - q_offset[b])
        np.testing.assert_allclose(out[b, :rows], ref[b, :rows], **PAGED_TOL)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("D", WIDTHS)
def test_flash_attention_e4m3_at_head_width(D, group):
    """K2 on an e4m3 bntd cache: causal with per-request offsets, keys at the
    64-row kv tiles' edge; p rounded to e4m3 on both sides."""
    from omchat_tpu.ops.flash_attention import flash_attention

    H, KVH = GROUPS[group]
    rng = np.random.default_rng(400 + D)
    B, S, T = 2, 64, 128
    u = _directions(rng, KVH, D)
    k, v = _np(rng, B, KVH, T, D), _np(rng, B, KVH, T, D)
    k[:, :, 63] = k[:, :, 64] = 0.8 * u[None]
    q = _query(rng, B, S, H, KVH, D, u)
    (jk, tk), (jv, tv) = _cache(k, "e4m3"), _cache(v, "e4m3")
    qo, kl = np.asarray([0, 40], np.int32), np.asarray([64, 100], np.int32)
    ref = np.asarray(flash_attention(jnp.asarray(q), jk, jv, causal=True, q_offset=jnp.asarray(qo),
                                     kv_len=jnp.asarray(kl), kv_format="bntd", block_q=64, block_k=64,
                                     interpret=True))
    out = t_flash.flash_attention(_t(q), tk, tv, causal=True, q_offset=_t(qo), kv_len=_t(kl), kv_format="bntd")
    for b in range(B):
        rows = min(S, int(kl[b]) - int(qo[b]))
        np.testing.assert_allclose(out[b, :rows].numpy(), ref[b, :rows], **K2_E4M3_TOL)


# ---------------------------------------------------------------------------
# the width rule of the CUDA entries, recorded instead of launched
# ---------------------------------------------------------------------------

BF16_WIDTHS = tuple(range(8, 129, 8))
E4M3_WIDTHS = tuple(range(16, 129, 16))


def test_the_width_rule():
    """Every multiple of 8 from 8 to 128 on bf16, of 16 from 16 to 128 on e4m3."""
    assert tuple(d for d in range(0, 300) if t_flash.head_dim_supported(d)) == BF16_WIDTHS
    assert tuple(d for d in range(0, 300) if t_flash.head_dim_supported(d, e4m3=True)) == E4M3_WIDTHS


@pytest.fixture
def recorded(monkeypatch):
    """The kernels' C entries recorded instead of launched, on meta tensors
    that pass for the card's: each call appends (entry, args), pointers kept
    as the tensors they point at."""
    calls = []

    def require_cuda(name, *tensors, cache=()):
        return "_e4m3" if any(t.dtype == E4M3 for t in cache) else ""

    for mod in (t_flash, t_decode, t_paged):
        monkeypatch.setattr(mod, "_require_cuda", require_cuda)
    for mod in (t_decode, t_paged):
        monkeypatch.setattr(mod, "num_sms", lambda index: 132)
    monkeypatch.setattr(t_flash, "_tma_strides", lambda name, what, t: tuple(t.stride()[:-1]))
    kl = t_decode.kernel_lib
    monkeypatch.setattr(kl, "ptr", lambda t: t)
    monkeypatch.setattr(kl, "stream_ptr", lambda device=None: 0)
    monkeypatch.setattr(kl, "launch", lambda source, entry, argtypes, *args: calls.append((entry, args)))
    # the wrappers count each recorded call as a launch: their counts are put back afterwards, as later tests
    # in the process read them
    for w in (t_decode.flash_decode_stacked, t_decode.flash_decode, t_paged.paged_flash_decode,
              t_paged.paged_flash_decode_manual, t_paged.paged_flash_prefill, t_flash.flash_attention):
        monkeypatch.setattr(w, "launches", w.launches)
    return calls


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _call(kernel: str, D: int, cache_dtype):
    """One call of the CUDA wrapper ``kernel`` at head width D over a cache
    of ``cache_dtype``, Qwen2-0.5B's 14 / 2 heads."""
    H, KVH, B, T, PS = 14, 2, 2, 256, 16
    i32 = torch.zeros(B, dtype=torch.int32, device="meta")
    tables = torch.zeros(B, 4, dtype=torch.int32, device="meta")
    if kernel == "flash_decode_stacked":
        kc = _meta(2, B, KVH, T, D, dtype=cache_dtype)
        return t_decode.flash_decode_stacked(_meta(B, 1, H, D), kc, kc, i32, 1, _meta(B, KVH, D), _meta(B, KVH, D))
    if kernel == "flash_decode":
        kc = _meta(B, KVH, T, D, dtype=cache_dtype)
        return t_decode.flash_decode(_meta(B, 1, H, D), kc, kc, i32)
    pool = _meta(9, KVH, PS, D, dtype=cache_dtype)
    if kernel in ("paged_flash_decode", "paged_flash_decode_manual"):
        return getattr(t_paged, kernel)(_meta(B, 1, H, D), pool, pool, i32, tables, _meta(B, KVH, D),
                                        _meta(B, KVH, D))
    if kernel == "paged_flash_prefill":
        return t_paged.paged_flash_prefill(_meta(B, 32, H, D), pool, pool, i32, tables, i32)
    kc = _meta(B, KVH, T, D, dtype=cache_dtype)
    return t_flash.flash_attention(_meta(B, 64, H, D), kc, kc, causal=True, kv_format="bntd")


# each wrapper's C entry and the index of the head width among its arguments
ENTRIES = {"flash_decode_stacked": ("omchat_flash_decode_stacked", 12), "flash_decode": ("omchat_flash_decode", 9),
           "paged_flash_decode": ("omchat_paged_flash_decode", 13),
           "paged_flash_decode_manual": ("omchat_paged_flash_decode_manual", 13),
           "paged_flash_prefill": ("omchat_paged_flash_prefill", 12), "flash_attention": ("omchat_flash_attention", 20)}


@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
@pytest.mark.parametrize("kernel", list(ENTRIES))
def test_each_cuda_entry_takes_the_widths_of_the_rule(recorded, kernel, cache):
    """A width the rule takes reaches the C entry of the cache's dtype with
    the true width; any other raises before a launch, naming the wrapper,
    the width and the dtype."""
    dtype, e4m3 = (E4M3, True) if cache == "e4m3" else (torch.bfloat16, False)
    entry, d_arg = ENTRIES[kernel]
    for D in range(4, 137, 4):
        if t_flash.head_dim_supported(D, e4m3):
            _call(kernel, D, dtype)
            got_entry, args = recorded.pop()
            assert got_entry == entry + ("_e4m3" if e4m3 else "") and args[d_arg] == D
        else:
            with pytest.raises(ValueError, match=rf"^{kernel}: head width {D} on an? {'e4m3' if e4m3 else 'bfloat16'} "
                                                 r"cache is not taken by the CUDA kernel, which takes a multiple of "
                                                 rf"{16 if e4m3 else 8} from {16 if e4m3 else 8} to 128"):
                _call(kernel, D, dtype)
    assert not recorded


@pytest.mark.parametrize("kernel", ["flash_decode_stacked", "flash_decode", "paged_flash_decode",
                                    "paged_flash_decode_manual"])
def test_split_scratch_at_head_width_64(recorded, kernel):
    """The split-KV wrappers size their scratch by the true width: B x H x
    splits partial states of D + 2 floats, with the cut of decode_splits
    (K3, K6: the 256-row cache) or paged_splits (K12, K13: 4 pages of 16)."""
    _call(kernel, 64, torch.bfloat16)
    (_, args), = recorded
    if kernel.startswith("paged"):
        scratch, splits, rows = args[8], args[17], args[18]
        assert (splits, rows) == t_paged.paged_splits(2, 2, 4 * 16, 132)
    else:
        scratch = args[8] if kernel == "flash_decode_stacked" else args[5]
        splits, rows = args[-3], args[-2]
        assert (splits, rows) == t_decode.decode_splits(2, 2, 256, 132)
    assert scratch.dtype == torch.float32
    assert scratch.numel() == t_decode.scratch_floats(2, 14, splits, 64) == 2 * 14 * splits * 66


def test_splits_at_the_narrow_serving_shapes():
    """Qwen2-0.5B's 2 kv heads: the request's 3328-row cache cut into the
    finest chunks, one 64-row tile each (52 x 2 blocks, fewer than the 132
    SMs), the serving workload's 16 slots of 32-page tables into chunks of a
    multiple of 128 rows; neither reads the head width."""
    assert t_decode.decode_splits(1, 2, 3328, 132) == (52, 64)
    splits, rows = t_paged.paged_splits(16, 2, 32 * 128, 132)
    assert rows % 128 == 0 and rows <= t_paged.SPLIT_MAX_ROWS and splits * rows == 32 * 128


# ---------------------------------------------------------------------------
# the three engines on a model of the new geometry
# ---------------------------------------------------------------------------

# Qwen2-0.5B's attention geometry (14 / 2 heads of 64, tied embeddings, rope
# theta 1e6) and InternViT-300M's (heads of 64, layer norm, no qk-norm) at 2 + 2
# layers, narrow elsewhere.  The final norm's scale of LOGIT_GAIN spreads the
# first logits over about +-10 and the q / k projections of QK_GAIN give the
# softmax rows of mass, so that greedy steps are decisive and attention
# decides them; both are applied to the JAX weights before the port takes them.
NARROW_VISION = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2, image_size=56,
                     patch_size=14, qk_normalization=False, norm_type="layer_norm")
NARROW_TEXT = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=14,
                   num_key_value_heads=2, head_dim=64, max_position_embeddings=1024, rope_theta=1000000.0,
                   tie_word_embeddings=True)
NARROW_PINPOINTS = ((56, 112), (112, 56), (112, 112))
LOGIT_GAIN, QK_GAIN = 40.0, 1.0
ENGINE_NEW = 10
# First-token logits against the JAX engine's (XLA attention, p in fp32), as a
# share of max |logit| (~29 here), about 5x the gap read on this CPU: the
# port's kernel route (plain versions on the CPU) rounds p to the cache's
# dtype for K2's P V product, as the Pallas kernel does, bf16 (read 2.6e-4)
# or e4m3 (5.0e-3); the plain route keeps p in fp32 and differs by sums in
# other orders and, on e4m3, the store's rounding (3.9e-6 bf16, 7.9e-5 e4m3).
ENGINE_LOGITS_REL = {("bf16", None): 1.5e-3, ("e4m3", None): 2.5e-2, ("bf16", "plain"): 4e-4,
                     ("e4m3", "plain"): 4e-4}
SLOT = dict(max_slots=2, max_len=256, chunk_size=32)
PAGED = dict(max_slots=3, num_pages=48, page_size=16, prompt_bucket=16, max_len=256, prefill_chunk=32)


def _narrow_configs():
    """(the JAX OmChatConfig, the port's) of the narrow model."""
    import omchat_tpu.config as jc

    import omchat_torch.config as tc

    return tuple(m.OmChatConfig(vision=m.VisionConfig(**NARROW_VISION), text=m.TextConfig(**NARROW_TEXT),
                                image_grid_pinpoints=NARROW_PINPOINTS) for m in (jc, tc))


def _narrow_request():
    from omchat_torch.processing.chat import image_prompt, make_context
    from omchat_torch.utils.testing import MockTokenizer

    _, ids = make_context(MockTokenizer(), image_prompt("what is in the picture?", 2), None,
                          "You are a helpful assistant.")
    return ids, np.random.default_rng(9).standard_normal((2, 3, 56, 56)).astype(np.float32)


def _text_requests():
    rng = np.random.default_rng(11)
    return [rng.integers(1, 512, n).tolist() for n in (23, 40)]


@pytest.fixture(scope="module")
def narrow():
    """The JAX engines on the narrow model, per cache dtype: the
    single-request engine's greedy ids and first-token logits on the image
    request, the paged engine's on it and two text requests, the slot
    engine's on the text requests; and the weights for the port."""
    from omchat_tpu.config import GenerationConfig
    from omchat_tpu.runtime.batch_engine import BatchEngine
    from omchat_tpu.runtime.generate import OmChatEngine
    from omchat_tpu.runtime.paged_engine import PagedBatchEngine
    from tests.test_sharding import _tiny_params

    jcfg, _ = _narrow_configs()
    params = _tiny_params(jcfg)
    lm = params["language_model"]
    lm["norm"]["scale"] = lm["norm"]["scale"] * LOGIT_GAIN
    for proj in ("q_proj", "k_proj"):
        lm["layers"]["self_attn"][proj]["kernel"] = lm["layers"]["self_attn"][proj]["kernel"] * QK_GAIN
    ids, px = _narrow_request()
    texts = _text_requests()
    gen = GenerationConfig(max_new_tokens=ENGINE_NEW, eos_token_id=-1)
    ref = {}
    for cache, dtype in (("bf16", jnp.bfloat16), ("e4m3", jnp.float8_e4m3fn)):
        eng = OmChatEngine(jcfg, params, attn_impl="xla", image_cache_size=0, cache_dtype=dtype)
        single = eng.generate([ids], px, gen).token_ids[0]
        logits, _ = eng.prefill(eng.plan([ids]), eng.encode_images(px), ENGINE_NEW)
        pe = PagedBatchEngine(jcfg, params, attn_impl="xla", cache_dtype=dtype, image_cache_size=0, **PAGED)
        rids = [pe.submit(i, p, max_new_tokens=ENGINE_NEW, eos_token_id=-1) for i, p in [(ids, px)]
                + [(t, None) for t in texts]]
        pe.run_to_completion(max_ticks=500)
        be = BatchEngine(jcfg, params, attn_impl="xla", cache_dtype=dtype, image_cache_size=0, **SLOT)
        srids = [be.submit(t, None, max_new_tokens=ENGINE_NEW, eos_token_id=-1) for t in texts]
        be.run_to_completion(max_ticks=500)
        ref[cache] = dict(single=single, logits=np.asarray(logits), paged=[pe.result(r) for r in rids],
                          slot=[be.result(r) for r in srids])
    return from_jax_params(jax.device_get(params)), ref


def _cache_dtype(cache):
    return E4M3 if cache == "e4m3" else torch.bfloat16


@pytest.mark.parametrize("impl", [None, "plain"], ids=["kernel_path", "plain_path"])
@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
def test_single_request_engine_at_head_width_64(narrow, cache, impl):
    """``OmChatEngine``: greedy ids and first-token logits against the JAX
    engine's; the cache holds heads of 64 in the cache's dtype."""
    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.generate import OmChatEngine

    tparams, ref = narrow
    _, tcfg = _narrow_configs()
    ids, px = _narrow_request()
    eng = OmChatEngine(tcfg, tparams, attn_impl=impl, image_cache_size=0, cache_dtype=_cache_dtype(cache),
                       device="cpu")
    first = {}
    out = eng.generate([ids], px, GenerationConfig(max_new_tokens=ENGINE_NEW, eos_token_id=-1),
                       logits_callback=lambda step, lg: first.setdefault(step, lg.clone()))
    assert out.token_ids[0] == ref[cache]["single"]
    want = ref[cache]["logits"]
    assert np.abs(first[0].numpy() - want).max() <= ENGINE_LOGITS_REL[cache, impl] * np.abs(want).max()
    _, kv = eng.prefill(eng.plan([ids]), eng.encode_images(px), ENGINE_NEW)
    assert kv.k.dtype == _cache_dtype(cache) and kv.k.shape[-1] == 64


@pytest.mark.parametrize("kernel", ["auto", "manual"], ids=["k12", "k13"])
@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
def test_paged_engine_at_head_width_64(narrow, cache, kernel):
    """``PagedBatchEngine`` on K12's and K13's route: the JAX engine's greedy
    ids for the image request and two text requests, every page back."""
    from omchat_torch.runtime.paged_engine import PagedBatchEngine

    tparams, ref = narrow
    _, tcfg = _narrow_configs()
    ids, px = _narrow_request()
    pe = PagedBatchEngine(tcfg, tparams, cache_dtype=_cache_dtype(cache), image_cache_size=0, decode_kernel=kernel,
                          decode_roll=4, device="cpu", **PAGED)
    assert pe.k_pool.dtype == _cache_dtype(cache) and pe.k_pool.shape[-1] == 64
    rids = [pe.submit(i, p, max_new_tokens=ENGINE_NEW, eos_token_id=-1) for i, p in [(ids, px)]
            + [(t, None) for t in _text_requests()]]
    assert pe.run_to_completion(max_ticks=500) < 500
    assert [pe.result(r) for r in rids] == ref[cache]["paged"]
    assert pe.allocator.available == PAGED["num_pages"]


@pytest.mark.parametrize("cache", ["bf16", "e4m3"])
def test_slot_engine_at_head_width_64(narrow, cache):
    """``BatchEngine``: K2 into a slot, K3 at the slot rows; the JAX engine's
    greedy ids."""
    from omchat_torch.runtime.batch_engine import BatchEngine

    tparams, ref = narrow
    _, tcfg = _narrow_configs()
    be = BatchEngine(tcfg, tparams, cache_dtype=_cache_dtype(cache), image_cache_size=0, device="cpu", **SLOT)
    rids = [be.submit(t, None, max_new_tokens=ENGINE_NEW, eos_token_id=-1) for t in _text_requests()]
    assert be.run_to_completion(max_ticks=500) < 500
    assert [be.result(r) for r in rids] == ref[cache]["slot"]
