"""Decode over a per-layer cache (K6) on the CPU against the JAX package:
K6's plain version against ``flash_decode`` in interpret mode (ragged
lengths, a length of 0, GQA groups of 7 and 2, an e4m3 cache), the
``decode_attention`` dispatcher on a 4-D cache, ``cache_attend`` with one
query row against the JAX package's, and K6 on the written cache against K3
on the read-only cache plus the self column (the same step).

Same seeded numpy inputs on both sides, float32 queries; tolerance atol
2e-5 / rtol 1e-4, the JAX package's for this kernel
(tests/test_pallas_kernels.py:83).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omchat_torch.ops import decode_attention as t_decode
from omchat_torch.ops.attention import decode_attention
from omchat_torch.ops.fp8 import E4M3, to_e4m3

ATOL, RTOL = 2e-5, 1e-4


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize(
    "H,KVH,T,lengths,cache",
    [(28, 4, 384, [137, 384], "float32"), (28, 4, 128, [100], "float32"), (4, 2, 200, [0, 1, 128, 199], "float32"),
     (28, 4, 256, [61, 256], "e4m3")],
    ids=["group7_ragged", "group7_one_block", "group2_zero_and_one", "e4m3_cache"],
)
def test_flash_decode_matches_pallas(H, KVH, T, lengths, cache):
    from omchat_tpu.ops.decode_attention import flash_decode

    rng = np.random.default_rng(41)
    B, D = len(lengths), 128
    q = _np(rng, B, 1, H, D)
    k, v = _np(rng, B, KVH, T, D), _np(rng, B, KVH, T, D)
    lens = np.asarray(lengths, np.int32)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if cache == "e4m3":  # stored as e4m3 on both sides, widened to q's dtype in the kernel
        jk, jv = jk.astype(jnp.float8_e4m3fn), jv.astype(jnp.float8_e4m3fn)
        tk, tv = to_e4m3(tk), to_e4m3(tv)
        assert tk.dtype == E4M3
    ref = np.asarray(flash_decode(jnp.asarray(q), jk, jv, jnp.asarray(lens), block_k=128, interpret=True))
    out = t_decode.flash_decode(torch.from_numpy(q), tk, tv, torch.from_numpy(lens))
    assert out.shape == (B, 1, H, D) and t_decode.flash_decode.launches == 0  # CPU tensors never launch
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    for b, n in enumerate(lengths):
        if n == 0:
            assert (out[b] == 0).all()
    routed = decode_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(lens))
    assert torch.equal(routed, out)  # a 4-D cache routes to K6
    if 0 not in lengths:  # the plain reference route (no zero-length rows: the reference averages all columns)
        plain = decode_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(lens), impl="plain")
        np.testing.assert_allclose(plain.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_k6_on_the_written_cache_equals_k3_with_the_self_column():
    """One decode step two ways: K3 over the read-only stacked cache with the
    in-flight K/V as a self column (cache_len excluding it), K6 over the
    layer cache with the row written in (cache_len + 1)."""
    rng = np.random.default_rng(42)
    L, B, H, KVH, T, D = 3, 2, 8, 2, 256, 128
    q = torch.from_numpy(_np(rng, B, 1, H, D))
    kc, vc = torch.from_numpy(_np(rng, L, B, KVH, T, D)), torch.from_numpy(_np(rng, L, B, KVH, T, D))
    kn, vn = torch.from_numpy(_np(rng, B, KVH, D)), torch.from_numpy(_np(rng, B, KVH, D))
    lens = torch.tensor([100, 37], dtype=torch.int32)
    for li in range(L):
        k3 = t_decode.flash_decode_stacked(q, kc, vc, lens, li, kn, vn)
        kw, vw = kc[li].clone(), vc[li].clone()
        for b in range(B):
            kw[b, :, lens[b]] = kn[b]
            vw[b, :, lens[b]] = vn[b]
        k6 = t_decode.flash_decode(q, kw, vw, lens + 1)
        np.testing.assert_allclose(k6.numpy(), k3.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("impl", [None, "plain"], ids=["kernel_path", "plain_path"])
def test_cache_attend_one_row_matches_jax(impl):
    """``cache_attend`` with S == 1 writes the token into the layer cache at
    ``write_pos`` and decodes over it (K6's plain version, or the plain
    reference), as the JAX package's does on its XLA route (its Pallas route
    does not run on the CPU outside interpret mode)."""
    from omchat_tpu.config import OmChatConfig
    from omchat_tpu.models.qwen2 import cache_attend as j_cache_attend

    from omchat_torch.models.qwen2 import cache_attend

    rng = np.random.default_rng(43)
    B, H, KVH, T, D = 2, 4, 2, 64, 128
    q, k, v = _np(rng, B, 1, H, D), _np(rng, B, 1, KVH, D), _np(rng, B, 1, KVH, D)
    kc, vc = _np(rng, B, KVH, T, D), _np(rng, B, KVH, T, D)
    wp = np.asarray([9, 40], np.int32)
    want, (jk, jv) = j_cache_attend(OmChatConfig.tiny().text, "xla", jnp.asarray(wp),
                                    jnp.asarray(wp + 1), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    (jnp.asarray(kc), jnp.asarray(vc)))
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = cache_attend(impl, torch.from_numpy(wp), wp.tolist(), torch.from_numpy(wp + 1), tkc, tvc,
                       torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_array_equal(tkc.numpy(), np.asarray(jk))  # the row written in place
    np.testing.assert_array_equal(tvc.numpy(), np.asarray(jv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_flash_decode_never_falls_back_off_the_cpu():
    m = lambda *s: torch.empty(*s, device="meta", dtype=torch.bfloat16)  # noqa: E731
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        t_decode.flash_decode(m(1, 1, 2, 128), m(1, 2, 8, 128), m(1, 2, 8, 128), torch.ones(1, dtype=torch.int32))
