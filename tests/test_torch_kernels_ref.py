"""The port's kernel modules on the CPU (plain versions) against the JAX
package's Pallas kernels run in interpret mode, as the JAX tests run them.

Same seeded numpy inputs to both sides, float32; tolerances are float32
round-off of differently ordered sums (the JAX side tiles and rescales, the
plain versions do not).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omchat_torch.ops import decode_attention as t_decode
from omchat_torch.ops import flash_attention as t_flash
from omchat_torch.ops import paged_attention as t_paged

ATOL, RTOL = 3e-5, 1e-4


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_packed_qkv_norm_attention_matches_pallas():
    """K1: head_dim 128, SP padded past the valid length."""
    from omchat_tpu.ops.flash_attention import packed_prescale, packed_qkv_norm_attention

    rng = np.random.default_rng(1)
    B, S, SP, H, D, eps = 2, 50, 56, 2, 128, 1e-6
    qkv = _np(rng, B, SP, 3 * H * D)
    qg = (1.0 + 0.1 * _np(rng, H * D)) * packed_prescale(D)
    kg = 1.0 - 0.1 * _np(rng, H * D)
    ref = packed_qkv_norm_attention(
        jnp.asarray(qkv), num_heads=H, q_gamma=jnp.asarray(qg), k_gamma=jnp.asarray(kg), eps=eps,
        valid_len=S, interpret=True,
    )
    out = t_flash.packed_qkv_norm_attention(
        torch.from_numpy(qkv), num_heads=H, q_gamma=torch.from_numpy(qg), k_gamma=torch.from_numpy(kg), eps=eps,
        valid_len=S,
    )
    np.testing.assert_allclose(out[:, :S].numpy(), np.asarray(ref)[:, :S], atol=ATOL, rtol=RTOL)
    assert t_flash.packed_qkv_norm_attention.launches == 0  # CPU tensors never launch


@pytest.mark.parametrize(
    "H,KVH,q_offset,kv_len",
    [(14, 2, [0, 40], [64, 100]), (4, 2, [16, 64], [80, 97])],
    ids=["group7", "group2"],
)
def test_flash_attention_bntd_matches_pallas(H, KVH, q_offset, kv_len):
    """K2: causal GQA over the head-major cache layout with per-batch
    q_offset and ragged kv_len."""
    from omchat_tpu.ops.flash_attention import flash_attention

    rng = np.random.default_rng(2)
    B, S, T, D = 2, 64, 128, 128
    q, k, v = _np(rng, B, S, H, D), _np(rng, B, KVH, T, D), _np(rng, B, KVH, T, D)
    qo, kl = np.asarray(q_offset, np.int32), np.asarray(kv_len, np.int32)
    ref = flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, q_offset=jnp.asarray(qo),
        kv_len=jnp.asarray(kl), kv_format="bntd", block_q=64, block_k=64, interpret=True,
    )
    out = t_flash.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True, q_offset=torch.from_numpy(qo),
        kv_len=torch.from_numpy(kl), kv_format="bntd",
    )
    for b in range(B):
        rows = min(S, int(kl[b]) - int(qo[b]))  # rows past kv_len are garbage in both
        np.testing.assert_allclose(out[b, :rows].numpy(), np.asarray(ref)[b, :rows], atol=ATOL, rtol=RTOL)


def test_flash_attention_noncausal_btnd_matches_reference():
    """K2's plain version on the ViT split path (btnd, non-causal) against the
    JAX package's XLA attention."""
    from omchat_tpu.ops.attention import _xla_attention

    rng = np.random.default_rng(3)
    q, k, v = _np(rng, 2, 17, 4, 16), _np(rng, 2, 17, 4, 16), _np(rng, 2, 17, 4, 16)
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False, q_offset=None, kv_len=None)
    out = t_flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("cache_len,layer", [([0, 0], 1), ([37, 200], 0), ([128, 255], 2)],
                         ids=["empty", "ragged", "full_tiles"])
def test_flash_decode_stacked_matches_pallas(cache_len, layer):
    """K3: one token against layer ``layer`` of a 3-layer stacked cache, the
    in-flight K/V folded in as a self column; cache_len 0 and > 0."""
    from omchat_tpu.ops.decode_attention import flash_decode_stacked

    rng = np.random.default_rng(4)
    L, B, H, KVH, T, D = 3, 2, 28, 4, 256, 128
    q = _np(rng, B, 1, H, D)
    kc, vc = _np(rng, L, B, KVH, T, D), _np(rng, L, B, KVH, T, D)
    kn, vn = _np(rng, B, KVH, D), _np(rng, B, KVH, D)
    lens = np.asarray(cache_len, np.int32)
    ref = flash_decode_stacked(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens), jnp.int32(layer), jnp.asarray(kn),
        jnp.asarray(vn), block_k=128, interpret=True,
    )
    out = t_decode.flash_decode_stacked(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc), torch.from_numpy(lens), layer,
        torch.from_numpy(kn), torch.from_numpy(vn),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_commit_rows_matches_pallas_and_leaves_other_rows():
    """K4: N rows written in place at (page, offset); every other byte of
    the pools is unchanged, and the result equals the Pallas commit."""
    from omchat_tpu.ops.paged_attention import commit_rows

    rng = np.random.default_rng(5)
    P, KVH, PS, D, N = 6, 2, 16, 128, 4
    kp, vp = _np(rng, P, KVH, PS, D), _np(rng, P, KVH, PS, D)
    pages = np.asarray([0, 3, 5, 2], np.int32)
    offsets = np.asarray([0, 7, 15, 9], np.int32)
    kr, vr = _np(rng, N, KVH, D), _np(rng, N, KVH, D)
    ref_k, ref_v = commit_rows(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pages), jnp.asarray(offsets), jnp.asarray(kr),
        jnp.asarray(vr), interpret=True,
    )
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out_k, out_v = t_paged.commit_rows(tk, tv, torch.from_numpy(pages), torch.from_numpy(offsets),
                                       torch.from_numpy(kr), torch.from_numpy(vr))
    assert out_k is tk and out_v is tv  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(ref_k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(ref_v))
    touched = np.zeros((P, PS), bool)
    touched[pages, offsets] = True
    np.testing.assert_array_equal(tk.numpy().transpose(0, 2, 1, 3)[~touched], kp.transpose(0, 2, 1, 3)[~touched])
    np.testing.assert_array_equal(tk.numpy()[pages, :, offsets], kr)


@pytest.mark.parametrize("which", ["packed_qkv_norm_attention", "flash_attention", "flash_decode_stacked",
                                   "commit_rows"])
def test_wrappers_never_fall_back_off_the_cpu(which):
    """A tensor that is not on the CPU launches the kernel or raises — here
    (no CUDA device) a meta tensor must raise, not take the plain version."""
    m = lambda *s: torch.empty(*s, device="meta", dtype=torch.bfloat16)  # noqa: E731
    calls = {
        "packed_qkv_norm_attention": lambda: t_flash.packed_qkv_norm_attention(
            m(1, 8, 3 * 128), num_heads=1, q_gamma=m(128), k_gamma=m(128), eps=1e-6),
        "flash_attention": lambda: t_flash.flash_attention(m(1, 8, 2, 128), m(1, 8, 2, 128), m(1, 8, 2, 128)),
        "flash_decode_stacked": lambda: t_decode.flash_decode_stacked(
            m(1, 1, 2, 128), m(1, 1, 2, 8, 128), m(1, 1, 2, 8, 128), torch.zeros(1, dtype=torch.int32), 0,
            m(1, 2, 128), m(1, 2, 128)),
        "commit_rows": lambda: t_paged.commit_rows(
            m(2, 2, 8, 128), m(2, 2, 8, 128), torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
            m(1, 2, 128), m(1, 2, 128)),
    }
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        calls[which]()
