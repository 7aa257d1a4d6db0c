"""The plain versions behind the Hopper attention kernels (K1's prepass and
attention, K2, at head width 128 and at the towers' 64 and 72) against the
JAX package's Pallas kernels in interpret mode, at the shapes the kernels'
128-row tiling makes special, and the wrappers' refusal of operands that a TMA tensor map cannot take.

Same seeded numpy inputs to both sides, float32; tolerances are float32
round-off of differently ordered sums (the JAX side tiles and rescales, the
plain versions do not).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omchat_torch.ops import flash_attention as t_flash

ATOL, RTOL = 3e-5, 1e-4


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("B,SP,valid,H", [(2, 72, 65, 3), (1, 136, 136, 2)], ids=["ragged", "unpadded"])
def test_k1_prepass_then_attention_matches_pallas(B, SP, valid, H):
    """K1 as the CUDA route composes it: the prepass (qn, kn) and the
    attention over qn, kn and the v block, each in its plain version."""
    from omchat_tpu.ops.flash_attention import packed_prescale, packed_qkv_norm_attention

    rng = np.random.default_rng(11)
    D, eps = 128, 1e-6
    HD = H * D
    qkv = _np(rng, B, SP, 3 * HD)
    qg = (1.0 + 0.1 * _np(rng, HD)) * packed_prescale(D)
    kg = 1.0 - 0.1 * _np(rng, HD)
    ref = packed_qkv_norm_attention(
        jnp.asarray(qkv), num_heads=H, q_gamma=jnp.asarray(qg), k_gamma=jnp.asarray(kg), eps=eps,
        valid_len=valid, interpret=True,
    )
    x = torch.from_numpy(qkv)
    n0 = t_flash.qk_norm_prepass.launches
    qn, kn = t_flash.qk_norm_prepass(x, torch.from_numpy(qg), torch.from_numpy(kg), eps)
    assert t_flash.qk_norm_prepass.launches == n0  # CPU tensors never launch
    assert qn.shape == kn.shape == (B, SP, HD)
    out = t_flash.packed_self_attention_plain(qn, kn, x[..., 2 * HD:], num_heads=H, valid_len=valid, prescaled=True)
    np.testing.assert_allclose(out[:, :valid].numpy(), np.asarray(ref)[:, :valid], atol=ATOL, rtol=RTOL)
    # and the same values as the K1 wrapper's CPU route
    whole = t_flash.packed_qkv_norm_attention(x, num_heads=H, q_gamma=torch.from_numpy(qg),
                                              k_gamma=torch.from_numpy(kg), eps=eps, valid_len=valid)
    np.testing.assert_allclose(out[:, :valid].numpy(), whole[:, :valid].numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize(
    "q_offset,kv_len",
    [([0, 37, 0], [133, 237, 0]), ([128, 37, 100], [328, 190, 60])],
    ids=["offset37_empty", "offset128_ragged_padding"],
)
def test_k2_plain_matches_pallas_across_kv_tiles(q_offset, kv_len):
    """K2: S = 200 q rows over T = 328 cache rows (neither a multiple of 128),
    q_offset 37 and 128 (the causal diagonal crosses two 128-column tiles or
    sits on a tile edge), ragged kv_len, and a batch row whose rows are all
    padding (kv_len 0, or every position at or past kv_len)."""
    from omchat_tpu.ops.flash_attention import flash_attention

    rng = np.random.default_rng(12)
    B, S, T, H, KVH, D = 3, 200, 328, 4, 2, 128
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
    assert torch.isfinite(out).all()
    for b in range(B):
        rows = max(0, min(S, int(kl[b]) - int(qo[b])))  # rows past kv_len are unspecified
        np.testing.assert_allclose(out[b, :rows].numpy(), np.asarray(ref)[b, :rows], atol=ATOL, rtol=RTOL)
        if kl[b] == 0:  # no valid column: the port writes zeros (the Pallas kernel's rows are unspecified)
            assert not out[b].any()


@pytest.mark.parametrize("D", [64, 72])
@pytest.mark.parametrize("causal,S,fmt", [(False, 77, "btnd"), (True, 130, "bntd")], ids=["noncausal_btnd", "causal"])
def test_k2_plain_matches_pallas_at_tower_head_widths(D, causal, S, fmt):
    """K2 at the towers' head widths, 64 (CLIP-L, InternViT-300M) and 72
    (SigLIP so400m): the plain version, whose q prescale takes D^-0.5 of the
    true width, against the Pallas kernel in interpret mode."""
    from omchat_tpu.ops.flash_attention import flash_attention

    rng = np.random.default_rng(13)
    B, H, KVH = 2, 4, 4 if fmt == "btnd" else 2
    kv_shape = (B, S, KVH, D) if fmt == "btnd" else (B, KVH, S, D)
    q, k, v = _np(rng, B, S, H, D), _np(rng, *kv_shape), _np(rng, *kv_shape)
    ref = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, kv_format=fmt, block_q=64,
                          block_k=64, interpret=True)
    out = t_flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
                                  kv_format=fmt)
    assert t_flash.head_dim_supported(D) and t_flash.head_dim_supported(D, e4m3=True) == (D % 16 == 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_tma_strides_refuse_by_name():
    """What a TMA tensor map cannot take is refused before any launch, with
    the operand named; what it can take comes back as element strides (a
    size-1 dimension gets its contiguous stride)."""
    bf = torch.bfloat16
    k = torch.empty(2, 4, 8, 128, dtype=bf)
    assert t_flash._tma_strides("f", "k", k) == (4 * 8 * 128, 8 * 128, 128)
    btnd = torch.empty(2, 8, 4, 128, dtype=bf).transpose(1, 2)  # a [B, T, KVH, D] view read in place
    assert t_flash._tma_strides("f", "k", btnd) == (8 * 4 * 128, 128, 4 * 128)
    one = torch.empty(1, 8, 2, 128, dtype=bf).transpose(1, 2)[:, :1]
    assert t_flash._tma_strides("f", "k", one) == (128 * 8 * 2, 8 * 2 * 128, 2 * 128)
    e4m3 = torch.empty(1, 4, 8, 128, dtype=torch.float8_e4m3fn)
    assert t_flash._tma_strides("f", "k", e4m3) == (4 * 8 * 128, 8 * 128, 128)
    with pytest.raises(ValueError, match=r"f: k has a stride of 132 elements, not a multiple of 16 bytes"):
        t_flash._tma_strides("f", "k", torch.empty(2, 4, 8, 132, dtype=bf)[..., :128])
    with pytest.raises(ValueError, match=r"f: v's base address is not 16-byte aligned"):
        t_flash._tma_strides("f", "v", torch.empty(2 * 8 * 128 + 1, dtype=bf)[1:].view(2, 8, 128))
    with pytest.raises(ValueError, match=r"f: q needs a unit column stride"):
        t_flash._tma_strides("f", "q", torch.empty(2, 128, 8, dtype=bf).transpose(1, 2))
