"""The w8a8 kernels' plain versions (K7 rmsnorm_quant, K8 add_rmsnorm_quant,
K9 fc1 + GELU + quantize, K11 proj glue) and the int8 linear ops on the CPU,
against the JAX package: its Pallas kernels in interpret mode and its XLA
ops, on the same seeded numpy inputs.

Tolerances (bf16 inputs, as the JAX package's own oracles in
tests/test_pallas_kernels.py and tests/test_llm_glue.py use):
- int8 codes: max |Δ| <= 1 and at least 99% equal — a code moves by one
  where the two sides' fp32 sums (mean of squares, rsqrt, tanh) differ in
  the last bit next to a rounding boundary;
- x' (the new residual): within one bf16 ulp of the reference value (K8);
  for K11 on 99% of its elements and all within the JAX package's own x'
  limit for this kernel (rtol 1e-2, atol 2e-2): JAX on the CPU keeps fp32
  through the body's bf16 roundings of the dequantized product (XLA's
  default excess precision), and a ±1 code of the quantized attention
  output moves its whole row of x' by a few ulps;
- row scales: rtol 1e-5 (fp32 round-off of the same amax); for K11 rtol
  1e-3, as the row an input code moves has another amax (4e-5 seen);
- int32 products, int8 weight codes and their scales: exactly equal.
Each kernel is also held against the port's own unfused chain with the
JAX package's limits for that comparison (codes ±1 and >= 90% equal, row
scales rtol 1e-2).  The int8 kernels are the port's [out, in] transposes of
the JAX [in, out] ones.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omchat_torch.ops import linear as tlin
from omchat_torch.ops import norms as tnorms
from omchat_torch.ops import quant_matmul as tqm

CODE_EQUAL = 0.99


def _bf16(rng, *shape, scale=1.0, offset=0.0):
    a = (rng.standard_normal(shape) * scale + offset).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def check_codes(got, want, equal=CODE_EQUAL):
    d = np.abs(_np(got).astype(np.int32) - _np(want).astype(np.int32))
    assert d.max() <= 1, f"codes differ by {d.max()}"
    assert (d == 0).mean() >= equal, f"only {(d == 0).mean():.4f} of the codes equal"


def check_within_bf16_ulp(got, want, share=1.0):
    g, w = _np(got), _np(want)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    within = (np.abs(g - w) <= ulp).mean()
    assert within >= share, f"{within:.4f} of the elements within one bf16 ulp (max |Δ| {np.abs(g - w).max()})"
    if share < 1.0:
        np.testing.assert_allclose(g, w, rtol=1e-2, atol=2e-2)


def _qparams(rng, k, n, bias=True):
    """A quantized linear, as the JAX package holds it and as the port does."""
    q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = jnp.asarray(rng.random(n) * 4e-4 + 1e-4, jnp.bfloat16)
    jp = {"kernel_q": jnp.asarray(q), "scale": s}
    tp = {"kernel_q": torch.from_numpy(q.T.copy()), "scale": torch.from_numpy(np.asarray(s, np.float32)).bfloat16()}
    if bias:
        b = rng.standard_normal(n).astype(np.float32) * 0.01
        jp["bias"] = jnp.asarray(b, jnp.bfloat16)
        tp["bias"] = torch.from_numpy(b).bfloat16()
    return jp, tp


@pytest.mark.parametrize("shape", [(2, 21, 256), (3, 128, 384)], ids=["rows42_padded", "rows384"])
def test_rmsnorm_quant_matches_pallas(shape):
    from omchat_tpu.ops.linear import quantize_activations
    from omchat_tpu.ops.norms import rms_norm, rmsnorm_quant

    rng = np.random.default_rng(3)
    jx, tx = _bf16(rng, *shape)
    jg, tg = _bf16(rng, shape[-1], scale=0.1, offset=1.0)
    want_q, want_rs = rmsnorm_quant(jx, jg, eps=1e-6, interpret=True)
    got_q, got_rs = tnorms.rmsnorm_quant(tx, tg, eps=1e-6)
    assert got_q.dtype == torch.int8 and got_q.shape == tx.shape and got_rs.shape == (*shape[:-1], 1)
    check_codes(got_q, want_q)
    np.testing.assert_allclose(_np(got_rs), _np(want_rs), rtol=1e-5)
    # against the unfused chain (JAX's own limits for the kernel vs the chain)
    chain_q, chain_rs = quantize_activations(rms_norm(jx, jg, 1e-6))
    check_codes(got_q, chain_q, equal=0.9)
    np.testing.assert_allclose(_np(got_rs), _np(chain_rs), rtol=1e-2)


@pytest.mark.parametrize("residual", ["layerscale", "plain"])
def test_add_rmsnorm_quant_matches_pallas(residual):
    from omchat_tpu.ops.linear import quantize_activations
    from omchat_tpu.ops.norms import add_rmsnorm_quant, rms_norm

    rng = np.random.default_rng(4)
    B, S, D = 2, 21, 256  # 42 rows: not a multiple of the TPU's row block
    jx, tx = _bf16(rng, B, S, D)
    jd, td = _bf16(rng, B, S, D)
    jg, tg = _bf16(rng, D, scale=0.1, offset=1.0)
    if residual == "layerscale":
        jls, tls = _bf16(rng, D, scale=0.1)
    else:  # the port takes None for a plain residual, JAX a vector of ones
        jls, tls = jnp.ones((D,), jnp.bfloat16), None
    want_x, want_q, want_rs = add_rmsnorm_quant(jx, jd, jls, jg, eps=1e-6, interpret=True)
    got_x, got_q, got_rs = tnorms.add_rmsnorm_quant(tx, td, tls, tg, eps=1e-6)
    assert got_x.dtype == torch.bfloat16 and got_q.dtype == torch.int8
    check_within_bf16_ulp(got_x, want_x)
    check_codes(got_q, want_q)
    np.testing.assert_allclose(_np(got_rs), _np(want_rs), rtol=1e-5)
    chain_q, chain_rs = quantize_activations(rms_norm(jx + jd * jls, jg, 1e-6))
    check_codes(got_q, chain_q, equal=0.9)
    np.testing.assert_allclose(_np(got_rs), _np(chain_rs), rtol=1e-2)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_fc1_gelu_quant_matches_pallas(bias):
    from omchat_tpu.ops.linear import dense_prequant_gelu_quant
    from omchat_tpu.ops.quant_matmul import dense_prequant_gelu_quant_pallas

    rng = np.random.default_rng(5)
    M, K, N = 24, 256, 384  # M not a block multiple
    xq = rng.integers(-127, 128, (2, M, K)).astype(np.int8)
    rs = (rng.random((2, M, 1)) * 0.01 + 1e-3).astype(np.float32)
    jp, tp = _qparams(rng, K, N, bias)
    out_scale = np.float32(0.01)
    want = dense_prequant_gelu_quant_pallas(jnp.asarray(xq), jnp.asarray(rs), jp, jnp.float32(out_scale),
                                            interpret=True)
    txq, trs = torch.from_numpy(xq), torch.from_numpy(rs)
    assert tqm.pallas_supported(K, N)
    got = tqm.fc1_gelu_quant(txq, trs, tp, torch.tensor(out_scale))
    assert got.dtype == torch.int8 and got.shape == (2, M, N)
    check_codes(got, want)
    # the unfused chains (they divide by out_scale) agree with each other and with the kernel
    chain = tlin.dense_prequant_gelu_quant(txq, trs, tp, torch.tensor(out_scale))
    check_codes(chain, dense_prequant_gelu_quant(jnp.asarray(xq), jnp.asarray(rs), jp, jnp.float32(out_scale)))
    check_codes(got, chain)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_attn_proj_glue_quant_matches_pallas(bias):
    from omchat_tpu.ops.linear import dense
    from omchat_tpu.ops.norms import add_rmsnorm_quant
    from omchat_tpu.ops.quant_matmul import attn_proj_glue_quant

    rng = np.random.default_rng(7)
    B, M, K = 2, 70, 256  # M not a multiple of the TPU's 128-row block
    assert tqm.proj_glue_supported(K, K) and not tqm.proj_glue_supported(K, 2 * K)
    ja, ta = _bf16(rng, B, M, K, scale=0.5)
    jx, tx = _bf16(rng, B, M, K)
    jp, tp = _qparams(rng, K, K, bias)
    jls, tls = _bf16(rng, K, scale=0.1, offset=0.05)
    jg, tg = _bf16(rng, K, scale=0.1, offset=1.0)
    want_x, want_q, want_rs = attn_proj_glue_quant(ja, jx, jp, jls, jg, 1e-6, interpret=True)
    got_x, got_q, got_rs = tqm.attn_proj_glue_quant(ta, tx, tp, tls, tg, 1e-6)
    assert got_x.shape == tx.shape and got_q.dtype == torch.int8 and got_rs.shape == (B, M, 1)
    check_within_bf16_ulp(got_x, want_x, share=CODE_EQUAL)
    check_codes(got_q, want_q)
    np.testing.assert_allclose(_np(got_rs), _np(want_rs), rtol=1e-3)
    # against the unfused chain: w8a8 dense, then K8
    chain_x, chain_q, chain_rs = add_rmsnorm_quant(jx, dense(ja, jp, a8=True), jls, jg, 1e-6, interpret=True)
    check_within_bf16_ulp(got_x, chain_x, share=CODE_EQUAL)
    check_codes(got_q, chain_q, equal=0.9)
    np.testing.assert_allclose(_np(got_rs), _np(chain_rs), rtol=1e-2)


def test_quantize_linear_and_tree_match_jax():
    """Codes and scales exactly equal (the port's kernel_q is the transpose)."""
    from omchat_tpu.ops.linear import quantize_linear, quantize_tree

    rng = np.random.default_rng(8)
    w2 = (rng.standard_normal((64, 48)) * 0.02).astype(np.float32)
    w3 = (rng.standard_normal((3, 32, 40)) * 0.02).astype(np.float32)
    w3[1, :, 5] = 0.0  # an all-zero column: the 1e-8 scale floor
    b3 = rng.standard_normal((3, 40)).astype(np.float32)
    conv = rng.standard_normal((2, 2, 3, 8)).astype(np.float32)
    jtree = {"a": {"kernel": jnp.asarray(w2)}, "b": {"kernel": jnp.asarray(w3), "bias": jnp.asarray(b3)},
             "patch": {"kernel": jnp.asarray(conv)}}
    ttree = {"a": {"kernel": torch.from_numpy(w2)}, "b": {"kernel": torch.from_numpy(w3), "bias": torch.from_numpy(b3)},
             "patch": {"kernel": torch.from_numpy(conv)}}
    want, got = quantize_tree(jtree), tlin.quantize_tree(ttree)
    for name, axes in (("a", (1, 0)), ("b", (0, 2, 1))):
        np.testing.assert_array_equal(got[name]["kernel_q"].numpy(), np.transpose(np.asarray(want[name]["kernel_q"]),
                                                                                  axes))
        assert got[name]["scale"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got[name]["scale"]), _np(want[name]["scale"]))
    np.testing.assert_array_equal(got["b"]["bias"].numpy(), b3)
    assert "kernel" in got["patch"] and "kernel_q" not in got["patch"]  # the 4-D conv stays
    single = tlin.quantize_linear({"kernel": torch.from_numpy(w2)})
    np.testing.assert_array_equal(single["kernel_q"].numpy(), np.asarray(quantize_linear({"kernel": w2})["kernel_q"]).T)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["weight_only", "a8", "prequant"])
def test_dense_matches_jax(mode, dtype):
    """float32: the int8 paths are the same elementwise arithmetic on an exact
    int32 product (rtol 1e-6); weight-only is a float32 matmul (rtol 1e-5 +
    atol 1e-6, sums in another order).  bfloat16: one bf16 ulp."""
    from omchat_tpu.ops import linear as jlin

    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 19, 64)).astype(np.float32)
    jp, tp = _qparams(rng, 64, 96)
    if dtype == "float32":
        jp["bias"], tp["bias"] = jp["bias"].astype(jnp.float32), tp["bias"].float()
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    if mode == "prequant":
        jq, jrs = jlin.quantize_activations(jx)
        tq, trs = tlin.quantize_activations(tx)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(trs.numpy(), np.asarray(jrs))
        np.testing.assert_array_equal(tlin._int8_product(tq, tp).numpy(),
                                      np.asarray(jnp.einsum("bsk,kn->bsn", jq.astype(jnp.int32),
                                                            jp["kernel_q"].astype(jnp.int32))))
        want = jlin.dense_prequant(jq, jrs, jp, dtype=jx.dtype)
        got = tlin.dense_prequant(tq, trs, tp, dtype=tx.dtype)
    else:
        want = jlin.dense(jx, jp, a8=mode == "a8")
        got = tlin.dense(tx, tp, a8=mode == "a8")
    assert got.dtype == tx.dtype and got.shape == (2, 19, 96)
    if dtype == "bfloat16":
        check_within_bf16_ulp(got, want)
    elif mode == "weight_only":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)


def test_swiglu_quant_waits_for_k10():
    with pytest.raises(NotImplementedError, match="K10"):
        tqm.swiglu_quant(None, None, {}, {}, None)


def test_from_jax_params_carries_bf16_and_int8_leaves():
    """bf16 numpy leaves arrive as torch bf16 with their values; int8
    ``kernel_q`` leaves arrive transposed to the port's [out, in]."""
    from omchat_torch.checkpoint.convert import from_jax_params

    rng = np.random.default_rng(12)
    s = jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16)
    q = rng.integers(-127, 128, (3, 4, 5)).astype(np.int8)
    got = from_jax_params({"p": {"kernel_q": np.asarray(q), "scale": np.asarray(s)}})["p"]
    assert got["scale"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["scale"].float().numpy(), np.asarray(s, np.float32))
    assert got["kernel_q"].dtype == torch.int8
    np.testing.assert_array_equal(got["kernel_q"].numpy(), q.transpose(0, 2, 1))
