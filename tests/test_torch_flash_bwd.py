"""The port's trainable flash attention (K16: forward + lse, dQ, dK/dV) on the
CPU against the JAX package's ``flash_attention_trainable`` in interpret mode
(block 128, as ``tests/test_flash_bwd.py`` runs it).

float32 inputs from numpy seeds on both sides.  Outputs are compared on the
valid rows within atol 2e-5 / rtol 1e-4 and dq/dk/dv within atol 5e-5 /
rtol 1e-3 (the JAX package's own limits): float32 round-off of sums taken in
another order.  Padding rows' outputs are not pinned (the TPU kernel emits
the mean of v there, flash_attention_bwd.py:608-614; the port emits zeros).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omchat_tpu.ops.flash_attention_bwd import flash_attention_trainable as jax_trainable

from omchat_torch.ops import flash_attention_bwd as fb

OUT_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-5, rtol=1e-3)


def _packed_ids(b, s, seed):
    """Documents of random lengths and a -1 padding tail on every row."""
    rng = np.random.default_rng(seed)
    seg = np.full((b, s), -1, np.int32)
    for i in range(b):
        off, doc = 0, 0
        end = s - int(rng.integers(8, 40))
        while off < end:
            n = min(int(rng.integers(20, 90)), end - off)
            seg[i, off : off + n] = doc
            off, doc = off + n, doc + 1
    return seg


CASES = {
    "causal_gqa4_2": dict(B=1, S=256, H=4, KVH=2, causal=True),
    "noncausal_gqa4_2": dict(B=1, S=256, H=4, KVH=2, causal=False),
    "causal_gqa7_1_ragged200": dict(B=1, S=200, H=7, KVH=1, causal=True),
    "noncausal_mha2_ragged200": dict(B=2, S=200, H=2, KVH=2, causal=False),
    "packed_causal_gqa4_2": dict(B=2, S=300, H=4, KVH=2, causal=True, packed=True),
    "packed_noncausal_gqa7_1": dict(B=1, S=260, H=7, KVH=1, causal=False, packed=True),
}


def _inputs(c, seed=0):
    rng = np.random.default_rng(seed)
    B, S, H, KVH = c["B"], c["S"], c["H"], c["KVH"]
    q = rng.standard_normal((B, S, H, 128)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, 128)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, 128)).astype(np.float32)
    w = np.cos(np.arange(B * S * H * 128).reshape(B, S, H, 128) * 0.01).astype(np.float32)
    seg = _packed_ids(B, S, seed + 1) if c.get("packed") else None
    return q, k, v, w, seg


def _jax_side(c, q, k, v, w, seg):
    js = None if seg is None else jnp.asarray(seg)

    def fn(q, k, v):
        return jax_trainable(q, k, v, c["causal"], 128, 128, True, js)

    out = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", list(CASES))
def test_trainable_attention_matches_jax(name):
    c = CASES[name]
    q, k, v, w, seg = _inputs(c)
    ref_out, ref_grads = _jax_side(c, q, k, v, w, seg)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ts = None if seg is None else torch.from_numpy(seg)
    out = fb.flash_attention_trainable(tq, tk, tv, c["causal"], ts)
    (out * torch.from_numpy(w)).sum().backward()
    valid = np.ones(q.shape[:2], bool) if seg is None else seg >= 0
    np.testing.assert_allclose(out.detach().numpy()[valid], ref_out[valid], **OUT_TOL)
    for got, ref, n in zip((tq.grad, tk.grad, tv.grad), ref_grads, "qkv"):
        np.testing.assert_allclose(got.numpy(), ref, err_msg=f"d{n}", **GRAD_TOL)


@pytest.mark.parametrize("name", ["causal_gqa7_1_ragged200", "packed_causal_gqa4_2"])
def test_plain_kernels_match_autograd_reference(name):
    """The three plain versions, called one by one as the autograd function
    calls the kernels, against autograd through the port's plain attention
    reference (the ``"plain"`` route); padding rows get lse = -inf and zero
    gradient."""
    from omchat_torch.ops.attention import attention_reference

    c = CASES[name]
    q, k, v, w, seg = _inputs(c, seed=3)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ts = None if seg is None else torch.from_numpy(seg)
    ref = attention_reference(tq, tk, tv, causal=c["causal"], q_offset=None, kv_len=None, segment_ids=ts)
    wt = torch.from_numpy(w)
    valid = torch.ones(q.shape[:2], dtype=torch.bool) if ts is None else ts >= 0
    (ref * wt * valid[:, :, None, None]).sum().backward()
    qd, kd, vd = (x.detach() for x in (tq, tk, tv))
    out, lse = fb.flash_fwd(qd, kd, vd, c["causal"], ts)
    assert lse.shape == (c["B"], c["H"], c["S"])
    assert bool(torch.isneginf(lse.transpose(1, 2)[~valid]).all())
    assert bool(torch.isfinite(lse.transpose(1, 2)[valid]).all())
    dout = wt * valid[:, :, None, None]
    di = fb.flash_di(dout, out)
    dq = fb.flash_bwd_dq(qd, kd, vd, dout, lse, di, c["causal"], ts)
    dk, dv = fb.flash_bwd_dkv(qd, kd, vd, dout, lse, di, c["causal"], ts)
    torch.testing.assert_close(out[valid], ref.detach()[valid], **OUT_TOL)
    for got, want, n in ((dq, tq.grad, "q"), (dk, tk.grad, "k"), (dv, tv.grad, "v")):
        torch.testing.assert_close(got, want, msg=f"d{n}", **GRAD_TOL)
    assert float(dq[~valid].abs().max() if (~valid).any() else 0.0) == 0.0


def test_wrappers_route_cpu_tensors_to_the_plain_versions():
    """A CPU tensor takes the plain version: no kernel launch is counted."""
    c = CASES["causal_gqa4_2"]
    q, k, v, _, _ = _inputs(c)
    n0 = (fb.flash_fwd.launches, fb.flash_bwd_dq.launches, fb.flash_bwd_dkv.launches)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    fb.flash_attention_trainable(tq, tk, tv, True).sum().backward()
    assert (fb.flash_fwd.launches, fb.flash_bwd_dq.launches, fb.flash_bwd_dkv.launches) == n0
    assert tq.grad is not None and tk.grad.shape == tk.shape


def test_prescale_matches_jax_on_every_bf16_pattern():
    """The forward and dK/dV kernels take q already multiplied by D^-0.5 in
    bf16 (``_prescaled``), as JAX multiplies it before its pallas_calls
    (flash_attention_bwd.py:331, :432): the two products must agree bitwise
    on all 65536 bf16 patterns.  Excluded: the 1130 patterns whose fp32
    product is subnormal (|q| < 1.33e-37; 1120 of them differ), which XLA on
    the CPU flushes to zero before rounding while PyTorch keeps them, and NaN
    inputs, which give NaN on both sides with payloads that IEEE leaves
    open."""
    import ml_dtypes

    bits = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    q = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16).reshape(1, 512, 1, 128)
    got = fb._prescaled(q).view(torch.int16).numpy().view(np.uint16).ravel()
    jq = jnp.asarray(bits.view(ml_dtypes.bfloat16).reshape(1, 512, 1, 128))
    ref = np.asarray(jq * jnp.asarray(128**-0.5, jnp.bfloat16)).view(np.uint16).ravel()
    qf = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    with np.errstate(invalid="ignore"):
        prod = np.abs(qf * np.float32(ml_dtypes.bfloat16(128**-0.5)))  # the fp32 product both sides round
    flushed = (prod < np.finfo(np.float32).tiny) & (prod > 0)
    nan = np.isnan(qf)
    assert flushed.sum() == 1130 and np.abs(qf[flushed]).max() < 1.33e-37
    assert (ref[flushed] & 0x7FFF == 0).all() and (got[flushed] != ref[flushed]).sum() == 1120
    keep = ~flushed & ~nan
    assert keep.sum() == 65536 - 1130 - 254
    np.testing.assert_array_equal(got[keep], ref[keep])
    out = got.view(ml_dtypes.bfloat16).astype(np.float32)
    assert np.isnan(out[nan]).all() and np.isnan(np.asarray(ref).view(ml_dtypes.bfloat16).astype(np.float32)[nan]).all()


@pytest.mark.parametrize("name", ["causal_gqa7_1_ragged200", "packed_noncausal_gqa7_1"])
def test_prescaled_q_gives_the_plain_versions_the_same_inputs(name):
    """The plain versions round q * scale to q's dtype themselves; handing
    them the prescaled q with a unit scale is the kernels' view and must give
    the same scores: the wrappers' prescale changes no bits of the math."""
    c = CASES[name]
    q, k, v, _, seg = _inputs(c, seed=5)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    ts = None if seg is None else torch.from_numpy(seg)
    qs, s, _ = fb._scores(tq, tk, c["causal"], ts)
    torch.testing.assert_close(qs, fb._prescaled(tq), rtol=0, atol=0)
    s_pre = torch.einsum("bngsd,btnd->bngst", fb._grouped(fb._prescaled(tq), tk.shape[2]), tk.float())
    torch.testing.assert_close(s, s_pre, rtol=0, atol=0)


def test_wrappers_route_cpu_bf16_tensors_to_the_plain_versions():
    """bf16 CPU tensors (the kernels' dtype) also take the plain versions and
    count no launch; the results equal the plain versions' bitwise."""
    c = CASES["packed_causal_gqa4_2"]
    q, k, v, w, seg = _inputs(c, seed=7)
    tq, tk, tv, tw = (torch.from_numpy(x).bfloat16() for x in (q, k, v, w))
    ts = torch.from_numpy(seg)
    n0 = (fb.flash_fwd.launches, fb.flash_bwd_dq.launches, fb.flash_bwd_dkv.launches)
    out, lse = fb.flash_fwd(tq, tk, tv, True, ts)
    ro, rl = fb.flash_fwd_plain(tq, tk, tv, True, ts)
    assert torch.equal(out, ro) and torch.equal(lse, rl)
    di = fb.flash_di(tw, out)
    dk, dv = fb.flash_bwd_dkv(tq, tk, tv, tw, lse, di, True, ts)
    rk, rv = fb.flash_bwd_dkv_plain(tq, tk, tv, tw, lse, di, True, ts)
    assert torch.equal(dk, rk) and torch.equal(dv, rv)
    assert (fb.flash_fwd.launches, fb.flash_bwd_dq.launches, fb.flash_bwd_dkv.launches) == n0


@pytest.mark.parametrize("name", ["causal_gqa7_1_ragged200", "packed_noncausal_gqa7_1"])
def test_backward_hands_both_kernels_one_prescaled_q(name, monkeypatch):
    """The backward computes q * D^-0.5 once (``_prescaled``) and hands the
    same tensor to the dQ and dK/dV wrappers as ``q_scaled``; on the CPU route
    the gradients still match the JAX package's flash_attention_trainable in
    interpret mode within the JAX package's limits."""
    c = CASES[name]
    q, k, v, w, seg = _inputs(c, seed=11)
    ref_out, ref_grads = _jax_side(c, q, k, v, w, seg)
    handed = {}

    def recording(fn, key):
        def wrapper(*args, q_scaled=None, **kw):
            handed[key] = q_scaled
            return fn(*args, q_scaled=q_scaled, **kw)
        return wrapper

    monkeypatch.setattr(fb, "flash_bwd_dq", recording(fb.flash_bwd_dq, "dq"))
    monkeypatch.setattr(fb, "flash_bwd_dkv", recording(fb.flash_bwd_dkv, "dkv"))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ts = None if seg is None else torch.from_numpy(seg)
    out = fb.flash_attention_trainable(tq, tk, tv, c["causal"], ts)
    (out * torch.from_numpy(w)).sum().backward()
    assert handed["dq"] is handed["dkv"] is not None
    assert torch.equal(handed["dq"], fb._prescaled(tq.detach()))
    valid = np.ones(q.shape[:2], bool) if seg is None else seg >= 0
    np.testing.assert_allclose(out.detach().numpy()[valid], ref_out[valid], **OUT_TOL)
    for got, ref, n in zip((tq.grad, tk.grad, tv.grad), ref_grads, "qkv"):
        np.testing.assert_allclose(got.numpy(), ref, err_msg=f"d{n}", **GRAD_TOL)
