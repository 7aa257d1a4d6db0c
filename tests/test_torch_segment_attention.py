"""K2 with segment ids (multi-document packing) in the port against the JAX
package, on the CPU.

- The plain version behind ``omchat_flash_attention_seg`` against the JAX
  ``flash_attention(..., segment_ids=)`` in interpret mode: causal and
  non-causal, GQA, q and kv tilings that pad the sequence to different
  lengths, a -1 tail.  float32; valid rows within atol 2e-5 / rtol 1e-4 (the
  JAX package's own limits for this kernel, float32 round-off of differently
  ordered sums).  A -1 query row: zeros in the port (plain version and CUDA
  kernel alike), unspecified in JAX (its finite mask value averages v over the
  tiles it visited), so only valid rows are compared.
- ``attention(impl=None, segment_ids=)`` on the CPU: the plain version, with
  kv_len defaulting to the count of ids >= 0.
- The packed ``loss_fn(attn_impl=None)`` (``qwen2_forward(segment_ids=)`` on
  the kernel route) on a batch from the port's ``pack_rows`` against the JAX
  ``loss_fn(attn_impl="pallas")`` (interpret mode) on the same batch and
  weights, loss within 1e-5 relative; and against the same documents run one
  at a time.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omchat_tpu.config import OmChatConfig
from omchat_tpu.ops import flash_attention as jfa
from omchat_tpu.training import train_step as jts

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.cli import train as tcli
from omchat_torch.config import OmChatConfig as TOmChatConfig
from omchat_torch.ops import flash_attention as tfa
from omchat_torch.ops.attention import attention, attention_reference
from omchat_torch.training import train_step as tts

ATOL, RTOL = 2e-5, 1e-4
LOSS_RTOL = 1e-5


def _seg(B, S, docs):
    """[B, S] int32 ids: ``docs[b]`` the (start, end) of each document of row
    b, -1 elsewhere."""
    seg = np.full((B, S), -1, np.int32)
    for b, spans in enumerate(docs):
        for i, (s, e) in enumerate(spans):
            seg[b, s:e] = i
    return seg


CASES = {
    # the JAX package's packing case at GQA group 2: three documents and a pad
    # on row 0, one document and a long pad on row 1
    "gqa_two_rows": dict(B=2, S=384, H=4, KVH=2, D=64, docs=[[(0, 100), (100, 260), (260, 300)], [(0, 180)]],
                         blocks=(128, 128)),
    # q tiles of 128 rows pad 1350 to 1408, kv tiles of 512 to 1536
    "mismatched_block_padding": dict(B=1, S=1350, H=2, KVH=1, D=32, docs=[[(0, 400), (400, 1001), (1001, 1290)]],
                                     blocks=(128, 512)),
    # documents cut inside tiles, a 7-row -1 tail, group 1
    "mha_tail": dict(B=1, S=256, H=2, KVH=2, D=16, docs=[[(0, 77), (77, 130), (130, 249)]], blocks=(64, 64)),
}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k2_with_segments_matches_pallas_interpret(case, causal):
    c = CASES[case]
    B, S, H, KVH, D = c["B"], c["S"], c["H"], c["KVH"], c["D"]
    rng = np.random.default_rng(len(case) + causal)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in ((B, S, H, D), (B, S, KVH, D),
                                                                        (B, S, KVH, D)))
    seg = _seg(B, S, c["docs"])
    bq, bk = c["blocks"]
    if case == "mismatched_block_padding":
        assert jfa._round_up(S, jfa.pick_block(S, bq)) != jfa._round_up(S, jfa.pick_block(S, bk))
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                          segment_ids=jnp.asarray(seg), block_q=bq, block_k=bk, interpret=True))
    n0 = tfa.flash_attention.seg_launches
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
                              segment_ids=torch.from_numpy(seg)).numpy()
    assert tfa.flash_attention.seg_launches == n0  # CPU tensors never launch
    valid = seg >= 0
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL, rtol=RTOL)
    # a -1 row: zeros in the port; finite in JAX, not compared
    assert (got[~valid] == 0).all()
    assert np.isfinite(want[~valid]).all()


def test_k2_segments_need_self_attention():
    """S != T raises in both packages."""
    q, k = torch.zeros((1, 8, 2, 16)), torch.zeros((1, 16, 2, 16))
    seg = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="S == T"):
        tfa.flash_attention(q, k, k, causal=True, segment_ids=seg)
    with pytest.raises(ValueError, match="S == T"):
        jfa.flash_attention(jnp.zeros((1, 8, 2, 16)), jnp.zeros((1, 16, 2, 16)), jnp.zeros((1, 16, 2, 16)),
                            causal=True, segment_ids=jnp.zeros((1, 8), jnp.int32), interpret=True)


def test_attention_dispatch_with_segments_on_the_cpu():
    """``attention(impl=None)`` takes K2's plain version; on valid rows it
    agrees with the plain route (``attention_reference``); an explicit
    kv_len equal to the count of ids >= 0 changes nothing."""
    rng = np.random.default_rng(3)
    B, S, H, KVH, D = 2, 96, 4, 1, 32
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    seg = torch.from_numpy(_seg(B, S, [[(0, 30), (30, 90)], [(0, 50), (50, 60), (60, 96)]]))
    got = attention(q, k, v, causal=True, segment_ids=seg)
    plain = tfa.flash_attention_plain(q, k.transpose(1, 2), v.transpose(1, 2), causal=True, q_offset=None,
                                      kv_len=(seg >= 0).sum(1), segment_ids=seg)
    assert torch.equal(got, plain)
    explicit = attention(q, k, v, causal=True, segment_ids=seg, kv_len=(seg >= 0).sum(1))
    assert torch.equal(got, explicit)
    ref = attention_reference(q, k, v, causal=True, q_offset=None, kv_len=None, segment_ids=seg)
    valid = seg >= 0
    torch.testing.assert_close(got[valid], ref[valid], atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def setup():
    from tests.test_sharding import _tiny_params

    cfg = OmChatConfig.tiny()
    return cfg, TOmChatConfig.tiny(), jax.device_get(_tiny_params(cfg))


def _rows(seed):
    rng = np.random.default_rng(seed)
    return [[(rng.integers(5, 400, 11).tolist(), 4), (rng.integers(5, 400, 7).tolist(), 3),
             (rng.integers(5, 400, 9).tolist(), 5)],
            [(rng.integers(5, 400, 13).tolist(), 6)]]


def test_packed_loss_on_the_kernel_route_matches_jax_pallas(setup, monkeypatch):
    jcfg, tcfg, jparams = setup
    rows = _rows(7)
    tb = tcli.pack_rows(rows, 32)
    jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    # the JAX package's kernel route, in interpret mode on the CPU
    monkeypatch.setattr(jfa, "flash_attention", functools.partial(jfa.flash_attention, interpret=True))
    jloss, jn = jts.loss_fn(jparams, jcfg, jb, attn_impl="pallas", remat=False)
    loss, n = tts.loss_fn(from_jax_params(jparams), tcfg, tb, attn_impl=None, remat=False)
    assert int(n) == int(jn) == 18
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)


def test_packed_loss_matches_the_documents_one_at_a_time(setup):
    """The packed batch's summed loss equals the sum over its documents, each
    run alone in a row of its own length (positions restart at 0 in both)."""
    _, tcfg, jparams = setup
    params = from_jax_params(jparams)
    rows = _rows(8)
    loss, n = tts.loss_fn(params, tcfg, tcli.pack_rows(rows, 32), attn_impl=None, remat=False)
    total, count = 0.0, 0
    for row in rows:
        for ids, tlen in row:
            one, m = tts.loss_fn(params, tcfg, tcli.pack_rows([[(ids, tlen)]], len(ids)), attn_impl=None,
                                 remat=False)
            total += one.item() * int(m)
            count += int(m)
    assert count == int(n)
    np.testing.assert_allclose(loss.item() * int(n), total, rtol=LOSS_RTOL)
