"""Training attention (K16a forward + lse, K16b dQ, K16c dK/dV) at head widths
other than 128, and the trainer on a model of that geometry, on the CPU
against the JAX package.

- K16's plain versions (``flash_fwd_plain``, ``flash_bwd_dq_plain``,
  ``flash_bwd_dkv_plain``, through the autograd function a CPU tensor takes)
  against JAX's ``flash_attention_trainable`` in interpret mode (block 128,
  as tests/test_torch_flash_bwd.py runs it) at head widths 8, 16, 64 and 72:
  causal group 7 / 1 over a ragged 200 rows, non-causal 16 / 16 heads (the
  300M ViT's), and a packed causal group-7 case with a -1 tail.  float32 on
  both sides, at that file's limits: outputs atol 2e-5 / rtol 1e-4 on the
  valid rows, dq / dk / dv atol 5e-5 / rtol 1e-3 (float32 round-off of sums
  taken in another order).
- The width rule of the three CUDA entries (``head_dim_supported``, shared
  with K2): which (D, dtype) each wrapper hands its C entry, recorded
  instead of launched on meta tensors, and the messages of the refusals
  (widths 4, 12, 136, 256; an fp32 tensor).
- A model of the InternVL2-1B geometry (Qwen2-0.5B's head width 64 and group
  7, InternViT-300M's head width 64 without qk-norm; 2 + 2 layers, narrow
  elsewhere, float32): the port's ``loss_fn`` and gradients, ``train_step``
  (stage-1 and stage-2) and ``lora_train_step`` against the JAX package's on
  the same weights (``from_jax_params``; XLA attention there), at
  tests/test_torch_train.py's limits: loss rel 1e-5 and every gradient leaf
  within 1e-4 of its max |g|; step losses rel 1e-4 and every parameter within
  1e-3 * lr per update (LoRA adapters: 1e-2 * lr, that file's QLoRA limit,
  for the reason at LORA_PER_UPDATE).
- ``random_model_spec``: the tiny model, fp32 on the CPU and bf16 on CUDA.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omchat_tpu.ops.flash_attention_bwd import flash_attention_trainable as jax_trainable

from tests.test_torch_train import _assert_tree_close, _batch, _jax_optimizer

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.ops import flash_attention as t_flash
from omchat_torch.ops import flash_attention_bwd as fb
from omchat_torch.utils.tree import tree_items

OUT_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-5, rtol=1e-3)
LOSS_RTOL, GRAD_REL, STEP_LOSS_RTOL = 1e-5, 1e-4, 1e-4
# LoRA adapters after their steps, per update and lr: tests/test_torch_train.py's
# QLoRA limit.  At this geometry the adapter gradients agree with JAX's within
# 1.3e-6 of each leaf's max |g| (read on this CPU), but k_proj's and q_proj's a
# have elements near Adam's eps (1e-8) whose ~7e-10 of round-off moves their
# normalised update by up to lr * 7e-10 / (4 eps) ~ 1.7e-2 lr (read: 1.7e-3 lr).
LORA_PER_UPDATE = 1e-2

WIDTHS = (8, 16, 64, 72)
CASES = {
    "causal_group7_ragged200": dict(B=1, S=200, H=7, KVH=1, causal=True),
    "noncausal_vit300m_16_16": dict(B=1, S=150, H=16, KVH=16, causal=False),
    "packed_causal_group7_tail": dict(B=1, S=260, H=14, KVH=2, causal=True, packed=True),
}


def _packed_ids(s, seed):
    """Documents of 20-89 rows and a -1 tail of 8-39 rows."""
    rng = np.random.default_rng(seed)
    seg = np.full((1, s), -1, np.int32)
    off, doc, end = 0, 0, s - int(rng.integers(8, 40))
    while off < end:
        n = min(int(rng.integers(20, 90)), end - off)
        seg[0, off:off + n] = doc
        off, doc = off + n, doc + 1
    return seg


def _inputs(c, D, seed):
    rng = np.random.default_rng(seed)
    B, S, H, KVH = c["B"], c["S"], c["H"], c["KVH"]
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    w = np.cos(np.arange(B * S * H * D).reshape(B, S, H, D) * 0.01).astype(np.float32)
    seg = _packed_ids(S, seed + 1) if c.get("packed") else None
    return q, k, v, w, seg


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("D", WIDTHS)
def test_trainable_attention_matches_jax_at_head_width(D, name):
    """The output and dq, dk, dv of a weighted sum, K16's plain versions
    against the Pallas kernels in interpret mode; padding rows get zero
    gradient (their outputs are not pinned: the TPU kernel emits the mean of
    v there, the port zeros)."""
    c = CASES[name]
    q, k, v, w, seg = _inputs(c, D, seed=D)
    js = None if seg is None else jnp.asarray(seg)

    def fn(q, k, v):
        return jax_trainable(q, k, v, c["causal"], 128, 128, True, js)

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref_out = np.asarray(fn(jq, jk, jv))
    ref_grads = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * w), argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ts = None if seg is None else torch.from_numpy(seg)
    n0 = (fb.flash_fwd.launches, fb.flash_bwd_dq.launches, fb.flash_bwd_dkv.launches)
    out = fb.flash_attention_trainable(tq, tk, tv, c["causal"], ts)
    (out * torch.from_numpy(w)).sum().backward()
    assert (fb.flash_fwd.launches, fb.flash_bwd_dq.launches, fb.flash_bwd_dkv.launches) == n0  # the plain versions
    valid = np.ones(q.shape[:2], bool) if seg is None else seg >= 0
    np.testing.assert_allclose(out.detach().numpy()[valid], ref_out[valid], **OUT_TOL)
    for got, ref, n in zip((tq.grad, tk.grad, tv.grad), ref_grads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), err_msg=f"d{n}", **GRAD_TOL)
    if seg is not None:
        assert not tq.grad.numpy()[~valid].any()


@pytest.mark.parametrize("D", (16, 64))
def test_lse_and_padding_rows_at_head_width(D):
    """K16a's plain lse against log-sum-exp of the scaled scores at the true
    width's scale; padding rows get lse = -inf and zero output."""
    c = CASES["packed_causal_group7_tail"]
    q, k, v, _, seg = _inputs(c, D, seed=3)
    tq, tk, tv, ts = map(torch.from_numpy, (q, k, v, seg))
    out, lse = fb.flash_fwd(tq, tk, tv, True, ts)
    mask = fb.attention_mask(c["S"], True, ts, "cpu")[:, None, None]
    s = torch.einsum("bsngd,btnd->bngst", tq.reshape(1, c["S"], 2, 7, D) * D ** -0.5, tk)
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1).reshape(1, 14, c["S"])
    valid = ts[0] >= 0
    torch.testing.assert_close(lse[..., valid], want[..., valid], atol=1e-5, rtol=1e-5)
    assert bool(torch.isneginf(lse[..., ~valid]).all()) and not out[0, ~valid].any()


# ---------------------------------------------------------------------------
# the width rule of the CUDA entries, recorded instead of launched
# ---------------------------------------------------------------------------

ENTRIES = {"flash_fwd": "omchat_flash_attention_fwd", "flash_bwd_dq": "omchat_flash_attention_bwd_dq",
           "flash_bwd_dkv": "omchat_flash_attention_bwd_dkv"}
D_ARG = {"flash_fwd": 10, "flash_bwd_dq": 12, "flash_bwd_dkv": 13}  # the index of D among each entry's arguments


@pytest.fixture
def recorded(monkeypatch):
    """The three C entries recorded instead of launched, on meta tensors
    that pass for the card's: each call appends (entry, args)."""
    calls = []
    monkeypatch.setattr(fb, "_on_cuda", lambda name, tensors: None)
    kl = fb.kernel_lib
    monkeypatch.setattr(kl, "ptr", lambda t: t)
    monkeypatch.setattr(kl, "stream_ptr", lambda device=None: 0)
    monkeypatch.setattr(kl, "launch", lambda source, entry, argtypes, *args: calls.append((entry, args)))
    for w in (fb.flash_fwd, fb.flash_bwd_dq, fb.flash_bwd_dkv):  # put back: later tests read the counts
        monkeypatch.setattr(w, "launches", w.launches)
    return calls


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _call(kernel: str, D: int, dtype=torch.bfloat16, seg=False):
    """One call of the CUDA wrapper ``kernel`` at head width D, Qwen2-0.5B's
    14 / 2 heads over 2 x 200 rows."""
    B, S, H, KVH = 2, 200, 14, 2
    q, k, v, do = _meta(B, S, H, D, dtype=dtype), _meta(B, S, KVH, D), _meta(B, S, KVH, D), _meta(B, S, H, D)
    lse, di = _meta(B, H, S, dtype=torch.float32), _meta(B, H, S, dtype=torch.float32)
    ids = torch.zeros(B, S, dtype=torch.int32, device="meta") if seg else None
    if kernel == "flash_fwd":
        return fb.flash_fwd(q, k, v, True, ids)
    return getattr(fb, kernel)(q, k, v, do, lse, di, True, ids)


@pytest.mark.parametrize("kernel", list(ENTRIES))
def test_each_cuda_entry_takes_the_widths_of_the_rule(recorded, kernel):
    """A width of the shared rule reaches the C entry with the true width,
    with and without segment ids; any other raises before a launch, naming
    the wrapper, the width and q's shape."""
    for D in range(4, 261, 4):
        if t_flash.head_dim_supported(D):
            for seg in (False, True):
                _call(kernel, D, seg=seg)
                entry, args = recorded.pop()
                assert entry == ENTRIES[kernel] and args[D_ARG[kernel]] == D
                assert (args[D_ARG[kernel] - 4:D_ARG[kernel]]) == (2, 200, 14, 2)  # B, S, H, KVH
        else:
            with pytest.raises(ValueError, match=rf"^{kernel}: head width {D} \(q \(2, 200, 14, {D}\)\) is not taken "
                                                 r"by the CUDA kernel, which takes a multiple of 8 from 8 to 128$"):
                _call(kernel, D)
    assert not recorded
    assert [d for d in range(0, 300) if t_flash.head_dim_supported(d)] == list(range(8, 129, 8))


@pytest.mark.parametrize("kernel", list(ENTRIES))
@pytest.mark.parametrize("D", (4, 12, 136, 256))
def test_refused_widths_and_dtypes(recorded, kernel, D):
    """The widths the rule refuses and an fp32 q raise by name; nothing is launched."""
    with pytest.raises(ValueError, match=rf"{kernel}: head width {D} "):
        _call(kernel, D)
    with pytest.raises(TypeError, match=rf"^{kernel}: the CUDA kernel takes bfloat16, got torch.float32 "
                                        rf"\(q \(2, 200, 14, 64\)\)$"):
        _call(kernel, 64, dtype=torch.float32)
    assert not recorded


def test_dq_scale_is_the_true_widths(recorded):
    """K16b multiplies dQ by D^-0.5 rounded to bf16 at the true width."""
    for D in (16, 64, 72, 128):
        _call("flash_bwd_dq", D)
        (_, args), = recorded
        recorded.clear()
        assert args[14].value == float(torch.tensor(D ** -0.5, dtype=torch.bfloat16))


def test_a_group_that_does_not_divide_is_refused(recorded):
    q, k = _meta(1, 64, 14, 64), _meta(1, 64, 4, 64)
    with pytest.raises(ValueError, match=r"^flash_fwd: q \(1, 64, 14, 64\) / k \(1, 64, 4, 64\) / v \(1, 64, 4, 64\) "
                                         r"unsupported by the CUDA kernel \(whole GQA groups, self-attention\)$"):
        fb.flash_fwd(q, k, k, True)
    assert not recorded


# ---------------------------------------------------------------------------
# the trainer on the InternVL2-1B geometry, 2 + 2 layers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def geometry():
    """(JAX cfg, port cfg, JAX params) of the head-64, group-7 model."""
    from tests.test_sharding import _tiny_params
    from tests.test_torch_head_widths import _narrow_configs

    jcfg, tcfg = _narrow_configs()
    assert (tcfg.text.attn_head_dim, tcfg.text.num_attention_heads // tcfg.text.num_key_value_heads) == (64, 7)
    assert tcfg.vision.head_dim == 64 and not tcfg.vision.qk_normalization
    return jcfg, tcfg, jax.device_get(_tiny_params(jcfg))


def test_loss_and_gradients_at_head_width_64(geometry):
    from omchat_tpu.training import train_step as jts

    from omchat_torch.training import train_step as tts

    jcfg, tcfg, jparams = geometry
    tb, jb = _batch(tcfg, 0)
    jloss, jn = jts.loss_fn(jparams, jcfg, jb, attn_impl="xla")
    jgrads = jax.grad(lambda p: jts.loss_fn(p, jcfg, jb, attn_impl="xla")[0])(jparams)
    params = tts.set_trainable(from_jax_params(jparams))
    n0 = fb.flash_bwd_dkv.launches
    loss, n = tts.loss_fn(params, tcfg, tb)
    assert int(n) == int(jn)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    paths = [p for p, t in tree_items(params) if t.requires_grad]
    nested: dict = {}
    for path, g in zip(paths, tts.gradients(loss, tts.trainable_leaves(params))):
        node = nested
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = g
    assert fb.flash_bwd_dkv.launches == n0  # CPU tensors: the plain versions
    _assert_tree_close(nested, jgrads, GRAD_REL, "grad")


@pytest.mark.parametrize("stage1", [True, False], ids=["stage1_projector_only", "stage2_every_weight"])
def test_train_steps_at_head_width_64(geometry, stage1):
    """Three steps, warmup 1 + cosine, clip 1.0: losses and every parameter
    against the JAX step; in stage-1 every leaf outside the projector is
    untouched."""
    from omchat_tpu.training import train_step as jts
    from omchat_tpu.training.schedules import warmup_cosine_schedule as jax_schedule

    from omchat_torch.training import train_step as tts
    from omchat_torch.training.schedules import warmup_cosine_schedule

    jcfg, tcfg, jparams = geometry
    lr, steps = 1e-3, 3
    mask = None
    if stage1:
        mask = {k: jax.tree.map(lambda _, grp=k: "train" if grp == "projector" else "freeze", v)
                for k, v in jparams.items()}
    jopt = _jax_optimizer(jax_schedule(lr, total_steps=steps, warmup_steps=1), 1.0, 1, mask)
    jstate = jts.init_train_state(jparams, jopt)
    topt = tts.make_optimizer(warmup_cosine_schedule(lr, total_steps=steps, warmup_steps=1),
                              weight_decay=tts.ADAMW_WEIGHT_DECAY, grad_clip=1.0)
    state = tts.init_train_state(from_jax_params(jparams), topt,
                                 (lambda path: path[0] == "projector") if stage1 else None)
    frozen0 = {p: t.clone() for p, t in tree_items(state.params) if not t.requires_grad}
    for i in range(steps):
        tb, jb = _batch(tcfg, 10 + i)
        jstate, jloss = jts.train_step(jstate, jcfg, jb, jopt, attn_impl="xla")
        state, loss = tts.train_step(state, tcfg, tb, topt)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_LOSS_RTOL)
    _assert_tree_close(state.params, jstate.params, 0.0, "param", atol=1e-3 * lr * steps)
    for path, t in tree_items(state.params):
        if path in frozen0:
            assert torch.equal(t, frozen0[path]), ".".join(path)
    assert bool(frozen0) == stage1


def test_lora_steps_at_head_width_64(geometry):
    """Three LoRA steps (rank 4 on q / k / v / o): losses and adapters
    against JAX ``lora_train_step``; the base is untouched."""
    from omchat_tpu.training import lora as jlora
    from omchat_tpu.training.schedules import warmup_cosine_schedule as jax_schedule

    import optax

    from omchat_torch.training import lora as tlora
    from omchat_torch.training import train_step as tts
    from omchat_torch.training.schedules import warmup_cosine_schedule

    jcfg, tcfg, jparams = geometry
    jl = jax.device_get(jlora.init_lora(jax.random.PRNGKey(0), jparams, rank=4, alpha=8.0, dtype=jnp.float32))
    lr, steps = 2e-3, 3
    jopt = optax.masked(_jax_optimizer(jax_schedule(lr, total_steps=steps, warmup_steps=0), 1.0, 1),
                        {**jax.tree.map(lambda _: True, jl), "scale": False})
    jopt_state = jopt.init(jl)
    params = from_jax_params(jparams)
    base0 = {p: t.clone() for p, t in tree_items(params)}
    tl = from_jax_params(jl)
    topt = tts.AdamW(warmup_cosine_schedule(lr, total_steps=steps), grad_clip=1.0)
    tstate = topt.init(tlora.lora_leaves(tl))
    for i in range(steps):
        tb, jb = _batch(tcfg, 20 + i)
        jl, jopt_state, jloss = jlora.lora_train_step(jl, jopt_state, jparams, jcfg, jb, jopt, attn_impl="xla")
        tl, tstate, loss = tlora.lora_train_step(tl, tstate, params, tcfg, tb, topt)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_LOSS_RTOL)
    _assert_tree_close(tl["layers"], jl["layers"], 0.0, "adapter", atol=LORA_PER_UPDATE * lr * steps)
    assert float(tl["layers"]["self_attn"]["q_proj"]["b"].detach().abs().max()) > 0
    for path, t in tree_items(params):
        assert torch.equal(t, base0[path]), ".".join(path)


# ---------------------------------------------------------------------------
# the train CLI's random model
# ---------------------------------------------------------------------------


def test_random_model_is_the_tiny_model_on_every_device():
    """Without --model-path the CLI builds JAX's choice, ``OmChatConfig.tiny()``
    (cli/train.py), in fp32 on the CPU and in bf16 on CUDA (no card needed
    to ask)."""
    from omchat_tpu.config import OmChatConfig as JOmChatConfig

    from omchat_torch.cli.train import random_model, random_model_spec
    from omchat_torch.config import OmChatConfig

    for device, dtype in ((torch.device("cuda"), torch.bfloat16), (torch.device("cpu"), torch.float32)):
        cfg, got = random_model_spec(device)
        assert cfg == OmChatConfig.tiny() and got == dtype
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JOmChatConfig.tiny())
    cfg, params = random_model(torch.device("cpu"))
    assert cfg == OmChatConfig.tiny()
    assert {t.dtype for _, t in tree_items(params)} == {torch.float32}
    heads = cfg.vision.head_dim, cfg.text.attn_head_dim
    assert all(t_flash.head_dim_supported(d) for d in heads)  # K16 takes both on the card
