"""The port's vocab extension (``training.vision_tokenizer``) and contrastive
loss (``ops.contrastive``) against the JAX package's, on the CPU.

- The three cases of ``tests/test_vision_tokenizer.py`` on both packages side
  by side with the same ``FakeTokenizer``: the resized embedding and lm_head
  rows equal (float32; the mean rows within 1e-6, fp32 sums in another
  order), the pretrained-rows splice, and a train step on the extended vocab
  whose frozen lm_head stays bitwise while the embeddings move.
- ``clip_contrastive_loss`` and its gradient against JAX's without a mesh,
  within 1e-6; a mesh or process group refused, naming A13.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omchat_tpu.config import OmChatConfig
from omchat_tpu.ops.contrastive import clip_contrastive_loss as jclip
from omchat_tpu.training.vision_tokenizer import initialize_vision_tokenizer as jinit

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.config import OmChatConfig as TOmChatConfig
from omchat_torch.ops.contrastive import clip_contrastive_loss as tclip
from omchat_torch.training import train_step as tts
from omchat_torch.training.vision_tokenizer import initialize_vision_tokenizer as tinit
from omchat_torch.training.vision_tokenizer import mask_predicate
from omchat_torch.utils.tree import tree_items
from tests.test_vision_tokenizer import FakeTokenizer

MEAN_ATOL = 1e-6


@pytest.fixture(scope="module")
def setup():
    from tests.test_sharding import _tiny_params

    cfg = OmChatConfig.tiny()
    return cfg, TOmChatConfig.tiny(), jax.device_get(_tiny_params(cfg))


def _lm(params):
    lm = params["language_model"]
    return np.asarray(lm["embed_tokens"], np.float32), np.asarray(lm["lm_head"]["kernel"], np.float32)


def test_extend_vocab_mean_init_matches_jax(setup):
    jcfg, tcfg, jparams = setup
    v = jcfg.text.vocab_size
    jtok, ttok = FakeTokenizer(v), FakeTokenizer(v)
    jp, jtc, jmask = jinit(jparams, jcfg.text, jtok, mm_use_im_start_end=True)
    tparams = from_jax_params(jparams)
    before = {p: t.clone() for p, t in tree_items(tparams)}
    tp, ttc, tmask = tinit(tparams, tcfg.text, ttok, mm_use_im_start_end=True)
    assert ttc.vocab_size == jtc.vocab_size == v + 2
    assert all(torch.equal(t, before[p]) for p, t in tree_items(tparams))  # nothing mutated
    (je, jh), (te, th) = _lm(jp), (tp["language_model"]["embed_tokens"].numpy(),
                                   tp["language_model"]["lm_head"]["kernel"].numpy())
    assert te.shape == je.shape and th.shape == jh.shape
    np.testing.assert_array_equal(te[:v], je[:v])
    np.testing.assert_array_equal(th[:, :v], jh[:, :v])
    np.testing.assert_allclose(te[v:], je[v:], atol=MEAN_ATOL, rtol=0)
    np.testing.assert_allclose(th[:, v:], jh[:, v:], atol=MEAN_ATOL, rtol=0)
    assert [p for p, m in tree_items(tmask) if not m] == []
    # re-adding the same tokens is a no-op
    _, tc2, _ = tinit(tp, ttc, ttok, mm_use_im_start_end=True)
    assert tc2.vocab_size == v + 2


@pytest.mark.parametrize("shape", ["rows", "full"])
def test_pretrained_rows_splice_matches_jax(setup, shape):
    jcfg, tcfg, jparams = setup
    d, v = jcfg.text.hidden_size, jcfg.text.vocab_size
    rows = np.random.default_rng(2).standard_normal((2 if shape == "rows" else v + 2, d)).astype(np.float32)
    jp, _, _ = jinit(jparams, jcfg.text, FakeTokenizer(v), mm_use_im_start_end=True, pretrain_embed_rows=rows)
    tp, _, _ = tinit(from_jax_params(jparams), tcfg.text, FakeTokenizer(v), mm_use_im_start_end=True,
                     pretrain_embed_rows=rows)
    te = tp["language_model"]["embed_tokens"].numpy()
    np.testing.assert_array_equal(te[-2:], rows[-2:])
    np.testing.assert_allclose(te, _lm(jp)[0], atol=MEAN_ATOL, rtol=0)
    with pytest.raises(ValueError, match="im_start / im_end"):
        tinit(from_jax_params(jparams), tcfg.text, FakeTokenizer(v), mm_use_im_patch_token=True,
              pretrain_embed_rows=rows)


def test_finetune_step_on_extended_vocab_keeps_the_frozen_lm_head(setup):
    """The mask freezes lm_head through ``init_train_state``'s predicate;
    after a step on the extended vocab it is bitwise unchanged, the
    embeddings moved, and the loss is JAX's on the same batch."""
    jcfg, tcfg, jparams = setup
    v = jcfg.text.vocab_size
    jp, jtc, jmask = jinit(jparams, jcfg.text, FakeTokenizer(v), mm_use_im_start_end=True, tune_mm_mlp_adapter=True)
    tp, ttc, tmask = tinit(from_jax_params(jparams), tcfg.text, FakeTokenizer(v), mm_use_im_start_end=True,
                           tune_mm_mlp_adapter=True)
    frozen = sorted(p for p, m in tree_items(tmask) if not m)
    assert frozen == [("language_model", "lm_head", "kernel")]
    assert sorted(tuple(getattr(k, "key", k) for k in path) for path, m in
                  jax.tree_util.tree_flatten_with_path(jmask)[0] if not m) == frozen
    cfg2 = dataclasses.replace(tcfg, text=ttc)
    opt = tts.make_optimizer(lr=1e-2)
    state = tts.init_train_state(tp, opt, trainable=mask_predicate(tmask))
    head = state.params["language_model"]["lm_head"]["kernel"].clone()
    emb = state.params["language_model"]["embed_tokens"].detach().clone()
    b, m = 2, 8
    batch = {
        "token_ids": torch.full((b, m), 5, dtype=torch.int32),
        "is_image": torch.zeros((b, m), dtype=torch.bool),
        "image_index": torch.zeros((b, m), dtype=torch.int32),
        "positions": torch.arange(m, dtype=torch.int32).expand(b, m).contiguous(),
        "labels": torch.full((b, m), ttc.vocab_size - 1, dtype=torch.int32),
    }
    state, loss = tts.train_step(state, cfg2, batch, opt, attn_impl="plain", remat=False)
    assert torch.equal(state.params["language_model"]["lm_head"]["kernel"], head)
    assert float((state.params["language_model"]["embed_tokens"].detach() - emb).abs().max()) > 0

    from omchat_tpu.training import train_step as jts

    jloss, _ = jts.loss_fn(jp, dataclasses.replace(jcfg, text=jtc), {k: jnp.asarray(t.numpy()) for k, t in
                                                                     batch.items()}, attn_impl="xla", remat=False)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("b,d,scale", [(8, 16, 30.0), (5, 32, 100.0)])
def test_clip_contrastive_loss_and_gradient_match_jax(b, d, scale):
    rng = np.random.default_rng(b)
    img = rng.standard_normal((b, d)).astype(np.float32)
    txt = (img + 0.3 * rng.standard_normal((b, d))).astype(np.float32)
    jloss, (jgi, jgt) = jax.value_and_grad(lambda i, t: jclip(i, t, jnp.asarray(scale)), argnums=(0, 1))(
        jnp.asarray(img), jnp.asarray(txt))
    ti, tt = torch.from_numpy(img).requires_grad_(), torch.from_numpy(txt).requires_grad_()
    loss = tclip(ti, tt, scale)
    gi, gt = torch.autograd.grad(loss, (ti, tt))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(gi.numpy(), np.asarray(jgi), atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(jgt), atol=1e-6)
    # bf16 features are normalised in fp32, as in JAX
    lb = tclip(torch.from_numpy(img).bfloat16(), torch.from_numpy(txt).bfloat16(), scale)
    jb = jclip(jnp.asarray(img, jnp.bfloat16), jnp.asarray(txt, jnp.bfloat16), jnp.asarray(scale))
    np.testing.assert_allclose(lb.item(), float(jb), rtol=1e-5)


def test_clip_contrastive_loss_refuses_a_mesh_naming_a13():
    x = torch.zeros((2, 4))
    with pytest.raises(NotImplementedError, match="A13"):
        tclip(x, x, 1.0, mesh=object())
