"""Per-request LoRA banks on the CPU against the JAX package: the port's
``build_lora_bank`` bitwise on the JAX package's adapters, and the trunk and
the single-request engine over a bank against the JAX package's on the same
``OmChatConfig.tiny()`` float32 weights, within 1e-5 (four of
``tests/test_lora_bank.py``'s cases: bank row 0 is the base, each bank row
against its merged weights, a mixed-adapter batch, the bank through the
decode cache).  Two adapters as in that file: rank 4 (alpha 8) on q / k / v /
o, and rank 2 on every projection.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.config import GenerationConfig as TGen
from omchat_torch.config import OmChatConfig as TOmChatConfig
from omchat_torch.models.qwen2 import qwen2_forward as t_forward
from omchat_torch.runtime.generate import OmChatEngine as TEngine
from omchat_torch.training.lora import build_lora_bank as t_build_bank
from omchat_torch.training.lora import merge_lora as t_merge

TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    """(JAX params, JAX adapters, the port's params and adapters, both banks)."""
    from omchat_tpu.config import OmChatConfig
    from omchat_tpu.training.lora import ALL_TARGETS, build_lora_bank, init_lora
    from tests.test_sharding import _tiny_params

    params = _tiny_params(OmChatConfig.tiny())

    def randomize(lora, key):
        leaves, tree = jax.tree_util.tree_flatten(lora["layers"])
        keys = jax.random.split(key, len(leaves))
        leaves = [(jax.random.normal(k, leaf.shape) * 0.1).astype(leaf.dtype) for k, leaf in zip(keys, leaves)]
        return {"layers": jax.tree_util.tree_unflatten(tree, leaves), "scale": lora["scale"]}

    k = jax.random.PRNGKey(0)
    adapters = [randomize(init_lora(k, params, rank=4, alpha=8.0), jax.random.fold_in(k, 1)),
                randomize(init_lora(k, params, rank=2, targets=ALL_TARGETS), jax.random.fold_in(k, 2))]
    t_adapters = [{"layers": from_jax_params(jax.device_get(a["layers"]), dtype=torch.float32), "scale": a["scale"]}
                  for a in adapters]
    return {"jparams": params, "jadapters": adapters, "jbank": build_lora_bank(adapters, dtype=jnp.float32),
            "tparams": from_jax_params(jax.device_get(params)), "tadapters": t_adapters,
            "tbank": t_build_bank(t_adapters, dtype=torch.float32)}


def _j_trunk(params, embeds, bank=None, ids=None):
    from omchat_tpu.config import OmChatConfig
    from omchat_tpu.models.qwen2 import qwen2_forward

    positions = jnp.broadcast_to(jnp.arange(embeds.shape[1]), embeds.shape[:2])
    hidden, _ = qwen2_forward(params["language_model"], OmChatConfig.tiny().text, jnp.asarray(embeds), positions,
                              attn_impl="xla", lora_bank=bank, adapter_ids=None if ids is None else jnp.asarray(ids))
    return np.asarray(hidden)


def _t_trunk(params, embeds, bank=None, ids=None):
    positions = torch.arange(embeds.shape[1]).expand(embeds.shape[:2])
    hidden, _ = t_forward(params["language_model"], TOmChatConfig.tiny().text, torch.from_numpy(embeds), positions,
                          attn_impl="plain", lora_bank=bank,
                          adapter_ids=None if ids is None else torch.as_tensor(ids))
    return hidden.numpy()


def _embeds(seed, b):
    return np.random.default_rng(seed).standard_normal((b, 8, TOmChatConfig.tiny().text.hidden_size)).astype(
        np.float32)


def test_build_lora_bank_is_bitwise_jax(setup):
    jbank, tbank = setup["jbank"]["layers"], setup["tbank"]["layers"]
    assert {g: set(n) for g, n in jbank.items()} == {g: set(n) for g, n in tbank.items()}
    for group, names in jbank.items():
        for name, ab in names.items():
            for leaf in ("a", "b"):
                want = np.asarray(ab[leaf])
                got = tbank[group][name][leaf].numpy()
                assert got.shape == want.shape and np.array_equal(got, want), (group, name, leaf)
    # row 0 is all zeros; the rank-2 adapter's padding rows too
    assert not tbank["self_attn"]["q_proj"]["a"][:, 0].any()
    assert not tbank["self_attn"]["q_proj"]["a"][:, 2, :, 2:].any()


def test_bank_row0_is_the_base(setup):
    embeds = _embeds(3, 2)
    base = _t_trunk(setup["tparams"], embeds)
    banked = _t_trunk(setup["tparams"], embeds, setup["tbank"], [0, 0])
    assert np.array_equal(banked, base)  # row 0 adds exact zeros
    np.testing.assert_allclose(banked, _j_trunk(setup["jparams"], embeds, setup["jbank"], [0, 0]), atol=TOL,
                               rtol=0)


def test_bank_matches_merged_weights_and_jax(setup):
    embeds = _embeds(4, 1)
    for i, adapter in enumerate(setup["tadapters"]):
        banked = _t_trunk(setup["tparams"], embeds, setup["tbank"], [i + 1])
        np.testing.assert_allclose(banked, _j_trunk(setup["jparams"], embeds, setup["jbank"], [i + 1]), atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(banked, _t_trunk(t_merge(setup["tparams"], adapter), embeds), atol=TOL, rtol=0)


def test_mixed_batch_rows_independent(setup):
    embeds = _embeds(5, 3)
    mixed = _t_trunk(setup["tparams"], embeds, setup["tbank"], [0, 1, 2])
    np.testing.assert_allclose(mixed, _j_trunk(setup["jparams"], embeds, setup["jbank"], [0, 1, 2]), atol=TOL, rtol=0)
    for row in range(3):
        solo = _t_trunk(setup["tparams"], embeds[row: row + 1], setup["tbank"], [row])
        np.testing.assert_allclose(mixed[row], solo[0], atol=TOL, rtol=0)


def test_bank_through_the_decode_cache(setup):
    """Prefill and decode under a bank: each adapter's greedy tokens and
    log-probs equal the JAX engine's with the same bank, and the merged
    engine's tokens; the decode state's adapter buffer follows each request
    (adapter 1, then 0, then per row); ids outside the bank raise."""
    from omchat_tpu.config import GenerationConfig, OmChatConfig
    from omchat_tpu.runtime.generate import OmChatEngine

    ids = [[7, 11, 13, 17, 19]]
    jgen = GenerationConfig(max_new_tokens=6, eos_token_id=-1)
    gen = TGen(max_new_tokens=6, eos_token_id=-1)
    jeng = OmChatEngine(OmChatConfig.tiny(), setup["jparams"], attn_impl="xla", prompt_bucket=8,
                        lora_bank=setup["jbank"])
    eng = TEngine(TOmChatConfig.tiny(), setup["tparams"], device="cpu", prompt_bucket=8, lora_bank=setup["tbank"])
    base = TEngine(TOmChatConfig.tiny(), setup["tparams"], device="cpu", prompt_bucket=8)
    for adapter in (1, 0, 2):
        got = eng.generate(ids, None, gen, adapter_id=adapter, return_logprobs=True)
        want = jeng.generate(ids, None, jgen, adapter_id=adapter, return_logprobs=True)
        assert got.token_ids == want.token_ids
        np.testing.assert_allclose(got.logprobs[0], want.logprobs[0], atol=TOL, rtol=0)
        truth = base if adapter == 0 else TEngine(TOmChatConfig.tiny(), t_merge(setup["tparams"],
                                                                                setup["tadapters"][adapter - 1]),
                                                  device="cpu", prompt_bucket=8)
        assert got.token_ids == truth.generate(ids, None, gen).token_ids
    rows = [[7, 11, 13, 17, 19], [5, 23, 29, 31, 37]]
    got = eng.generate(rows, None, gen, adapter_id=[2, 1]).token_ids
    assert got == jeng.generate(rows, None, jgen, adapter_id=[2, 1]).token_ids
    with pytest.raises(ValueError, match="out of range"):
        eng.generate(ids, None, gen, adapter_id=3)
    with pytest.raises(ValueError, match="out of range"):
        eng.generate(rows, None, gen, adapter_id=[1])
