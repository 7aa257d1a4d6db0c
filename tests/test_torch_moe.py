"""The port's Qwen2-MoE trunk on the CPU against the JAX package, at the tiny
geometry of tests/test_qwen2_moe_parity.py (8 experts, top 2, a shared
expert) in float32: ``qwen2_moe_forward`` (cacheless logits, a prefill then
decode steps over the cache, ``norm_topk_prob`` both ways),
``convert_hf_moe_layers``, the three engines' greedy tokens (the paged
engine on both expert routes), ``moe_impl="gmm"`` against dense,
``quantize_model`` on an MoE tree, and an attention-only LoRA bank.

Tolerances: logits atol 5e-5 / rtol 1e-3 (the JAX package's against HF,
tests/test_qwen2_moe_parity.py); gmm against dense atol 1e-5 / rtol 1e-4
(float32 products of the same rows in another grouping); the bank's trunk
1e-5 (tests/test_torch_lora_bank.py's); converters, quantized leaves and
greedy tokens exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.config import GenerationConfig as TGen
from omchat_torch.config import OmChatConfig as TOmChatConfig
from omchat_torch.config import TextConfig as TTextConfig
from omchat_torch.models import qwen2_moe as tmoe
from omchat_torch.models.qwen2 import embed_tokens as t_embed
from omchat_torch.models.qwen2 import init_kv_cache as t_init_cache
from omchat_torch.models.qwen2 import lm_head as t_lm_head

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=512, rope_theta=10000.0, tie_word_embeddings=False,
            num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32, shared_expert_intermediate_size=64,
            decoder_sparse_step=1, norm_topk_prob=False)
ATOL, RTOL = 5e-5, 1e-3
NEW = 6

_REF = {}


def _cfgs(norm_topk_prob=False):
    from omchat_tpu.config import TextConfig

    kw = {**TINY, "norm_topk_prob": norm_topk_prob}
    return TextConfig(**kw), TTextConfig(**kw)


def _params(norm_topk_prob=False):
    """(JAX params, the port's) of the tiny MoE trunk, from one JAX init."""
    if norm_topk_prob not in _REF:
        from omchat_tpu.models.qwen2_moe import init_params

        jcfg, _ = _cfgs(norm_topk_prob)
        jp = init_params(jax.random.PRNGKey(0), jcfg)
        _REF[norm_topk_prob] = (jp, from_jax_params(jax.device_get(jp)))
    return _REF[norm_topk_prob]


def _ids(n, seed=0, b=1):
    return np.random.default_rng(seed).integers(0, 256, size=(b, n), dtype=np.int64)


@pytest.mark.parametrize("moe_impl", ["dense", "gmm"])
@pytest.mark.parametrize("norm_topk_prob", [False, True])
def test_moe_forward_logits_match_jax(norm_topk_prob, moe_impl):
    from omchat_tpu.models.qwen2 import embed_tokens, lm_head
    from omchat_tpu.models.qwen2_moe import qwen2_moe_forward

    jcfg, tcfg = _cfgs(norm_topk_prob)
    jp, tp = _params(norm_topk_prob)
    ids = _ids(13, 1, b=2)
    pos = np.broadcast_to(np.arange(13), (2, 13))
    hidden, _ = qwen2_moe_forward(jp, jcfg, embed_tokens(jp, jnp.asarray(ids)), jnp.asarray(pos), attn_impl="xla")
    want = np.asarray(lm_head(jp, jcfg, hidden))
    got, _ = tmoe.qwen2_moe_forward(tp, tcfg, t_embed(tp, torch.from_numpy(ids)), torch.from_numpy(pos.copy()),
                                    moe_impl=moe_impl)
    np.testing.assert_allclose(t_lm_head(tp, tcfg, got).numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("impl", [None, "plain"], ids=["kernel_path", "plain_path"])
def test_moe_prefill_then_decode_over_the_cache_matches_jax(impl):
    """7 prompt rows into the cache, then 3 decode steps (``decode_scan``
    with the MoE block as the MLP): every step's logits are JAX's."""
    from omchat_tpu.models.qwen2 import embed_tokens, init_kv_cache, lm_head
    from omchat_tpu.models.qwen2_moe import qwen2_moe_forward

    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    ids = _ids(10, 2)
    jcache = init_kv_cache(jcfg, 1, 16, dtype=jnp.float32)
    tcache = t_init_cache(tcfg, 1, 16, dtype=torch.float32)
    _, jcache = qwen2_moe_forward(jp, jcfg, embed_tokens(jp, jnp.asarray(ids[:, :7])), jnp.arange(7)[None], jcache,
                                  write_pos=0, kv_len=jnp.asarray([7]), attn_impl="xla")
    _, tcache = tmoe.qwen2_moe_forward(tp, tcfg, t_embed(tp, torch.from_numpy(ids[:, :7])), torch.arange(7)[None],
                                       tcache, write_pos=0, kv_len=torch.tensor([7]), attn_impl=impl)
    for t in range(7, 10):
        h, jcache = qwen2_moe_forward(jp, jcfg, embed_tokens(jp, jnp.asarray(ids[:, t : t + 1])), jnp.asarray([[t]]),
                                      jcache, write_pos=t, kv_len=jnp.asarray([t + 1]), attn_impl="xla")
        g, tcache = tmoe.qwen2_moe_forward(tp, tcfg, t_embed(tp, torch.from_numpy(ids[:, t : t + 1])),
                                           torch.tensor([[t]]), tcache, write_pos=torch.tensor([t]),
                                           kv_len=torch.tensor([t + 1]), attn_impl=impl)
        np.testing.assert_allclose(t_lm_head(tp, tcfg, g).numpy(), np.asarray(lm_head(jp, jcfg, h)), atol=ATOL,
                                   rtol=RTOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("tokens", [1, 8, 64])
def test_gmm_matches_dense(tokens):
    """The grouped route against the dense one, on the block alone (every
    expert group sizes 0 to many) and through the trunk."""
    _, tcfg = _cfgs()
    _, tp = _params()
    layer = {k: v[0] for k, v in tp["layers"]["mlp"]["experts"].items()}
    x = torch.from_numpy(np.random.default_rng(tokens).standard_normal((tokens, 64)).astype(np.float32))
    w, idx = tmoe._router(x, tp["layers"]["mlp"]["gate"]["kernel"][0], tcfg)
    torch.testing.assert_close(tmoe._experts_gmm(x, layer, w, idx, tcfg), tmoe._experts_dense(x, layer, w, idx, tcfg),
                               atol=1e-5, rtol=1e-4)
    ids = torch.from_numpy(_ids(tokens, 3))
    pos = torch.arange(tokens)[None]
    dense, _ = tmoe.qwen2_moe_forward(tp, tcfg, t_embed(tp, ids), pos, moe_impl="dense")
    gmm, _ = tmoe.qwen2_moe_forward(tp, tcfg, t_embed(tp, ids), pos, moe_impl="gmm")
    torch.testing.assert_close(gmm, dense, atol=1e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="moe_impl"):
        tmoe.qwen2_moe_forward(tp, tcfg, t_embed(tp, ids), pos, moe_impl="megablox")


def _hf_moe_state(rng, cfg: dict) -> dict:
    """The HF Qwen2Moe trunk's keys (float32 torch tensors)."""
    d, n, e = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["num_experts"]
    fm, fs = cfg["moe_intermediate_size"], cfg["shared_expert_intermediate_size"]
    h, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h

    def w(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.05)

    s = {"model.embed_tokens.weight": w(cfg["vocab_size"], d), "model.norm.weight": 1 + w(d),
         "lm_head.weight": w(cfg["vocab_size"], d)}
    for i in range(n):
        p = f"model.layers.{i}."
        s[p + "input_layernorm.weight"], s[p + "post_attention_layernorm.weight"] = 1 + w(d), 1 + w(d)
        for name, o in (("q_proj", h * hd), ("k_proj", kvh * hd), ("v_proj", kvh * hd)):
            s[p + f"self_attn.{name}.weight"], s[p + f"self_attn.{name}.bias"] = w(o, d), w(o)
        s[p + "self_attn.o_proj.weight"] = w(d, h * hd)
        s[p + "mlp.gate.weight"] = w(e, d)
        for j in range(e):
            q = f"{p}mlp.experts.{j}."
            s[q + "gate_proj.weight"], s[q + "up_proj.weight"], s[q + "down_proj.weight"] = w(fm, d), w(fm, d), w(d, fm)
        q = p + "mlp.shared_expert."
        s[q + "gate_proj.weight"], s[q + "up_proj.weight"], s[q + "down_proj.weight"] = w(fs, d), w(fs, d), w(d, fs)
        s[p + "mlp.shared_expert_gate.weight"] = w(1, d)
    return s


def test_convert_hf_moe_layers_matches_jax():
    """``convert_qwen2`` on an MoE config (through ``convert_hf_moe_layers``)
    builds the JAX loader's tree, bitwise in float32."""
    from omchat_tpu.checkpoint.loader import convert_qwen2 as jconvert

    from omchat_torch.checkpoint.loader import convert_qwen2

    jcfg, tcfg = _cfgs()
    state = _hf_moe_state(np.random.default_rng(4), TINY)
    want = from_jax_params(jax.device_get(jconvert(state, jcfg, dtype=jnp.float32)))
    got = convert_qwen2(state, tcfg, dtype=torch.float32)
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_w.keys() == flat_g.keys()
    for path, leaf in flat_w.items():
        assert torch.equal(flat_g[path], leaf), path
    assert got["layers"]["mlp"]["experts"]["gate_proj"].shape == (2, 8, 64, 32)
    torch.testing.assert_close(tmoe.convert_hf_moe_layers(state, tcfg, torch.float32), got["layers"]["mlp"])


# ---- the engines -------------------------------------------------------------


_ENGINES = {}


def _jax_engine_tokens():
    """The JAX engines' greedy tokens, as tests/test_qwen2_moe_parity.py runs
    them: the single-request engine on one prompt, the slot engine on a 7-row
    prompt, the paged engine on two prompts."""
    if not _ENGINES:
        from omchat_tpu.config import GenerationConfig, OmChatConfig
        from omchat_tpu.runtime.batch_engine import BatchEngine
        from omchat_tpu.runtime.generate import OmChatEngine
        from omchat_tpu.runtime.paged_engine import PagedBatchEngine

        jcfg, _ = _cfgs()
        jp, _ = _params()
        ocfg, params = OmChatConfig(text=jcfg), {"language_model": jp}
        gen = GenerationConfig(max_new_tokens=NEW, eos_token_id=-1)
        eng = OmChatEngine(ocfg, params, attn_impl="xla", prompt_bucket=8)
        single = eng.generate([_ids(9)[0].tolist()], None, gen).token_ids[0]
        slot_ids = _ids(7, 5)[0].tolist()
        be = BatchEngine(ocfg, params, max_slots=2, max_len=64, chunk_size=8, attn_impl="xla")
        rid = be.submit(slot_ids, max_new_tokens=NEW, eos_token_id=-1)
        be.run_to_completion()
        reqs = [_ids(n, 6 + n)[0].tolist() for n in (7, 5)]
        pe = PagedBatchEngine(ocfg, params, max_slots=2, num_pages=16, page_size=8, attn_impl="xla", prompt_bucket=8,
                              max_len=64)
        rids = [pe.submit(ids, max_new_tokens=NEW, eos_token_id=-1) for ids in reqs]
        pe.run_to_completion(max_ticks=200)
        _ENGINES.update(single=single, slot_ids=slot_ids, slot=be.result(rid), reqs=reqs,
                        paged=[pe.result(r) for r in rids])
    return _ENGINES


def _tocfg():
    _, tcfg = _cfgs()
    return TOmChatConfig(text=tcfg)


@pytest.mark.parametrize("impl", [None, "plain"], ids=["kernel_path", "plain_path"])
def test_single_request_engine_matches_jax(impl):
    from omchat_torch.runtime.generate import OmChatEngine

    ref = _jax_engine_tokens()
    eng = OmChatEngine(_tocfg(), {"language_model": _params()[1]}, attn_impl=impl, prompt_bucket=8, device="cpu")
    out = eng.generate([_ids(9)[0].tolist()], None, TGen(max_new_tokens=NEW, eos_token_id=-1))
    assert out.token_ids[0] == ref["single"]


def test_slot_engine_matches_jax():
    from omchat_torch.runtime.batch_engine import BatchEngine

    ref = _jax_engine_tokens()
    be = BatchEngine(_tocfg(), {"language_model": _params()[1]}, max_slots=2, max_len=64, chunk_size=8, device="cpu")
    rid = be.submit(ref["slot_ids"], max_new_tokens=NEW, eos_token_id=-1)
    be.run_to_completion()
    assert be.result(rid) == ref["slot"]


@pytest.mark.parametrize("moe_impl", ["dense", "gmm"])
@pytest.mark.parametrize("chunk", [1024, 8], ids=["short_prefill", "chunked_prefill"])
def test_paged_engine_matches_jax(moe_impl, chunk):
    """Both expert routes in the paged prefill, the rolls (decode_roll 2) and
    the JAX engine's tokens; a chunk of 8 sends the prompts through the
    paged chunk prefill."""
    from omchat_torch.runtime.paged_engine import PagedBatchEngine

    ref = _jax_engine_tokens()
    pe = PagedBatchEngine(_tocfg(), {"language_model": _params()[1]}, max_slots=2, num_pages=16, page_size=8,
                          prompt_bucket=8, max_len=64, decode_roll=2, prefill_chunk=chunk, moe_impl=moe_impl,
                          device="cpu")
    rids = [pe.submit(ids, max_new_tokens=NEW, eos_token_id=-1) for ids in ref["reqs"]]
    pe.run_to_completion(max_ticks=200)
    assert [pe.result(r) for r in rids] == ref["paged"]


def test_paged_engine_speculative_verify_on_moe():
    """The verify body takes the MoE block too: prompt-lookup speculation
    leaves the greedy tokens as they were."""
    from omchat_torch.runtime.paged_engine import PagedBatchEngine

    ref = _jax_engine_tokens()
    pe = PagedBatchEngine(_tocfg(), {"language_model": _params()[1]}, max_slots=2, num_pages=16, page_size=8,
                          prompt_bucket=8, max_len=64, speculative=True, draft_len=2, moe_impl="gmm", device="cpu")
    rids = [pe.submit(ids, max_new_tokens=NEW, eos_token_id=-1) for ids in ref["reqs"]]
    pe.run_to_completion(max_ticks=200)
    assert [pe.result(r) for r in rids] == ref["paged"]


def test_paged_engine_moe_options_refused():
    from omchat_torch.runtime.paged_engine import PagedBatchEngine

    with pytest.raises(ValueError, match="moe_impl"):
        PagedBatchEngine(_tocfg(), {"language_model": _params()[1]}, page_size=8, moe_impl="megablox", device="cpu")


def test_quantize_model_on_an_moe_tree_matches_jax():
    """``quantize_model`` quantizes what JAX's ``quantize_tree`` does (dicts
    with a 2-D or 3-D kernel: attention, router, shared expert and its gate)
    to the same int8 codes and scales, and leaves the bare expert stacks as
    they are."""
    from omchat_tpu.ops.linear import quantize_tree

    from omchat_torch.api import quantize_model

    jp, tp = _params()
    bf = lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t  # noqa: E731
    tparams = {"language_model": jax.tree.map(bf, tp)}
    want = from_jax_params(jax.device_get(quantize_tree(jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp))))
    _, got = quantize_model(_tocfg(), tparams, w8a8=False)
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got["language_model"])[0])
    assert flat_w.keys() == flat_g.keys()
    for path, leaf in flat_w.items():
        assert flat_g[path].dtype == leaf.dtype and torch.equal(flat_g[path], leaf), path
    mlp = got["language_model"]["layers"]["mlp"]
    assert mlp["experts"]["gate_proj"].dtype == torch.bfloat16
    assert mlp["gate"]["kernel_q"].dtype == torch.int8 and mlp["shared_expert"]["down_proj"]["kernel_q"].dtype == torch.int8


def test_attention_lora_bank_on_moe_trunk_matches_jax():
    """A bank of attention adapters serves on the MoE trunk (the MoE block
    takes no mlp adapter); each bank row's trunk output is JAX's; a bank
    that also targets the MLP is refused."""
    from omchat_tpu.models.qwen2 import embed_tokens
    from omchat_tpu.models.qwen2_moe import qwen2_moe_forward
    from omchat_tpu.training.lora import ALL_TARGETS, build_lora_bank, init_lora

    from omchat_torch.runtime.generate import OmChatEngine
    from omchat_torch.training.lora import build_lora_bank as t_build_bank

    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    k = jax.random.PRNGKey(3)
    lora = init_lora(k, {"language_model": jp}, rank=4, alpha=8.0, targets=ALL_TARGETS, dtype=jnp.float32)
    assert set(lora["layers"]) == {"self_attn"}  # no expert layout to adapt
    leaves, tree = jax.tree_util.tree_flatten(lora["layers"])
    keys = jax.random.split(jax.random.fold_in(k, 1), len(leaves))
    lora = {"layers": jax.tree_util.tree_unflatten(tree, [jax.random.normal(kk, a.shape) * 0.1
                                                          for kk, a in zip(keys, leaves)]), "scale": lora["scale"]}
    jbank = build_lora_bank([lora], dtype=jnp.float32)
    tbank = t_build_bank([{"layers": from_jax_params(jax.device_get(lora["layers"])), "scale": lora["scale"]}],
                         dtype=torch.float32)
    ids = _ids(9, 8, b=2)
    pos = np.broadcast_to(np.arange(9), (2, 9))
    rows = np.asarray([0, 1])
    want, _ = qwen2_moe_forward(jp, jcfg, embed_tokens(jp, jnp.asarray(ids)), jnp.asarray(pos), attn_impl="xla",
                                lora_bank=jbank, adapter_ids=jnp.asarray(rows))
    got, _ = tmoe.qwen2_moe_forward(tp, tcfg, t_embed(tp, torch.from_numpy(ids)), torch.from_numpy(pos.copy()),
                                    lora_bank=tbank, adapter_ids=torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert not np.allclose(np.asarray(want[0]), np.asarray(want[1]))  # row 1 took its adapter
    OmChatEngine(_tocfg(), {"language_model": tp}, lora_bank=tbank, device="cpu")
    mlp_bank = {"layers": {**tbank["layers"], "mlp": {"gate_proj": tbank["layers"]["self_attn"]["q_proj"]}}}
    with pytest.raises(ValueError, match="adapts attention only"):
        OmChatEngine(_tocfg(), {"language_model": tp}, lora_bank=mlp_bank, device="cpu")


def test_init_params_is_the_jax_tree():
    """The port's random MoE init (through ``qwen2.init_params``, as the
    decoder dispatch reaches it) has the JAX init's leaves and shapes."""
    from omchat_torch.models.qwen2 import init_params

    jp, _ = _params()
    _, tcfg = _cfgs()
    mine = init_params(tcfg, torch.Generator().manual_seed(0))
    assert jax.tree.map(np.shape, jax.device_get(jp)) == jax.tree.map(lambda t: tuple(t.shape), mine)
    cfg = dataclasses.replace(tcfg, num_experts=0)
    assert "gate_proj" in init_params(cfg, torch.Generator().manual_seed(0))["layers"]["mlp"]
