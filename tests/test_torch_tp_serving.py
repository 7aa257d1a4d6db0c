"""Tensor-parallel serving on CPU gloo worlds against the JAX engines on the
JAX package's CPU mesh (tests/test_sharding.py:36-157), in float32:

- ``OmChatEngine(mesh=)``: greedy generation with an image and its
  first-token logits, chunked prefill, an e4m3 cache (on the plain route,
  the counterpart of XLA's: K2 rounds p to e4m3 there, so its logits differ
  from XLA's by more than these limits, tests/test_torch_fp8.py), an int8
  weight-only tree sharded through ``adapt_specs_to_quantized``;
- ``BatchEngine(mesh=)`` with 2 slots;
- ``PagedBatchEngine(mesh=)``: the default route (text and an image), an
  e4m3 pool, a prefix-cache hit and the speculative verify;
- ``tp_flash_attention`` on each rank's heads against JAX's per-shard
  kernel (interpret mode), and ``tp_shardable``'s rule;
- every option of the single-request engine (sampling with bias, penalties
  and log-probs, a mask, stop keywords, the on-device loop, beams,
  speculative decoding) as the same engine gives it on one device, the
  leader taking the host decisions;
- the tokens of every case bitwise equal across the world's ranks;
- three planted faults, each outside the limits: o_proj's row-parallel
  reduce dropped, the cache written with the other rank's kv heads, the
  vocabulary blocks gathered in reversed rank order.

The JAX engines run ``attn_impl="xla"`` on sharded params, as its own tests
do; the port's ranks run the kernels' plain versions (CPU tensors).  Limits:
logits atol 3e-5 / rtol 1e-4; greedy tokens identical.  One world runs every
case (``run_ranks``, 150 s deadline): tp 2 here (the tiny config's 4 q / 2
kv heads), tp 4 in ``test_torch_tp_serving4.py`` (8 q / 4 kv heads).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from omchat_torch.parallel.launch import run_ranks

import test_torch_parallel_ranks as ranks

ATOL, RTOL = 3e-5, 1e-4
TIMEOUT = 150
NEW = 5
HEADS = {2: (4, 2), 4: (8, 4)}


def _request(rng) -> dict:
    px = rng.standard_normal((1, 3, 56, 56)).astype(np.float32)
    att = {"q": rng.standard_normal((2, 64, 8, 128)).astype(np.float32),
           "k": rng.standard_normal((2, 128, 4, 128)).astype(np.float32),
           "v": rng.standard_normal((2, 128, 4, 128)).astype(np.float32),
           "q_offset": np.asarray([32, 48], np.int32), "kv_len": np.asarray([96, 112], np.int32)}
    return {"ids": [5, 6, 7, -200, 8, 9, 10, 11, 12], "pixels": px, "texts": [[5, 6, 7, 8, 9], [11, 12, 13]],
            "prefix": list(range(20, 37)), "echo": [3, 4, 5, 6, 3, 4, 5, 6, 3, 4, 5, 6, 3, 4],
            "new_tokens": NEW, "attention": att}


def _jax_refs(tp: int, req: dict) -> tuple:
    """(the JAX tree, its int8 tree, {case: JAX's result}) on a pure-TP
    mesh of ``tp`` CPU devices."""
    from omchat_tpu.config import GenerationConfig, OmChatConfig
    from omchat_tpu.ops.linear import quantize_tree
    from omchat_tpu.ops.sampling import greedy
    from omchat_tpu.parallel.mesh import create_mesh
    from omchat_tpu.parallel.sharding import omchat_param_specs, shard_params
    from omchat_tpu.parallel.tp_attention import tp_flash_attention
    from omchat_tpu.runtime.batch_engine import BatchEngine
    from omchat_tpu.runtime.generate import OmChatEngine, _decode_step_jit
    from omchat_tpu.runtime.paged_engine import PagedBatchEngine
    from tests.test_sharding import _tiny_params

    base = OmChatConfig.tiny()
    h, kvh = HEADS[tp]
    cfg = dataclasses.replace(base, text=dataclasses.replace(base.text, num_attention_heads=h,
                                                             num_key_value_heads=kvh))
    params = _tiny_params(cfg, seed=tp)
    qparams = quantize_tree(params)
    mesh = create_mesh(tp=tp, devices=jax.devices()[:tp])
    shard = lambda p: shard_params(p, mesh, omchat_param_specs(cfg, p))  # noqa: E731
    sharded = shard(params)
    gen = GenerationConfig(max_new_tokens=NEW, eos_token_id=-1)
    ids, px, texts = req["ids"], req["pixels"], req["texts"]

    def engine(p=sharded, **kw):
        return OmChatEngine(cfg, p, attn_impl="xla", prompt_bucket=8, image_cache_size=0, mesh=mesh, **kw)

    def generate(eng, prompt=ids, pixels=px):
        out = eng.generate([prompt], pixels, gen)
        feats = eng.encode_images(pixels) if pixels is not None else None
        logits, _ = eng.prefill(eng.plan([prompt]), feats, NEW)
        return {"tokens": out.token_ids[0], "logits": np.asarray(logits)[0]}

    ref = {"generate": generate(engine())}
    eng = engine()
    plan = eng.plan([ids])
    logits, cache = eng.prefill_chunked(plan, eng.encode_images(px), NEW, chunk_size=8)
    first, toks, kv_len = np.asarray(logits)[0], [int(np.asarray(greedy(logits))[0])], jnp.asarray(plan.lengths)
    for _ in range(NEW - 1):
        logits, cache = _decode_step_jit(sharded, cfg, jnp.asarray([toks[-1]]), kv_len, cache, "xla")
        kv_len = kv_len + 1
        toks.append(int(np.asarray(greedy(logits))[0]))
    ref["chunked"] = {"tokens": toks, "logits": first}
    ref["e4m3"] = generate(engine(cache_dtype=jnp.float8_e4m3fn))
    ref["int8"] = generate(engine(shard(qparams)), prompt=texts[0], pixels=None)

    def drive(be, requests):
        rids = [be.submit(p, x, max_new_tokens=NEW, eos_token_id=-1) for p, x in requests]
        be.run_to_completion(max_ticks=300)
        return [be.result(r) for r in rids]

    both = [(t, None) for t in texts]
    ref["batch"] = {"tokens": drive(BatchEngine(cfg, sharded, max_slots=2, max_len=64, chunk_size=16,
                                                attn_impl="xla", mesh=mesh), both)}
    paged = dict(max_slots=2, num_pages=24, page_size=8, prompt_bucket=16, max_len=96, attn_impl="xla", mesh=mesh)
    ref["paged"] = {"tokens": drive(PagedBatchEngine(cfg, sharded, **paged), both + [(ids, px)])}
    ref["paged_e4m3"] = {"tokens": drive(PagedBatchEngine(cfg, sharded, cache_dtype=jnp.float8_e4m3fn, **paged),
                                         both)}
    pe = PagedBatchEngine(cfg, sharded, prefix_cache=True, **paged)
    ref["paged_prefix"] = {"tokens": drive(pe, [(req["prefix"] + [41], None)])
                           + drive(pe, [(req["prefix"] + [42, 43], None)])}
    ref["paged_speculative"] = {"tokens": drive(PagedBatchEngine(cfg, sharded, speculative=True, draft_len=3,
                                                                 draft_fn=ranks.echo_draft, **paged),
                                                [(req["echo"], None)])}
    att = {k: jnp.asarray(v) for k, v in req["attention"].items()}
    ref["tp_attention"] = np.asarray(tp_flash_attention(att["q"], att["k"], att["v"], mesh, causal=True,
                                                        q_offset=att["q_offset"], kv_len=att["kv_len"],
                                                        interpret=True))
    return jax.device_get(params), jax.device_get(qparams), ref


def _world(tp: int) -> tuple:
    req = _request(np.random.default_rng(tp))
    jparams, jqparams, ref = _jax_refs(tp, req)
    res = run_ranks(ranks.tp_serving_rank, tp, tp, HEADS[tp], jparams, jqparams, req, timeout=TIMEOUT)
    return tp, res, ref


@pytest.fixture(scope="module")
def world():
    return _world(2)


GENERATE_CASES = ["generate", "chunked", "e4m3", "int8"]
ENGINE_CASES = ["batch", "paged", "paged_e4m3", "paged_prefix", "paged_speculative"]


@pytest.mark.parametrize("case", GENERATE_CASES)
def test_single_request_engine_under_a_mesh_matches_jax(world, case):
    """Greedy tokens identical, first-token logits within the limits."""
    _, res, ref = world
    got, want = res[0][case], ref[case]
    assert got["tokens"] == want["tokens"]
    np.testing.assert_allclose(got["logits"][0], want["logits"], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_batch_engines_under_a_mesh_match_jax(world, case):
    _, res, ref = world
    assert res[0][case]["tokens"] == ref[case]["tokens"]


def test_the_prefix_cache_hit_and_the_verify_ran(world):
    """The paged routes the token cases stand for were taken: the second
    request mapped the first one's published pages, and the drafts went
    through verify dispatches."""
    _, res, _ = world
    assert res[0]["paged_prefix"]["hits"] >= 2
    assert res[0]["paged_speculative"]["verifies"] >= 1


def test_every_rank_draws_the_same_tokens(world):
    tp, res, _ = world
    for r in range(1, tp):
        for case, got in res[r].items():
            if case == "options":
                assert got == {k: v[1] for k, v in res[0]["options"].items()}, r
            else:
                assert got["tokens"] == res[0][case]["tokens"], (r, case)


OPTIONS = ["sampled_bias_penalties_logprobs", "allowed_tokens_mask", "stop_keywords", "ondevice_sampled", "beams",
           "speculative"]


@pytest.mark.parametrize("option", OPTIONS)
def test_generation_options_under_a_mesh_match_one_device(world, option):
    """Each option of the single-request engine under the mesh gives what
    the same engine gives on one device over the whole tree: tokens equal,
    log-probs within the limits.  The mask, the stop keywords and the draft
    are the leader's decisions: the other ranks' callables refuse to run."""
    _, res, _ = world
    one, tp = res[0]["options"][option]
    if option == "sampled_bias_penalties_logprobs":
        assert tp[0] == one[0]
        np.testing.assert_allclose(tp[1], one[1], atol=ATOL, rtol=RTOL)
        assert [[t for t, _ in step] for row in tp[2] for step in row] == \
            [[t for t, _ in step] for row in one[2] for step in row]
    else:
        assert tp == one


def test_tp_flash_attention_on_each_ranks_heads_matches_jax(world):
    """tests/test_tp_attention.py's case: causal GQA, per-batch offsets and
    lengths, 8 q / 4 kv heads over the mesh; the rows each batch row
    attends."""
    _, res, ref = world
    got = res[0]["tp_attention"]["out"]
    att = _request(np.random.default_rng(world[0]))["attention"]
    for b in range(2):
        valid = int(att["kv_len"][b]) - int(att["q_offset"][b])
        np.testing.assert_allclose(got[b, :valid], ref["tp_attention"][b, :valid], atol=2e-5, rtol=1e-4)


def test_tp_shardable_takes_whole_gqa_groups_on_a_pure_tp_mesh(world):
    tp, res, _ = world
    assert res[0]["tp_attention"]["shardable"] == [True, False, False]
    from omchat_torch.parallel.mesh import create_mesh
    from omchat_torch.parallel.tp_attention import tp_shardable

    assert not tp_shardable(create_mesh(tp=1, ranks=range(tp)), 28, 4)  # data axis: not pure TP
    assert not tp_shardable(None, 28, 4)


@pytest.mark.parametrize("fault", ranks.SERVING_FAULTS)
def test_a_planted_fault_falls_outside_the_limits(world, fault):
    """Against the sound run on the same world: some step's logits leave
    the limits."""
    _, res, _ = world
    good, bad = res[0]["generate"]["logits"], res[0][fault]["logits"]
    gap = np.abs(bad - good) - (ATOL + RTOL * np.abs(good))
    assert float(gap.max()) > 0, fault
