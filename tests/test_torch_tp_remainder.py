"""The rest of tensor-parallel serving on a CPU gloo world of 2 ranks, each
case against the JAX package's engines on one device with
``attn_impl="xla"`` (where ``quant_glue_ok`` is false, which is exactly the
JAX package's semantics under a mesh), in float32:

- w8a8 (the tiny model quantized and calibrated by the JAX package's load
  steps): ``OmChatEngine`` with an image (the ViT in w8a8 too),
  ``PagedBatchEngine`` (the default route and a prefix-cache hit),
  ``BatchEngine`` with 2 slots; the row-parallel products' int8 codes, row
  scales and int32 accumulators bitwise one device's;
- a LoRA bank, given whole and sharded like its targets: 3 adapters on the
  default targets and 2 on ``ALL_TARGETS``, ``OmChatEngine.generate(
  adapter_id=)`` for every id and a mixed-adapter ``BatchEngine`` batch;
  adapter 0 bitwise the base;
- the MoE trunk (4 experts, 2 a rank): the three engines, the paged engine
  on both expert routes (its gmm route against the JAX engine's dense
  route: the JAX gmm route is the megablox Pallas kernel, whose 128-row
  tiles the tiny trunk does not fill);
- every option of the single-request engine (sampling with bias,
  penalties and log-probs, a mask, stop keywords, the on-device loop, beams,
  speculative decoding) with the bank and on the MoE trunk, as the same
  engine gives it on one device;
- the tokens of every run bitwise equal across the ranks;
- three planted faults, each outside the limits (or breaking the bitwise
  check): the row-parallel amax not reduced over the ranks, a row-parallel
  LoRA delta added after the reduce, a rank's experts indexed from expert 0.

Limits: logits atol 3e-5 / rtol 1e-4 and greedy tokens identical (those of
``test_torch_tp_serving.py``); in w8a8 the one-device engines' limits of
``tests/test_torch_w8a8.py`` (first-step logits within 2e-2 of max
|logit|, tokens identical).  The kv-head replication and the MoE trunk at
tp 4 are in ``test_torch_tp_remainder4.py``, the entry points in
``test_torch_tp_remainder_cli.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from omchat_torch.parallel.launch import run_ranks

import test_torch_parallel_ranks as ranks

ATOL, RTOL = 3e-5, 1e-4
GLUE_TOL = 2e-2
TIMEOUT = 150
NEW = 5


def request(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"ids": [5, 6, 7, -200, 8, 9, 10, 11, 12], "pixels": rng.standard_normal((1, 3, 56, 56)).astype(np.float32),
            "texts": [[5, 6, 7, 8, 9], [11, 12, 13]], "prefix": list(range(20, 37)),
            "echo": [3, 4, 5, 6, 3, 4, 5, 6, 3, 4, 5, 6, 3, 4], "new_tokens": NEW}


def jax_tree(case: str, seed: int):
    """The JAX config and whole tree of a case (w8a8: quantized and
    calibrated as the JAX load path does)."""
    from omchat_tpu.config import OmChatConfig
    from omchat_tpu.models import intern_vit, projector, qwen2, qwen2_moe

    cfg = ranks.remainder_config(OmChatConfig, case)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    trunk = qwen2_moe.init_params(k3, cfg.text) if cfg.text.is_moe else qwen2.init_params(k3, cfg.text)
    params = {"vision_tower": intern_vit.init_params(k1, cfg.vision),
              "projector": projector.init_params(k2, cfg.projector, cfg.vision.hidden_size, cfg.text.hidden_size),
              "language_model": trunk}
    if case == "w8a8":
        from omchat_tpu.models.intern_vit import calibrate_fc1_scales
        from omchat_tpu.ops.linear import quantize_tree

        params = quantize_tree(params)
        size = cfg.vision.image_size
        pixels = jnp.asarray(np.random.default_rng(0).standard_normal((2, 3, size, size)), jnp.bfloat16)
        params["vision_tower"] = calibrate_fc1_scales(params["vision_tower"], cfg.vision, pixels)
    return cfg, params


def jax_banks(params) -> dict:
    """{name: the JAX bank}: 3 adapters on the default targets (rank 4 and 2,
    alpha 8), 2 on ALL_TARGETS; every a and b random."""
    from omchat_tpu.training.lora import ALL_TARGETS, build_lora_bank, init_lora

    def randomize(lora, key):
        leaves, tree = jax.tree_util.tree_flatten(lora["layers"])
        keys = jax.random.split(key, len(leaves))
        leaves = [(jax.random.normal(k, leaf.shape) * 0.1).astype(leaf.dtype) for k, leaf in zip(keys, leaves)]
        return {"layers": jax.tree_util.tree_unflatten(tree, leaves), "scale": lora["scale"]}

    k = jax.random.PRNGKey(3)
    default = [randomize(init_lora(jax.random.fold_in(k, i), params, rank=r, alpha=8.0), jax.random.fold_in(k, 10 + i))
               for i, r in enumerate((4, 2, 4))]
    every = [randomize(init_lora(jax.random.fold_in(k, 20 + i), params, rank=2, targets=ALL_TARGETS),
                       jax.random.fold_in(k, 30 + i)) for i in range(2)]
    return {"default": build_lora_bank(default, dtype=jnp.float32), "all": build_lora_bank(every, dtype=jnp.float32)}


def jax_refs(cases, seed: int, req: dict) -> tuple:
    """({case: the whole tree as numpy}, {bank: numpy}, {case: {run: JAX's
    result}}) from the JAX engines on one device."""
    from omchat_tpu.config import GenerationConfig
    from omchat_tpu.runtime.batch_engine import BatchEngine
    from omchat_tpu.runtime.generate import OmChatEngine
    from omchat_tpu.runtime.paged_engine import PagedBatchEngine

    ids, px, texts = req["ids"], req["pixels"], req["texts"]
    gen = GenerationConfig(max_new_tokens=NEW, eos_token_id=-1)
    paged = dict(max_slots=2, num_pages=24, page_size=8, prompt_bucket=16, max_len=96, attn_impl="xla")
    plain = [(t, None, {}) for t in texts]

    def drive(be, requests):
        rids = [be.submit(p, x, max_new_tokens=NEW, eos_token_id=-1, **kw) for p, x, kw in requests]
        be.run_to_completion(max_ticks=300)
        return [be.result(r) for r in rids]

    def generate(eng, adapter_id=0):
        out = eng.generate([ids], px, gen, adapter_id=adapter_id)
        logits, _ = eng.prefill(eng.plan([ids]), eng.encode_images(px), NEW,
                                adapter_ids=jnp.asarray([adapter_id], jnp.int32))
        return {"tokens": out.token_ids[0], "logits": np.asarray(logits)[0]}

    trees, banks, refs = {}, {}, {}
    for case in cases:
        cfg, params = jax_tree(case, seed)
        engine = lambda **kw: OmChatEngine(cfg, params, attn_impl="xla", prompt_bucket=8,  # noqa: E731
                                           image_cache_size=0, **kw)
        batch = lambda **kw: BatchEngine(cfg, params, max_slots=2, max_len=64, chunk_size=16,  # noqa: E731
                                         attn_impl="xla", **kw)
        ref = {}
        if case == "lora":
            for name, bank in jax_banks(params).items():
                banks[name] = jax.device_get(bank)
                eng = engine(lora_bank=bank)
                for i in range(bank["layers"]["self_attn"]["q_proj"]["a"].shape[1]):
                    ref[f"{name}_{i}"] = generate(eng, i)
                mixed = [(t, None, {"adapter_id": i}) for t, i in zip(texts + [ids[:3]], (1, 2, 0))]
                ref[f"{name}_batch"] = {"tokens": drive(batch(lora_bank=bank), mixed)}
        else:
            ref["generate"] = generate(engine())
            ref["batch"] = {"tokens": drive(batch(), plain)}
            ref["paged"] = {"tokens": drive(PagedBatchEngine(cfg, params, **paged), plain + [(ids, px, {})])}
            if cfg.text.is_moe:  # JAX's gmm is the megablox Pallas kernel (128-row tiles): its dense route's tokens
                ref["paged_gmm"] = ref["paged"]
            if case == "w8a8":
                pe = PagedBatchEngine(cfg, params, prefix_cache=True, **paged)
                ref["paged_prefix"] = {"tokens": drive(pe, [(req["prefix"] + [41], None, {})])
                                       + drive(pe, [(req["prefix"] + [42, 43], None, {})])}
        trees[case] = jax.device_get(params)
        refs[case] = ref
    return trees, banks, refs


def run_world(tp: int, cases) -> tuple:
    req = request(tp)
    trees, banks, refs = jax_refs(cases, seed=tp, req=req)
    res = run_ranks(ranks.tp_remainder_rank, tp, tp, tuple(cases), trees, banks, req, timeout=TIMEOUT)
    return tp, res, refs


CASES = ("w8a8", "lora", "moe4")


@pytest.fixture(scope="module")
def world():
    return run_world(2, CASES)


def check_logits(case: str, got, want) -> None:
    if case == "w8a8":
        assert float(np.abs(got - want).max()) <= GLUE_TOL * float(np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


ENGINE_RUNS = [("w8a8", "generate"), ("w8a8", "batch"), ("w8a8", "paged"), ("w8a8", "paged_prefix"),
               ("moe4", "generate"), ("moe4", "batch"), ("moe4", "paged"), ("moe4", "paged_gmm")]


@pytest.mark.parametrize("case,run", ENGINE_RUNS)
def test_engines_under_a_mesh_match_jax(world, case, run):
    """Greedy tokens identical; the single-request engine's first-step
    logits within the case's limits."""
    _, res, refs = world
    got, want = res[0][case][run], refs[case][run]
    assert got["tokens"] == want["tokens"]
    if "logits" in want:
        check_logits(case, got["logits"][0], want["logits"])


@pytest.mark.parametrize("run", ["default_0", "default_1", "default_2", "default_3", "all_0", "all_1", "all_2",
                                 "default_batch", "all_batch"])
def test_a_lora_bank_under_a_mesh_matches_jax(world, run):
    _, res, refs = world
    got, want = res[0]["lora"][run], refs["lora"][run]
    assert got["tokens"] == want["tokens"]
    if "logits" in want:
        check_logits("lora", got["logits"][0], want["logits"])


def test_adapter_0_is_bitwise_the_base(world):
    """Bank row 0 is zeros: its delta adds exactly nothing, on a column
    target's columns and on a row target's partial sums alike."""
    _, res, _ = world
    base = res[0]["lora"]["base"]
    for name in ("default_0", "all_0"):
        got = res[0]["lora"][name]
        assert got["tokens"] == base["tokens"] and np.array_equal(got["logits"], base["logits"]), name


def test_row_parallel_codes_and_accumulators_are_bitwise_one_devices(world):
    """o_proj over the rank's heads and down_proj over its slice of the
    width: the int8 codes, the row scales and the int32 accumulator."""
    _, res, _ = world
    assert res[0]["w8a8"]["codes"] == {"o_proj": (True, True, True), "down_proj": (True, True, True)}


def test_the_prefix_hit_ran(world):
    _, res, _ = world
    assert res[0]["w8a8"]["paged_prefix"]["hits"] >= 2


def test_every_rank_draws_the_same_tokens(world):
    tp, res, _ = world
    for r in range(1, tp):
        for case, runs in res[r].items():
            for run, got in runs.items():
                if run == "options":
                    assert got == {k: v[1] for k, v in res[0][case]["options"].items()}, (r, case)
                else:
                    assert got["tokens"] == res[0][case][run]["tokens"], (r, case, run)


OPTIONS = ["sampled_bias_penalties_logprobs", "allowed_tokens_mask", "stop_keywords", "ondevice_sampled", "beams",
           "speculative"]


@pytest.mark.parametrize("case", ["lora", "moe4"])
@pytest.mark.parametrize("option", OPTIONS)
def test_generation_options_with_a_bank_and_on_the_moe_trunk_match_one_device(world, case, option):
    """Every option ``test_torch_tp_serving.py`` serves under a mesh, with a
    LoRA bank (``generate``'s calls on adapter 1) and on the MoE trunk: the
    mesh gives what the same engine gives on one device over the whole tree
    (tokens equal, log-probs within the limits)."""
    _, res, _ = world
    one, tp = res[0][case]["options"][option]
    if option == "sampled_bias_penalties_logprobs":
        assert tp[0] == one[0]
        np.testing.assert_allclose(tp[1], one[1], atol=ATOL, rtol=RTOL)
    else:
        assert tp == one


@pytest.mark.parametrize("case", CASES)
def test_a_planted_fault_falls_outside_the_limits(world, case):
    """Against the sound run on the same world: some step's logits leave
    the case's limits (the w8a8 fault also breaks the codes' bitwise
    check)."""
    _, res, _ = world
    sound = res[0][case]["all_1" if case == "lora" else "generate"]["logits"]
    bad = res[0][case]["fault"]["logits"]
    if case == "w8a8":
        assert float(np.abs(bad - sound).max()) > GLUE_TOL * float(np.abs(sound).max()) or \
            res[0][case]["fault_codes"] != res[0][case]["codes"]
        assert res[0][case]["fault_codes"]["o_proj"][0] is False
    else:
        gap = np.abs(bad - sound) - (ATOL + RTOL * np.abs(sound))
        assert float(gap.max()) > 0, case
