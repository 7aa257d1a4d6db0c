"""The rest of tensor-parallel serving on a CPU gloo world of 4 ranks,
against the JAX package's engines on one device (``attn_impl="xla"``), in
float32 (the setup and the limits of ``test_torch_tp_remainder.py``):

- kv heads replicated at a tp that does not divide them, the situation of
  Qwen2-7B's 4 kv heads at tp 8 (tests/test_sharding.py:87-117): the tiny
  trunk's 4 q / 2 kv heads (a q head a rank over both kv heads on each) and
  a trunk of 6 q / 2 kv heads (rank 1 holds q heads 2-3 over kv heads 0
  and 1, so its attention runs once per kv head), in ``OmChatEngine`` (with
  an image), ``PagedBatchEngine`` and ``BatchEngine``; the cache's head
  axis replicated (``kv_cache_specs(...).k[2]`` is None), k_proj whole on
  every rank;
- the MoE trunk at 8 experts, 2 a rank, in the three engines, the paged
  engine on both expert routes, and every option of the single-request
  engine on it as one device gives it;
- tokens bitwise equal across the ranks;
- the planted faults: a rank's q heads reading the kv head of the next
  group, a rank's experts indexed from expert 0.
"""

import numpy as np
import pytest

from test_torch_tp_remainder import ATOL, OPTIONS, RTOL, run_world

CASES = ("kv42", "kv62", "moe8")


@pytest.fixture(scope="module")
def world():
    return run_world(4, CASES)


@pytest.mark.parametrize("case,run", [(c, r) for c in CASES for r in ("generate", "batch", "paged")]
                         + [("moe8", "paged_gmm")])
def test_engines_under_a_mesh_of_four_match_jax(world, case, run):
    _, res, refs = world
    got, want = res[0][case][run], refs[case][run]
    assert got["tokens"] == want["tokens"]
    if "logits" in want:
        np.testing.assert_allclose(got["logits"][0], want["logits"], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", ["kv42", "kv62"])
def test_the_kv_heads_replicate_on_every_rank(world, case):
    """JAX's spec: the cache's head axis is not split (as
    tests/test_sharding.py:107-109 asserts), so a rank's cache and k_proj
    hold every kv head; the rank's q heads read their kv heads run by
    run."""
    from omchat_torch.config import OmChatConfig
    from omchat_torch.parallel.mesh import Mesh
    from omchat_torch.parallel.tp_attention import head_runs

    import test_torch_parallel_ranks as ranks

    tp, res, _ = world
    want_runs = {"kv42": [[(0, 1, 0)], [(0, 1, 0)], [(0, 1, 1)], [(0, 1, 1)]],
                 "kv62": [[(0, 2, 0)], [(0, 1, 0), (1, 2, 1)], [(0, 1, 1)], [(0, 1, 1)]]}[case]
    layout = res[0][case]["layout"]  # rank 0's, in its world
    assert layout["head_axis"] is None
    assert layout["cache"] == [2, 2, 2, 64, 16]  # [L, B, KVH, T, D]: both kv heads
    assert layout["k_proj"] == (2, 64, 32)  # whole
    assert layout["runs"] == want_runs[0]
    cfg = ranks.remainder_config(OmChatConfig, case)
    grid = np.arange(tp).reshape(1, tp)
    assert [head_runs(cfg.text, Mesh(grid, ("data", "model"), rank=r)) for r in range(tp)] == want_runs


def test_every_rank_draws_the_same_tokens(world):
    tp, res, _ = world
    for r in range(1, tp):
        for case, runs in res[r].items():
            for run, got in runs.items():
                if run == "options":
                    assert got == {k: v[1] for k, v in res[0][case]["options"].items()}, (r, case)
                else:
                    assert got["tokens"] == res[0][case][run]["tokens"], (r, case, run)


@pytest.mark.parametrize("option", OPTIONS)
def test_generation_options_on_the_moe_trunk_at_tp4_match_one_device(world, option):
    _, res, _ = world
    one, tp = res[0]["moe8"]["options"][option]
    if option == "sampled_bias_penalties_logprobs":
        assert tp[0] == one[0]
        np.testing.assert_allclose(tp[1], one[1], atol=ATOL, rtol=RTOL)
    else:
        assert tp == one


@pytest.mark.parametrize("case", CASES)
def test_a_planted_fault_falls_outside_the_limits(world, case):
    _, res, _ = world
    sound, bad = res[0][case]["generate"]["logits"], res[0][case]["fault"]["logits"]
    gap = np.abs(bad - sound) - (ATOL + RTOL * np.abs(sound))
    assert float(gap.max()) > 0, case
