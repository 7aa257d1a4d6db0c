"""The port's paged continuous-batching engine on the CPU against the JAX
package's ``PagedBatchEngine``: the same ``OmChatConfig.tiny()`` float32
weights, the same mixed workload, identical greedy tokens on every route
(batched shorts, lone short, chunked and grouped chunks, whose attention
walks the page tables through K14), at decode_roll 1, 2 and 4 and on the
plain reference route; page accounting across waves and cancels;
sampling; the options that wait for later slices.
"""

import numpy as np
import pytest
import torch

import jax

from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.config import GenerationConfig
from omchat_torch.config import OmChatConfig as TOmChatConfig
from omchat_torch.constants import IMAGE_TOKEN_INDEX
from omchat_torch.runtime.paged_engine import PagedBatchEngine as TPagedEngine

MAX_NEW = 6
# page 8, bucket 16, chunk 32: prompts over 32 merged rows (every image
# request here) take the chunked route; C and D end on equal 16-row tails
ENGINE = dict(max_slots=4, num_pages=40, page_size=8, prompt_bucket=16, max_len=96, prefill_chunk=32)


def _workload():
    """A, B short text (batched), C, D two-tile images (chunked, tails
    grouped), E a three-tile image (chunked), F a short text admitted alone
    once A and B finish."""
    rng = np.random.default_rng(11)

    def tiles(n):
        return rng.standard_normal((n, 3, 56, 56)).astype(np.float32)

    img = IMAGE_TOKEN_INDEX
    return [
        (list(range(5, 15)), None),
        (list(range(20, 34)), None),
        ([7, 8, img, img, 9, 10, 11, 12, 13, 14], tiles(2)),
        ([7, img, img, 30, 31, 32, 33, 34, 35, 36, 37, 38], tiles(2)),
        ([40, img, img, img] + list(range(41, 53)), tiles(3)),
        ([60, 61, 62, 63, 64, 65], None),
    ]


@pytest.fixture(scope="module")
def reference():
    """JAX's PagedBatchEngine on the workload (XLA attention), run once."""
    from omchat_tpu.config import GenerationConfig as JGenerationConfig
    from omchat_tpu.config import OmChatConfig
    from omchat_tpu.runtime.paged_engine import PagedBatchEngine
    from tests.test_sharding import _tiny_params

    cfg = OmChatConfig.tiny()
    params = _tiny_params(cfg)
    eng = PagedBatchEngine(cfg, params, attn_impl="xla", **ENGINE)
    gen = JGenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-1)
    rids = [eng.submit(ids, px, max_new_tokens=MAX_NEW, eos_token_id=-1, generation=gen) for ids, px in _workload()]
    eng.run_to_completion(max_ticks=200)
    tokens = [eng.result(r) for r in rids]
    assert all(len(t) == MAX_NEW for t in tokens)
    return from_jax_params(jax.device_get(params)), tokens


def _port(params, **kw):
    return TPagedEngine(TOmChatConfig.tiny(), params, device="cpu", **{**ENGINE, **kw})


def _spy(eng, name, calls):
    orig = getattr(eng, name)

    def wrapped(*a):
        calls.append((name, a))
        return orig(*a)

    setattr(eng, name, wrapped)


def _run(eng, work=None, **submit):
    rids = [eng.submit(ids, px, max_new_tokens=MAX_NEW, eos_token_id=-1, **submit) for ids, px in (work or _workload())]
    ticks = eng.run_to_completion(max_ticks=200)
    assert ticks < 200
    return [eng.result(r) for r in rids]


@pytest.mark.parametrize("roll,impl", [(1, None), (4, None), (2, None), (4, "plain")],
                         ids=["roll1", "roll4", "k14_route", "plain_roll4"])
def test_paged_engine_matches_jax_on_every_route(reference, roll, impl, monkeypatch):
    params, want = reference
    from omchat_torch.ops import paged_attention as pa

    eng = _port(params, decode_roll=roll, attn_impl=impl)
    calls = []
    for name in ("_prefill_shorts", "_prefill_chunk_group", "_prefill_tick"):
        _spy(eng, name, calls)
    walks = []  # every chunk's attention walks the page tables (K14) unless plain
    k14 = pa.paged_flash_prefill
    monkeypatch.setattr(pa, "paged_flash_prefill", lambda *a: walks.append(a[0].shape) or k14(*a))
    assert _run(eng) == want
    assert eng.allocator.available == ENGINE["num_pages"]
    shorts = [len(a[0]) for n, a in calls if n == "_prefill_shorts"]
    groups = [len(a[0]) for n, a in calls if n == "_prefill_chunk_group"]
    ticks = [a[0] for n, a in calls if n == "_prefill_tick"]
    assert 2 in shorts  # A and B in one batched prefill
    assert 2 in groups  # C and D's equal-width tail chunks in one dispatch
    assert any(r.image_features is None and r.plan.lengths[0] <= 32 for r in ticks)  # F alone
    assert any(r.plan.lengths[0] > 32 for r in ticks)  # a per-request chunk
    chunk_dispatches = sum(n == "_prefill_chunk_group" or (n == "_prefill_tick" and a[0].plan.lengths[0] > 32)
                           for n, a in calls)
    assert len(walks) == (0 if impl == "plain" else chunk_dispatches * TOmChatConfig.tiny().text.num_hidden_layers)
    if impl == "plain":
        return
    assert pa.paged_flash_decode.launches == k14.launches == pa.commit_pages.launches == 0


def test_pages_return_across_waves_and_cancel_frees(reference):
    params, want = reference
    eng = _port(params, decode_roll=2)
    assert _run(eng) == want
    assert _run(eng) == want  # a second wave over recycled pages
    assert eng.allocator.available == ENGINE["num_pages"]
    rid = eng.submit(list(range(5, 40)), None, max_new_tokens=40, eos_token_id=-1)
    eng.step()
    eng.step()
    assert eng.stats()["pages_free"] < ENGINE["num_pages"] and not eng.finished(rid)
    eng.cancel(rid)
    eng.step()
    assert eng.finished(rid) and not eng.has_work()
    assert eng.allocator.available == ENGINE["num_pages"]
    assert 0 < len(eng.result(rid)) < 40


def test_sampling_top_k1_is_greedy_and_seeded_runs_repeat(reference):
    params, want = reference
    top1 = GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-1, do_sample=True, temperature=0.7, top_k=1)
    assert _run(_port(params, decode_roll=2), generation=top1) == want
    free = GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-1, do_sample=True, temperature=1.5, top_p=0.95)
    runs = [_run(_port(params, decode_roll=2, rng_seed=3), generation=free) for _ in range(2)]
    assert runs[0] == runs[1]


@pytest.mark.parametrize("option", [
    dict(prefix_cache=True), dict(speculative=True), dict(pipeline_rolls=True), dict(streaming_roll=4),
    dict(cache_dtype=torch.float8_e4m3fn), dict(decode_kernel="manual"), dict(mesh=object()),
], ids=lambda o: next(iter(o)))
def test_waiting_options_raise(option):
    with pytest.raises(NotImplementedError):
        TPagedEngine(TOmChatConfig.tiny(), {"language_model": {"embed_tokens": torch.zeros(2)}}, device="cpu",
                     **option)


def test_waiting_request_options_raise(reference):
    params, _ = reference
    eng = _port(params)
    with pytest.raises(NotImplementedError):
        eng.submit([5, 6], logprobs=True)
    with pytest.raises(NotImplementedError):
        eng.submit([5, 6], generation=GenerationConfig(presence_penalty=0.5))
    with pytest.raises(NotImplementedError):
        TPagedEngine(TOmChatConfig(text=TOmChatConfig.tiny().text.__class__(num_experts=4, moe_intermediate_size=8)),
                     params, device="cpu")


def test_paged_engine_defaults_to_cuda(reference):
    params, _ = reference
    with pytest.raises(RuntimeError, match="CUDA"):
        TPagedEngine(TOmChatConfig.tiny(), params)
