"""The rank side of the multi-rank tests: functions that
``omchat_torch.parallel.launch.run_ranks`` runs in spawned ranks (this
module imports no JAX, so a rank starts in seconds), and the launcher's own
tests.  The JAX references run in the test process
(``tests/test_torch_parallel_*.py``)."""

import contextlib
import time

import pytest
import torch

from omchat_torch.parallel.launch import run_ranks


@contextlib.contextmanager
def _planted(fault):
    """The faults the limits must catch, each swapped into the modules the
    step reaches."""
    from omchat_torch.models import intern_vit, qwen2
    from omchat_torch.parallel import comm
    from omchat_torch.training import train_step as ts

    saved = []

    def swap(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    if fault == "row_reduce_dropped":  # down_proj's partial sums left unreduced
        mlp = qwen2._mlp
        swap(qwen2, "_mlp", lambda y, p, *args, mesh=None: mlp(comm.copy_to_axis(y, mesh), p))
    elif fault == "qk_norm_local":  # each rank normalizes over its own heads only
        swap(intern_vit, "_qk_norm", lambda x, scale, eps, width, mesh: intern_vit.rms_norm(x, scale, eps))
    elif fault == "mean_of_rank_means":
        swap(ts, "_data_loss", lambda s, n, mesh: s / n.clamp(min=1) / mesh.axis_size("data"))
    elif fault == "fsdp_grad_unscattered":
        class Unscattered(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, mesh, dim):
                ctx.n, ctx.i, ctx.dim = mesh.axis_size("data"), mesh.axis_index("data"), dim
                return comm._gather(x, mesh.group("data"), dim)

            @staticmethod
            def backward(ctx, g):  # this rank's own gradient, not the sum over the data ranks
                return g.chunk(ctx.n, ctx.dim)[ctx.i].contiguous(), None, None

        swap(comm, "_fsdp_gather", lambda x, mesh, dim: Unscattered.apply(x, mesh, dim))
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def train_rank(tp, jparams, variants, lr):
    """Every variant on this world: (name, fsdp, fault, batches, accum) →
    rank 0 returns {name: (losses, gathered params as numpy)}."""
    import torch.distributed as dist

    from omchat_torch.checkpoint.convert import from_jax_params
    from omchat_torch.config import OmChatConfig as TCfg
    from omchat_torch.parallel.mesh import create_mesh
    from omchat_torch.parallel.sharding import canonical_shapes, gather_params, omchat_param_specs
    from omchat_torch.training import train_step as ts
    from omchat_torch.utils.tree import tree_map

    cfg = TCfg.tiny()
    mesh = create_mesh(tp=tp)
    out = {}
    for name, fsdp, fault, batches, accum in variants:
        params = from_jax_params(jparams)
        shapes = canonical_shapes(params)
        specs = omchat_param_specs(cfg, params, fsdp=fsdp)
        opt = ts.AdamW(lr, grad_clip=1.0, grad_accum=accum)
        step, shard_batch, place = ts.make_sharded_train_step(cfg, mesh, specs, opt)
        state = ts.init_train_state(place(params), opt)
        losses = []
        with _planted(fault):
            for b in batches:
                state, loss = step(state, cfg, shard_batch({k: torch.from_numpy(v) for k, v in b.items()}))
                losses.append(float(loss))
        full = gather_params(state.params, mesh, specs, shapes)
        if dist.get_rank() == 0:
            out[name] = (losses, tree_map(lambda t: t.detach().numpy(), full))
    return out


def norm_rank():
    from omchat_torch.cli.train import random_model
    from omchat_torch.parallel.mesh import create_mesh
    from omchat_torch.parallel.sharding import leaf_specs, omchat_param_specs, shard_params
    from omchat_torch.training.train_step import _global_norm
    from omchat_torch.utils.tree import tree_items

    cfg, params = random_model(torch.device("cpu"))
    mesh = create_mesh(tp=2)
    specs = omchat_param_specs(cfg, params, fsdp=True)
    local = shard_params(params, mesh, specs)
    by_path = leaf_specs(local, specs)
    paths = [p for p, _ in tree_items(local)]
    sharded = _global_norm([by_path[p] for p in paths], mesh)([t for _, t in tree_items(local)])
    canonical = torch.sqrt(sum(t.square().sum() for _, t in tree_items(params)))
    return {"sharded": float(sharded), "canonical": float(canonical)}


def _who():
    import torch.distributed as dist

    x = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(x)
    return dist.get_rank(), dist.get_world_size(), torch.get_num_threads(), float(x)


def _fails_on_rank_1():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("planted failure on rank 1")
    dist.barrier()  # rank 0 waits for a rank that never comes


def _sleeps():
    time.sleep(120)


def test_run_ranks_returns_results_in_rank_order():
    assert run_ranks(_who, 3, timeout=60) == [(r, 3, 1, 6.0) for r in range(3)]


def test_a_failing_rank_fails_the_call_and_the_others_are_killed():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="planted failure on rank 1"):
        run_ranks(_fails_on_rank_1, 2, timeout=60)
    assert time.monotonic() - t0 < 50


def test_the_deadline_kills_every_rank():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="deadline"):
        run_ranks(_sleeps, 2, timeout=8)
    assert time.monotonic() - t0 < 40


def _grads_and_replicated(params, leaves_paths, grads, mesh, specs, shapes):
    """(the canonical gradient tree, {path: this rank's gradient} of the
    leaves the model axis replicates)."""
    from omchat_torch.parallel.sharding import gather_params, leaf_specs
    from omchat_torch.utils.tree import tree_map

    tree: dict = {}
    for path, g in zip(leaves_paths, grads):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = g
    by_path = leaf_specs(tree, specs)
    replicated = {p: g.numpy() for p, g in zip(leaves_paths, grads) if "model" not in by_path[p]}
    full = gather_params(tree, mesh, specs, {p: shapes[p] for p in leaves_paths})
    return tree_map(lambda t: t.numpy(), full), replicated


def modules_rank(tp, cases):
    """The tensor-parallel modules on a world of ``tp`` ranks (one model
    group), each case's forward and the gradient of its scalar loss."""
    import torch.distributed as dist

    from omchat_torch.checkpoint.convert import from_jax_params
    from omchat_torch.config import TextConfig, VisionConfig
    from omchat_torch.models import intern_vit, qwen2, qwen2_moe
    from omchat_torch.ops.contrastive import clip_contrastive_loss
    from omchat_torch.ops.cross_entropy import vocab_parallel_cross_entropy, vocab_parallel_token_losses
    from omchat_torch.parallel import comm
    from omchat_torch.parallel.mesh import create_mesh
    from omchat_torch.parallel.sharding import (block_range, canonical_shapes, qwen2_param_specs, shard_params,
                                                vision_param_specs)
    from omchat_torch.utils.tree import tree_items

    mesh = create_mesh(tp=tp)
    dp_mesh = create_mesh(tp=1)  # the same ranks on the data axis
    m = mesh.axis_index("model")
    out = {}
    for name, case in cases.items():
        if name == "comm":  # the FSDP pair: all-gather (reduce-scatter backward) and its reverse
            x = torch.from_numpy(case["x"][m]).requires_grad_()
            g = comm.all_gather_dim(x, mesh, "model", 1)
            (gx,) = torch.autograd.grad((g * torch.from_numpy(case["w"])).sum(), x)
            y = torch.from_numpy(case["y"][m]).requires_grad_()
            sc = comm.reduce_scatter_dim(y, mesh, "model", 1)
            (gy,) = torch.autograd.grad((sc * torch.from_numpy(case["v"][m])).sum(), y)
            out[name] = {"gather": g.detach().numpy(), "grad_x": gx.numpy(), "scatter": sc.detach().numpy(),
                         "grad_y": gy.numpy()}
        elif name == "ce":
            v = case["kernel"].shape[1]
            lo, hi = block_range(v, tp, m)
            hidden = torch.from_numpy(case["hidden"]).requires_grad_()
            kernel = torch.from_numpy(case["kernel"][:, lo:hi].copy()).requires_grad_()
            loss = vocab_parallel_cross_entropy(hidden, kernel, torch.from_numpy(case["labels"]), v, mesh)
            gh, gk = torch.autograd.grad(loss, (hidden, kernel))
            gk_full = comm._gather(gk.contiguous(), mesh.group("model"), 1)
            out[name] = {"loss": float(loss), "grad_hidden": gh.numpy(), "grad_kernel": gk_full.numpy()}
        elif name == "clip":
            b = case["img"].shape[0] // tp
            img = torch.from_numpy(case["img"][m * b:(m + 1) * b].copy()).requires_grad_()
            txt = torch.from_numpy(case["txt"][m * b:(m + 1) * b].copy()).requires_grad_()
            loss = clip_contrastive_loss(img, txt, case["scale"], mesh=dp_mesh)
            gi, gt = torch.autograd.grad(loss, (img, txt))
            group = dp_mesh.group("data")
            out[name] = {"loss": float(loss), "grad_img": comm._gather(gi, group, 0).numpy(),
                         "grad_txt": comm._gather(gt, group, 0).numpy()}
        elif name.startswith("vit"):
            cfg = VisionConfig(**case["cfg"])
            params = from_jax_params(case["params"])
            specs = vision_param_specs(cfg)
            shapes = canonical_shapes(params)
            local = shard_params(params, mesh, specs)
            paths = [p for p, _ in tree_items(local)]
            leaves = [t.requires_grad_() for _, t in tree_items(local)]
            fault = case.get("fault")
            with _planted(fault):
                hidden = intern_vit.intern_vit_forward(local, cfg, torch.from_numpy(case["pixels"]), attn_impl="vjp",
                                                       remat=True, mesh=mesh)
            loss = (hidden * torch.from_numpy(case["weight"])).sum()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
            full, rep = _grads_and_replicated(local, paths, grads, mesh, specs, shapes)
            out[name] = {"hidden": hidden.detach().numpy(), "grads": full, "replicated": rep}
        else:  # "trunk" / "moe": logits and the gradient of the mean CE
            cfg = TextConfig(**case["cfg"])
            params = from_jax_params(case["params"])
            specs = qwen2_param_specs(cfg)
            shapes = canonical_shapes(params)
            local = shard_params(params, mesh, specs)
            paths = [p for p, _ in tree_items(local)]
            leaves = [t.requires_grad_() for _, t in tree_items(local)]
            ids = torch.from_numpy(case["ids"])
            pos = torch.arange(ids.shape[1])[None].expand(ids.shape[0], -1)
            x = qwen2.embed_tokens(local, ids, mesh, cfg.vocab_size)
            fwd = qwen2_moe.qwen2_moe_forward if cfg.is_moe else qwen2.qwen2_forward
            hidden, _ = fwd(local, cfg, x, pos, attn_impl="vjp", remat=True, mesh=mesh)
            logits = qwen2.lm_head(local, cfg, hidden, mesh)
            tok, valid = vocab_parallel_token_losses(logits, torch.from_numpy(case["labels"]), cfg.vocab_size, mesh)
            loss = tok.sum() / valid.sum()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
            full, rep = _grads_and_replicated(local, paths, grads, mesh, specs, shapes)
            out[name] = {"logits": comm._gather(logits.detach().contiguous(), mesh.group("model"), -1).numpy(),
                         "loss": float(loss), "grads": full, "replicated": rep}
    return out if dist.get_rank() == 0 else {n: {"replicated": r.get("replicated")} for n, r in out.items()}


def cli_rank(argv):
    """``cli.train.main`` in a rank of a launched world."""
    from omchat_torch.cli.train import main

    main(argv)


# --------------------------------------------------------------------------
# tensor-parallel serving (tests/test_torch_tp_serving*.py)
# --------------------------------------------------------------------------

SERVING_FAULTS = ("o_proj_reduce_dropped", "kv_heads_of_the_other_rank", "vocab_blocks_reversed")


def echo_draft(context):
    """A draft every tick (a random model rarely repeats an n-gram of its
    prompt): the context's last three tokens."""
    return list(context[-3:])


def serving_config(heads):
    """The tiny OmChat config with the trunk's (q, kv) head counts."""
    import dataclasses

    from omchat_torch.config import OmChatConfig

    cfg = OmChatConfig.tiny()
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_attention_heads=heads[0],
                                                             num_key_value_heads=heads[1]))


@contextlib.contextmanager
def _serving_fault(fault, mesh):
    """The serving faults the limits must catch: o_proj's row-parallel
    reduce dropped in every layer, the cache written with the next rank's kv
    heads (the prefill's write, which its attention then reads, and the
    decode's row commit), the vocabulary blocks gathered in reversed rank
    order."""
    from omchat_torch.models import qwen2
    from omchat_torch.parallel import comm

    saved = []

    def swap(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    if fault == "o_proj_reduce_dropped":
        row = qwen2._row_lora_dense

        def o_proj_unreduced(y, p, a8, lora, name, ids, m):
            # o_proj's partial sums as they are (the row product without a mesh); down_proj still reduces
            return row(y, p, a8, lora, name, ids, None if name == "o_proj" else m)

        swap(qwen2, "_row_lora_dense", o_proj_unreduced)
    elif fault == "kv_heads_of_the_other_rank":
        commit, attend = qwen2.commit_decode_rows, qwen2.cache_attend

        def other(rows):  # [..., KVH/tp, D] at dim 2: the next rank's kv heads
            tp, me = mesh.axis_size("model"), mesh.axis_index("model")
            return comm._gather(rows.contiguous(), mesh.group("model"), 2).chunk(tp, 2)[(me + 1) % tp].contiguous()

        swap(qwen2, "commit_decode_rows", lambda cache, wp, k, v, impl=None: commit(cache, wp, other(k), other(v), impl))
        swap(qwen2, "cache_attend", lambda impl, wp, starts, kv_len, kc, vc, q, k, v, seg=None, runs=None: attend(
            impl, wp, starts, kv_len, kc, vc, q, other(k), other(v), seg, runs))
    elif fault == "vocab_blocks_reversed":
        def reversed_gather(logits, vocab_size, m):
            blocks = comm._gather(logits.contiguous(), m.group("model"), 0).chunk(m.axis_size("model"), 0)
            return torch.cat(blocks[::-1], dim=-1)

        swap(qwen2, "gather_vocab", reversed_gather)
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def _refuse_to_decide(*args):
    raise AssertionError("a rank other than the leader took a host decision itself")


def generation_options(cfg, params, local, mesh, req, lora_bank=None, adapter_id=None) -> dict:
    """The single-request engine's options under ``mesh`` against the same
    engine on one device in this rank (the whole tree): sampling with bias,
    penalties and log-probs, an allowed-tokens mask and stop keywords (taken
    on the leader only: the other ranks pass callables that must not run, and
    no tokenizer), the on-device loop, beams and speculative decoding; with
    ``lora_bank`` (whole) the ``generate`` calls take ``adapter_id``.
    {option: (one device's output, the mesh's)}."""
    import dataclasses

    import torch.distributed as dist

    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.generate import OmChatEngine
    from omchat_torch.utils.testing import MockTokenizer

    lead = dist.get_rank() == 0
    ids, n = req["texts"][0] + req["echo"], req["new_tokens"]
    adapter = {} if adapter_id is None else {"adapter_id": adapter_id}
    greedy = GenerationConfig(max_new_tokens=n, eos_token_id=-1)
    sampled = dataclasses.replace(greedy, do_sample=True, temperature=0.8, top_k=40, top_p=0.9,
                                  presence_penalty=0.5, frequency_penalty=0.3)

    def allowed(generated):
        return list(range(50 + len(generated), 300, 7))

    runs = {
        "sampled_bias_penalties_logprobs": lambda e, one: (
            lambda o: (o.token_ids, o.logprobs, o.top_logprobs))(e.generate(
                [ids], None, sampled, rng_key=11, logit_bias={17: 5.0, 23: -3.0}, return_logprobs=True,
                top_logprobs=3, **adapter)),
        "allowed_tokens_mask": lambda e, one: e.generate(
            [ids], None, greedy, allowed_tokens_fn=allowed if one or lead else _refuse_to_decide, **adapter).token_ids,
        "stop_keywords": lambda e, one: e.generate(
            [ids], None, dataclasses.replace(greedy, max_new_tokens=3 * n), stop_keywords=["\x20"],
            tokenizer=MockTokenizer() if one or lead else None, **adapter).token_ids,
        "ondevice_sampled": lambda e, one: e.generate_ondevice([ids], None, sampled, rng_key=5).token_ids,
        "beams": lambda e, one: e.beam_search(ids, None, num_beams=3, max_new_tokens=n, eos_token_id=-1),
        "speculative": lambda e, one: e.generate_speculative(
            ids, None, greedy, draft_len=3, draft_fn=echo_draft if one or lead else _refuse_to_decide),
    }
    one = OmChatEngine(cfg, params, prompt_bucket=8, device="cpu", lora_bank=lora_bank)
    tp = OmChatEngine(cfg, local, prompt_bucket=8, device="cpu", mesh=mesh, lora_bank=lora_bank)
    return {name: (run(one, True), run(tp, False)) for name, run in runs.items()}


def tp_serving_rank(tp, heads, jparams, jqparams, req):
    """Every serving case on this world's pure-TP mesh, on the CPU in fp32:
    rank 0 returns {case: result}, every rank {case: its tokens}."""
    import numpy as np
    import torch.distributed as dist

    from omchat_torch.checkpoint.convert import from_jax_params
    from omchat_torch.config import GenerationConfig
    from omchat_torch.ops.fp8 import E4M3
    from omchat_torch.ops.sampling import greedy
    from omchat_torch.parallel.comm import _gather
    from omchat_torch.parallel.mesh import create_mesh
    from omchat_torch.parallel.sharding import omchat_param_specs, shard_params
    from omchat_torch.parallel.tp_attention import tp_flash_attention, tp_shardable
    from omchat_torch.runtime.batch_engine import BatchEngine
    from omchat_torch.runtime.generate import OmChatEngine
    from omchat_torch.runtime.paged_engine import PagedBatchEngine

    cfg = serving_config(heads)
    mesh = create_mesh(tp=tp)
    shard = lambda p: shard_params(p, mesh, omchat_param_specs(cfg, p))  # noqa: E731
    local = shard(from_jax_params(jparams))
    ids, px, texts, n = req["ids"], req["pixels"], req["texts"], req["new_tokens"]
    gen = GenerationConfig(max_new_tokens=n, eos_token_id=-1)
    out = {}

    def engine(params=local, **kw):
        return OmChatEngine(cfg, params, prompt_bucket=8, device="cpu", mesh=mesh, **kw)

    def generate(eng, prompt=ids, pixels=px):
        steps = []
        o = eng.generate([prompt], pixels, gen, logits_callback=lambda s, lg: steps.append(lg[0].numpy()))
        return {"tokens": o.token_ids[0], "logits": np.stack(steps)}

    out["generate"] = generate(engine())
    for fault in SERVING_FAULTS:
        with _serving_fault(fault, mesh):
            out[fault] = generate(engine())
    eng = engine()
    plan = eng.plan([ids])
    logits, cache = eng.prefill_chunked(plan, eng.encode_images(px), n, chunk_size=8)
    first, toks, kv_len = logits[0].numpy(), [int(greedy(logits)[0])], torch.as_tensor(plan.lengths)
    for _ in range(n - 1):
        logits, cache = eng.decode_step(torch.tensor([toks[-1]], dtype=torch.int32), kv_len, cache)
        kv_len = kv_len + 1
        toks.append(int(greedy(logits)[0]))
    out["chunked"] = {"tokens": toks, "logits": first[None]}
    # the plain route: K2's plain version rounds p to e4m3 on an e4m3 cache, XLA keeps it in fp32
    out["e4m3"] = generate(engine(cache_dtype=E4M3, attn_impl="plain"))
    out["int8"] = generate(engine(shard(from_jax_params(jqparams))), prompt=texts[0], pixels=None)

    def drive(be, requests):
        rids = [be.submit(p, x, max_new_tokens=n, eos_token_id=-1) for p, x in requests]
        be.run_to_completion(300)
        return [be.result(r) for r in rids]

    both = [(t, None) for t in texts]
    out["batch"] = {"tokens": drive(BatchEngine(cfg, local, max_slots=2, max_len=64, chunk_size=16, mesh=mesh,
                                                device="cpu"), both)}
    paged = dict(max_slots=2, num_pages=24, page_size=8, prompt_bucket=16, max_len=96, mesh=mesh, device="cpu")
    out["paged"] = {"tokens": drive(PagedBatchEngine(cfg, local, **paged), both + [(ids, px)])}
    out["paged_e4m3"] = {"tokens": drive(PagedBatchEngine(cfg, local, cache_dtype=E4M3, **paged), both)}
    pe = PagedBatchEngine(cfg, local, prefix_cache=True, **paged)
    first_run = drive(pe, [(req["prefix"] + [41], None)])
    out["paged_prefix"] = {"tokens": first_run + drive(pe, [(req["prefix"] + [42, 43], None)]),
                           "hits": pe.prefix_cache.hits}
    pe = PagedBatchEngine(cfg, local, speculative=True, draft_len=3, draft_fn=echo_draft, **paged)
    out["paged_speculative"] = {"tokens": drive(pe, [(req["echo"], None)]), "verifies": pe.verifies_eager}
    out["options"] = generation_options(cfg, from_jax_params(jparams), local, mesh, req)
    # K2 on the rank's heads (tests/test_tp_attention.py's case)
    att = req["attention"]
    heads_of = lambda a: torch.from_numpy(a).chunk(tp, 2)[mesh.axis_index("model")]  # noqa: E731
    o = tp_flash_attention(heads_of(att["q"]), heads_of(att["k"]), heads_of(att["v"]), mesh, causal=True,
                           q_offset=torch.as_tensor(att["q_offset"]), kv_len=torch.as_tensor(att["kv_len"]))
    out["tp_attention"] = {"out": _gather(o.contiguous(), mesh.group("model"), 2).numpy(),
                           "shardable": [tp_shardable(mesh, h, kv) for h, kv in ((28, 4), (25, 4), (28, 3))]}
    if dist.get_rank() == 0:
        return out
    return {**{k: {"tokens": v["tokens"]} for k, v in out.items() if "tokens" in v},
            "options": {k: v[1] for k, v in out["options"].items()}}


def _post(port: int, path: str, body: dict) -> dict:
    import json
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def serve_and_ask(argv, requests) -> list:
    """``cli.serve.main(argv)`` on this rank; on the leading rank it runs in
    a thread, answers ``requests`` ([(path, body)]) over HTTP and is shut
    down; on a follower it returns when the leader stops.  Returns the
    answers (the leader's), [] on a follower."""
    import threading

    from omchat_torch.cli import serve

    ready = threading.Event()
    box = {}

    def on_ready(server):
        box["server"] = server
        ready.set()

    thread = threading.Thread(target=serve.main, args=(argv,), kwargs={"on_ready": on_ready}, daemon=True)
    thread.start()
    answers = []
    while thread.is_alive() and not ready.wait(0.05):
        pass
    if ready.is_set():
        port = box["server"].server_address[1]
        answers = [_post(port, path, body) for path, body in requests]
        box["server"].shutdown()
    thread.join(120)
    assert not thread.is_alive(), "the server did not stop"
    return answers


def tp_cli_rank(ckpt, lora_dir, requests, prompt):
    """The serving entry points in a launched world (the tests' gloo ranks):
    ``load_pretrained_model(tp=)`` (plain, int8, a LoRA merge) with each
    rank's leaf shapes, ``single_inference``, ``chat`` (stdin on rank 0),
    and ``serve`` on all three routes answering ``requests``."""
    import contextlib
    import io
    import sys

    import torch.distributed as dist

    from omchat_torch.api import load_pretrained_model
    from omchat_torch.config import GenerationConfig

    rank, tp = dist.get_rank(), dist.get_world_size()
    gen = GenerationConfig(max_new_tokens=4, eos_token_id=-1)
    out = {}
    for name, kw in (("load", {}), ("int8", {"quantize_int8": True}), ("lora", {"lora_path": lora_dir})):
        model = load_pretrained_model(ckpt, dtype=torch.float32, device="cpu", tp=tp, **kw)
        steps = []
        o = model.engine.generate([prompt], None, gen, logits_callback=lambda s, lg: steps.append(lg[0].numpy()))
        lm = model.engine.params["language_model"]
        q = lm["layers"]["self_attn"]["q_proj"]
        out[name] = {"tokens": o.token_ids[0], "logits": steps[0],
                     "q_shape": tuple((q.get("kernel") if "kernel" in q else q["kernel_q"]).shape),
                     "embed_rows": lm["embed_tokens"].shape[0]}
        del model
    base = ["--model-path", ckpt, "--device", "cpu", "--tp", str(tp), "--max-new-tokens", "3"]
    from omchat_torch.cli import chat, single_inference

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        single_inference.main(base + ["--image-path", f"{ckpt}/img.png", "--question", "what is it?"])
    out["single_inference"] = text.getvalue()
    text = io.StringIO()
    stdin = sys.stdin
    sys.stdin = io.StringIO("hello\nand then?\n\n" if rank == 0 else "")
    try:
        with contextlib.redirect_stdout(text):
            chat.main(base)
    finally:
        sys.stdin = stdin
    out["chat"] = text.getvalue()
    serve = ["--model-path", ckpt, "--device", "cpu", "--tp", str(tp), "--host", "127.0.0.1", "--port", "0"]
    small = ["--page-size", "8", "--num-pages", "64", "--max-len", "256", "--max-slots", "2"]
    for route, flags in (("paged", ["--paged", *small]), ("slots", ["--continuous-batching", *small]),
                         ("single", [])):
        out[f"serve_{route}"] = serve_and_ask(serve + flags, requests)
    return out


class _Counter:
    """A stand-in engine for the leader / follower machinery."""

    def __init__(self):
        self.calls = []

    def add(self, x, fail_on=None, stream_callback=None):
        import torch.distributed as dist

        if fail_on == "every rank" or fail_on == dist.get_rank():
            raise ValueError(f"{x} refused")
        if stream_callback is not None:
            stream_callback(x)
        self.calls.append(x)
        return 2 * x


def replica_rank():
    """The leader's replicated calls on a world of 2: one that every rank
    runs, one that every rank refuses alike (the leader reports it and both
    go on), one that only the follower refuses (both raise
    ``ReplicaDiverged``, the leader with the follower's traceback)."""
    import torch.distributed as dist

    from omchat_torch.parallel import serving
    from omchat_torch.parallel.mesh import create_mesh

    serving_counter = type("Counter", (_Counter,), {"add": serving.replicated(_Counter.add)})
    mesh = create_mesh(tp=2)
    engine = serving_counter()
    out = {}
    if dist.get_rank() == 0:
        serving.lead(mesh, engine=engine)
        seen = []
        out["ok"] = engine.add(3, stream_callback=seen.append)  # an observer: the follower gets None
        out["seen"] = seen
        try:
            engine.add(5, fail_on="every rank")
        except ValueError as e:
            out["alike"] = str(e)
        out["after"] = engine.add(7)
        try:
            engine.add(9, fail_on=1)
        except serving.ReplicaDiverged as e:
            out["diverged"] = str(e)
    else:
        try:
            serving.follow(mesh, engine=engine)
        except serving.ReplicaDiverged as e:
            out["diverged"] = str(e)
    out["calls"] = engine.calls
    return out


# --------------------------------------------------------------------------
# the rest of tensor-parallel serving (tests/test_torch_tp_remainder*.py):
# w8a8, a LoRA bank, the MoE trunk, kv heads replicated at an indivisible tp
# --------------------------------------------------------------------------

MOE_TEXT = dict(num_experts_per_tok=2, moe_intermediate_size=32, shared_expert_intermediate_size=64)
REMAINDER_TEXT = {
    "w8a8": {},
    "lora": {},
    "moe4": dict(num_experts=4, **MOE_TEXT),
    "moe8": dict(num_experts=8, **MOE_TEXT),
    "kv42": {},  # the tiny trunk's 4 q / 2 kv heads: at tp 4 a q head a rank, both kv heads on each
    "kv62": dict(num_attention_heads=6, num_key_value_heads=2, head_dim=16),  # rank 1: q heads 2-3 over kv 0 and 1
}
REMAINDER_FAULTS = {"w8a8": "amax_not_reduced", "lora": "lora_delta_after_reduce", "moe4": "experts_from_zero",
                    "moe8": "experts_from_zero", "kv42": "next_kv_head", "kv62": "next_kv_head"}


def remainder_config(config_cls, case):
    """``config_cls.tiny()`` (either package's OmChatConfig) with the
    case's trunk, in w8a8 for "w8a8"."""
    import dataclasses

    cfg = config_cls.tiny()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, **REMAINDER_TEXT[case]))
    return cfg.with_w8a8() if case == "w8a8" else cfg


@contextlib.contextmanager
def remainder_fault(fault):
    """The faults the limits must catch: each rank's amax of a row-parallel
    layer left unreduced (each quantizes its slice at its own scale), a
    row-parallel LoRA delta added after the reduce (each rank's slice of
    the delta only), a rank's experts indexed from expert 0 instead of its
    block's first, a rank's q heads reading the kv head of the next group."""
    from omchat_torch.models import qwen2, qwen2_moe
    from omchat_torch.parallel import comm, tp_attention

    saved = []

    def swap(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    if fault == "amax_not_reduced":
        swap(comm, "max_over_axis", lambda x, mesh, axis="model": x.detach().contiguous().clone())
    elif fault == "lora_delta_after_reduce":
        def after(y, p, a8, lora, name, ids, mesh):
            out = comm.row_parallel_dense(y, p, mesh, a8=a8)
            return out + qwen2.lora_delta(y, lora[name], ids) if lora is not None and name in lora else out

        swap(qwen2, "_row_lora_dense", after)
    elif fault == "experts_from_zero":
        block = qwen2_moe.expert_block
        swap(qwen2_moe, "expert_block", lambda cfg, mesh=None: (lambda b: slice(0, b.stop - b.start))(block(cfg, mesh)))
    elif fault == "next_kv_head":
        swap(tp_attention, "_kv_head", lambda j, h, kvh: (j // (h // kvh) + 1) % kvh)
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def row_parallel_codes(cfg, whole, local, mesh, seed=7) -> dict:
    """The w8a8 row-parallel products of layer 0 (o_proj over the rank's
    heads, down_proj over its slice of the width) on seeded activations
    against one device's: {name: (codes, row scales, int32 accumulator)
    each bitwise equal}."""
    import numpy as np

    from omchat_torch.ops.linear import _int8_product, quantize_activations
    from omchat_torch.parallel.comm import model_slice, row_parallel_int8
    from omchat_torch.utils.tree import layer_slice

    tc = cfg.text
    full, mine = (layer_slice(t["language_model"]["layers"], 0) for t in (whole, local))
    out = {}
    for name, group, width, units in (("o_proj", "self_attn", tc.num_attention_heads * tc.attn_head_dim,
                                       tc.num_attention_heads), ("down_proj", "mlp", tc.intermediate_size, None)):
        x = torch.from_numpy(np.random.default_rng(seed).standard_normal((2, 9, width)).astype(np.float32))
        cols = model_slice(width, mesh, units=units)
        xq, rs, acc = row_parallel_int8(x[..., cols], mine[group][name], mesh)
        wq, wrs = quantize_activations(x)
        out[name] = (torch.equal(xq, wq[..., cols]), torch.equal(rs, wrs),
                     torch.equal(acc, _int8_product(wq, full[group][name])))
    return out


def _drive(be, requests, n):
    rids = [be.submit(p, x, max_new_tokens=n, eos_token_id=-1, **kw) for p, x, kw in requests]
    be.run_to_completion(300)
    return [be.result(r) for r in rids]


def tp_remainder_rank(tp, cases, trees, banks, req):
    """Each case of ``cases`` on this world's pure-TP mesh, on the CPU in
    fp32: the three engines over the rank's shard of ``trees[case]`` (a
    whole JAX tree as numpy), the LoRA banks of ``banks`` given whole, the
    case's planted fault.  Rank 0 returns {case: {run: result}}, the others
    {case: {run: tokens}}."""
    import numpy as np
    import torch.distributed as dist

    from omchat_torch.checkpoint.convert import from_jax_params
    from omchat_torch.config import GenerationConfig, OmChatConfig
    from omchat_torch.parallel.mesh import create_mesh
    from omchat_torch.parallel.sharding import kv_cache_specs, local_kv_shape, omchat_param_specs, shard_params
    from omchat_torch.parallel.tp_attention import head_runs
    from omchat_torch.runtime.batch_engine import BatchEngine
    from omchat_torch.runtime.generate import OmChatEngine
    from omchat_torch.runtime.paged_engine import PagedBatchEngine

    mesh = create_mesh(tp=tp)
    ids, px, texts, n = req["ids"], req["pixels"], req["texts"], req["new_tokens"]
    gen = GenerationConfig(max_new_tokens=n, eos_token_id=-1)
    paged = dict(max_slots=2, num_pages=24, page_size=8, prompt_bucket=16, max_len=96, mesh=mesh, device="cpu")
    plain = [(t, None, {}) for t in texts]
    out = {}

    def generate(eng, adapter_id=None):
        steps = []
        o = eng.generate([ids], px, gen, logits_callback=lambda s, lg: steps.append(lg[0].numpy()),
                         **({} if adapter_id is None else {"adapter_id": adapter_id}))
        return {"tokens": o.token_ids[0], "logits": np.stack(steps)}

    for case in cases:
        cfg = remainder_config(OmChatConfig, case)
        whole = from_jax_params(trees[case])
        local = shard_params(whole, mesh, omchat_param_specs(cfg, whole))
        engine = lambda **kw: OmChatEngine(cfg, local, prompt_bucket=8, device="cpu", mesh=mesh,  # noqa: E731
                                           image_cache_size=0, **kw)
        batch = lambda **kw: BatchEngine(cfg, local, max_slots=2, max_len=64, chunk_size=16, mesh=mesh,  # noqa: E731
                                         device="cpu", **kw)
        res = {}
        if case == "lora":
            res["base"] = generate(engine())
            for name, bank in banks.items():
                tbank = {"layers": {g: {k: {x: torch.from_numpy(np.asarray(a)) for x, a in ab.items()}
                                        for k, ab in names.items()} for g, names in bank["layers"].items()}}
                eng = engine(lora_bank=tbank)
                for i in range(tbank["layers"]["self_attn"]["q_proj"]["a"].shape[1]):
                    res[f"{name}_{i}"] = generate(eng, i)
                mixed = [(t, None, {"adapter_id": i}) for t, i in zip(texts + [ids[:3]], (1, 2, 0))]
                res[f"{name}_batch"] = {"tokens": _drive(batch(lora_bank=tbank), mixed, n)}
            with remainder_fault(REMAINDER_FAULTS[case]):
                res["fault"] = generate(engine(lora_bank=tbank), 1)
            res["options"] = generation_options(cfg, whole, local, mesh, req, lora_bank=tbank, adapter_id=1)
        else:
            res["generate"] = generate(engine())
            res["batch"] = {"tokens": _drive(batch(), plain, n)}
            res["paged"] = {"tokens": _drive(PagedBatchEngine(cfg, local, **paged), plain + [(ids, px, {})], n)}
            if cfg.text.is_moe:
                res["paged_gmm"] = {"tokens": _drive(PagedBatchEngine(cfg, local, moe_impl="gmm", **paged),
                                                     plain + [(ids, px, {})], n)}
            if cfg.text.is_moe:
                res["options"] = generation_options(cfg, whole, local, mesh, req)
            if case == "w8a8":
                pe = PagedBatchEngine(cfg, local, prefix_cache=True, **paged)
                first = _drive(pe, [(req["prefix"] + [41], None, {})], n)
                res["paged_prefix"] = {"tokens": first + _drive(pe, [(req["prefix"] + [42, 43], None, {})], n),
                                       "hits": pe.prefix_cache.hits}
                res["codes"] = row_parallel_codes(cfg, whole, local, mesh)
            if case.startswith("kv"):
                res["layout"] = {"runs": head_runs(cfg.text, mesh), "head_axis": kv_cache_specs(cfg.text, mesh).k[2],
                                 "cache": local_kv_shape(cfg.text, mesh, 2, 64),
                                 "k_proj": tuple(local["language_model"]["layers"]["self_attn"]["k_proj"]
                                                 ["kernel"].shape)}
            with remainder_fault(REMAINDER_FAULTS[case]):
                res["fault"] = generate(engine())
                if case == "w8a8":
                    res["fault_codes"] = row_parallel_codes(cfg, whole, local, mesh)
        out[case] = res
    if dist.get_rank() == 0:
        return out
    return {case: {k: {"tokens": v["tokens"]} for k, v in res.items() if isinstance(v, dict) and "tokens" in v}
            | ({"options": {k: v[1] for k, v in res["options"].items()}} if "options" in res else {})
            for case, res in out.items()}


def tp_remainder_cli_rank(ckpt, prompt):
    """``load_pretrained_model(w8a8=True, tp=)`` in a launched world: the
    greedy tokens, first-step logits and the calibrated fc1 scales of each
    rank's shard; ``single_inference --w8a8 --tp`` (rank 0 prints)."""
    import contextlib
    import io

    import torch.distributed as dist

    from omchat_torch.api import load_pretrained_model
    from omchat_torch.cli import single_inference
    from omchat_torch.config import GenerationConfig

    tp = dist.get_world_size()
    gen = GenerationConfig(max_new_tokens=4, eos_token_id=-1)
    model = load_pretrained_model(ckpt, dtype=torch.float32, device="cpu", w8a8=True, tp=tp)
    steps = []
    o = model.engine.generate([prompt], None, gen, logits_callback=lambda s, lg: steps.append(lg[0].numpy()))
    vt = model.engine.params["vision_tower"]["layers"]
    out = {"tokens": o.token_ids[0], "logits": steps[0], "w8a8": model.config.text.w8a8 and model.config.vision.w8a8,
           "fc1_out_scale": vt["mlp"]["fc1_out_scale"].clone(),
           "qkv_codes": tuple(vt["attn"]["qkv"]["kernel_q"].shape)}
    del model
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        single_inference.main(["--model-path", ckpt, "--device", "cpu", "--tp", str(tp), "--w8a8",
                               "--max-new-tokens", "3", "--image-path", f"{ckpt}/img.png", "--question", "what is it?"])
    out["single_inference"] = text.getvalue()
    return out
