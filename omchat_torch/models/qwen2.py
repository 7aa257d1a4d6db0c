"""Qwen2 decoder with a device-resident KV cache — PyTorch port of the dense
trunk of ``omchat_tpu/models/qwen2.py``.

GQA attention with qkv bias and no o-proj bias, RoPE (linear / dynamic-NTK),
RMSNorm, SwiGLU MLP, optional tied lm_head.  The cache is one head-major
tensor pair [L, B, KVH, T, D], in the weights' dtype or e4m3 (the fp8 cache:
K/V rounded on every write with :func:`omchat_torch.ops.fp8.cast_to`, widened
to q's dtype on every read).

- Prefill (:func:`cache_attend`) writes each layer's K/V into its cache slice
  in place and runs causal attention against it (kernel K2 on CUDA).
- Decode (:func:`decode_scan`) keeps the cache read-only through the layer
  loop: each layer attends to its cache layer plus the in-flight token as a
  self column (kernel K3), and one commit after the loop writes the L x B new
  rows in place (:func:`commit_decode_rows`, kernel K4).  :func:`qwen2_forward`
  sends every one-token step with a cache there; a direct
  :func:`cache_attend` call with S == 1 writes the token into its layer cache
  and decodes over it (kernel K6), as the JAX package's does.

The port updates the cache in place where the JAX package returns a new one
(saves a copy of the whole cache per call).

w8a8 (``cfg.w8a8``): prefill calls (S > 1) run the matmuls int8 x int8 with
per-token activation quantization; the decode step (S == 1) stays
weight-only int8.  With ``quant_glue`` (every route but ``attn_impl="plain"``)
and quantized params a prefill layer is :func:`_decoder_layer_glue`: the
input norm writes int8 codes (K7) and o_proj rides the residual + norm +
quantize pass (K11); with the static scales of
:func:`calibrate_swiglu_scales` the MLP's gate and up write int8 codes (K10)
for down_proj.

Per-request LoRA (``lora_bank`` and ``adapter_ids`` [B] of
:func:`qwen2_forward`): each batch row adds its own adapter's low-rank delta
to q / k / v / o and gate / up / down, gathered from a stacked bank
(:func:`omchat_torch.training.lora.build_lora_bank`, whose row 0 is all
zeros: the base model).  A layer with a bank runs the unfused chain, as the
JAX package's does.

Tensor parallelism (``mesh``): each rank holds its shard of the tree
(:mod:`omchat_torch.parallel.sharding`): its q heads, its kv heads (all of
them where tp does not divide the kv heads), its slice of the MLP's width,
its block of the vocabulary.  A layer enters each tensor-parallel block
through *copy to the model axis* and leaves it through *reduce from the
model axis* after o_proj and down_proj (:mod:`omchat_torch.parallel.comm`);
attention runs on the local heads, once per run of heads that share a kv
head where the kv heads replicate (:mod:`omchat_torch.parallel.tp_attention`).
The training pass runs cacheless; the serving paths (cached prefill, the
decode scan, the row commit, the verify rows) run against a cache of the
rank's kv heads, [L, B, KVH/tp, T, D] or [L, B, KVH, T, D] replicated, and
:func:`full_logits` gathers the ranks' vocabulary blocks, so that every rank
picks from the same whole logits.  Under a mesh w8a8 runs the unfused chain
(``quant_glue`` off, as JAX's ``quant_glue_ok`` is under a mesh): q / k / v
and gate / up are column products on the replicated input, o_proj and
down_proj row products whose codes take the whole row's scale and whose
int32 partials are summed (:func:`~omchat_torch.parallel.comm.
row_parallel_int8`).  A LoRA bank is sharded like its targets
(:func:`~omchat_torch.parallel.sharding.lora_bank_specs`): a column
target's delta is the rank's columns, a row target's is a partial sum added
before the reduce.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from omchat_torch.config import TextConfig
from omchat_torch.ops.attention import PLAIN, attention, decode_attention
from omchat_torch.ops.fp8 import cast_to
from omchat_torch.ops.linear import dense, dense_prequant, div127, silu
from omchat_torch.ops.norms import rms_norm, rmsnorm_quant
from omchat_torch.ops.paged_attention import commit_rows, commit_rows_plain
from omchat_torch.ops.quant_matmul import attn_proj_glue_quant, proj_glue_supported, swiglu_quant
from omchat_torch.ops.rope import apply_rope, rope_cos_sin
from omchat_torch.parallel.comm import (all_gather_blocks, copy_to_axis, gather_layer, reduce_from_axis,
                                        row_parallel_dense)
from omchat_torch.parallel.sharding import block_range, check_trunk_tp, split_sizes
from omchat_torch.parallel.tp_attention import by_runs, head_runs, one_head
from omchat_torch.utils.tree import layer_list, layer_slice


class KVCache(NamedTuple):
    """Stacked head-major KV cache; k/v: [L, B, KVH, S_max, Dh]."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


def init_kv_cache(cfg: TextConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None,
                  mesh=None) -> KVCache:
    """A zeroed cache; ``dtype`` torch.float8_e4m3fn halves its bytes.
    ``mesh``: this rank's kv heads only (``parallel.sharding.local_kv_shape``)."""
    from omchat_torch.parallel.sharding import local_kv_shape

    shape = local_kv_shape(cfg, mesh, batch, max_len)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device), v=torch.zeros(shape, dtype=dtype, device=device))


def lora_delta(y: torch.Tensor, ab: dict, ids: torch.Tensor) -> torch.Tensor:
    """Each batch row's low-rank delta from ITS adapter of a stacked bank:
    y [B, S, in]; ab {"a": [N, in, r], "b": [N, r, out]} (scale folded into
    b); ids [B] bank rows.  Row 0 of a bank is zeros, so id 0 adds exactly
    zero."""
    a = ab["a"].index_select(0, ids).to(y.dtype)  # [B, in, r]
    b = ab["b"].index_select(0, ids).to(y.dtype)  # [B, r, out]
    return torch.bmm(torch.bmm(y, a), b)


def _lora_dense(y, p: dict, a8: bool, lora: Optional[dict], name: str, ids) -> torch.Tensor:
    """``dense(y, p)`` plus the per-row delta of ``lora[name]`` where the bank
    adapts this projection."""
    out = dense(y, p, a8=a8)
    if lora is not None and name in lora:
        return out + lora_delta(y, lora[name], ids)
    return out


def _row_lora_dense(y, p: dict, a8: bool, lora: Optional[dict], name: str, ids, mesh) -> torch.Tensor:
    """A row-parallel projection (o_proj, down_proj) with its per-row LoRA
    delta: :func:`_lora_dense` without a mesh; under one, the delta over the
    rank's input rows joins the rank's partial sum before the reduce."""
    delta = lora_delta(y, lora[name], ids) if lora is not None and name in lora else None
    return row_parallel_dense(y, p, mesh, a8=a8, partial=delta)


def _mlp(y: torch.Tensor, p: dict, a8: bool = False, lora: Optional[dict] = None, adapter_ids=None,
         mesh=None) -> torch.Tensor:
    """SwiGLU: down(silu(gate(y)) * up(y)); per-row LoRA deltas when serving
    a bank.  ``mesh``: gate and up hold this rank's slice of the width and
    down_proj's partial sums are reduced over the model axis."""
    y = copy_to_axis(y, mesh)
    g = _lora_dense(y, p["gate_proj"], a8, lora, "gate_proj", adapter_ids)
    u = _lora_dense(y, p["up_proj"], a8, lora, "up_proj", adapter_ids)
    h = F.silu(g) * u
    return _row_lora_dense(h, p["down_proj"], a8, lora, "down_proj", adapter_ids, mesh)


def _mlp_prequant(yq, yrs, p: dict, dtype) -> torch.Tensor:
    """SwiGLU over pre-quantized activations (the glue path).  With a
    calibrated ``swiglu_out_scale`` gate and up write the int8 codes of
    silu(g) · u at that static scale (K10) and down_proj reads them; else
    the bf16 intermediate is quantized again per token for down_proj."""
    if "swiglu_out_scale" in p:
        codes = swiglu_quant(yq, yrs, p["gate_proj"], p["up_proj"], p["swiglu_out_scale"])
        return dense_prequant(codes, p["swiglu_out_scale"], p["down_proj"], dtype=dtype)
    g = dense_prequant(yq, yrs, p["gate_proj"], dtype=dtype)
    u = dense_prequant(yq, yrs, p["up_proj"], dtype=dtype)
    return dense(F.silu(g) * u, p["down_proj"], a8=True)


def quant_glue_ok(attn_impl) -> bool:
    """Whether prefill takes the fused glue kernels: every route but the
    plain reference (the JAX package's ``attn_impl="xla"``, which runs the
    unfused chain).  :func:`decoder_layer` also keeps them off under a mesh,
    as the JAX package's ``quant_glue_ok`` is false there."""
    return attn_impl != PLAIN


def attention_inputs(cfg: TextConfig, y, p: dict, cos, sin, a8: bool = False, lora: Optional[dict] = None,
                     adapter_ids=None):
    """q/k/v projections + RoPE.  y: [B, S, D] (normed) → q [B, S, H, hd],
    k/v [B, S, KVH, hd]."""
    b, s, _ = y.shape
    hd = cfg.attn_head_dim  # the head counts follow the kernels' widths: a tensor-parallel shard holds fewer
    q = _lora_dense(y, p["q_proj"], a8, lora, "q_proj", adapter_ids).reshape(b, s, -1, hd)
    k = _lora_dense(y, p["k_proj"], a8, lora, "k_proj", adapter_ids).reshape(b, s, -1, hd)
    v = _lora_dense(y, p["v_proj"], a8, lora, "v_proj", adapter_ids).reshape(b, s, -1, hd)
    q, k = apply_rope(q, k, cos, sin)
    return q, k, v


def decoder_layer(cfg: TextConfig, x, layer: dict, cos, sin, attend, *, quant_glue: bool = False,
                  lora: Optional[dict] = None, adapter_ids=None, mlp_fn=None, mesh=None):
    """One decoder layer.  ``attend(q, k, v) -> ctx [B, S, H, hd]`` owns the
    cache handling (prefill write + causal attention, or the decode self
    column).  ``quant_glue``: w8a8 prefill layers over quantized params take
    the fused glue path (:func:`_decoder_layer_glue`).  ``lora``: this
    layer's slice of a LoRA bank ({group: {name: {"a": [N, in, r], "b":
    [N, r, out]}}}), applied per row by ``adapter_ids`` [B].
    ``mlp_fn(y, mlp_params, a8, lora, adapter_ids, mesh=)``: the MLP (default
    the dense SwiGLU; the MoE trunk's block, which takes no glue path).
    ``mesh``: ``layer`` (and ``lora``) is this rank's tensor-parallel shard:
    q/k/v on its heads enter through *copy to the model axis*, o_proj's and
    the MLP's partial sums leave through *reduce from the model axis* (in
    w8a8 the int32 accumulator's); both are the identity without a mesh.
    ``attend`` then sees the rank's q heads and its kv heads (all of them
    where they replicate).  The glue path stays off under a mesh
    (:func:`quant_glue_ok`)."""
    b, s, _ = x.shape
    # w8a8 serves the compute-bound prefill; the one-token decode step keeps
    # the weight-only int8 path
    a8 = cfg.w8a8 and s > 1
    attn_p = layer["self_attn"]
    if (quant_glue and a8 and lora is None and mlp_fn is None and mesh is None and "kernel_q" in attn_p["q_proj"]
            and "kernel_q" in attn_p["o_proj"]):
        return _decoder_layer_glue(cfg, x, layer, cos, sin, attend)
    attn_lora = lora.get("self_attn") if lora is not None else None
    mlp_lora = lora.get("mlp") if lora is not None else None
    y = rms_norm(x, layer["input_layernorm"]["scale"], cfg.rms_norm_eps)
    q, k, v = attention_inputs(cfg, copy_to_axis(y, mesh), attn_p, cos, sin, a8, attn_lora, adapter_ids)
    o = attend(q, k, v).reshape(b, s, -1)
    x = x + _row_lora_dense(o, attn_p["o_proj"], a8, attn_lora, "o_proj", adapter_ids, mesh)
    y = rms_norm(x, layer["post_attention_layernorm"]["scale"], cfg.rms_norm_eps)
    return x + (mlp_fn or _mlp)(y, layer["mlp"], a8, mlp_lora, adapter_ids, mesh=mesh)


def _decoder_layer_glue(cfg: TextConfig, x, layer: dict, cos, sin, attend):
    """w8a8 prefill layer on the fused glue kernels: the input norm writes
    only int8 codes (K7); o_proj, the residual, the post-attention norm and
    its quantization are one pass (K11) when o_proj is square, else a w8a8
    o_proj and K7.  Matches the unfused w8a8 layer to ±1 int8 code per
    quantization point."""
    b, s, _ = x.shape
    eps = cfg.rms_norm_eps
    attn_p = layer["self_attn"]
    xq, xrs = rmsnorm_quant(x, layer["input_layernorm"]["scale"], eps)
    h, kvh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.attn_head_dim
    q = dense_prequant(xq, xrs, attn_p["q_proj"], dtype=x.dtype).reshape(b, s, h, hd)
    k = dense_prequant(xq, xrs, attn_p["k_proj"], dtype=x.dtype).reshape(b, s, kvh, hd)
    v = dense_prequant(xq, xrs, attn_p["v_proj"], dtype=x.dtype).reshape(b, s, kvh, hd)
    q, k = apply_rope(q, k, cos, sin)
    o = attend(q, k, v).reshape(b, s, -1)
    post_gamma = layer["post_attention_layernorm"]["scale"]
    n_out, k_in = attn_p["o_proj"]["kernel_q"].shape
    if proj_glue_supported(k_in, n_out):
        x, yq, yrs = attn_proj_glue_quant(o, x, attn_p["o_proj"], None, post_gamma, eps)
    else:
        x = x + dense(o, attn_p["o_proj"], a8=True)
        yq, yrs = rmsnorm_quant(x, post_gamma, eps)
    return x + _mlp_prequant(yq, yrs, layer["mlp"], x.dtype)


def cache_attend(attn_impl, write_pos, starts, kv_len, k_cache, v_cache, q, k, v, segment_ids=None, runs=None):
    """Cache handler for one layer: write K/V at ``write_pos`` [B]
    (``starts``: the same offsets as host ints) into the head-major cache
    layer [B, KVH, T, D] in place, rounded to the cache's dtype, and attend
    causally against the cache (``kv_len`` [B] valid length after the write):
    on an e4m3 cache the prompt's own attention sees the rounded K/V, as in
    the JAX package.  One query row (S == 1) decodes over the written layer
    cache (:func:`~omchat_torch.ops.attention.decode_attention` on a 4-D
    cache: kernel K6, ``kv_len`` including the token).  With no cache
    (``k_cache is None``) it attends over this call's K/V only, within
    ``segment_ids`` when given.  ``runs``
    (:func:`~omchat_torch.parallel.tp_attention.head_runs`): the rank's q
    heads attend run by run, each to its kv head of a replicated cache;
    every kv head is written."""
    if k_cache is None:
        return by_runs(runs, q, lambda qr, h: attention(qr, one_head(k, h, 2, copy=False),
                                                        one_head(v, h, 2, copy=False), causal=True,
                                                        impl=attn_impl, segment_ids=segment_ids))
    s = q.shape[1]
    for bi, wp in enumerate(starts):
        k_cache[bi, :, wp : wp + s] = cast_to(k[bi].transpose(0, 1), k_cache.dtype)
        v_cache[bi, :, wp : wp + s] = cast_to(v[bi].transpose(0, 1), v_cache.dtype)
    if s == 1:
        return by_runs(runs, q, lambda qr, h: decode_attention(qr, one_head(k_cache, h, 1),
                                                               one_head(v_cache, h, 1), kv_len, impl=attn_impl))
    return by_runs(runs, q, lambda qr, h: attention(qr, one_head(k_cache, h, 1, copy=False),
                                                    one_head(v_cache, h, 1, copy=False), causal=True,
                                                    q_offset=write_pos, kv_len=kv_len, impl=attn_impl,
                                                    kv_format="bntd"))


def commit_decode_rows(cache: KVCache, write_pos: torch.Tensor, k_rows, v_rows, attn_impl=None) -> KVCache:
    """Commit the decode loop's staged K/V rows ([L, B, KVH, D]) into the
    stacked cache at ``write_pos`` [B], in place — the one write of the
    read-only-cache decode step.  Each (layer, batch) cache row is one "page"
    of the row-commit kernel (K4 on CUDA, which rounds to an e4m3 cache
    itself); ``attn_impl="plain"`` writes with the plain indexed assignment."""
    n_layers, b = k_rows.shape[0], k_rows.shape[1]
    rows = (
        torch.arange(n_layers, dtype=torch.int32, device=k_rows.device)[:, None] * b
        + torch.arange(b, dtype=torch.int32, device=k_rows.device)[None, :]
    ).reshape(-1)
    wp = write_pos.to(torch.int32).expand(n_layers, b).reshape(-1)
    shape = cache.k.shape
    kf = cache.k.view(n_layers * b, *shape[2:])
    vf = cache.v.view(n_layers * b, *shape[2:])
    commit = commit_rows_plain if attn_impl == PLAIN else commit_rows
    commit(kf, vf, rows, wp, k_rows.reshape(n_layers * b, *k_rows.shape[2:]),
           v_rows.reshape(n_layers * b, *v_rows.shape[2:]))
    return cache


def decode_scan(cfg: TextConfig, attn_impl, params: dict, inputs_embeds, cos, sin, cache: KVCache, kv_len, write_pos,
                lora_bank: Optional[dict] = None, adapter_ids=None, mlp_fn=None, mesh=None):
    """Single-token decode over the layer stack with the cache READ-ONLY in
    the loop: layer ``li`` attends to its cache layer (selected inside the
    kernel) plus the in-flight token as a self column; the new K/V rows are
    committed once after the loop.  ``mesh``: the layers and the cache are
    this rank's shards; where the kv heads replicate, each run of q heads
    that share a kv head decodes over that head (K3 on a copy of its
    layer slice) and the commit writes every kv head."""
    n_layers = params["layers"]["input_layernorm"]["scale"].shape[0]
    cache_len = (kv_len - 1).to(torch.int32)  # excludes the in-flight token
    k_rows, v_rows = [], []
    runs = head_runs(cfg, mesh)
    x = inputs_embeds
    for li in range(n_layers):
        def attend(q, k, v, li=li):
            k_rows.append(k[:, 0])
            v_rows.append(v[:, 0])
            if runs is None:
                return decode_attention(q, cache.k, cache.v, cache_len, impl=attn_impl, layer=li,
                                        k_new=k[:, 0], v_new=v[:, 0])
            # a run's kv head of layer li, copied contiguous for K3 as a one-layer stack
            return by_runs(runs, q, lambda qr, h: decode_attention(
                qr, one_head(cache.k[li], h, 1)[None], one_head(cache.v[li], h, 1)[None], cache_len,
                impl=attn_impl, layer=0, k_new=one_head(k[:, 0], h, 1), v_new=one_head(v[:, 0], h, 1)))

        x = decoder_layer(cfg, x, layer_slice(params["layers"], li), cos, sin, attend,
                          lora=_bank_layer(lora_bank, li), adapter_ids=adapter_ids, mlp_fn=mlp_fn, mesh=mesh)
    cache = commit_decode_rows(cache, write_pos, torch.stack(k_rows), torch.stack(v_rows), attn_impl)
    return x, cache


def _bank_layer(lora_bank: Optional[dict], li: int) -> Optional[dict]:
    """Layer ``li``'s slice of a LoRA bank, or None without one."""
    return None if lora_bank is None else layer_slice(lora_bank["layers"], li)


def qwen2_forward(
    params: dict,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[KVCache] = None,
    write_pos: Optional[torch.Tensor] = None,
    kv_len: Optional[torch.Tensor] = None,
    *,
    attn_impl: Optional[str] = None,
    remat: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
    lora_bank: Optional[dict] = None,
    adapter_ids: Optional[torch.Tensor] = None,
    mlp_fn=None,
    mesh=None,
    fsdp_dims: Optional[dict] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder trunk (no lm_head).

    inputs_embeds [B, S, D]; positions [B, S]; with a cache, this call's K/V
    are written at ``write_pos`` [B] and attention runs against the cache with
    valid length ``kv_len`` [B] (after the write).  S == 1 with a cache is a
    decode step.  Returns (hidden [B, S, D], the cache, updated in place).

    Without a cache (the training path): ``remat`` checkpoints every layer
    (``torch.utils.checkpoint``, non-reentrant: only the layer inputs are
    kept and the layer runs again in the backward), and ``segment_ids``
    [B, S] (negative = padding) isolates packed documents.

    ``lora_bank`` (``build_lora_bank``: leaves [L, N, in, r] / [L, N, r,
    out], bank row 0 = the base) with ``adapter_ids`` [B]: each batch row
    applies its own adapter.  ``mlp_fn``: every layer's MLP (see
    :func:`decoder_layer`; the MoE trunk passes its block).

    ``mesh`` (:class:`omchat_torch.parallel.mesh.Mesh`): ``params`` (and a
    ``lora_bank``) is this rank's shard and every layer runs tensor-parallel
    over the ``model`` axis; a cache holds this rank's kv heads, all of them
    where tp does not divide them
    (:func:`omchat_torch.parallel.sharding.local_kv_shape`).
    ``fsdp_dims``: one layer's tree of the dimension each leaf is split on
    over ``data`` (None: whole), from the FSDP spec tree; the shards are
    all-gathered inside the checkpointed layer, so the remat recompute
    gathers them again."""
    if mesh is not None:
        check_trunk_tp(cfg, mesh.axis_size("model"))
    cos, sin = rope_cos_sin(
        positions,
        cfg.attn_head_dim,
        theta=cfg.rope_theta,
        scaling=cfg.rope_scaling,
        max_position_embeddings=cfg.max_position_embeddings,
        dtype=inputs_embeds.dtype,
    )
    b = inputs_embeds.shape[0]
    dev = inputs_embeds.device
    write_pos = (torch.zeros((b,), dtype=torch.int32, device=dev) if write_pos is None
                 else torch.as_tensor(write_pos, dtype=torch.int32, device=dev).expand(b))
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=dev).expand(b)
    if lora_bank is None or adapter_ids is None:
        lora_bank, adapter_ids = None, None
    else:
        adapter_ids = torch.as_tensor(adapter_ids, device=dev).long()

    if segment_ids is not None and cache is not None:
        raise ValueError("segment_ids (packing) is for the cacheless training path")
    runs = head_runs(cfg, mesh)
    if cache is not None and inputs_embeds.shape[1] == 1:
        x, cache = decode_scan(cfg, attn_impl, params, inputs_embeds, cos, sin, cache, kv_len, write_pos,
                               lora_bank, adapter_ids, mlp_fn, mesh)
    elif cache is None:
        def attend(q, k, v):
            return cache_attend(attn_impl, None, (), None, None, None, q, k, v, segment_ids, runs)

        def layer_fn(x, layer, lora=None):
            layer = gather_layer(layer, mesh, fsdp_dims)
            return decoder_layer(cfg, x, layer, cos, sin, attend, quant_glue=quant_glue_ok(attn_impl), lora=lora,
                                 adapter_ids=adapter_ids, mlp_fn=mlp_fn, mesh=mesh)

        x = inputs_embeds
        n_layers = params["layers"]["input_layernorm"]["scale"].shape[0]
        for li, layer in enumerate(layer_list(params["layers"], n_layers)):
            if remat and torch.is_grad_enabled():
                x = checkpoint(layer_fn, x, layer, _bank_layer(lora_bank, li), use_reentrant=False)
            else:
                x = layer_fn(x, layer, _bank_layer(lora_bank, li))
    else:
        x = inputs_embeds
        n_layers = params["layers"]["input_layernorm"]["scale"].shape[0]
        starts = write_pos.tolist()
        for li in range(n_layers):
            def attend(q, k, v, kc=cache.k[li], vc=cache.v[li]):
                return cache_attend(attn_impl, write_pos, starts, kv_len, kc, vc, q, k, v, runs=runs)

            x = decoder_layer(cfg, x, layer_slice(params["layers"], li), cos, sin, attend,
                              quant_glue=quant_glue_ok(attn_impl), lora=_bank_layer(lora_bank, li),
                              adapter_ids=adapter_ids, mlp_fn=mlp_fn, mesh=mesh)
    return rms_norm(x, params["norm"]["scale"], cfg.rms_norm_eps), cache


@torch.no_grad()
def calibrate_swiglu_scales(params: dict, cfg: TextConfig, inputs_embeds: torch.Tensor,
                            positions: torch.Tensor) -> dict:
    """Per-layer static SwiGLU-output scales for the quantizing MLP epilogue
    (the LLM analogue of :func:`~omchat_torch.models.intern_vit.
    calibrate_fc1_scales`; a function, as in the JAX package: no load path
    calls it).  Runs the unfused w8a8 trunk (``dense(..., a8=True)`` for
    every matmul, causal attention without a cache) on a calibration batch
    (inputs_embeds [B, S, D], positions [B, S]) over quantized params and
    records each layer's amax of ``silu(gate(y)) * up(y)``.  Returns a new
    params dict with ``layers.mlp.swiglu_out_scale`` [L] fp32 set to
    max(amax, 1e-6) / 127 — the glue layer picks it up (K10).

    The JAX package runs this attention on its XLA route.  Here it takes the
    default route on CUDA (kernel K2), as
    :func:`~omchat_torch.models.intern_vit.calibrate_fc1_scales` does, and the
    plain reference attention (the XLA route's counterpart) on the CPU."""
    impl = None if inputs_embeds.is_cuda else PLAIN
    cos, sin = rope_cos_sin(
        positions,
        cfg.attn_head_dim,
        theta=cfg.rope_theta,
        scaling=cfg.rope_scaling,
        max_position_embeddings=cfg.max_position_embeddings,
        dtype=inputs_embeds.dtype,
    )
    b, s, _ = inputs_embeds.shape
    eps = cfg.rms_norm_eps
    n_layers = params["layers"]["input_layernorm"]["scale"].shape[0]
    x, amax = inputs_embeds, []
    for layer in layer_list(params["layers"], n_layers):
        y = rms_norm(x, layer["input_layernorm"]["scale"], eps)
        q, k, v = attention_inputs(cfg, y, layer["self_attn"], cos, sin, True)
        ctx = attention(q, k, v, causal=True, impl=impl).reshape(b, s, -1)
        x = x + dense(ctx, layer["self_attn"]["o_proj"], a8=True)
        y = rms_norm(x, layer["post_attention_layernorm"]["scale"], eps)
        p = layer["mlp"]
        h = silu(dense(y, p["gate_proj"], a8=True)) * dense(y, p["up_proj"], a8=True)
        x = x + dense(h, p["down_proj"], a8=True)
        amax.append(h.float().abs().amax())
    out = dict(params)
    out["layers"] = dict(params["layers"])
    out["layers"]["mlp"] = {**params["layers"]["mlp"], "swiglu_out_scale": div127(torch.stack(amax).clamp(min=1e-6))}
    return out


def lm_head(params: dict, cfg: TextConfig, hidden: torch.Tensor, mesh=None) -> torch.Tensor:
    """Project to vocab logits (fp32).  ``mesh``: the vocabulary is sharded
    over the model axis and this rank's block of the logits comes back
    (:func:`omchat_torch.ops.cross_entropy.vocab_parallel_cross_entropy`
    takes it); a tied head reads the embedding's shard."""
    if mesh is not None:
        hidden = copy_to_axis(hidden, mesh)
    if cfg.tie_word_embeddings or "lm_head" not in params:
        return (hidden @ params["embed_tokens"].T.to(hidden.dtype)).float()
    return dense(hidden, params["lm_head"]).float()


def gather_vocab(logits: torch.Tensor, vocab_size: int, mesh) -> torch.Tensor:
    """The whole vocabulary's logits [..., V] from each rank's block [...,
    block] (blocks of :func:`~omchat_torch.parallel.sharding.split_sizes`,
    the larger first), concatenated in rank order; the logits as they are
    without a mesh."""
    if mesh is None or mesh.axis_size("model") == 1:
        return logits
    return all_gather_blocks(logits, mesh, "model", split_sizes(vocab_size, mesh.axis_size("model")))


def full_logits(params: dict, cfg: TextConfig, hidden: torch.Tensor, mesh=None) -> torch.Tensor:
    """The serving head: :func:`lm_head` over the whole vocabulary (fp32) on
    every rank.  ``mesh``: each rank's vocabulary block, gathered
    (:func:`gather_vocab`), so that sampling, masks, penalties and log-probs
    see what they see on one device and every rank picks the same token."""
    return gather_vocab(lm_head(params, cfg, hidden, mesh), cfg.vocab_size, mesh)


def embed_tokens(params: dict, input_ids: torch.Tensor, mesh=None, vocab_size: Optional[int] = None) -> torch.Tensor:
    """Token embedding lookup; sentinel ids (< 0) map to row 0 and ids beyond
    the vocab clamp to the last row (the JAX ``mode="clip"`` take).

    ``mesh``: the table is this rank's block of the ``vocab_size`` rows; a
    rank looks up the ids in its block, writes zeros for the others, and the
    sum over the model axis is the lookup, with the same clipping."""
    table = params["embed_tokens"]
    if mesh is None:
        safe = input_ids.long().clamp(min=0, max=table.shape[0] - 1)
        return table[safe]
    lo, hi = block_range(vocab_size, mesh.axis_size("model"), mesh.axis_index("model"))
    safe = input_ids.long().clamp(min=0, max=vocab_size - 1)
    mine = (safe >= lo) & (safe < hi)
    rows = table[(safe - lo).clamp(min=0, max=hi - lo - 1)]
    return reduce_from_axis(torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype)), mesh)


def init_params(cfg: TextConfig, generator: torch.Generator, dtype=torch.float32, device=None,
                mlp: bool = True) -> dict:
    """Random weights from a seeded generator (the JAX ``init_params``
    distribution): normal(0, 0.02) matrices, zero biases, unit norms.  An
    MoE config gets the MoE trunk's (:func:`omchat_torch.models.qwen2_moe.
    init_params`); ``mlp=False`` leaves out the dense MLP (the MoE init
    adds its block)."""
    if cfg.is_moe and mlp:
        from omchat_torch.models.qwen2_moe import init_params as moe_init

        return moe_init(cfg, generator, dtype, device)
    d, f, l, vocab = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers, cfg.vocab_size
    h, kvh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.attn_head_dim
    device = device if device is not None else generator.device

    def nrm(shape):
        return torch.randn(shape, generator=generator, device=device, dtype=dtype).mul_(0.02)

    def proj(i, o, bias):
        p = {"kernel": nrm((l, i, o))}
        if bias:
            p["bias"] = torch.zeros((l, o), dtype=dtype, device=device)
        return p

    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=device)  # noqa: E731
    params = {
        "embed_tokens": nrm((vocab, d)),
        "layers": {
            "input_layernorm": {"scale": ones(l, d)},
            "post_attention_layernorm": {"scale": ones(l, d)},
            "self_attn": {
                "q_proj": proj(d, h * hd, cfg.attention_bias),
                "k_proj": proj(d, kvh * hd, cfg.attention_bias),
                "v_proj": proj(d, kvh * hd, cfg.attention_bias),
                "o_proj": proj(h * hd, d, False),
            },
        },
        "norm": {"scale": ones(d)},
    }
    if mlp:
        params["layers"]["mlp"] = {
            "gate_proj": proj(d, f, False),
            "up_proj": proj(d, f, False),
            "down_proj": proj(f, d, False),
        }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": nrm((d, vocab))}
    return params
