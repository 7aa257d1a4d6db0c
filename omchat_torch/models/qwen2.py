"""Qwen2 decoder with a device-resident KV cache — PyTorch port of the dense
trunk of ``omchat_tpu/models/qwen2.py``.

GQA attention with qkv bias and no o-proj bias, RoPE (linear / dynamic-NTK),
RMSNorm, SwiGLU MLP, optional tied lm_head.  The cache is one head-major
tensor pair [L, B, KVH, T, D].

- Prefill (:func:`cache_attend`) writes each layer's K/V into its cache slice
  in place and runs causal attention against it (kernel K2 on CUDA).
- Decode (:func:`decode_scan`) keeps the cache read-only through the layer
  loop: each layer attends to its cache layer plus the in-flight token as a
  self column (kernel K3), and one commit after the loop writes the L x B new
  rows in place (:func:`commit_decode_rows`, kernel K4).

The port updates the cache in place where the JAX package returns a new one
(saves a copy of the whole cache per call).  LoRA banks and the w8a8 glue
layer come with later slices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from omchat_torch.config import TextConfig
from omchat_torch.ops.attention import PLAIN, attention, decode_attention
from omchat_torch.ops.linear import dense
from omchat_torch.ops.norms import rms_norm
from omchat_torch.ops.paged_attention import commit_rows, commit_rows_plain
from omchat_torch.ops.rope import apply_rope, rope_cos_sin
from omchat_torch.utils.tree import layer_slice


class KVCache(NamedTuple):
    """Stacked head-major KV cache; k/v: [L, B, KVH, S_max, Dh]."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


def init_kv_cache(cfg: TextConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len, cfg.attn_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device), v=torch.zeros(shape, dtype=dtype, device=device))


def _mlp(y: torch.Tensor, p: dict) -> torch.Tensor:
    """SwiGLU: down(silu(gate(y)) * up(y))."""
    return dense(F.silu(dense(y, p["gate_proj"])) * dense(y, p["up_proj"]), p["down_proj"])


def attention_inputs(cfg: TextConfig, y, p: dict, cos, sin):
    """q/k/v projections + RoPE.  y: [B, S, D] (normed) → q [B, S, H, hd],
    k/v [B, S, KVH, hd]."""
    b, s, _ = y.shape
    h, kvh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.attn_head_dim
    q = dense(y, p["q_proj"]).reshape(b, s, h, hd)
    k = dense(y, p["k_proj"]).reshape(b, s, kvh, hd)
    v = dense(y, p["v_proj"]).reshape(b, s, kvh, hd)
    q, k = apply_rope(q, k, cos, sin)
    return q, k, v


def decoder_layer(cfg: TextConfig, x, layer: dict, cos, sin, attend):
    """One decoder layer.  ``attend(q, k, v) -> ctx [B, S, H, hd]`` owns the
    cache handling (prefill write + causal attention, or the decode self
    column)."""
    b, s, _ = x.shape
    y = rms_norm(x, layer["input_layernorm"]["scale"], cfg.rms_norm_eps)
    q, k, v = attention_inputs(cfg, y, layer["self_attn"], cos, sin)
    ctx = attend(q, k, v)
    x = x + dense(ctx.reshape(b, s, -1), layer["self_attn"]["o_proj"])
    y = rms_norm(x, layer["post_attention_layernorm"]["scale"], cfg.rms_norm_eps)
    return x + _mlp(y, layer["mlp"])


def cache_attend(attn_impl, write_pos, starts, kv_len, k_cache, v_cache, q, k, v):
    """Prefill cache handler for one layer: write K/V at ``write_pos`` [B]
    (``starts``: the same offsets as host ints) into the head-major cache
    layer [B, KVH, T, D] in place and attend causally against it (``kv_len``
    [B] valid length after the write).  With no cache (``k_cache is None``) it
    attends over this call's K/V only."""
    if k_cache is None:
        return attention(q, k, v, causal=True, impl=attn_impl)
    s = q.shape[1]
    for bi, wp in enumerate(starts):
        k_cache[bi, :, wp : wp + s] = k[bi].transpose(0, 1).to(k_cache.dtype)
        v_cache[bi, :, wp : wp + s] = v[bi].transpose(0, 1).to(v_cache.dtype)
    return attention(q, k_cache, v_cache, causal=True, q_offset=write_pos, kv_len=kv_len, impl=attn_impl,
                     kv_format="bntd")


def commit_decode_rows(cache: KVCache, write_pos: torch.Tensor, k_rows, v_rows, attn_impl=None) -> KVCache:
    """Commit the decode loop's staged K/V rows ([L, B, KVH, D]) into the
    stacked cache at ``write_pos`` [B], in place — the one write of the
    read-only-cache decode step.  Each (layer, batch) cache row is one "page"
    of the row-commit kernel (K4 on CUDA); ``attn_impl="plain"`` writes with
    the plain indexed assignment."""
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


def decode_scan(cfg: TextConfig, attn_impl, params: dict, inputs_embeds, cos, sin, cache: KVCache, kv_len, write_pos):
    """Single-token decode over the layer stack with the cache READ-ONLY in
    the loop: layer ``li`` attends to its cache layer (selected inside the
    kernel) plus the in-flight token as a self column; the new K/V rows are
    committed once after the loop."""
    n_layers = params["layers"]["input_layernorm"]["scale"].shape[0]
    cache_len = (kv_len - 1).to(torch.int32)  # excludes the in-flight token
    k_rows, v_rows = [], []
    x = inputs_embeds
    for li in range(n_layers):
        def attend(q, k, v, li=li):
            k_rows.append(k[:, 0])
            v_rows.append(v[:, 0])
            return decode_attention(q, cache.k, cache.v, cache_len, impl=attn_impl, layer=li,
                                    k_new=k[:, 0], v_new=v[:, 0])

        x = decoder_layer(cfg, x, layer_slice(params["layers"], li), cos, sin, attend)
    cache = commit_decode_rows(cache, write_pos, torch.stack(k_rows), torch.stack(v_rows), attn_impl)
    return x, cache


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
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder trunk (no lm_head).

    inputs_embeds [B, S, D]; positions [B, S]; with a cache, this call's K/V
    are written at ``write_pos`` [B] and attention runs against the cache with
    valid length ``kv_len`` [B] (after the write).  S == 1 with a cache is a
    decode step.  Returns (hidden [B, S, D], the cache, updated in place)."""
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

    if cache is not None and inputs_embeds.shape[1] == 1:
        x, cache = decode_scan(cfg, attn_impl, params, inputs_embeds, cos, sin, cache, kv_len, write_pos)
    else:
        x = inputs_embeds
        n_layers = params["layers"]["input_layernorm"]["scale"].shape[0]
        starts = write_pos.tolist()
        for li in range(n_layers):
            kc = cache.k[li] if cache is not None else None
            vc = cache.v[li] if cache is not None else None

            def attend(q, k, v, kc=kc, vc=vc):
                return cache_attend(attn_impl, write_pos, starts, kv_len, kc, vc, q, k, v)

            x = decoder_layer(cfg, x, layer_slice(params["layers"], li), cos, sin, attend)
    return rms_norm(x, params["norm"]["scale"], cfg.rms_norm_eps), cache


def lm_head(params: dict, cfg: TextConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Project to vocab logits (fp32)."""
    if cfg.tie_word_embeddings or "lm_head" not in params:
        return (hidden @ params["embed_tokens"].T.to(hidden.dtype)).float()
    return dense(hidden, params["lm_head"]).float()


def embed_tokens(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup; sentinel ids (< 0) map to row 0 and ids beyond
    the vocab clamp to the last row (the JAX ``mode="clip"`` take)."""
    table = params["embed_tokens"]
    safe = input_ids.long().clamp(min=0, max=table.shape[0] - 1)
    return table[safe]


def init_params(cfg: TextConfig, generator: torch.Generator, dtype=torch.float32, device=None) -> dict:
    """Random weights from a seeded generator (the JAX ``init_params``
    distribution): normal(0, 0.02) matrices, zero biases, unit norms."""
    if cfg.is_moe:
        raise NotImplementedError("the Qwen2-MoE trunk waits for the MoE slice")
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
            "mlp": {
                "gate_proj": proj(d, f, False),
                "up_proj": proj(d, f, False),
                "down_proj": proj(f, d, False),
            },
        },
        "norm": {"scale": ones(d)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": nrm((d, vocab))}
    return params
