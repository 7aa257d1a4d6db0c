"""Vision-tokenizer initialization — vocab extension for multimodal
fine-tuning, PyTorch port of ``omchat_tpu/training/vision_tokenizer.py``.

The reference's ``initialize_vision_tokenizer`` (omchat_arch.py:211-253) adds
the image special tokens to the tokenizer, resizes both embedding matrices to
the new tokenizer length, mean-initializes the fresh rows, optionally splices
pretrained adapter rows, and sets which embeddings train.  As in the JAX
package it is a function over the param tree that mutates no tensor: it
returns the resized params, the updated text config and a trainable mask, a
tree of bools over the params.  The port freezes a leaf by
``requires_grad=False`` (``train_step.init_train_state``'s ``trainable``
predicate on a leaf's path); :func:`mask_predicate` turns the mask into that
predicate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from omchat_torch.config import TextConfig
from omchat_torch.constants import DEFAULT_IM_END_TOKEN, DEFAULT_IM_START_TOKEN, DEFAULT_IMAGE_PATCH_TOKEN
from omchat_torch.utils.tree import tree_map


def _resize_rows(emb: torch.Tensor, new_size: int, num_new: int) -> torch.Tensor:
    """Resize [V, D] to [new_size, D]; the last ``num_new`` rows become the
    mean (in fp32) of all earlier rows (omchat_arch.py:223-229's
    ``input_embeddings_avg`` applied after HF ``resize_token_embeddings``
    truncates / extends).  Returns a new tensor."""
    v, d = emb.shape
    if new_size <= v:
        emb = emb[:new_size].clone()
    else:
        emb = torch.cat([emb, emb.new_zeros((new_size - v, d))], dim=0)
    if num_new > 0:
        avg = emb[:-num_new].float().mean(dim=0, keepdim=True)
        emb[-num_new:] = avg.expand(num_new, d).to(emb.dtype)
    return emb


def initialize_vision_tokenizer(
    params: dict,
    cfg: TextConfig,
    tokenizer,
    *,
    mm_use_im_patch_token: bool = False,
    mm_use_im_start_end: bool = False,
    tune_mm_mlp_adapter: bool = False,
    pretrain_embed_rows=None,
) -> Tuple[dict, TextConfig, dict]:
    """Add image special tokens and extend the embeddings to match.

    Args mirror the reference's model_args (omchat_arch.py:211-253):
      mm_use_im_patch_token: add ``<im_patch>``.
      mm_use_im_start_end: add ``<im_start>`` / ``<im_end>`` and mean-init the
        new input / output embedding rows.
      tune_mm_mlp_adapter: train the input embeddings, freeze the lm_head
        (in the returned mask).
      pretrain_embed_rows: optional pretrained ``embed_tokens`` weight (a
        tensor or array) — either the full resized matrix or just the
        ``num_new`` rows (omchat_arch.py:237-247's two accepted shapes).

    Returns (params, cfg, trainable_mask): the mask is a tree of bools over
    ``params`` (True = train this leaf), all True when no freezing was
    requested; ``init_train_state(params, opt, trainable=mask_predicate(mask))``
    applies it.
    """
    lm = dict(params["language_model"])
    num_new = 0
    if mm_use_im_patch_token:
        num_new += tokenizer.add_tokens([DEFAULT_IMAGE_PATCH_TOKEN], special_tokens=True)
    if mm_use_im_start_end:
        num_new += tokenizer.add_tokens([DEFAULT_IM_START_TOKEN, DEFAULT_IM_END_TOKEN], special_tokens=True)
    new_size = len(tokenizer)

    if num_new > 0 or new_size != cfg.vocab_size:
        mean_rows = num_new if mm_use_im_start_end else 0
        with torch.no_grad():
            lm["embed_tokens"] = _resize_rows(lm["embed_tokens"], new_size, mean_rows)
            if "lm_head" in lm and not cfg.tie_word_embeddings:
                head = dict(lm["lm_head"])
                # the lm_head kernel is [D, V]: resize / mean over the vocab axis
                head["kernel"] = _resize_rows(head["kernel"].t(), new_size, mean_rows).t().contiguous()
                lm["lm_head"] = head
        cfg = dataclasses.replace(cfg, vocab_size=new_size)

    if pretrain_embed_rows is not None:
        if not (mm_use_im_start_end and num_new == 2):
            raise ValueError("pretrained rows expect the im_start / im_end pair")
        emb = lm["embed_tokens"]
        rows = torch.as_tensor(np.asarray(pretrain_embed_rows)).to(dtype=emb.dtype, device=emb.device)
        emb = emb.detach().clone()
        if rows.shape == emb.shape:
            emb[-num_new:] = rows[-num_new:]
        elif rows.shape[0] == num_new:
            emb[-num_new:] = rows
        else:
            raise ValueError(f"Unexpected pretrained embed rows shape {tuple(rows.shape)} for embeddings "
                             f"{tuple(emb.shape)} with {num_new} new tokens")
        lm["embed_tokens"] = emb

    out_params = dict(params)
    out_params["language_model"] = lm

    # the trainable mask: the reference's requires_grad flips
    # (omchat_arch.py:231-236) as a tree
    mask = tree_map(lambda _: True, out_params)
    if tune_mm_mlp_adapter and mm_use_im_start_end:
        mlm = mask["language_model"]
        mlm["embed_tokens"] = True
        if "lm_head" in mlm:
            mlm["lm_head"] = tree_map(lambda _: False, mlm["lm_head"])
    return out_params, cfg, mask


def mask_predicate(mask: dict) -> Callable[[tuple], bool]:
    """The mask of :func:`initialize_vision_tokenizer` as the predicate on a
    leaf's path that ``train_step.init_train_state`` / ``set_trainable``
    take."""

    def trainable(path: tuple) -> bool:
        node = mask
        for key in path:
            node = node[key]
        return bool(node)

    return trainable
