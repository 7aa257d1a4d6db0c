"""OmChat model assembly: vision encode → project → splice — PyTorch port of
``omchat_tpu/models/omchat.py``.

The merged layout is planned on the host once (:func:`plan_multimodal_merge`,
integer work in numpy, prompt lengths bucketed to multiples of 128) and the
device-side splice is a gather plus a select (:func:`fuse_embeddings`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from omchat_torch.config import OmChatConfig
from omchat_torch.constants import IMAGE_TOKEN_INDEX
from omchat_torch.models.intern_vit import feature_select, intern_vit_forward
from omchat_torch.models.projector import projector_forward
from omchat_torch.models.qwen2 import embed_tokens


def encode_images(params: dict, cfg: OmChatConfig, pixel_values: torch.Tensor, *, attn_impl: Optional[str] = None):
    """ViT → feature_select → projector.  [N, 3, H, W] → [N, L, D_text]."""
    hidden = intern_vit_forward(
        params["vision_tower"], cfg.vision, pixel_values,
        feature_layer=cfg.vision_feature_layer, attn_impl=attn_impl,
    )
    feats = feature_select(hidden, cfg.vision_feature_select_strategy)
    return projector_forward(params["projector"], cfg.projector, feats)


@dataclass
class MergePlan:
    """Merged-sequence layout for a batch (host numpy arrays).

    token_ids:  [B, M] int32 — merged ids with 0 at image/pad rows
    is_image:   [B, M] bool — True where a row takes an image-feature vector
    image_index:[B, M] int32 — row into the flattened [ΣN*L, D] feature matrix
    lengths:    [B] int32 — true merged length per sequence (right padding)
    positions:  [B, M] int32 — 0..len-1 then 0s
    """

    token_ids: np.ndarray
    is_image: np.ndarray
    image_index: np.ndarray
    lengths: np.ndarray
    positions: np.ndarray

    @property
    def max_len(self) -> int:
        return self.token_ids.shape[1]


def round_up_to_bucket(n: int, bucket: int = 128) -> int:
    return ((n + bucket - 1) // bucket) * bucket


def plan_multimodal_merge(
    batch_input_ids: Sequence[Sequence[int]],
    image_seq_len: int,
    *,
    tokens_per_sentinel: Optional[Sequence[int]] = None,
    pad_to: Optional[int] = None,
    bucket: int = 128,
    max_length: Optional[int] = None,
) -> MergePlan:
    """Expand each ``-200`` sentinel into ``image_seq_len`` feature rows,
    consumed in sentinel order across the batch (the reference's
    ``cur_image_idx`` walk, omchat_arch.py:119-152)."""
    merged: List[Tuple[List[int], List[int], List[int]]] = []
    global_sentinel = 0
    feature_offset = 0
    for ids in batch_input_ids:
        tok: List[int] = []
        img_idx: List[int] = []
        is_img: List[int] = []
        for t in ids:
            if t == IMAGE_TOKEN_INDEX:
                n = tokens_per_sentinel[global_sentinel] if tokens_per_sentinel is not None else image_seq_len
                tok.extend([0] * n)
                img_idx.extend(range(feature_offset, feature_offset + n))
                is_img.extend([1] * n)
                feature_offset += n
                global_sentinel += 1
            else:
                tok.append(int(t))
                img_idx.append(0)
                is_img.append(0)
        if max_length is not None:
            tok, img_idx, is_img = tok[:max_length], img_idx[:max_length], is_img[:max_length]
        merged.append((tok, img_idx, is_img))

    lengths = np.asarray([len(m[0]) for m in merged], dtype=np.int32)
    m_len = pad_to if pad_to is not None else round_up_to_bucket(int(lengths.max()), bucket)
    b = len(merged)
    token_ids = np.zeros((b, m_len), dtype=np.int32)
    image_index = np.zeros((b, m_len), dtype=np.int32)
    is_image = np.zeros((b, m_len), dtype=bool)
    positions = np.zeros((b, m_len), dtype=np.int32)
    for i, (tok, img_idx, is_img) in enumerate(merged):
        n = len(tok)
        token_ids[i, :n] = tok
        image_index[i, :n] = img_idx
        is_image[i, :n] = is_img
        positions[i, :n] = np.arange(n)
    return MergePlan(token_ids, is_image, image_index, lengths, positions)


def fuse_embeddings(params: dict, token_ids, is_image, image_index, image_features: Optional[torch.Tensor]):
    """Text embedding where ``is_image`` is False, else the gathered image
    feature row.  image_features: [R, D] flattened tile rows."""
    embeds = embed_tokens(params["language_model"], token_ids)
    if image_features is None:
        return embeds
    img = image_features[image_index.long()]  # [B, M, D]
    return torch.where(is_image[..., None], img.to(embeds.dtype), embeds)
