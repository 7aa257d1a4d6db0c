"""Contrastive (CLIP) loss — PyTorch port of ``omchat_tpu/ops/contrastive.py``
on one device.

The reference's GatherLayer + ClipLoss (multimodal_encoder/utils.py:652-728):
similarity logits with a learned temperature, symmetric cross-entropy.  The
JAX package also gathers the features across data-parallel ranks
(``mesh=``); that gather comes with the parallelism slice (ROADMAP queue A
item A13), and until then a mesh or process group is refused.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def clip_contrastive_loss(image_features: torch.Tensor, text_features: torch.Tensor, logit_scale,
                          mesh=None, axis: str = "data") -> torch.Tensor:
    """Symmetric InfoNCE over one device's batch, in fp32: image / text
    features [B, D] are L2-normalized here (norms clipped at 1e-6), logits
    ``logit_scale * img @ txt^T`` and its transpose, the matching pair the
    label of each row.  Differentiable by autograd.  ``mesh`` (a device mesh
    or a ``torch.distributed`` process group) raises ``NotImplementedError``:
    the cross-rank gather waits for A13."""
    if mesh is not None:
        raise NotImplementedError(f"clip_contrastive_loss: the gather across ranks (mesh axis {axis!r}) waits for "
                                  "the parallelism slice (ROADMAP queue A item A13)")

    def norm(x):
        x = x.float()
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-6)

    img, txt = norm(image_features), norm(text_features)
    scale = torch.as_tensor(logit_scale, dtype=torch.float32, device=img.device)
    labels = torch.arange(img.shape[0], device=img.device)
    li = F.cross_entropy(scale * img @ txt.t(), labels)
    lt = F.cross_entropy(scale * txt @ img.t(), labels)
    return (li + lt) / 2
