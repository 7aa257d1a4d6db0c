"""Decoder-trunk dispatch (PyTorch port of ``omchat_tpu/models/decoder.py``).

``cfg.is_moe`` selects the Qwen2-MoE trunk in the JAX package; the port's MoE
trunk comes with the MoE slice, so an MoE config raises here until then."""

from __future__ import annotations

from omchat_torch.config import TextConfig
from omchat_torch.models.qwen2 import qwen2_forward


def decoder_forward(params: dict, cfg: TextConfig, *args, **kwargs):
    """Same signature and returns as :func:`qwen2_forward`."""
    if cfg.is_moe:
        raise NotImplementedError("the Qwen2-MoE trunk waits for the MoE slice")
    return qwen2_forward(params, cfg, *args, **kwargs)
