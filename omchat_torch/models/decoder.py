"""Decoder-trunk dispatch: the dense Qwen2 or the Qwen2-MoE trunk, by config
(PyTorch port of ``omchat_tpu/models/decoder.py``).

Both forwards share one contract (:func:`omchat_torch.models.qwen2.
qwen2_forward`), so the generation runtime and the serving engines stay
decoder-agnostic: ``cfg.is_moe`` (``num_experts > 0`` in the HF config)
routes to the MoE trunk."""

from __future__ import annotations

from omchat_torch.config import TextConfig
from omchat_torch.models.qwen2 import qwen2_forward


def decoder_forward(params: dict, cfg: TextConfig, *args, **kwargs):
    """Same signature and returns as :func:`qwen2_forward`; the MoE trunk
    when configured (its dense expert route, as the JAX package's)."""
    if cfg.is_moe:
        from omchat_torch.models.qwen2_moe import qwen2_moe_forward

        return qwen2_moe_forward(params, cfg, *args, **kwargs)
    return qwen2_forward(params, cfg, *args, **kwargs)
