"""Linear layer helper (PyTorch port of the bf16 path of
``omchat_tpu/ops/linear.py:117 dense``).

A param dict is ``{"kernel": [in, out], "bias"?: [out]}``; the kernel keeps
the JAX package's [in, out] layout.  The int8 weight-only and w8a8 paths come
with the w8a8 slice.
"""

from __future__ import annotations

import torch


def dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    """y = x @ W (+ bias)."""
    if "kernel" not in p:
        raise NotImplementedError("quantized linear params wait for the w8a8 slice")
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y
