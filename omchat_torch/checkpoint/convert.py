"""Carry a JAX param tree into the port's layout.

``from_jax_params`` takes the tree that the JAX package's ``init_params``
(or its checkpoint loader) builds, with numpy leaves, and returns the same
tree of torch tensors.  Every leaf keeps its layout (per-layer stacking on a
leading axis, linear kernels [in, out]) except the patch-embedding conv,
which goes HWIO [P, P, 3, D] → OIHW [D, 3, P, P] for ``F.conv2d``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _leaf(x, path, dtype, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.kind == "f" and arr.dtype != np.float32 and arr.dtype != np.float64:
        arr = arr.astype(np.float32)  # bf16 / fp16 numpy leaves go through fp32
    t = torch.from_numpy(np.array(arr, copy=True))  # own, writable memory
    if path[-2:] == ("patch_embedding", "kernel"):
        t = t.permute(3, 2, 0, 1).contiguous()  # HWIO → OIHW
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device) if device is not None else t


def from_jax_params(tree, dtype: Optional[torch.dtype] = None, device=None, _path=()):
    """Nested dict of numpy-like leaves → the same nested dict of tensors
    (``dtype``: cast floating leaves; ``device``: where they go)."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, dtype, device, _path + (k,)) for k, v in tree.items()}
    return _leaf(tree, _path, dtype, device)
