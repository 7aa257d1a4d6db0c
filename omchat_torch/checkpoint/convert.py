"""Carry a JAX param tree into the port's layout.

``from_jax_params`` takes the tree that the JAX package's ``init_params``
(or its checkpoint loader, or ``quantize_tree``) builds, with numpy leaves,
and returns the same tree of torch tensors.  Every leaf keeps its layout
(per-layer stacking on a leading axis, linear kernels [in, out]) and its
dtype (bf16 leaves stay bf16) except:

- conv kernels, HWIO → OIHW for ``F.conv2d``: the patch embedding's [P, P,
  3, D] and the C-Abstractor's (``conv1`` / ``conv2`` / ``conv3`` /
  ``downsample.conv``, the depthwise [3, 3, 1, C] one included);
- int8 ``kernel_q`` leaves, [..., in, out] → [..., out, in], the port's
  int8 layout (:mod:`omchat_torch.ops.linear`).  Their scales, the static
  ``fc1_out_scale`` and everything else come across as they are;
- Python scalars, such as the ``scale`` of an ``init_lora`` adapter tree,
  which stay Python numbers.

So a QLoRA base (``quantize_tree`` over the trunk's layers) and a LoRA
adapter tree cross like any other tree, and so does a tree with lists (the
C-Abstractor's ``s1`` / ``s2`` / ``readout``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


# The param groups whose 4-D "kernel" is a conv's (HWIO in the JAX package).
_CONV_KERNELS = ("patch_embedding", "conv1", "conv2", "conv3", "conv")


def _leaf(x, path, dtype, device) -> torch.Tensor:
    arr = np.asarray(x)
    bf16 = arr.dtype.name == "bfloat16"
    if arr.dtype.kind == "f" and arr.dtype != np.float32 and arr.dtype != np.float64 or bf16:
        arr = arr.astype(np.float32)  # bf16 / fp16 numpy leaves go through fp32
    t = torch.from_numpy(np.array(arr, copy=True))  # own, writable memory
    if bf16:
        t = t.to(torch.bfloat16)  # exact: the values came from bf16
    if path[-1:] == ("kernel",) and len(path) > 1 and path[-2] in _CONV_KERNELS and t.dim() == 4:
        t = t.permute(3, 2, 0, 1).contiguous()  # HWIO → OIHW
    if path[-1:] == ("kernel_q",):
        t = t.transpose(-1, -2).contiguous()  # [.., in, out] → [.., out, in]
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device) if device is not None else t


def from_jax_params(tree, dtype: Optional[torch.dtype] = None, device=None, _path=()):
    """Nested dicts / lists of numpy-like leaves → the same nesting of
    tensors (``dtype``: cast floating leaves; ``device``: where they go)."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, dtype, device, _path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [from_jax_params(v, dtype, device, _path + (i,)) for i, v in enumerate(tree)]
    if isinstance(tree, (int, float)):
        return tree
    return _leaf(tree, _path, dtype, device)
