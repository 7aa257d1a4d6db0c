"""The fp8 (e4m3) KV cache's store: values rounded as the JAX package stores
them.

``jnp.astype(float8_e4m3fn)`` rounds to nearest even, subnormals included,
and turns what rounds past 448 (|x| > 464), +-inf and NaN into NaN with the
input's sign.  ``torch.Tensor.to(torch.float8_e4m3fn)`` saturates instead
(500 -> 448), so every store into an e4m3 cache or pool goes through
:func:`to_e4m3` (or :func:`cast_to`), and the CUDA stores (K4, K15) round the
same way in the kernel (``csrc/common.cuh`` ``bf16x2_to_e4m3x2``).
"""

from __future__ import annotations

import torch

E4M3 = torch.float8_e4m3fn
E4M3_MAX = 448.0
E4M3_OVERFLOW = 464.0  # 448 plus half an ulp: a tie rounds to even, to 448


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` as e4m3, bit for bit as ``jnp.astype(jnp.float8_e4m3fn)``."""
    # |x| in (448, 464] rounds to 448 as the clamped value does; what torch's
    # cast does past 448 (saturate or NaN, by device) never matters
    sat = x.clamp(-E4M3_MAX, E4M3_MAX).to(E4M3).view(torch.uint8)
    nan = torch.where(torch.signbit(x), 0xFF, 0x7F).to(torch.uint8)  # NaN with x's sign
    return torch.where(x.abs() <= E4M3_OVERFLOW, sat, nan).view(E4M3)


def cast_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in a cache's storage dtype: :func:`to_e4m3` for an e4m3 cache,
    ``Tensor.to`` otherwise."""
    return to_e4m3(x) if dtype == E4M3 else x.to(dtype)
