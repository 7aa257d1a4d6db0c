"""Device selection for the port's entry points.

Every entry point runs on CUDA unless the caller asks for the CPU; without a
CUDA device the default raises instead of quietly running on the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on an NVIDIA GPU by default "
            "(pass device='cpu' explicitly to run the plain PyTorch path on the CPU)"
        )
    return dev
