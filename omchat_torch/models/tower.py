"""Vision tower dispatch — PyTorch port of ``omchat_tpu/models/tower.py``
(the reference builder's substring rule: "internvit-300m" → InternViT-300M,
"internvit" → InternViT-6B, anything else → CLIP, and SigLIP by an explicit
"siglip" in the name).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

from omchat_torch.checkpoint.loader import convert_vision_tower
from omchat_torch.config import VisionConfig
from omchat_torch.models.clip_vit import ClipVisionConfig, clip_vit_forward, convert_hf_clip_vision
from omchat_torch.models.intern_vit import intern_vit_forward


@dataclass(frozen=True)
class VisionTower:
    """A tower: (config, forward, checkpoint converter)."""

    name: str
    config: object
    forward: Callable  # (params, config, pixel_values, *, feature_layer, attn_impl) -> hidden
    convert: Callable  # (torch state dict, config, dtype) -> params tree

    @property
    def hidden_size(self) -> int:
        return self.config.hidden_size


def build_vision_tower(mm_vision_tower: str, config: Optional[object] = None, *, clip_smoe: bool = False,
                       num_experts: int = 4, num_selected: int = 2) -> VisionTower:
    """The tower a name selects, by substring as the reference does.

    ``clip_smoe`` / ``num_experts`` / ``num_selected`` (the legacy v1
    CLIP-SMoE knobs) turn the CLIP / SigLIP branch's layer MLPs into top-k
    routed expert banks; InternViT towers ignore them, as the reference
    does."""
    name = mm_vision_tower.lower()
    if "internvit-300m" in name or "intern_vit_300m" in name:
        return VisionTower(name, config or VisionConfig.internvit_300m(), intern_vit_forward, convert_vision_tower)
    if "internvit" in name or "intern_vit" in name:
        return VisionTower(name, config or VisionConfig.internvit_6b(), intern_vit_forward, convert_vision_tower)
    cfg = config or (ClipVisionConfig.siglip_so400m() if "siglip" in name else ClipVisionConfig())
    if clip_smoe and not cfg.clip_smoe:
        cfg = dataclasses.replace(cfg, clip_smoe=True, num_experts=num_experts, num_selected=num_selected)
    return VisionTower(name, cfg, clip_vit_forward, convert_hf_clip_vision)
