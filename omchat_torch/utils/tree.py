"""Param-tree helpers."""

from __future__ import annotations


def layer_slice(layers: dict, i: int) -> dict:
    """Layer ``i`` of a param tree stacked on a leading layer axis (views, no copies)."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}
