"""Param-tree helpers."""

from __future__ import annotations


def layer_slice(layers: dict, i: int) -> dict:
    """Layer ``i`` of a param tree stacked on a leading layer axis (views, no copies)."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


def layer_list(layers: dict, n: int) -> list:
    """Layers ``0..n-1`` of a stacked param tree, each a dict of views: one
    ``unbind`` per leaf, so a backward through all of them stacks each leaf's
    gradient once (indexing would write a full-size zero gradient per layer)."""
    parts = {k: layer_list(v, n) if isinstance(v, dict) else v[:n].unbind(0) for k, v in layers.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def tree_items(tree, prefix=()):
    """(path tuple, leaf) pairs of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, prefix + (k,))
    else:
        yield prefix, tree


def tree_map(fn, tree):
    """``fn`` over every leaf of a nested dict / list, keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
