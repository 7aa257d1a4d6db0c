"""LRU cache of encoded image features keyed by pixel (or caller) identity —
PyTorch port of ``omchat_tpu/runtime/feature_cache.py``.

Multi-turn VQA resends the same image every turn, and the ViT encode is the
most expensive single stage of a turn; it is a pure function of the pixel
tiles, so its output can be reused across requests.  Callers that hold the
original compressed image bytes (the server's base64 payload) pass a hash of
those as the key; otherwise :func:`pixel_digest` hashes the host pixel array.
Device tensors are never hashed implicitly (that would copy them back to the
host).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional

import numpy as np

__all__ = ["ImageFeatureCache", "cached_encode", "pixel_digest"]


def pixel_digest(pixel_values: np.ndarray) -> str:
    """Content hash of a host-side pixel array (shape/dtype-qualified)."""
    a = np.ascontiguousarray(pixel_values)
    h = hashlib.blake2b(digest_size=16)
    h.update(str((a.shape, a.dtype.str)).encode())
    h.update(a.tobytes())
    return h.hexdigest()


class ImageFeatureCache:
    """Bounded LRU: key -> encoded feature tensor (stays on the device).

    ``capacity`` counts entries, not bytes: one 5-tile anyres encode at the
    13B geometry is [5125, 3584] bf16 = 37 MB of device memory, so the
    default 8 holds ~300 MB.  Not thread-safe by itself; engines use it from
    their scheduler/submit thread only."""

    def __init__(self, capacity: int = 8):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._entries: "OrderedDict[str, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: Optional[str]):
        if key is None:
            return None
        feats = self._entries.get(key)
        if feats is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return feats

    def peek(self, key: Optional[str]):
        """Lookup without hit/miss accounting or LRU touch — for schedulers
        deciding whether to defer an encode."""
        if key is None:
            return None
        return self._entries.get(key)

    def put(self, key: Optional[str], feats) -> None:
        if key is None:
            return
        self._entries[key] = feats
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def stats(self) -> dict:
        return {"entries": len(self._entries), "capacity": self.capacity, "hits": self.hits, "misses": self.misses}

    def clear(self) -> None:
        self._entries.clear()


def cached_encode(cache: Optional[ImageFeatureCache], pixel_values, cache_key, encode_fn):
    """Encode through the cache: with no key, host numpy input is
    content-hashed and anything else is encoded uncached."""
    if cache is not None:
        if cache_key is None and isinstance(pixel_values, np.ndarray):
            cache_key = pixel_digest(pixel_values)
        feats = cache.get(cache_key)
        if feats is not None:
            return feats
    feats = encode_fn(pixel_values)
    if cache is not None:
        cache.put(cache_key, feats)
    return feats
