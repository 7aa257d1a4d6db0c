"""Automatic prefix caching: content-addressed reuse of immutable prompt KV
pages across requests.  The port's own copy of
``omchat_tpu/runtime/prefix_cache.py`` (pure Python over ``hashlib``, nothing
of the JAX package imported): its digests are bitwise the JAX copy's on the
same inputs.

Pages are the unit of sharing: a page of the pool holds ``page_size``
positions of K/V for every layer, and a *prompt* page's content is fully
determined by the token ids up to and including that page (RoPE positions are
absolute from 0, so two prompts with the same token prefix produce
byte-identical K/V for the shared pages).  A chain of BLAKE2b digests over
page-sized token blocks is the content address.

Only pages that stay immutable are ever shared or published:

- the page containing position ``prompt_len`` is excluded — the first decode
  step writes there;
- image K/V depends on pixel content, which token ids alone do not address:
  WITHOUT an ``image_key`` everything at or after the first image token is
  excluded; WITH one (the request's compressed-payload / pixel digest, the
  same identity the encoded-image LRU uses), pages covering image rows mix
  the key plus the splice layout (is_image, image_index) into the digest
  chain, so multi-turn VQA re-sending the same image reuses the whole
  previous-turn KV — image rows included — and turn N+1 prefills only its
  new suffix;
- generated-token pages are never published.

Ownership: a page published to the cache belongs to the cache, not to the
request that wrote it.  Requests hold references (their own published pages
plus any pages matched at admission); at refcount zero a page becomes
evictable LRU but stays mapped, so a later identical prefix still hits until
page pressure reclaims it.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence


def page_hashes(
    token_ids: Sequence[int],
    prompt_len: int,
    page_size: int,
    first_image_pos: Optional[int] = None,
    *,
    image_key: Optional[str] = None,
    is_image=None,
    image_index=None,
) -> List[bytes]:
    """Digest chain over the shareable full pages of a prompt.

    ``token_ids`` are the *expanded* prompt ids (image placeholders already
    spliced); hashing stops before the page that the first decode write
    (position ``prompt_len``) or — without an ``image_key`` — the first
    image token lands in.  With ``image_key`` (a content identity for ALL of
    the request's images, in order), pages containing image rows fold the
    key and the splice layout (``is_image``/``image_index`` blocks) into the
    chain instead of stopping: identical token prefix + identical image
    bytes address identical K/V; a different image diverges the chain at its
    first image page while the plain-text pages before it still match.

    A request consuming a match must still cap its hit at ``(prompt_len -
    1) // page_size`` pages so at least one prompt token remains to prefill
    (the final-position logits come from the prefill) — the engine does this
    at admission; the *publishable* set here may be one page larger.
    """
    limit = prompt_len
    if first_image_pos is not None and image_key is None:
        limit = min(limit, first_image_pos)
    n = max(0, limit) // page_size
    out: List[bytes] = []
    h = b"omchat-prefix-v1"
    for i in range(n):
        lo, hi = i * page_size, (i + 1) * page_size
        m = hashlib.blake2b(h, digest_size=16)
        m.update(np_tobytes(token_ids[lo:hi]))
        if image_key is not None and is_image is not None:
            import numpy as np

            blk = np.asarray(is_image[lo:hi])
            if blk.any():
                m.update(image_key.encode())
                m.update(np_tobytes(blk.astype(np.int64)))
                m.update(np_tobytes(image_index[lo:hi]))
        h = m.digest()
        out.append(h)
    return out


def np_tobytes(block) -> bytes:
    import numpy as np

    return np.asarray(block, np.int64).tobytes()


class PrefixPageCache:
    """Host-side refcounted map of page-content digests to pool pages."""

    def __init__(self) -> None:
        self.by_hash: Dict[bytes, int] = {}
        self.hash_of: Dict[int, bytes] = {}
        self.refs: Dict[int, int] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # refcount-0 pages
        self.hits = 0
        self.misses = 0

    # -- lookup / reference lifecycle ---------------------------------------

    def lookup(self, hashes: Sequence[bytes]) -> List[int]:
        """Longest-prefix match; takes a reference on every returned page."""
        pages: List[int] = []
        for h in hashes:
            p = self.by_hash.get(h)
            if p is None:
                break
            pages.append(p)
        for p in pages:
            self.refs[p] += 1
            self._lru.pop(p, None)
        self.hits += len(pages)
        self.misses += len(hashes) - len(pages)
        return pages

    def publish(self, h: bytes, page: int) -> bool:
        """Publish a freshly prefilled page under its digest, holding one
        reference for the publisher.  Returns False (page stays owned by the
        caller) if the digest is already mapped — the concurrent-twin case."""
        if h in self.by_hash:
            return False
        self.by_hash[h] = page
        self.hash_of[page] = h
        self.refs[page] = 1
        return True

    def unref(self, page: int) -> None:
        self.refs[page] -= 1
        if self.refs[page] == 0:
            self._lru[page] = None  # evictable, most-recently-released last

    def holds(self, page: int) -> bool:
        return page in self.hash_of

    # -- eviction -----------------------------------------------------------

    @property
    def evictable(self) -> int:
        return len(self._lru)

    def evict(self, n: int) -> List[int]:
        """Drop up to ``n`` least-recently-released refcount-0 pages from the
        cache and return them (caller gives them back to the allocator)."""
        out: List[int] = []
        while self._lru and len(out) < n:
            page, _ = self._lru.popitem(last=False)
            del self.by_hash[self.hash_of.pop(page)]
            del self.refs[page]
            out.append(page)
        return out

    def flush(self) -> List[int]:
        """Drop every refcount-0 page (test/ops hook)."""
        return self.evict(len(self._lru))

    def stats(self) -> dict:
        return {
            "pages_cached": len(self.by_hash),
            "evictable": len(self._lru),
            "hits": self.hits,
            "misses": self.misses,
        }
