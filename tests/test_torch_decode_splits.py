"""``ops.decode_attention.decode_splits``: how the split-KV decode kernels (K3
and K6) cut a cache of T rows over blocks.  A plain host function of the
capacity, the batch, the kv heads and the card's SM count, so it runs here."""

import pytest

from omchat_torch.ops.decode_attention import SPLIT_ROWS, decode_splits

SHAPES = [(1, 4, 3328, 132), (16, 4, 3328, 132), (1, 4, 256, 132), (2, 2, 300, 132), (1, 4, 3328, 114),
          (3, 4, 4096, 132), (64, 4, 3328, 132), (1, 1, 65, 8)]


@pytest.mark.parametrize("B,KVH,T,sms", SHAPES)
def test_every_row_lies_in_exactly_one_split(B, KVH, T, sms):
    splits, rows = decode_splits(B, KVH, T, sms)
    chunks = [range(s * rows, min((s + 1) * rows, T)) for s in range(splits)]
    assert all(len(c) > 0 for c in chunks)
    covered = [r for c in chunks for r in c]
    assert covered == list(range(T))


@pytest.mark.parametrize("B,KVH,T,sms", SHAPES)
def test_chunks_are_multiples_of_the_tile(B, KVH, T, sms):
    _, rows = decode_splits(B, KVH, T, sms)
    assert rows % SPLIT_ROWS == 0 and rows > 0


@pytest.mark.parametrize("B,KVH,T,sms", [(1, 4, 3328, 132), (2, 4, 3328, 132), (1, 4, 3328, 114),
                                          (1, 2, 8192, 132)])
def test_grid_fills_every_sm(B, KVH, T, sms):
    splits, rows = decode_splits(B, KVH, T, sms)
    assert B * KVH * splits >= sms
    if (B, KVH, T, sms) == (1, 4, 3328, 132):  # the main path: 64-row chunks, 208 blocks
        assert (splits, rows) == (52, 64)


@pytest.mark.parametrize("T", [0, 1, 17, 64])
def test_a_tiny_cache_is_one_split(T):
    assert decode_splits(1, 4, T, 132) == (1, 64)


def test_a_large_batch_is_one_split():
    assert decode_splits(64, 4, 3328, 132) == (1, 3328)


def test_depends_on_its_arguments_only():
    first = [decode_splits(*shape) for shape in SHAPES]
    assert [decode_splits(*shape) for shape in reversed(SHAPES)][::-1] == first
    assert all(isinstance(n, int) and isinstance(r, int) for n, r in first)
