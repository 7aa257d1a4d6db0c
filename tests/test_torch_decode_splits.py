"""``ops.decode_attention.decode_splits``: how the split-KV decode kernels (K3
and K6, and through ``ops.paged_attention.paged_splits`` K12 and K13) cut a
cache of T rows over blocks.  A plain host function of the capacity, the
batch, the kv heads and the card's SM count, so it runs here; and the host
side of the K12 / K13 launch, whose C entry is recorded instead of called."""

import inspect
import os
import re

import pytest
import torch

from omchat_torch.ops import paged_attention as pa
from omchat_torch.ops.decode_attention import SPLIT_ROWS, decode_splits
from omchat_torch.ops.paged_attention import PAGE_SIZES, SPLIT_MAX_ROWS, SPLIT_TILE_ROWS, paged_splits

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


def _k3_splits_before_the_tile_argument(B, KVH, T, sms):
    """decode_splits as K3 and K6 had it before it took a tile: their cut must not move."""
    tiles = max(1, -(-T // 64))
    rows = min(tiles, max(1, tiles * B * KVH // sms)) * 64
    return max(1, -(-T // rows)), rows


@pytest.mark.parametrize("B,KVH,T,sms", SHAPES)
def test_k3_and_k6_splits_are_unchanged(B, KVH, T, sms):
    assert decode_splits(B, KVH, T, sms) == _k3_splits_before_the_tile_argument(B, KVH, T, sms)
    assert decode_splits(B, KVH, T, sms, tile=SPLIT_ROWS) == decode_splits(B, KVH, T, sms)
    if (B, KVH, T, sms) == (1, 4, 3328, 132):
        assert decode_splits(B, KVH, T, sms) == (52, 64)


# K12 and K13 at the serving engine's shapes: 16 slots of 4 kv heads over tables of 1-32 pages of 128 rows, and
# capacities that are no multiple of 128 (a width of 19 pages of 16 rows)
PAGED_SHAPES = [(16, 4, 20 * 128, 132), (16, 4, 128, 132), (16, 4, 32 * 128, 132), (1, 4, 3328, 132),
                (6, 4, 3328, 132), (4, 2, 19 * 16, 132), (3, 4, 1000 * 16, 114), (16, 4, 26 * 128, 8)]


def _k13_stage_rows() -> int:
    """The rows of one stage of K13's (and K12's) ring, as their shared header declares them."""
    src = os.path.join(os.path.dirname(__file__), "..", "omchat_torch", "csrc", "paged_decode_split.cuh")
    with open(src) as f:
        return int(re.search(r"constexpr int STAGE_ROWS = (\d+);", f.read()).group(1))


@pytest.mark.parametrize("B,KVH,cap,sms", PAGED_SHAPES)
def test_k13_chunks_are_multiples_of_its_stage(B, KVH, cap, sms):
    stage = _k13_stage_rows()
    _, rows = paged_splits(B, KVH, cap, sms)
    assert rows > 0 and rows % stage == 0 and rows % SPLIT_TILE_ROWS == 0


@pytest.mark.parametrize("B,KVH,cap,sms", PAGED_SHAPES)
def test_k13_every_row_lies_in_exactly_one_chunk(B, KVH, cap, sms):
    splits, rows = paged_splits(B, KVH, cap, sms)
    chunks = [range(s * rows, min((s + 1) * rows, cap)) for s in range(splits)]
    assert all(len(c) > 0 for c in chunks)
    assert [r for c in chunks for r in c] == list(range(cap))


@pytest.mark.parametrize("PS", PAGE_SIZES)
@pytest.mark.parametrize("B,KVH,cap,sms", PAGED_SHAPES)
def test_k13_chunks_start_on_page_boundaries(B, KVH, cap, sms, PS):
    """A chunk boundary is a page boundary at every page size the kernels are built for."""
    splits, rows = paged_splits(B, KVH, cap, sms)
    assert all((s * rows) % PS == 0 for s in range(splits))


@pytest.mark.parametrize("B,KVH,cap,sms", PAGED_SHAPES)
def test_k13_split_reads_only_the_capacity(B, KVH, cap, sms):
    """The same capacity in pages of any size is cut the same way (so page
    size 32 can compute page size 128's bits): decode_splits's rows for two
    blocks an SM, at most SPLIT_MAX_ROWS."""
    rows = min(decode_splits(B, KVH, cap, 2 * sms, tile=SPLIT_TILE_ROWS)[1], SPLIT_MAX_ROWS)
    assert paged_splits(B, KVH, cap, sms) == (-(-cap // rows), rows)
    for PS in PAGE_SIZES:
        if cap % PS == 0:
            assert paged_splits(B, KVH, (cap // PS) * PS, sms) == paged_splits(B, KVH, cap, sms)


def test_k13_serving_shape_spreads_the_longest_request():
    """The serving workload's 16 slots of 4 kv heads over 32-page tables (4096
    rows): 256-row chunks, at most 4 stages a block, so the workload's longest
    request (~2.5k rows) is read by 10 blocks a kv head; one long request
    alone is cut finer, into 128-row chunks, to fill the card."""
    assert paged_splits(16, 4, 32 * 128, 132) == (16, 256)
    assert paged_splits(1, 4, 32 * 128, 132) == (32, 128)
    assert all(paged_splits(*shape)[1] <= SPLIT_MAX_ROWS for shape in PAGED_SHAPES)


def _recorded_split_launch(monkeypatch, name, B, KVH, W, PS, sms, lengths):
    """The C entry ``pa._launch_split_decode`` would call for K12 or K13
    (``name``) on CPU operands of the given shape, recorded instead of
    launched: (source, entry, splits, rows)."""
    calls = []
    monkeypatch.setattr(pa, "_require_cuda", lambda *a, **kw: "")
    monkeypatch.setattr(pa, "num_sms", lambda index: sms)
    monkeypatch.setattr(pa.kernel_lib, "stream_ptr", lambda device=None: 0)
    monkeypatch.setattr(pa.kernel_lib, "launch", lambda source, entry, argtypes, *args: calls.append(
        (source, entry, args[17], args[18])))
    bf = torch.bfloat16
    q = torch.zeros(B, 1, KVH, 128, dtype=bf)
    kp = vp = torch.zeros(2, KVH, PS, 128, dtype=bf)
    kn = vn = torch.zeros(B, KVH, 128, dtype=bf)
    tables = torch.zeros(B, W, dtype=torch.int32)
    pa._launch_split_decode(name, q, kp, vp, torch.as_tensor(lengths, dtype=torch.int32), tables, kn, vn, 0)
    (call,) = calls
    return call


@pytest.mark.parametrize("PS", PAGE_SIZES)
@pytest.mark.parametrize("B,KVH,cap,sms", PAGED_SHAPES)
def test_k12_and_k13_take_their_split_from_one_function(monkeypatch, B, KVH, cap, sms, PS):
    """Both wrappers hand their C entry the (splits, rows) of paged_splits for
    the table's capacity, so the two kernels can never cut a capacity
    differently."""
    W = -(-cap // PS)
    want = paged_splits(B, KVH, W * PS, sms)
    for name, source in (("paged_flash_decode", "paged_flash_decode.cu"),
                         ("paged_flash_decode_manual", "paged_flash_decode_manual.cu")):
        got = _recorded_split_launch(monkeypatch, name, B, KVH, W, PS, sms, [W * PS] * B)
        assert got[0] == source and got[2:] == want


@pytest.mark.parametrize("B,KVH,cap,sms", PAGED_SHAPES)
def test_k12_chunking_reads_no_lengths(monkeypatch, B, KVH, cap, sms):
    """K12's cut is the same whatever the lengths (they live on the card):
    empty requests, full ones, ragged ones."""
    W = -(-cap // 128)
    cuts = {_recorded_split_launch(monkeypatch, "paged_flash_decode", B, KVH, W, 128, sms, lengths)[2:]
            for lengths in ([0] * B, [W * 128] * B, [(7 * b) % (W * 128 + 1) for b in range(B)])}
    assert cuts == {paged_splits(B, KVH, W * 128, sms)}
    assert list(inspect.signature(paged_splits).parameters) == ["B", "KVH", "capacity", "num_sms"]
