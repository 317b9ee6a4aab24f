"""The numpy radix spec must agree with stable sorting semantics."""

import numpy as np
import pytest

from inplacemsdradixsort.ops import radix_ref as rr


@pytest.mark.parametrize("n,tile,bits,shift", [
    (1000, 128, 4, 28),
    (4096, 512, 8, 24),
    (777, 256, 8, 0),
    (5000, 512, 6, 13),
])
def test_stable_dest_is_permutation(rng, n, tile, bits, shift):
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    d = rr.digits_of(keys, shift, bits)
    dest = rr.stable_dest(d, tile, 1 << bits)
    assert sorted(dest) == list(range(n))


@pytest.mark.parametrize("n,tile,bits", [(4096, 512, 8), (999, 128, 4)])
def test_partition_matches_stable_argsort(rng, n, tile, bits):
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    out, sizes = rr.partition(keys, 32 - bits, bits, tile)
    d = rr.digits_of(keys, 32 - bits, bits)
    expect = keys[np.argsort(d, kind="stable")]
    assert np.array_equal(out, expect)
    assert np.array_equal(sizes, np.bincount(d, minlength=1 << bits))


def test_cursors_match_bincount(rng):
    n, tile, bits = 3000, 256, 8
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    d = rr.digits_of(keys, 24, bits)
    hist = rr.tile_histograms(d, tile, 1 << bits)
    assert hist.sum() == n
    bases = rr.digit_bases(hist)
    assert bases[0] == 0
    assert np.all(np.diff(bases) == hist.sum(0)[:-1])


def test_padded_layout_invariants(rng):
    hist = rng.integers(0, 500, (7, 16)).astype(np.int64)
    slots, bstarts, bcaps = rr.padded_layout(hist, align=128)
    padded = ((hist + 127) // 128) * 128
    # slots lane-aligned, within bucket bounds, non-overlapping
    assert np.all(slots % 128 == 0)
    for d in range(16):
        assert slots[0, d] == bstarts[d]
        ends = slots[:, d] + padded[:, d]
        assert np.all(slots[1:, d] == ends[:-1])
        assert ends[-1] == bstarts[d] + bcaps[d]
