"""Splitter / delimiter selection tests (reference msb_64.c:1304-1322,
1545-1564 semantics)."""

import jax.numpy as jnp
import numpy as np
import pytest

from inplacemsdradixsort.ops import splitters as sp


def test_extract_delimiters_quantiles(rng):
    s = np.sort(rng.integers(0, 1 << 32, 10000, dtype=np.uint32))
    d = np.asarray(sp.extract_delimiters(jnp.asarray(s), 63))
    assert d.shape == (63,)
    assert np.all(np.diff(d.astype(np.int64)) >= 0)
    # splits roughly balance the sample
    counts = np.searchsorted(s, d, side="right")
    share = np.diff(np.concatenate([[0], counts, [len(s)]]))
    assert share.max() < len(s) / 64 * 3


def test_extract_delimiters_duplicate_shift():
    # a huge run of one value: the splitter landing inside the run with more
    # duplicates after than before must step down by 1 (msb_64.c:1313-1320)
    s = np.sort(
        np.concatenate([
            np.arange(100, dtype=np.uint32),
            np.full(900, 500, dtype=np.uint32),
        ])
    )
    d = np.asarray(sp.extract_delimiters(jnp.asarray(s), 3))
    # picks at ~250/500/750 all hit the 500-run; with more mass after the
    # pick they shift to 499 so the run lands in one range
    assert 499 in d.tolist()


def test_hybrid_delimiters_sentinel_and_sorted(rng):
    s = np.sort(rng.integers(0, 1 << 32, 5000, dtype=np.uint32))
    d = np.asarray(sp.hybrid_delimiters(jnp.asarray(s), 128, 32))
    assert d.shape == (128,)
    assert d[-1] == 0xFFFFFFFF
    assert np.all(np.diff(d.astype(np.int64)) >= 0)


def test_radix_delimiters_constant_top_bits():
    d = np.asarray(sp.radix_delimiters(64, 32))
    # each delimiter ends a range with constant top-6 bits
    # ((p+1)<<26)-1 — msb_64.c:1559-1563 analog
    assert np.array_equal(
        d, ((np.arange(1, 65, dtype=np.uint64) << 26) - 1).astype(np.uint32)
    )


def test_classify_matches_semantics(rng):
    s = np.sort(rng.integers(0, 1 << 32, 4000, dtype=np.uint32))
    d = np.asarray(sp.hybrid_delimiters(jnp.asarray(s), 32, 32))
    keys = rng.integers(0, 1 << 32, 1000, dtype=np.uint32)
    r = np.asarray(sp.classify(jnp.asarray(keys), jnp.asarray(d)))
    # range p holds keys with d[p-1] < k <= d[p]
    assert np.all(keys <= d[r])
    nz = r > 0
    assert np.all(keys[nz] > d[r[nz] - 1])


def test_destination_map(rng):
    s = np.sort(rng.integers(0, 1 << 32, 8000, dtype=np.uint32))
    delims = sp.hybrid_delimiters(jnp.asarray(s), 64, 32)
    bounds = sp.shard_delimiters(jnp.asarray(s), 4)
    dest = np.asarray(sp.destination_map(delims, bounds))
    assert dest.shape == (64,)
    assert np.all(np.diff(dest) >= 0)
    assert dest.min() >= 0 and dest.max() <= 3
