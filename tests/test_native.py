"""Native C++ runtime: MT parity with the reference stream, verifier."""

import numpy as np
import pytest

from inplacemsdradixsort.utils import native
from inplacemsdradixsort.utils import rng as pyrng

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native lib unavailable (no compiler)"
)


def test_mt64_matches_python_spec():
    a = native.mt64_stream(42, 700)
    b = pyrng.mt64_stream(42, 700)
    assert np.array_equal(a, b)


def test_mt64_canonical():
    out = native.mt64_stream(5489, 1)
    assert int(out[0]) == 14514284786278117030


def test_uniform_u32_serial_matches():
    a = native.uniform_u32(7, 512, parallel=False)
    b = pyrng.uniform_u32(7, 512)
    assert np.array_equal(a, b)


def test_zipf_skew():
    z = native.zipf_u32(1, 100000, theta=1.0, num_items=1 << 16)
    # heavy skew: the most frequent value covers a large share
    _, counts = np.unique(z, return_counts=True)
    assert counts.max() > 100000 * 0.05


def test_check_sorted(rng):
    x = np.sort(rng.integers(0, 1 << 32, 100000, dtype=np.uint32))
    ok, cs = native.check_sorted(x, threads=4)
    assert ok
    assert cs == int(x.astype(np.uint64).sum())
    x[50000] = 0
    ok2, _ = native.check_sorted(x, threads=4)
    assert not ok2


def test_check_same(rng):
    x = rng.integers(0, 1 << 32, 5000, dtype=np.uint32)
    assert native.check_same(x, x.copy())
    y = x.copy()
    y[17] ^= 1
    assert not native.check_same(x, y)
