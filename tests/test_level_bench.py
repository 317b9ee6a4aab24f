"""benchmarks/level_vs_xla_sort.py on the CPU: its plain-XLA MSD level is
a stable top-byte partition (checked against the numpy spec), and it
refuses to time anything without a GPU."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from inplacemsdradixsort.ops import radix_ref as rr

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))
import level_vs_xla_sort as lv  # noqa: E402


@pytest.mark.parametrize("n", [1000, 4096])
def test_level_is_the_stable_top_byte_partition(n):
    keys = np.random.default_rng(n).integers(0, 2**32, n, dtype=np.uint32)
    k = jnp.asarray(keys)
    r = jnp.arange(n, dtype=jnp.uint32)
    starts, out_k, out_r = jax.jit(lv.level)(k, r, lv.destinations(k))
    want, sizes = rr.partition(keys, shift=24, bits=8, tile=n)
    assert np.array_equal(np.asarray(out_k), want)
    assert np.array_equal(keys[np.asarray(out_r)], want)
    assert np.array_equal(np.asarray(starts),
                          np.concatenate([[0], np.cumsum(sizes)[:-1]]))


def test_lowering_table_covers_the_package_sort_forms():
    rows = lv.lowering_table(8)
    assert {r["form"] for r in rows} >= {
        "jnp.sort u32", "lax.sort (u32, u64) num_keys=1",
        "lax.sort (u32, u32) num_keys=2"}
    assert all(r["xla_sort"] == 1 for r in rows)        # XLA:CPU


def test_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        lv.main(["--log-n", "10"])
