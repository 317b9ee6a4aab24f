"""Public API tests: sort/check/mamalloc against oracles on all the
reference-motivated input distributions (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import inplacemsdradixsort as rs
from inplacemsdradixsort.config import SortConfig
from inplacemsdradixsort.models import distributions as dist
from inplacemsdradixsort.utils.checking import (
    check_permutation,
    checksum,
)

DISTS = ["uniform", "zipf075", "zipf100", "dup_heavy", "sorted", "reverse",
         "all_equal"]


@pytest.mark.parametrize("name", DISTS)
def test_sort_keys_matches_numpy(name):
    keys = dist.make(name, jax.random.key(0), 4096, dtype=jnp.uint32)
    res = rs.sort(keys)
    assert np.array_equal(np.asarray(res.keys), np.sort(np.asarray(keys)))


def test_sort_u64():
    # true 64-bit keys (the reference's native type, msb_64.h:37) need x64
    with jax.enable_x64(True):
        keys = jnp.asarray(
            np.random.default_rng(1).integers(
                0, 1 << 64, 2000, dtype=np.uint64
            )
        )
        res = rs.sort(keys)
        assert res.keys.dtype == jnp.uint64
        assert np.array_equal(np.asarray(res.keys), np.sort(np.asarray(keys)))


def test_sort_pairs_permutation_and_stability():
    keys = dist.dup_heavy(jax.random.key(2), 3000)
    sk, perm = rs.sort_with_indices(keys)
    assert check_permutation(sk, perm, keys)
    # stability: equal keys keep ascending original indices
    sk_np, p_np = np.asarray(sk), np.asarray(perm)
    for v in np.unique(sk_np):
        idx = p_np[sk_np == v]
        assert np.all(np.diff(idx.astype(np.int64)) > 0)


def test_check_key_eq_rid_trick():
    # the reference's same=1 mode: rids initialized equal to keys
    # (msb_64.c:2461)
    keys = dist.uniform(jax.random.key(3), 1000)
    res = rs.sort(keys, keys.astype(jnp.uint32))
    cs = rs.check(res.keys, res.rids, same=True,
                  input_checksum=checksum(keys))
    assert cs == checksum(res.keys)


def test_check_rejects_unsorted():
    bad = jnp.asarray(np.array([3, 1, 2], dtype=np.uint32))
    with pytest.raises(AssertionError):
        rs.check(bad)


def test_check_cross_shard_boundaries():
    a = jnp.asarray(np.array([1, 5], dtype=np.uint32))
    b = jnp.asarray(np.array([4, 9], dtype=np.uint32))
    with pytest.raises(AssertionError):
        rs.check([a, b])
    rs.check([a, jnp.asarray(np.array([5, 9], dtype=np.uint32))])


def test_mamalloc_padding():
    buf = rs.mamalloc(1000, fudge=1.125)
    assert buf.shape[0] >= 1125
    assert buf.shape[0] * buf.dtype.itemsize % rs.api.LINE_BYTES == 0
    with jax.enable_x64(True):
        wide = rs.mamalloc(1000, dtype=jnp.uint64)
        assert wide.dtype == jnp.uint64 and wide.shape[0] >= 1000
        assert wide.shape[0] * 8 % rs.api.LINE_BYTES == 0


def test_timing_report_rows():
    keys = dist.uniform(jax.random.key(4), 512)
    res = rs.sort(keys, timing=True)
    labels = [l for l, _ in res.times]
    assert labels == [
        "sample", "part_first", "part_blocks", "combine", "compact",
        "balance", "swap_online", "swap_offline", "inject", "local_sort",
    ]




@pytest.mark.parametrize("dtype", ["int32", "float32", "int64"])
def test_key_dtype_families(dtype):
    """i32/f32/i64 keys (the reference suite's 32/64-bit type families,
    Makefile:8-24) sort directly."""
    rng = np.random.default_rng(17)
    if dtype == "int32":
        x = rng.integers(-2**31, 2**31, 4096).astype(np.int32)
    elif dtype == "float32":
        x = rng.standard_normal(4096).astype(np.float32)
        x[:7] = [0.0, -0.0, np.inf, -np.inf, 1e-44, -1e-44, 3.5]
    else:
        x = rng.integers(-2**63, 2**63, 4096).astype(np.int64)
    with jax.enable_x64(dtype == "int64"):
        res = rs.sort(jnp.asarray(x))
        got = np.asarray(jax.device_get(res.keys))
    assert got.dtype == x.dtype
    assert np.array_equal(got, np.sort(x))


@pytest.mark.parametrize("engine", ["v4", "v5", "v3", "lsb", "pallas",
                                    "auto"])
def test_sort_rejects_removed_engine(engine):
    keys = jnp.arange(8, dtype=jnp.uint32)
    with pytest.raises(ValueError, match="unknown engine"):
        rs.sort(keys, config=SortConfig(engine=engine))


def test_sort_rejects_mismatched_rids():
    with pytest.raises(ValueError, match="rids shape"):
        rs.sort(jnp.arange(8, dtype=jnp.uint32),
                jnp.arange(7, dtype=jnp.uint32))


def test_sort_is_traceable():
    keys = dist.uniform(jax.random.key(9), 1000)
    got = jax.jit(lambda k: rs.sort(k).keys)(keys)
    assert np.array_equal(np.asarray(got), np.sort(np.asarray(keys)))


def test_sort_u64_rids_round_trip():
    # 64-bit payloads >= 2^32 ride along without truncation
    with jax.enable_x64(True):
        keys = dist.dup_heavy(jax.random.key(6), 2048)
        rids = jnp.arange(2048, dtype=jnp.uint64) + jnp.uint64(1 << 40)
        res = rs.sort(keys, rids)
        order = np.argsort(np.asarray(keys), kind="stable")
        assert res.rids.dtype == jnp.uint64
        assert np.array_equal(np.asarray(res.rids),
                              np.asarray(rids)[order])


def test_sort_keys_stable_only_below_the_xla_limit(monkeypatch):
    # past STABLE_MAX keys-only sorts ask XLA for its unstable sort (the
    # same result for keys alone); pairs stay stable
    from inplacemsdradixsort.ops import xla_engine
    monkeypatch.setattr(xla_engine, "STABLE_MAX", 100)
    x = np.random.default_rng(4).integers(0, 50, 1000, dtype=np.uint32)
    big = str(jax.make_jaxpr(xla_engine.sort_keys)(jnp.asarray(x)))
    small = str(jax.make_jaxpr(xla_engine.sort_keys)(jnp.asarray(x[:50])))
    assert "is_stable=False" in big and "is_stable=True" in small
    assert np.array_equal(np.asarray(rs.sort(jnp.asarray(x)).keys),
                          np.sort(x))
    pairs = str(jax.make_jaxpr(xla_engine.sort_pairs)(
        jnp.asarray(x), jnp.arange(1000, dtype=jnp.uint32)))
    assert "is_stable=True" in pairs
