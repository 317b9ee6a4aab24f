"""Distributed sort over the 8-virtual-device CPU mesh (SURVEY.md §4d)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from inplacemsdradixsort.config import SortConfig
from inplacemsdradixsort.models import distributions as dist
from inplacemsdradixsort.parallel import dsort
from inplacemsdradixsort.parallel.mesh import make_sort_mesh


def _mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple (virtual) devices")
    return make_sort_mesh()


@pytest.mark.parametrize("name", ["uniform", "zipf075", "dup_heavy",
                                  "sorted", "reverse"])
def test_distributed_sort(name):
    mesh = _mesh()
    n = 1 << 16
    keys = dist.make(name, jax.random.key(0), n, dtype=jnp.uint32)
    res = dsort.distributed_sort(keys, mesh=mesh)
    got = dsort.gather_sorted(res)
    assert got.shape[0] == n
    assert np.array_equal(got, np.sort(np.asarray(keys)))
    dsort.check_distributed(res)


def test_distributed_sort_all_equal_overflow_retry():
    # all-equal keys overflow any fudge-capped exchange: one shard receives
    # everything; the exchange is sized from the exact count matrix
    mesh = _mesh()
    n = 1 << 12
    keys = jnp.full((n,), 12345, jnp.uint32)
    res = dsort.distributed_sort(keys, mesh=mesh)
    got = dsort.gather_sorted(res)
    assert np.array_equal(got, np.asarray(keys))


def test_distributed_pairs_permutation():
    mesh = _mesh()
    n = 1 << 14
    keys = dist.dup_heavy(jax.random.key(1), n)
    rids = jnp.arange(n, dtype=jnp.uint32)
    res = dsort.distributed_sort(keys, rids, mesh=mesh)
    ks = np.asarray(jax.device_get(res.keys))
    rs_ = np.asarray(jax.device_get(res.rids))
    cnt = np.asarray(jax.device_get(res.counts))
    got_k = np.concatenate([ks[i, : cnt[i]] for i in range(ks.shape[0])])
    got_r = np.concatenate([rs_[i, : cnt[i]] for i in range(rs_.shape[0])])
    kn = np.asarray(keys)
    assert np.array_equal(got_k, np.sort(kn))
    # permutation integrity: keys[rids] == sorted keys
    assert np.array_equal(kn[got_r], got_k)


def test_distributed_host_chip_mesh():
    """2-level (hosts, chips) topology: collectives over the combined
    axes (the NUMAxthread analog, msb_64.c:206-237)."""
    from inplacemsdradixsort.parallel.mesh import make_host_chip_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_host_chip_mesh(2, 4)
    n = 1 << 16
    keys = dist.make("uniform", jax.random.key(7), n, dtype=jnp.uint32)
    res = dsort.distributed_sort(keys, mesh=mesh)
    got = dsort.gather_sorted(res)
    assert np.array_equal(got, np.sort(np.asarray(keys)))
    dsort.check_distributed(res)


def test_distributed_timing_report():
    mesh = _mesh()
    keys = dist.uniform(jax.random.key(2), 1 << 13)
    res = dsort.distributed_sort(keys, mesh=mesh, timing=True)
    labels = [l for l, _ in res.times]
    assert "sample" in labels and "balance" in labels
    assert sum(t for _, t in res.times) > 0


def test_make_sort_mesh_refuses_undersized_backend():
    # requesting more shards than the backend has devices must fail loudly
    # (a silently shrunk mesh made dryrun_multichip(8) "pass" on 1 chip)
    have = len(jax.devices())
    with pytest.raises(RuntimeError, match="need"):
        make_sort_mesh(have + 1)


def test_ragged_exchange_skew_and_parity():
    """10:1 skewed destinations: the ragged exchange must (a) match the
    dense path bitwise, and (b) keep the receive buffer within ~1.25x
    the worst shard's exact receive total (the dense path's compaction
    source was S x max-segment) — SURVEY §2.6.4, msb_64.c:1672-2158."""
    mesh = _mesh()
    S = mesh.devices.size
    rng = np.random.default_rng(42)
    n = S * 8192
    # 10:1 skew towards the top range: 10/11 of keys >= 0xF000_0000
    hot = rng.integers(0xF0000000, 0xFFFFFFFF, (10 * n) // 11,
                       dtype=np.uint32)
    cold = rng.integers(0, 2**32, n - hot.shape[0], dtype=np.uint32)
    keys = np.concatenate([hot, cold])
    rng.shuffle(keys)
    keys = jnp.asarray(keys)

    res_r = dsort.distributed_sort(
        keys, mesh=mesh, config=SortConfig(ragged_exchange=True))
    res_d = dsort.distributed_sort(
        keys, mesh=mesh, config=SortConfig(ragged_exchange=False))
    got_r = dsort.gather_sorted(res_r)
    got_d = dsort.gather_sorted(res_d)
    assert np.array_equal(got_r, np.sort(np.asarray(keys)))
    assert np.array_equal(got_r, got_d)
    # receive-buffer economy: per-shard buffer <= 1.25x worst exact total
    worst = int(np.asarray(jax.device_get(res_r.counts)).max())
    assert res_r.keys.shape[1] <= max(128, int(1.25 * worst))


def test_ragged_exchange_pairs():
    mesh = _mesh()
    n = 1 << 14
    rng = np.random.default_rng(3)
    keys = jnp.asarray(rng.integers(0, 1000, n, dtype=np.uint32))
    rids = jnp.arange(n, dtype=jnp.uint32)
    res = dsort.distributed_sort(
        keys, rids, mesh=mesh, config=SortConfig(ragged_exchange=True))
    got_k = dsort.gather_sorted(res)
    got_r = dsort.gather_rids(res)
    order = np.lexsort((np.asarray(rids), np.asarray(keys)))
    assert np.array_equal(got_k, np.asarray(keys)[order])
    assert np.array_equal(got_r, np.asarray(rids)[order])
