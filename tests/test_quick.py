"""`pytest -m quick` — the fast CPU smoke subset.

One case each for the public API and the distributed sort, so in-loop
regressions surface fast; the full matrix stays in the per-module files.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from inplacemsdradixsort.config import SortConfig

pytestmark = pytest.mark.quick


def _keys(n=16_384, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, n, dtype=np.uint32)


def test_quick_dsort():
    from inplacemsdradixsort.parallel.dsort import distributed_sort
    from inplacemsdradixsort.parallel.mesh import make_sort_mesh
    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 virtual devices")
    mesh = make_sort_mesh(4)
    x = _keys(64_000, seed=4)
    res = distributed_sort(jnp.asarray(x), mesh=mesh)
    ks = np.asarray(jax.device_get(res.keys))
    cnts = np.asarray(jax.device_get(res.counts))
    got = np.concatenate([ks[i, :cnts[i]] for i in range(len(cnts))])
    assert np.array_equal(got, np.sort(x))


def test_quick_api():
    import inplacemsdradixsort as rs
    x = _keys(5_000, seed=5)
    res = rs.sort(jnp.asarray(x), config=SortConfig(engine="xla"))
    assert np.array_equal(np.asarray(res.keys), np.sort(x))
