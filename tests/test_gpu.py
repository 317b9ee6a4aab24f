"""On the card only (``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/``): the main path sorts correctly and XLA hands its sorts to
CUB's radix sort."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import inplacemsdradixsort as rs
from inplacemsdradixsort.utils.hlo import sort_lowering

pytestmark = pytest.mark.gpu
N = 1 << 20


def test_sort_matches_numpy_on_gpu(gpu):
    x = np.random.default_rng(0).integers(0, 2**32, N, dtype=np.uint32)
    assert np.array_equal(np.asarray(rs.sort(jnp.asarray(x)).keys),
                          np.sort(x))


def test_sort_with_indices_is_stable_on_gpu(gpu):
    x = np.random.default_rng(1).integers(0, 1000, N, dtype=np.uint32)
    k, r = rs.sort_with_indices(jnp.asarray(x))
    order = np.argsort(x, kind="stable")
    assert np.array_equal(np.asarray(r), order)
    assert np.array_equal(np.asarray(k), x[order])


@pytest.mark.parametrize("pairs", [False, True], ids=["keys", "pairs"])
def test_api_sort_lowers_to_cub(gpu, pairs):
    k = jax.ShapeDtypeStruct((N,), jnp.uint32)
    if pairs:
        fn = jax.jit(lambda a, b: rs.sort(a, b).rids)
        args = (k, jax.ShapeDtypeStruct((N,), jnp.uint32))
    else:
        fn, args = jax.jit(lambda a: rs.sort(a).keys), (k,)
    got = sort_lowering(fn.lower(*args).compile().as_text())
    assert got["cub_radix_sort"] >= 1 and got["xla_sort"] == 0, got
