"""Order-preserving codecs + u64 keys through the main path."""

import jax
import jax.numpy as jnp
import numpy as np

import inplacemsdradixsort as rs
from inplacemsdradixsort.ops import keycodec as kc


def _sort_u64(x):
    with jax.enable_x64(True):
        return np.asarray(jax.device_get(rs.sort(jnp.asarray(x)).keys))


def test_i32_codec(rng):
    x = rng.integers(-(1 << 31), 1 << 31, 4096, dtype=np.int32)
    u = np.asarray(kc.encode_i32(jnp.asarray(x)))
    assert np.array_equal(np.argsort(u, kind="stable"),
                          np.argsort(x, kind="stable"))
    assert np.array_equal(np.asarray(kc.decode_i32(jnp.asarray(u))), x)


def test_f32_codec(rng):
    x = rng.normal(size=4096).astype(np.float32)
    x[:4] = [0.0, -0.0, np.inf, -np.inf]
    u = np.asarray(kc.encode_f32(jnp.asarray(x)))
    order_u = np.argsort(u, kind="stable")
    assert np.all(np.diff(x[order_u]) >= 0)
    back = np.asarray(kc.decode_f32(jnp.asarray(u)))
    assert np.array_equal(back.view(np.uint32), x.view(np.uint32))


def test_u64_split_join(rng):
    x = rng.integers(0, 1 << 64, 1000, dtype=np.uint64)
    hi, lo = kc.split_u64_host(x)
    assert np.array_equal(kc.join_u64_host(hi, lo), x)


def test_engine_u64(rng):
    x = rng.integers(0, 1 << 64, 12000, dtype=np.uint64)
    # include duplicates in the high word and the all-ones edge key
    x[:3000] = (x[0] & np.uint64(0xFFFFFFFF00000000)) | rng.integers(
        0, 1 << 32, 3000, dtype=np.uint64
    )
    x[:5] = np.uint64(0xFFFFFFFFFFFFFFFF)
    got = _sort_u64(x)
    assert got.dtype == np.uint64
    assert np.array_equal(got, np.sort(x))


def test_engine_u64_equal_hi_oversized(rng):
    # every key shares the high word: the order is all in the low word
    n = 16000
    x = (np.uint64(0xABCD1234) << np.uint64(32)) | rng.integers(
        0, 1 << 32, n, dtype=np.uint64
    )
    assert np.array_equal(_sort_u64(x), np.sort(x))
