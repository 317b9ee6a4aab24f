"""Input data models — the rebuilt generator suite.

The reference Makefile names generator sources ``init.c``, ``zipf.c``,
``shuffle.c`` that are absent from the repository (reference:
/root/reference/Makefile:8-24, README.md:19-33 limitations 5-6).  This module
rebuilds that capability: uniform, Zipfian (theta = 0.75 / 1.0), duplicate-
heavy, pre-sorted, reverse-sorted and all-equal inputs, for uint32 and uint64
keys, generated either on device (jax, fast at benchmark scale) or on host
(numpy, reference-MT-compatible for parity fixtures via utils.rng).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import rng as _rng


# ---------------------------------------------------------------- device-side

def uniform(key: jax.Array, n: int, dtype=jnp.uint32) -> jax.Array:
    """Uniform random keys over the full dtype domain."""
    return jax.random.bits(key, (n,), dtype=jnp.uint32).astype(dtype) if (
        dtype == jnp.uint32
    ) else _uniform64(key, n)


def _uniform64(key: jax.Array, n: int) -> jax.Array:
    hi, lo = jax.random.split(key)
    h = jax.random.bits(hi, (n,), dtype=jnp.uint32)
    l = jax.random.bits(lo, (n,), dtype=jnp.uint32)
    return (h.astype(jnp.uint64) << np.uint64(32)) | l.astype(jnp.uint64)


def zipf_table(num_items: int, theta: float) -> np.ndarray:
    """CDF table for a Zipf(theta) distribution over ``num_items`` ranks.

    P(rank i) ∝ 1 / i^theta, i = 1..num_items — the standard Zipfian model
    the reference's absent ``zipf.c`` implemented (README.md:32-33 limits the
    original generators to 32-bit keys and theta in {0.75, 1.0}).
    """
    ranks = np.arange(1, num_items + 1, dtype=np.float64)
    w = 1.0 / np.power(ranks, theta)
    cdf = np.cumsum(w)
    return (cdf / cdf[-1]).astype(np.float32)


def zipf(
    key: jax.Array,
    n: int,
    theta: float = 0.75,
    num_items: int = 1 << 20,
    dtype=jnp.uint32,
    shuffle_values: bool = True,
) -> jax.Array:
    """Zipfian keys: ranks drawn by inverse-CDF, mapped to key values.

    ``shuffle_values`` maps ranks to pseudo-random key values (a fixed hash)
    so that frequent keys are not clustered at the bottom of the key domain —
    this is what makes Zipfian inputs stress splitter selection the way the
    reference's skew handling expects (msb_64.c:1304-1322, 1545-1564).

    Draws are chunked at 2^26, which bounds the float draws and the
    search's temporaries to one chunk at card-filling sizes.
    """
    cdf = jnp.asarray(zipf_table(num_items, theta))
    CH = 1 << 26
    if n > CH:
        parts = []
        done = 0
        i = 0
        while done < n:
            m = min(CH, n - done)
            parts.append(zipf(jax.random.fold_in(key, i), m, theta,
                              num_items, dtype, shuffle_values))
            done += m
            i += 1
        return jnp.concatenate(parts)
    u = jax.random.uniform(key, (n,), dtype=jnp.float32)
    ranks = jnp.searchsorted(cdf, u).astype(jnp.uint32)
    if shuffle_values:
        vals = _hash_u32(ranks)
    else:
        vals = ranks
    if dtype == jnp.uint32:
        return vals.astype(jnp.uint32)
    return vals.astype(jnp.uint64) << np.uint64(32) | _hash_u32(
        vals
    ).astype(jnp.uint64)


def _hash_u32(x: jax.Array) -> jax.Array:
    """Finalizer-style 32-bit mix (splittable, collision-free permutation)."""
    x = x.astype(jnp.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def dup_heavy(key: jax.Array, n: int, distinct: int = 17, dtype=jnp.uint32):
    """Few distinct values — stresses the duplicate-aware splitter shift
    (msb_64.c:1313-1320)."""
    v = jax.random.randint(key, (n,), 0, distinct, dtype=jnp.int32)
    return _hash_u32(v.astype(jnp.uint32)).astype(dtype)


def presorted(n: int, dtype=jnp.uint32) -> jax.Array:
    return jnp.arange(n, dtype=jnp.uint32).astype(dtype)


def reverse_sorted(n: int, dtype=jnp.uint32) -> jax.Array:
    return jnp.arange(n - 1, -1, -1, dtype=jnp.int32).astype(dtype)


def all_equal(n: int, value: int = 0xDEADBEEF, dtype=jnp.uint32):
    return jnp.full((n,), value, dtype=dtype)


# ------------------------------------------------------------------ host-side

def uniform_reference(seed: int, n: int, dtype=np.uint32) -> np.ndarray:
    """Host uniform keys from the reference-compatible MT19937-64 stream
    (rand.c:47-86) — for bitwise parity fixtures against the reference."""
    if dtype == np.uint32:
        return _rng.uniform_u32(seed, n)
    return _rng.uniform_u64(seed, n)


NAMED = {
    "uniform": uniform,
    "zipf075": partial(zipf, theta=0.75),
    "zipf100": partial(zipf, theta=1.0),
    "dup_heavy": dup_heavy,
}


def make(name: str, key: jax.Array, n: int, dtype=jnp.uint32) -> jax.Array:
    if name == "sorted":
        return presorted(n, dtype)
    if name == "reverse":
        return reverse_sorted(n, dtype)
    if name == "all_equal":
        return all_equal(n, dtype=dtype)
    return NAMED[name](key, n, dtype=dtype)
