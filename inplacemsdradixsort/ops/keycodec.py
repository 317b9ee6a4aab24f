"""Order-preserving key codecs.

Bijections that map other key types onto unsigned words whose integer
order is the keys' order — the counterpart of the reference's
signed-compare bias trick (msb_64.c:248-251), extended to the type
families the original benchmark suite enumerated
(/root/reference/README.md:19-33, /root/reference/Makefile:8-24: 32/64-bit
variants).  ``api.sort`` sorts float32 keys as their ``encode_f32`` codes;
the u64 (hi, lo) split serves host-side fixtures and checks.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def encode_i32(x: jax.Array) -> jax.Array:
    """int32 -> order-preserving uint32."""
    return jax.lax.bitcast_convert_type(x, jnp.uint32) ^ np.uint32(
        0x80000000
    )


def decode_i32(u: jax.Array) -> jax.Array:
    return jax.lax.bitcast_convert_type(
        u ^ np.uint32(0x80000000), jnp.int32
    )


def encode_f32(x: jax.Array) -> jax.Array:
    """float32 -> order-preserving uint32 (IEEE total order; -0 < +0,
    NaNs sort above +inf by payload)."""
    u = jax.lax.bitcast_convert_type(x, jnp.uint32)
    mask = jnp.where(
        (u >> np.uint32(31)) != 0,
        np.uint32(0xFFFFFFFF),
        np.uint32(0x80000000),
    )
    return u ^ mask


def decode_f32(u: jax.Array) -> jax.Array:
    mask = jnp.where(
        (u >> np.uint32(31)) != 0,
        np.uint32(0x80000000),
        np.uint32(0xFFFFFFFF),
    )
    return jax.lax.bitcast_convert_type(u ^ mask, jnp.float32)


def split_u64(x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """uint64 -> (hi, lo) uint32 words (requires x64 for the input array)."""
    hi = (x >> np.uint64(32)).astype(jnp.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    return hi, lo


def join_u64(hi: jax.Array, lo: jax.Array) -> jax.Array:
    return (hi.astype(jnp.uint64) << np.uint64(32)) | lo.astype(jnp.uint64)


def split_u64_host(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return (x >> np.uint64(32)).astype(np.uint32), (
        x & np.uint64(0xFFFFFFFF)
    ).astype(np.uint32)


def join_u64_host(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
