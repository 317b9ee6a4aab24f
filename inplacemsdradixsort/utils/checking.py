"""Post-hoc verification — the ``check()`` / ``check_thread()`` analog.

The reference verifier (reference: /root/reference/src/msb_64.c:2432-2505)
runs a parallel scan asserting (a) ascending order within each thread chunk,
(b) ``key == rid`` payload integrity when requested, (c) ascending order
across NUMA-node boundaries, and returns an additive checksum the caller
compares against the input's checksum.

Here the same checks run as vectorized device code; the distributed variant
in ``parallel.dsort`` adds the cross-shard boundary check via collectives.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def checksum(keys) -> int:
    """Additive mod-2^64 checksum (msb_64.c:2456-2466 ``sum += key``).

    Computed on host; uint64 wraparound gives the mod-2^64 semantics of the
    reference's ``uint64_t sum`` accumulator.
    """
    host = np.asarray(jax.device_get(keys)).astype(np.uint64)
    return int(host.sum(dtype=np.uint64))


def is_sorted(keys: jax.Array) -> jax.Array:
    """True iff keys are ascending (msb_64.c:2461 ``assert(key >= pkey)``)."""
    if keys.shape[0] <= 1:
        return jnp.asarray(True)
    return jnp.all(keys[1:] >= keys[:-1])


def check(
    keys,
    rids: Optional[jax.Array] = None,
    same: bool = False,
    input_checksum=None,
) -> int:
    """Verify a sorted (keys, rids) result; returns the checksum.

    Mirrors the reference ``check(keys, rids, size, numa, same)``
    (msb_64.c:2470-2505):
      - asserts ascending order,
      - if ``same``, asserts key == rid elementwise (the reference's
        payload-integrity trick where rids were initialized equal to keys),
      - returns the additive checksum for comparison against the input's.

    Accepts a single array or a list of per-shard arrays (the analog of the
    reference's per-NUMA-node arrays, include/msb_64.h:37), asserting
    cross-shard boundary order like msb_64.c:2493-2494.
    """
    shards = keys if isinstance(keys, (list, tuple)) else [keys]
    rshards = (
        rids if isinstance(rids, (list, tuple)) else [rids] * len(shards)
    )
    total = 0
    prev_last = None
    for k, r in zip(shards, rshards):
        k = jnp.asarray(k)
        if not bool(is_sorted(k)):
            raise AssertionError("keys are not ascending within shard")
        if same:
            if r is None:
                raise AssertionError("same=True requires rids")
            if not bool(jnp.all(k == jnp.asarray(r).astype(k.dtype))):
                raise AssertionError("key != rid payload mismatch")
        if prev_last is not None and k.shape[0] > 0:
            if not bool(k[0] >= prev_last):
                raise AssertionError("cross-shard boundary out of order")
        if k.shape[0] > 0:
            prev_last = k[-1]
        total = (total + int(checksum(k))) % (1 << 64)
    if input_checksum is not None:
        if total != int(input_checksum) % (1 << 64):
            raise AssertionError(
                f"checksum mismatch: {total} != {int(input_checksum)}"
            )
    return total


def check_permutation(sorted_keys, sorted_rids, orig_keys) -> bool:
    """Payload-permutation integrity: sorted_keys == orig_keys[sorted_rids].

    Stronger than the reference's key==rid trick: verifies the rid payload is
    exactly the permutation that sorts the input.
    """
    orig = jnp.asarray(orig_keys)
    gathered = jnp.take(orig, jnp.asarray(sorted_rids).astype(jnp.int32))
    return bool(jnp.all(gathered == jnp.asarray(sorted_keys)))


# ------------------------------------------------------------ device gates
#
# check() fetches the whole array to the host.  At card-filling sizes the
# gates below run on the device instead and fetch only scalars: ascending
# order, a multiset fingerprint (count, sum mod 2^64 and a sum of mixed
# hashes mod 2^64, compared between input and output), and for
# (key, rid) results the permutation, payload and stability invariants.
# They switch on 64-bit types themselves; 64-bit inputs need the caller's
# ``jax.enable_x64`` to exist at all.


def _words_u64(x: jax.Array) -> jax.Array:
    """Each element's bits as one uint64 word (x64 must be on)."""
    if x.dtype.itemsize == 8:
        return jax.lax.bitcast_convert_type(x, jnp.uint64)
    if x.dtype.itemsize == 4:
        return jax.lax.bitcast_convert_type(x, jnp.uint32).astype(jnp.uint64)
    raise TypeError(f"unsupported dtype {x.dtype}")


def _mix64(z: jax.Array) -> jax.Array:
    """SplitMix64 finalizer: a bijective mix of a uint64 word."""
    z = z + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@jax.jit
def _fingerprint(x, counts):
    if counts is None:
        valid = jnp.ones(x.shape, jnp.bool_)
    else:
        valid = (jnp.arange(x.shape[-1])[None, :] < counts[:, None])
    w = jnp.where(valid, _words_u64(x), np.uint64(0))
    h = jnp.where(valid, _mix64(_words_u64(x)), np.uint64(0))
    return (jnp.sum(valid, dtype=jnp.int64), jnp.sum(w, dtype=jnp.uint64),
            jnp.sum(h, dtype=jnp.uint64))


def fingerprint(x: jax.Array, counts: Optional[jax.Array] = None):
    """(count, sum mod 2^64, hash sum mod 2^64) of the elements of ``x``,
    computed on device.  With ``counts``, ``x`` is (S, cap) and only the
    first ``counts[i]`` elements of row i count (distributed_sort's
    per-shard runs).  Equal multisets give equal fingerprints; a dropped,
    duplicated or altered element changes the count or, but for a 2^-64
    chance, the hash sum."""
    with jax.enable_x64(True):
        c, s, h = jax.device_get(_fingerprint(x, counts))
    return int(c), int(s), int(h)


@jax.jit
def _ascending(x):
    return jnp.all(x[1:] >= x[:-1])


def device_is_sorted(x: jax.Array) -> bool:
    """Ascending order along the last axis, checked on device."""
    if x.shape[-1] <= 1:
        return True
    return bool(jax.device_get(_ascending(x)))


@jax.jit
def _pair_gates(keys_in, keys_out, rids_out):
    n = keys_in.shape[0]
    in_range = jnp.all(rids_out < n)
    seen = jnp.zeros((n,), jnp.bool_).at[rids_out].set(
        True, mode="drop")
    payload = jnp.all(
        jnp.take(keys_in, rids_out, mode="clip") == keys_out)
    stable = jnp.all((keys_out[1:] != keys_out[:-1])
                     | (rids_out[1:] > rids_out[:-1]))
    return {"rids_permutation": in_range & jnp.all(seen),
            "payload": payload, "stable": stable}


def pair_gates(keys_in: jax.Array, keys_out: jax.Array,
               rids_out: jax.Array) -> dict:
    """Invariants of a stable (key, rid) sort whose input rids were
    ``arange(n)``, checked on device: ``rids_out`` is a permutation of
    ``arange(n)``, ``keys_in[rids_out] == keys_out``, and rids ascend
    within every run of equal keys."""
    with jax.enable_x64(True):
        got = jax.device_get(_pair_gates(keys_in, keys_out, rids_out))
    return {k: bool(v) for k, v in got.items()}
