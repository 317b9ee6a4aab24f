"""XLA-native sort engine — the single-chip local sort.

On the GPU, XLA rewrites a sort of fewer than 2^31 elements with one key
array (and at most one payload) into a call to CUB's device radix sort;
from 2^31 elements on it keeps its own comparison sort, and it refuses a
stable sort of that size.  ``chip_smoke.py`` reports which sorts reach
CUB.  Key+payload sorting mirrors the reference's (keys, rids) contract
(reference: /root/reference/include/msb_64.h:37-40).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

# the longest run XLA's GPU backend sorts stably
STABLE_MAX = 2**31 - 1


def sort_keys(keys: jax.Array) -> jax.Array:
    """Ascending keys.  Equal keys alone have no order to keep, so past
    ``STABLE_MAX`` the unstable sort gives the same result."""
    return jnp.sort(keys, stable=keys.shape[0] <= STABLE_MAX)


def sort_pairs(
    keys: jax.Array, rids: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Stable key+payload sort; at most ``STABLE_MAX`` pairs on the GPU."""
    k, r = jax.lax.sort((keys, rids), num_keys=1, is_stable=True)
    return k, r
