"""Executable numpy spec of the radix-partition math.

This module is the oracle for partition code (tests, and the plain-XLA
level of ``benchmarks/level_vs_xla_sort.py``).  It spells out, in plain
vectorized numpy, the exact quantities a partition kernel computes:

- per-tile digit histograms                 (reference ``histogram``,
                                             /root/reference/src/msb_64.c:701-738)
- global digit bases + per-(tile,digit) write cursors — the deterministic
  replacement for the reference's atomic block claiming
  (``moved[p<<4]`` fetch-adds, msb_64.c:2027,2056)
- stable destination of every element (reference ``partition_known`` /
  ``partition_ip_buf`` semantics, msb_64.c:353-472, 785-978)
- an aligned ("padded") bucket layout, each (tile, digit) run rounded up
  to whole ``align``-element slots.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def digits_of(keys: np.ndarray, shift: int, bits: int) -> np.ndarray:
    return ((keys >> np.uint32(shift)) & np.uint32((1 << bits) - 1)).astype(
        np.int32
    )


def tile_histograms(
    digits: np.ndarray, tile: int, radix: int
) -> np.ndarray:
    """(ntiles, radix) counts; ntiles = ceil(n / tile), last tile short."""
    n = digits.shape[0]
    ntiles = -(-n // tile)
    hist = np.zeros((ntiles, radix), dtype=np.int64)
    for t in range(ntiles):
        d = digits[t * tile : (t + 1) * tile]
        hist[t] = np.bincount(d, minlength=radix)
    return hist


def digit_bases(hist: np.ndarray) -> np.ndarray:
    """Exclusive prefix of global digit totals (bucket start offsets)."""
    totals = hist.sum(axis=0)
    return np.concatenate([[0], np.cumsum(totals)[:-1]]).astype(np.int64)


def tile_cursors(hist: np.ndarray) -> np.ndarray:
    """(ntiles, radix) global write cursor for each tile's digit run.

    cursor[t, d] = digit_base[d] + sum_{t' < t} hist[t', d] — the
    deterministic analog of the reference's atomic destination claiming.
    """
    bases = digit_bases(hist)
    tile_prefix = np.cumsum(hist, axis=0) - hist
    return bases[None, :] + tile_prefix


def stable_dest(digits: np.ndarray, tile: int, radix: int) -> np.ndarray:
    """Destination index of every element under a stable radix partition."""
    hist = tile_histograms(digits, tile, radix)
    cursors = tile_cursors(hist)
    n = digits.shape[0]
    dest = np.empty(n, dtype=np.int64)
    for t in range(hist.shape[0]):
        lo, hi = t * tile, min((t + 1) * tile, n)
        d = digits[lo:hi]
        # rank within tile among equal digits (stable)
        order = np.argsort(d, kind="stable")
        ranks = np.empty_like(order)
        run_starts = np.concatenate([[0], np.cumsum(np.bincount(
            d, minlength=radix))[:-1]])
        ranks[order] = np.arange(hi - lo) - run_starts[d[order]]
        dest[lo:hi] = cursors[t, d] + ranks
    return dest


def partition(
    keys: np.ndarray, shift: int, bits: int, tile: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Full stable radix partition; returns (partitioned keys, bucket sizes).

    Semantically equal to one reference MSD pass (histogram + permute,
    msb_64.c:1023-1027) done out-of-place.
    """
    radix = 1 << bits
    d = digits_of(keys, shift, bits)
    dest = stable_dest(d, tile, radix)
    out = np.empty_like(keys)
    out[dest] = keys
    sizes = np.bincount(d, minlength=radix)
    return out, sizes


def padded_layout(
    hist: np.ndarray, align: int = 128
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Aligned arena layout for a scatter that writes whole slots.

    Each (tile, digit) run occupies an ``align``-aligned slot; each bucket is the
    concatenation of its slots.  Returns (slot_starts, bucket_starts,
    bucket_caps) where slot_starts[t, d] is the arena offset of tile t's run
    of digit d, bucket_starts[d] the arena offset of bucket d, and
    bucket_caps[d] its padded capacity.
    """
    padded = ((hist + align - 1) // align) * align
    bucket_caps = padded.sum(axis=0)
    bucket_starts = np.concatenate([[0], np.cumsum(bucket_caps)[:-1]])
    within = np.cumsum(padded, axis=0) - padded
    slot_starts = bucket_starts[None, :] + within
    return slot_starts, bucket_starts.astype(np.int64), bucket_caps
