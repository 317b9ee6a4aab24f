#!/usr/bin/env python3
"""XLA's sort against one plain-XLA MSD partition level, on the card.

    python3 benchmarks/level_vs_xla_sort.py [--log-n 28] [--seed 0]
                                            [--iters 10]

Times, on uniform u32 keys:
  (a) ``jnp.sort`` of the keys;
  (b) ``lax.sort`` of (u32 key, u32 rid) pairs, ``num_keys=1``, stable;
  (c) one MSD partition level in plain XLA: a 256-bucket histogram of the
      top byte (``jnp.bincount``), its exclusive scan, and the scatter of
      keys and rids to destinations computed beforehand — the least any
      route step of an MSD engine must do.  Its two parts are also timed
      alone.
If (c) is not well under (a) and (b), no MSD engine built from such levels
can beat XLA's sort end to end on this card.

It also compiles (without running) the sort forms the package uses and
reports which became CUB radix-sort calls.  Every line is one JSON object
naming the card and its power limit; times are milliseconds on the host
clock around work that ends in ``block_until_ready``.  Exits non-zero
without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402

from inplacemsdradixsort.utils import compile_cache  # noqa: E402
from inplacemsdradixsort.utils.hlo import sort_lowering  # noqa: E402


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, args, iters):
    jax.block_until_ready(fn(*args))               # warm (compiled)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": float(np.median(ts)), "min_ms": min(ts),
            "max_ms": max(ts), "iters": iters}


def sort_keys(k):
    return jnp.sort(k)


def sort_pairs(k, r):
    return lax.sort((k, r), num_keys=1, is_stable=True)


def histogram_scan(k):
    hist = jnp.bincount(k >> np.uint32(24), length=256)
    return jnp.cumsum(hist) - hist


def scatter(k, r, dest):
    return (jnp.zeros_like(k).at[dest].set(k, unique_indices=True),
            jnp.zeros_like(r).at[dest].set(r, unique_indices=True))


def level(k, r, dest):
    return (histogram_scan(k),) + scatter(k, r, dest)


@jax.jit
def destinations(k):
    """Stable top-byte partition destinations (not timed)."""
    n = k.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    _, perm = lax.sort((k >> np.uint32(24), iota), num_keys=1,
                       is_stable=True)
    return jnp.zeros((n,), jnp.int32).at[perm].set(iota)


def lowering_table(log_n: int) -> list:
    """Which sort forms become CUB calls (compiled at 2^log_n, not run)."""
    n = 1 << log_n
    rows = []
    with jax.enable_x64(True):
        s = jax.ShapeDtypeStruct
        forms = {
            "jnp.sort u32": (sort_keys, (s((n,), jnp.uint32),)),
            "jnp.sort u64": (sort_keys, (s((n,), jnp.uint64),)),
            "jnp.sort i32": (sort_keys, (s((n,), jnp.int32),)),
            "jnp.sort f32": (sort_keys, (s((n,), jnp.float32),)),
            "lax.sort (u32, u32) num_keys=1": (
                sort_pairs, (s((n,), jnp.uint32), s((n,), jnp.uint32))),
            "lax.sort (u32, u64) num_keys=1": (
                sort_pairs, (s((n,), jnp.uint32), s((n,), jnp.uint64))),
            "lax.sort (u32, u32) num_keys=2": (
                lambda k, r: lax.sort((k, r), num_keys=2, is_stable=True),
                (s((n,), jnp.uint32), s((n,), jnp.uint32))),
            "lax.sort (i32, u32, u32) num_keys=1": (
                lambda d, k, r: lax.sort((d, k, r), num_keys=1,
                                         is_stable=True),
                (s((n,), jnp.int32), s((n,), jnp.uint32),
                 s((n,), jnp.uint32))),
        }
        for name, (fn, args) in forms.items():
            hlo = jax.jit(fn).lower(*args).compile().as_text()
            rows.append({"form": name, "log_n": log_n,
                         **sort_lowering(hlo)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-n", type=int, default=28)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    compile_cache.enable()
    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"level_vs_xla_sort: needs a GPU; found {d.platform}")
    where = {"card": card(), "device_kind": d.device_kind}

    n = 1 << args.log_n
    k = jax.random.bits(jax.random.key(args.seed), (n,), jnp.uint32)
    r = jnp.arange(n, dtype=jnp.uint32)
    dest = destinations(k)
    jk, jr = jax.jit(sort_pairs)(k, r)
    got = jax.jit(level)(k, r, dest)
    # the level's scatter is a stable top-byte partition: it agrees with
    # the sorted keys on the top byte, and its offsets with the sort's
    ok = bool(jnp.all((got[1] >> 24) == (jk >> 24))) and bool(
        jnp.all(got[0] == jnp.searchsorted(
            jk >> 24, jnp.arange(256, dtype=jnp.uint32))))
    del jk, jr, got
    if not ok:
        raise AssertionError("partition level disagrees with the sort")

    cells = {
        "a_jnp_sort_keys": (jax.jit(sort_keys), (k,)),
        "b_lax_sort_pairs": (jax.jit(sort_pairs), (k, r)),
        "c_level_total": (jax.jit(level), (k, r, dest)),
        "c_histogram_scan": (jax.jit(histogram_scan), (k,)),
        "c_scatter_keys_rids": (jax.jit(scatter), (k, r, dest)),
    }
    for name, (fn, fargs) in cells.items():
        print(json.dumps({"cell": name, "log_n": args.log_n, **where,
                          **time_ms(fn, fargs, args.iters)}), flush=True)
    for row in lowering_table(20):
        print(json.dumps({**row, **where}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
