"""Headline benchmark: keys/sec of ``rs.sort`` on uniform 32-bit keys, one
GPU.

    BENCH_LOGN=28 python bench.py

Prints exactly ONE JSON line:
    {"metric": ..., "value": N, "unit": "keys/s", "vs_baseline": N,
     "engine": ..., "device": ..., "card": ...}

``vs_baseline`` = ``rs.sort`` throughput / ``jnp.sort`` throughput on the
same card and input.  The sort engine is XLA's own sort, so this is about
1.0 until an engine of this package beats it.  ``card`` is the name and
power limit ``nvidia-smi`` reports.  Exits non-zero without a GPU or when
the result fails its gate (ascending, same multiset as the input).
Details go to stderr.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

import inplacemsdradixsort as rs
from inplacemsdradixsort.utils import checking, compile_cache

LOG = lambda *a: print(*a, file=sys.stderr, flush=True)


def time_fn(f, iters=5):
    jax.block_until_ready(f())  # warm
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(f())
    return (time.perf_counter() - t0) / iters


def main():
    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU; JAX found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    engine = rs.DEFAULT_CONFIG.engine
    logn = int(os.environ.get("BENCH_LOGN", "28"))
    n = 1 << logn
    LOG(f"bench: 2^{logn} uniform uint32 keys, engine {engine}, on {card}")
    keys = jax.random.bits(jax.random.key(0), (n,), dtype=jnp.uint32)
    ours = jax.jit(lambda k: rs.sort(k).keys)
    out = jax.block_until_ready(ours(keys))
    if not (checking.device_is_sorted(out)
            and checking.fingerprint(out) == checking.fingerprint(keys)):
        raise SystemExit(f"bench: engine {engine} failed its gate")
    del out

    t_ours = time_fn(lambda: ours(keys))
    t_base = time_fn(lambda: jnp.sort(keys))
    LOG(f"rs.sort: {t_ours*1e3:.3f} ms  jnp.sort: {t_base*1e3:.3f} ms")
    print(json.dumps({
        "metric": f"keys/sec, 2^{logn} uniform u32, 1 GPU",
        "value": n / t_ours,
        "unit": "keys/s",
        "vs_baseline": t_base / t_ours,
        "engine": engine,
        "device": dev.device_kind,
        "card": card,
    }))


if __name__ == "__main__":
    main()
