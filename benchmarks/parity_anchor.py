"""BASELINE config 1: bitwise parity vs the rebuilt reference binary.

Runs (or reuses) the reference ``msb_64`` with the reconstructed driver,
then sorts the identical key stream with ``rs.sort`` (u64 keys) and
compares:

  - input checksum (sum of keys mod 2^64) — stream identity
  - output checksum — element conservation
  - bitwise equality of the full sorted key sequence

Two input classes (the correctness contract in BASELINE.md names
"uniform & Zipfian inputs"):

  uniform — the reference generates its own MT19937-64 stream (seed 42,
      rand.c); our side regenerates the identical stream via
      utils.rng.uniform_u64 (fixture-verified MT parity).
  zipf100 / zipf075 — OUR Zipfian generator (models.distributions.zipf,
      theta=1.0/0.75 over 2^20 ranks, u64) is dumped to a binary file
      and fed to the reference via the driver's REF_INPUT hook; both
      engines then sort the same multiset from the same file.

Appends a row per (logn, dist) to ``benchmarks/parity_anchor.json``.
Usage:

  python benchmarks/parity_anchor.py [logn] [dist]   # default 27 uniform

The reference hard-codes 64 threads and needs per-thread chunks of >=
128 blocks (msb_64.c:1569, 2266), so logn >= 25.
"""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LOGN = int(sys.argv[1]) if len(sys.argv) > 1 else 27
DIST = sys.argv[2] if len(sys.argv) > 2 else "uniform"
OUT = os.environ.get("OUT", "/tmp/refbench")
TAG = f"{LOGN}" if DIST == "uniform" else f"{LOGN}_{DIST}"
DUMP = os.path.join(OUT, f"ref_sorted_{TAG}.u64")
INPUT = None if DIST == "uniform" else os.path.join(
    OUT, f"input_{TAG}.u64")
LOG = os.path.join(OUT, f"ref_run_{TAG}.log")


def gen_input():
    """Materialize the input stream as a numpy u64 array (and, for the
    skewed rows, as the binary file the reference driver reads)."""
    n = 1 << LOGN
    if DIST == "uniform":
        from inplacemsdradixsort.utils import rng as _rng
        return _rng.uniform_u64(42, n)
    if os.path.exists(INPUT):
        arr = np.fromfile(INPUT, dtype=np.uint64)
        assert len(arr) == n
        return arr
    import jax
    import jax.numpy as jnp
    from inplacemsdradixsort.models import distributions as dist
    theta = {"zipf075": 0.75, "zipf100": 1.0}[DIST]
    keys = dist.zipf(jax.random.key(7), n, theta=theta,
                     dtype=jnp.uint64)
    arr = np.asarray(jax.device_get(keys)).astype(np.uint64)
    os.makedirs(OUT, exist_ok=True)
    arr.tofile(INPUT)
    return arr


def run_reference():
    if os.path.exists(DUMP):
        print(f"reusing {DUMP}")
        return
    env = dict(os.environ, REF_DUMP=DUMP, OUT=OUT)
    if INPUT:
        env["REF_INPUT"] = INPUT
    script = os.path.join(REPO, "benchmarks", "baseline_reference.sh")
    with open(LOG, "w") as f:
        subprocess.run(["bash", script, str(LOGN)], env=env, stdout=f,
                       stderr=subprocess.STDOUT, check=True)
    print(open(LOG).read())


def main():
    n = 1 << LOGN
    keys = gen_input()
    run_reference()
    checksum_in = int(np.sum(keys.astype(np.uint64), dtype=np.uint64))

    ref_sorted = np.fromfile(DUMP, dtype=np.uint64)
    assert len(ref_sorted) == n, (len(ref_sorted), n)

    import jax
    import jax.numpy as jnp
    import inplacemsdradixsort as rs

    with jax.enable_x64(True):
        ours = np.asarray(jax.device_get(rs.sort(jnp.asarray(keys)).keys))

    checksum_out = int(np.sum(ours, dtype=np.uint64))
    bitwise = bool(np.array_equal(ours, ref_sorted))
    row = {
        "config": "BASELINE-1 parity anchor",
        "logn": LOGN,
        "dist": DIST,
        "n": n,
        "backend": str(jax.devices()[0]),
        "checksum_in": checksum_in,
        "checksum_out": checksum_out,
        "checksums_equal": checksum_in == checksum_out,
        "bitwise_equal_vs_reference": bitwise,
    }
    path = os.path.join(REPO, "benchmarks", "parity_anchor.json")
    rows = []
    if os.path.exists(path):
        old = json.load(open(path))
        rows = old if isinstance(old, list) else [old]
    rows = [r for r in rows
            if (r["logn"], r.get("dist", "uniform")) != (LOGN, DIST)]
    rows.append(row)
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
    print(json.dumps(row, indent=1))
    assert row["checksums_equal"] and bitwise, row


if __name__ == "__main__":
    main()
