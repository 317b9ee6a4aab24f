#!/usr/bin/env python3
"""Run the sort path once on the GPU at real sizes and check every result.

    python3 chip_smoke.py [--seed S]          # one card: the phases below
    python3 chip_smoke.py --four [--seed S]   # distributed_sort on 4 cards

One card (sizes from BASELINE.json):
  1. ``rs.sort`` of 2^31 uniform u32 keys (config 2);
  2. ``rs.sort`` of 2^31 Zipf(theta=1.0) u32 keys (config 3);
  3. ``rs.sort`` of 2^30 (u32 key, u64 rid = iota) pairs (config 4);
  4. ``rs.sort`` of 2^30 uniform u64 keys;
  5. ``distributed_sort`` on a one-card mesh at 2^28 uniform u32 keys.
Each phase also runs at 2^26 and is compared bitwise with ``np.sort`` on
the host, and the seed-42 parity fixture is sorted and compared.

``--four`` runs only ``distributed_sort`` over a 1-D mesh of four cards,
uniform and Zipf(1.0) u32 keys at 2^32 in total (BASELINE config 5 cut to
one host), plus the bitwise comparison at 2^26.

Inputs are generated on the card from ``--seed`` (sharded over the mesh
for the distributed phases), and the gates run on the card: count,
ascending order (per shard, and across shard boundaries), a multiset
fingerprint of input against output, and for pairs the permutation,
payload and stability invariants.  Per phase it prints compile seconds,
one warm sort time (informational), the process's peak device memory, the
compiled program's memory analysis, and which sorts in the compiled HLO
became CUB radix-sort calls.  The last line of standard output is one JSON
object; a failed phase exits non-zero before it is printed.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

import inplacemsdradixsort as rs
from inplacemsdradixsort.models import distributions as dist
from inplacemsdradixsort.parallel import dsort
from inplacemsdradixsort.parallel.mesh import make_sort_mesh
from inplacemsdradixsort.utils import checking, compile_cache
from inplacemsdradixsort.utils.hlo import sort_lowering
from inplacemsdradixsort.utils import rng as mtrng

ROOT = os.path.dirname(os.path.abspath(__file__))
PARITY_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                              "parity_seed42.json")


class Phase(NamedTuple):
    name: str
    dist: str          # models.distributions name
    dtype: str         # key dtype
    log_n: int
    pairs: bool = False

    @property
    def x64(self) -> bool:
        return self.pairs or jnp.dtype(self.dtype).itemsize == 8


ONE_CARD = (
    Phase("uniform_u32", "uniform", "uint32", 31),
    Phase("zipf100_u32", "zipf100", "uint32", 31),
    Phase("pairs_u32_u64rid", "uniform", "uint32", 30, pairs=True),
    Phase("uniform_u64", "uniform", "uint64", 30),
)
DSORT_ONE_LOG_N = 28
FOUR_LOG_N = 32
FOUR_DISTS = ("uniform", "zipf100")
BITWISE_LOG_N = 26


def log(*a):
    print(*a, flush=True)


def require_gpu(devices, count: int = 1):
    """Refuse to run anywhere but on ``count`` GPUs: no CPU fallback."""
    d = devices[0]
    if d.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU; JAX found {d.platform} "
            f"({d.device_kind})")
    if len(devices) < count:
        raise SystemExit(
            f"chip_smoke: needs {count} GPUs; JAX found {len(devices)}")


def card_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def peak_bytes(devices) -> object:
    stats = [d.memory_stats() or {} for d in devices]
    peaks = [s.get("peak_bytes_in_use") for s in stats]
    return None if None in peaks else max(peaks)


def memory_summary(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "not available"
    return (f"args={m.argument_size_in_bytes} out={m.output_size_in_bytes} "
            f"temp={m.temp_size_in_bytes} alias={m.alias_size_in_bytes}")


def timed(fn, *args):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def require(name: str, gates: dict):
    log(f"  {name} gates: " + " ".join(
        f"{k}={'ok' if v else 'FAIL'}" for k, v in gates.items()))
    failed = [k for k, v in gates.items() if not v]
    if failed:
        raise AssertionError(f"{name}: gates failed: {failed}")


# ------------------------------------------------------------ one card

@functools.partial(jax.jit, static_argnames=("name", "n", "dtype"))
def _generate(key, name, n, dtype):
    return dist.make(name, key, n, dtype=jnp.dtype(dtype))


@functools.partial(jax.jit, static_argnames=("n",))
def _iota_u64(n):
    return jnp.arange(n, dtype=jnp.uint64)


def _sort_keys(keys):
    return rs.sort(keys).keys


def _sort_pairs(keys, rids):
    res = rs.sort(keys, rids)
    return res.keys, res.rids


def run_phase(ph: Phase, seed: int, log_n: int, bitwise: bool) -> dict:
    """One ``rs.sort`` phase at 2^log_n; with ``bitwise`` the result is
    also fetched and compared with ``np.sort`` on the host."""
    n = 1 << log_n
    with jax.enable_x64(ph.x64):
        keys = _generate(jax.random.key(seed), ph.dist, n, ph.dtype)
        args = (keys, _iota_u64(n)) if ph.pairs else (keys,)
        fp_in = checking.fingerprint(keys)
        fn = jax.jit(_sort_pairs if ph.pairs else _sort_keys)
        t0 = time.perf_counter()
        compiled = fn.lower(*args).compile()
        compile_s = time.perf_counter() - t0
        lowering = sort_lowering(compiled.as_text())
        out, _ = timed(compiled, *args)
        out_k = out[0] if ph.pairs else out
        gates = {
            "count": out_k.shape == keys.shape,
            "ascending": checking.device_is_sorted(out_k),
            "fingerprint": checking.fingerprint(out_k) == fp_in,
        }
        if ph.pairs:
            gates.update(checking.pair_gates(keys, out[0], out[1]))
        if bitwise:
            host = np.asarray(jax.device_get(keys))
            order = np.argsort(host, kind="stable")
            gates["bitwise_keys_vs_np_sort"] = np.array_equal(
                np.asarray(jax.device_get(out_k)), host[order])
            if ph.pairs:
                gates["bitwise_rids_vs_np_argsort"] = np.array_equal(
                    np.asarray(jax.device_get(out[1])), order)
        del out, out_k
        _, warm_s = timed(compiled, *args)
    row = {"phase": ph.name, "log_n": log_n, "compile_s": compile_s,
           "warm_sort_s_informational": warm_s,
           "peak_bytes_in_use": peak_bytes(jax.devices()[:1]),
           "memory_analysis": memory_summary(compiled), "sorts": lowering}
    log(f"phase {ph.name} n=2^{log_n}: " + json.dumps(row))
    require(f"{ph.name}@2^{log_n}", gates)
    return row


def run_parity_fixture() -> None:
    """Sort the reference's seed-42 MT19937-64 stream (high words) and
    compare with the committed fixture and with ``np.sort``."""
    with open(PARITY_FIXTURE) as f:
        fx = json.load(f)
    keys = (mtrng.mt64_stream(fx["seed"], fx["n"])
            >> np.uint64(32)).astype(np.uint32)
    out = np.asarray(jax.device_get(rs.sort(jnp.asarray(keys)).keys))
    require("parity_seed42", {
        "input_checksum": int(keys.astype(np.uint64).sum())
        == fx["input_checksum"],
        "sorted_checksum": int(out.astype(np.uint64).sum())
        == fx["sorted_checksum"],
        "first4": out[:4].tolist() == fx["sorted_first4"],
        "last4": out[-4:].tolist() == fx["sorted_last4"],
        "bitwise_vs_np_sort": np.array_equal(out, np.sort(keys)),
    })


# ---------------------------------------------------------- distributed

def generate_sharded(mesh, name: str, n: int, seed: int) -> jax.Array:
    """(n,) keys of distribution ``name``, each shard generated on its
    own device (no whole array ever exists on one device)."""
    S = mesh.devices.size
    spec = P(tuple(mesh.axis_names))

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=spec,
                       out_specs=spec)
    def gen(shard):
        key = jax.random.fold_in(jax.random.key(seed), shard[0])
        return dist.make(name, key, n // S)

    shards = jax.device_put(jnp.arange(S, dtype=jnp.uint32),
                            NamedSharding(mesh, spec))
    return jax.jit(gen)(shards)


@jax.jit
def _shard_edges(keys, counts):
    """Per shard: valid prefix ascending, smallest and largest valid key."""
    valid = jnp.arange(keys.shape[1])[None, :] < counts[:, None]
    asc = jnp.all(jnp.where(valid[:, 1:], keys[:, 1:] >= keys[:, :-1],
                            True), axis=1)
    top = jnp.array(jnp.iinfo(keys.dtype).max, keys.dtype)
    return (asc, jnp.min(jnp.where(valid, keys, top), axis=1),
            jnp.max(jnp.where(valid, keys, 0), axis=1))


def dsort_gates(res: dsort.DSortResult, n: int, fp_in) -> dict:
    asc, lo, hi = (np.asarray(x) for x in jax.device_get(
        _shard_edges(res.keys, res.counts)))
    counts = np.asarray(jax.device_get(res.counts))
    live = [i for i in range(counts.shape[0]) if counts[i]]
    boundaries = all(hi[a] <= lo[b] for a, b in zip(live, live[1:]))
    return {
        "count": int(counts.sum()) == n,
        "ascending_per_shard": bool(asc[counts > 0].all()),
        "ascending_across_shards": boundaries,
        "fingerprint": checking.fingerprint(res.keys, res.counts) == fp_in,
    }


def run_dsort(mesh, name: str, seed: int, log_n: int,
              bitwise: bool) -> dict:
    """``distributed_sort`` of 2^log_n keys over ``mesh``."""
    n = 1 << log_n
    tag = f"dsort_{name}_{mesh.devices.size}card"
    keys = generate_sharded(mesh, name, n, seed)
    fp_in = checking.fingerprint(keys)
    t0 = time.perf_counter()
    steps = dsort.compiled_steps(keys, mesh=mesh, seed=seed)
    compile_s = time.perf_counter() - t0
    for step, compiled in steps.items():
        log(f"  {tag}@2^{log_n} {step} memory_analysis: "
            f"{memory_summary(compiled)}")
    res, first_s = timed(
        lambda: dsort.distributed_sort(keys, mesh=mesh, seed=seed))
    gates = dsort_gates(res, n, fp_in)
    if bitwise:
        gates["bitwise_vs_np_sort"] = np.array_equal(
            dsort.gather_sorted(res), np.sort(np.asarray(keys)))
    del res
    _, warm_s = timed(
        lambda: dsort.distributed_sort(keys, mesh=mesh, seed=seed))
    row = {"phase": tag, "log_n": log_n, "compile_s": compile_s,
           "first_sort_s": first_s, "warm_sort_s_informational": warm_s,
           "peak_bytes_in_use": peak_bytes(list(mesh.devices.flat)),
           "sorts": {k: sort_lowering(c.as_text())
                     for k, c in steps.items()}}
    log(f"phase {tag} n=2^{log_n}: " + json.dumps(row))
    require(f"{tag}@2^{log_n}", gates)
    return row


def run_four(mesh, seed: int, log_n: int = FOUR_LOG_N,
             bitwise_log_n: int = BITWISE_LOG_N) -> None:
    for name in FOUR_DISTS:
        run_dsort(mesh, name, seed, bitwise_log_n, bitwise=True)
        run_dsort(mesh, name, seed, log_n, bitwise=False)


def run_one_card(seed: int) -> None:
    run_parity_fixture()
    for ph in ONE_CARD:
        run_phase(ph, seed, BITWISE_LOG_N, bitwise=True)
        run_phase(ph, seed, ph.log_n, bitwise=False)
    mesh = make_sort_mesh(1)
    run_dsort(mesh, "uniform", seed, BITWISE_LOG_N, bitwise=True)
    run_dsort(mesh, "uniform", seed, DSORT_ONE_LOG_N, bitwise=False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only distributed_sort over four cards")
    args = ap.parse_args(argv)

    compile_cache.enable()
    count = 4 if args.four else 1
    require_gpu(jax.devices(), count)
    log(f"card: {card_name_and_power_limit()}")
    devices = jax.devices()[:count]
    log(f"jax {jax.__version__}: {count} x {devices[0].device_kind}")
    if args.four:
        run_four(make_sort_mesh(4), args.seed)
    else:
        run_one_card(args.seed)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
