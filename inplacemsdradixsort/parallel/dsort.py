"""Distributed range-partitioned sort over a device mesh.

The re-creation of the reference's cross-NUMA pipeline
(/root/reference/src/msb_64.c): sample (P1-P3), range partition + block
exchange (P4-P11), local sort (P12) — with the shared-memory machinery
replaced by SPMD collectives:

  reference (NUMA × threads)          here (mesh of chips)
  --------------------------          --------------------
  sample + parallel sample sort       per-shard sample -> all_gather ->
    (partition_keys :1037-1142)         replicated jnp.sort
  splitters + numa_dest (:1545-1613)  equal-depth shard bounds from the
                                        sorted sample (splitters module)
  block exchange via atomics +        exact count-sized exchange: the
    remote memcpy (:1672-2158)          (src, dst) count matrix is
                                        computed and fetched first, so
                                        buffers are allocated to the
                                        exact class — no fudge, no
                                        overflow, no retry
  20 pthread barriers                 implicit XLA program order
  two-level NUMA x threads topology   1-D or 2-D mesh: all collectives
    (schedule_threads :206-237)         run over the combined axes
  local MSD radix sort (P12)          XLA's sort under shard_map

Output: per-shard sorted runs in shard order (shard i holds keys <= shard
i+1's), the reference's per-NUMA-node output contract (msb_64.h:37).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DEFAULT_CONFIG, SortConfig
from ..ops import splitters as sp
from ..ops import xla_engine
from ..utils.timing import PhaseTimer

SENT32 = np.uint32(0xFFFFFFFF)
MIN_CAP = 128                 # smallest exchange buffer class


class DSortResult(NamedTuple):
    keys: jax.Array        # (S, cap) sharded; row i = shard i's sorted run
    rids: Optional[jax.Array]
    counts: jax.Array      # (S,) valid elements per shard
    overflow: jax.Array    # () bool — kept for API compat; always False
    times: list


def _axes(mesh: Mesh):
    """Collective axis spec: the combined tuple of all mesh axes (the
    two-level NUMA x thread analog, msb_64.c:206-237)."""
    names = tuple(mesh.axis_names)
    return names if len(names) > 1 else names[0]


def _my_shard(mesh: Mesh):
    """Combined shard index in axis-major order (matches all_gather's
    stacking order over the axis tuple)."""
    names = tuple(mesh.axis_names)
    idx = lax.axis_index(names[0])
    for a in names[1:]:
        idx = idx * mesh.shape[a] + lax.axis_index(a)
    return idx


def _data_spec(mesh: Mesh):
    return P(tuple(mesh.axis_names))


def _sample_bounds(keys, mesh, num_shards: int, sample_per_shard: int,
                   seed):
    """P1-P3: per-shard sample -> all_gather -> replicated sort ->
    equal-depth, duplicate-aware shard boundary splitters."""
    axis = _axes(mesh)
    me = _my_shard(mesh)
    k = jax.random.fold_in(jax.random.key(seed), me)
    idx = jax.random.randint(
        k, (sample_per_shard,), 0, keys.shape[0], dtype=jnp.int32
    )
    local = jnp.take(keys, idx)
    sample = lax.all_gather(local, axis).reshape(-1)
    sample = jnp.sort(sample)
    return sp.extract_delimiters(sample, num_shards - 1)


def _count_matrix(keys, bounds, mesh):
    """The (src, dst) segment-size matrix, known on every shard — the
    histogram exchange that replaces atomic block claiming
    (msb_64.c:2027,2056)."""
    num_shards = bounds.shape[0] + 1
    dest = jnp.searchsorted(bounds, keys, side="left").astype(jnp.int32)
    send_counts = jnp.sum(
        dest[:, None] == jnp.arange(num_shards)[None, :], axis=0,
        dtype=jnp.int32,
    )
    return lax.all_gather(send_counts, _axes(mesh))       # (S, S)


def _exchange(keys, rids, bounds, send_cap: int, recv_cap: int, mesh,
              ragged_caps=None):
    """P4-P11: classify, group, exchange, compact received segments.

    With ``ragged_caps`` (a per-round static cap tuple from the fetched
    count matrix): segment-packed round-robin exchange — round r moves
    every shard's segment for destination (me+r) % S via ``ppermute``,
    padded only to THAT round's worst segment, and lands it at its
    exact receiver offset (read-modify-write).  Wire bytes = sum of
    per-round caps ~= the exact segment bytes under skew, vs the dense
    path's S x max-segment padding (the reference's block exchange
    without its 4096-tuple padding, msb_64.c:1672-2158).  The rounds
    stand in for one lax.ragged_all_to_all, which runs on GPUs but hangs
    on XLA:CPU; the ppermute rounds run on the virtual CPU mesh of the
    tests as well as on the cards.

    ``ragged_caps=None`` keeps the dense exact-cap all_to_all fallback.
    ``send_cap``/``recv_cap`` are exact upper bounds fetched from the
    count matrix — no overflow is possible on either path."""
    axis = _axes(mesh)
    num_shards = bounds.shape[0] + 1
    n_local = keys.shape[0]
    dest = jnp.searchsorted(bounds, keys, side="left").astype(jnp.int32)

    sorted_keys, sorted_rids = _group_by_dest(dest, keys, rids)
    send_counts = jnp.sum(
        dest[:, None] == jnp.arange(num_shards)[None, :], axis=0,
        dtype=jnp.int32,
    )
    send_starts = jnp.cumsum(send_counts) - send_counts
    all_counts = lax.all_gather(send_counts, axis)        # (S, S)
    me = _my_shard(mesh)
    recv_counts = all_counts[:, me]                       # (S,)
    total_recv = jnp.sum(recv_counts)

    if ragged_caps is not None:
        S = num_shards
        cap_max = max(max(ragged_caps), 1)
        recv_starts = jnp.cumsum(recv_counts) - recv_counts

        def ship(x, fill):
            fillv = jnp.asarray(fill, x.dtype)
            src_pad = jnp.concatenate(
                [x, jnp.full((cap_max,), fillv, x.dtype)])
            out_pad = jnp.full((recv_cap + cap_max,), fillv, x.dtype)
            for r in range(S):
                cap_r = int(ragged_caps[r])
                if cap_r == 0:
                    continue
                dst = lax.rem(me + r, S)
                src_sh = lax.rem(me - r + S, S)
                seg = lax.dynamic_slice(
                    src_pad, (jnp.take(send_starts, dst),), (cap_r,))
                if r:
                    perm = [(i, (i + r) % S) for i in range(S)]
                    seg = lax.ppermute(seg, axis, perm)
                cnt_f = jnp.take(recv_counts, src_sh)
                rs = jnp.take(recv_starts, src_sh)
                cur = lax.dynamic_slice(out_pad, (rs,), (cap_r,))
                j = jnp.arange(cap_r)
                out_pad = lax.dynamic_update_slice(
                    out_pad, jnp.where(j < cnt_f, seg, cur), (rs,))
            return out_pad[:recv_cap]

        rk = ship(sorted_keys, SENT32)
        rr = None
        if rids is not None:
            rr = ship(sorted_rids, SENT32)
        return rk, rr, total_recv

    def pack(x, fill):
        j = jnp.arange(send_cap)[None, :]
        idx = jnp.clip(send_starts[:, None] + j, 0, n_local - 1)
        seg = jnp.take(x, idx)                            # (S, send_cap)
        return jnp.where(j < send_counts[:, None], seg, fill)

    sendbuf = pack(sorted_keys, jnp.asarray(SENT32, keys.dtype))
    recvbuf = lax.all_to_all(
        sendbuf, axis, split_axis=0, concat_axis=0, tiled=False
    )
    if rids is not None:
        recv_rids = lax.all_to_all(
            pack(sorted_rids, jnp.asarray(SENT32, rids.dtype)),
            axis, split_axis=0, concat_axis=0, tiled=False,
        )

    # compact: received segment s lands at [recv_starts[s], +counts[s])
    recv_starts = jnp.cumsum(recv_counts) - recv_counts
    out_idx = jnp.arange(recv_cap)
    src = jnp.searchsorted(
        jnp.cumsum(recv_counts), out_idx, side="right"
    ).astype(jnp.int32)
    src = jnp.clip(src, 0, num_shards - 1)
    pos = out_idx - jnp.take(recv_starts, src)
    valid = out_idx < total_recv
    flat = src * send_cap + jnp.clip(pos, 0, send_cap - 1)
    rk = jnp.where(
        valid, jnp.take(recvbuf.reshape(-1), flat),
        jnp.asarray(SENT32, keys.dtype),
    )
    rr = None
    if rids is not None:
        rr = jnp.where(
            valid, jnp.take(recv_rids.reshape(-1), flat),
            jnp.asarray(SENT32, rids.dtype),
        )
    return rk, rr, total_recv


def _group_by_dest(dest, keys, rids=None):
    """Deterministic send layout: local keys (and rids) stably grouped
    by destination shard."""
    if rids is None:
        _, k = lax.sort((dest, keys), num_keys=1, is_stable=True)
        return k, None
    _, k, r = lax.sort((dest, keys, rids), num_keys=1, is_stable=True)
    return k, r


def _local_sort(keys, rids=None):
    """P12: one shard's received run sorted by key, pairs by (key, rid)."""
    if rids is None:
        return xla_engine.sort_keys(keys), None
    return lax.sort((keys, rids), num_keys=2, is_stable=True)


@functools.lru_cache(maxsize=32)
def _build_steps(mesh: Mesh, pairs: bool, send_cap: int, recv_cap: int,
                 sample_per_shard: int, seed: int, ragged_caps=None):
    """The four jitted SPMD programs: plan, counts, exchange, local.
    Cached, so that sorts with the same buffer classes reuse them."""
    S = mesh.devices.size
    data_spec = _data_spec(mesh)
    rid_spec = data_spec if pairs else P()
    rid_out = rid_spec if pairs else P(None)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(data_spec,),
        out_specs=P(None), check_vma=False,
    )
    def plan(keys):
        return _sample_bounds(keys, mesh, S, sample_per_shard, seed)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(data_spec, P(None)),
        out_specs=P(None), check_vma=False,
    )
    def counts(keys, bounds):
        return _count_matrix(keys, bounds, mesh)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(data_spec, rid_spec, P(None)),
        out_specs=(data_spec, rid_out, data_spec),
        check_vma=False,
    )
    def exchange(keys, rids, bounds):
        rk, rr, total = _exchange(
            keys, rids if pairs else None, bounds, send_cap, recv_cap,
            mesh, ragged_caps=ragged_caps,
        )
        if rr is None:
            rr = jnp.zeros((1,), jnp.uint32)
        return rk, rr, total.reshape(1)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(data_spec, rid_spec),
        out_specs=(data_spec, rid_out), check_vma=False,
    )
    def local(keys, rids):
        k, r = _local_sort(keys, rids if pairs else None)
        return k, (r if pairs else jnp.zeros((1,), jnp.uint32))

    return jax.jit(plan), jax.jit(counts), jax.jit(exchange), jax.jit(local)


def _shape_cap(x: int) -> int:
    """Round a buffer size up to a coarse class (1/8th steps of the next
    power of two) to bound program re-specialization across runs."""
    if x <= MIN_CAP:
        return MIN_CAP
    p = 1 << (int(x - 1).bit_length())
    step = max(p // 8, MIN_CAP)
    return -(-x // step) * step


class _Prepared(NamedTuple):
    keys: jax.Array          # sharded over the mesh
    rids: jax.Array          # sharded, or a (1,) dummy for keys only
    bounds: jax.Array
    exchange: object         # the jitted exchange and local programs
    local: object
    recv_cap: int


def _prepare(keys, rids, mesh, config, seed, timer) -> _Prepared:
    """P1-P3 sample/splitters + the count matrix (one tiny fetch): exact
    buffer classes for the exchange — no fudge, no overflow, no retry."""
    S = mesh.devices.size
    n = keys.shape[0]
    if n % S:
        raise ValueError("pad N to a multiple of the shard count")
    if keys.dtype != jnp.uint32:
        raise TypeError(f"keys must be uint32, got {keys.dtype}")
    pairs = rids is not None
    sample_per_shard = max(
        1, min(int(config.sample_cap), int(config.sample_rate * n)) // S
    )
    sharding = NamedSharding(mesh, _data_spec(mesh))
    keys = jax.device_put(keys, sharding)
    rids = (jax.device_put(rids, sharding) if pairs
            else jnp.zeros((1,), jnp.uint32))

    plan, counts, _, _ = _build_steps(
        mesh, pairs, 1, 1, sample_per_shard, seed)
    with timer.phase("sample"):
        bounds = plan(keys)
        cnt = np.asarray(jax.device_get(counts(keys, bounds)))
    send_cap = _shape_cap(int(cnt.max()))
    recv_cap = _shape_cap(int(cnt.sum(axis=0).max()))
    ragged_caps = None
    if config.ragged_exchange:
        # per-round exact caps: round r moves segment (i -> (i+r)%S)
        worst = [max(cnt[i, (i + r) % S] for i in range(S))
                 for r in range(S)]
        ragged_caps = tuple(_shape_cap(int(w)) if w else 0
                            for w in worst)
    _, _, exchange, local = _build_steps(
        mesh, pairs, send_cap, recv_cap, sample_per_shard, seed,
        ragged_caps,
    )
    return _Prepared(keys, rids, bounds, exchange, local, recv_cap)


def distributed_sort(
    keys: jax.Array,
    rids: Optional[jax.Array] = None,
    mesh: Optional[Mesh] = None,
    config: SortConfig = DEFAULT_CONFIG,
    timing: bool = False,
    seed: int = 0,
) -> DSortResult:
    """Sort ``keys`` (globally) across the mesh.

    keys: (N,) uint32, N divisible by the shard count (pad with 0xFF..
    sentinels otherwise; they sort to the last shard's tail).  The mesh
    may be 1-D (chips) or 2-D (hosts, chips); collectives run over the
    combined axes.  Returns per-shard sorted runs + valid counts (the
    reference's per-NUMA-node arrays + sizes, msb_64.h:37); pairs are
    ordered by (key, rid).
    """
    from .mesh import make_sort_mesh
    if mesh is None:
        mesh = make_sort_mesh()
    S = mesh.devices.size
    pairs = rids is not None
    timer = PhaseTimer(enabled=timing)
    prep = _prepare(keys, rids, mesh, config, seed, timer)

    with timer.phase("balance"):
        rk, rr, totals = prep.exchange(prep.keys, prep.rids, prep.bounds)
        timer.sync(rk)
    with timer.phase("local_sort"):
        sk, sr = prep.local(rk, rr)
        timer.sync(sk)

    return DSortResult(
        keys=sk.reshape(S, -1),
        rids=sr.reshape(S, -1) if pairs else None,
        counts=totals.reshape(S),
        overflow=jnp.zeros((), jnp.bool_),
        times=timer.report(),
    )


def compiled_steps(
    keys: jax.Array,
    rids: Optional[jax.Array] = None,
    mesh: Optional[Mesh] = None,
    config: SortConfig = DEFAULT_CONFIG,
    seed: int = 0,
) -> dict:
    """The exchange and local-sort programs ``distributed_sort`` runs on
    these inputs, compiled but not run (for ``memory_analysis()`` and
    the optimized HLO).  Runs the sample and count steps to size them."""
    from .mesh import make_sort_mesh
    if mesh is None:
        mesh = make_sort_mesh()
    prep = _prepare(keys, rids, mesh, config, seed, PhaseTimer(False))
    received = jax.ShapeDtypeStruct(
        (mesh.devices.size * prep.recv_cap,), prep.keys.dtype,
        sharding=prep.keys.sharding)
    rr = prep.rids
    if rids is not None:
        rr = jax.ShapeDtypeStruct(received.shape, prep.rids.dtype,
                                  sharding=prep.rids.sharding)
    return {
        "exchange": prep.exchange.lower(
            prep.keys, prep.rids, prep.bounds).compile(),
        "local": prep.local.lower(received, rr).compile(),
    }


def gather_sorted(res: DSortResult) -> np.ndarray:
    """Materialize the global sorted sequence on host (tests/verification)."""
    ks = np.asarray(jax.device_get(res.keys))
    cnt = np.asarray(jax.device_get(res.counts))
    return np.concatenate([ks[i, : cnt[i]] for i in range(ks.shape[0])])


def gather_rids(res: DSortResult) -> np.ndarray:
    rs = np.asarray(jax.device_get(res.rids))
    cnt = np.asarray(jax.device_get(res.counts))
    return np.concatenate([rs[i, : cnt[i]] for i in range(rs.shape[0])])


def check_distributed(res: DSortResult) -> int:
    """Distributed check() analog: per-shard ascending, cross-shard
    boundary order (msb_64.c:2493-2494), returns the checksum."""
    ks = np.asarray(jax.device_get(res.keys))
    cnt = np.asarray(jax.device_get(res.counts))
    total = 0
    prev = None
    for i in range(ks.shape[0]):
        row = ks[i, : cnt[i]]
        if row.size:
            if not np.all(np.diff(row.astype(np.int64)) >= 0):
                raise AssertionError(f"shard {i} not sorted")
            if prev is not None and row[0] < prev:
                raise AssertionError(f"shard boundary {i} out of order")
            prev = row[-1]
            total = (total + int(row.astype(np.uint64).sum())) % (1 << 64)
    return total
