"""Public API — the analog of the reference library entry points.

Reference surface (/root/reference/include/msb_64.h:37-41):

    void sort(uint64_t **keys, uint64_t **rids, uint64_t *size,
              int threads, int numa, double fudge,
              char **description, uint64_t *times);
    uint64_t check(uint64_t **keys, uint64_t **rids, uint64_t *size,
                   int numa, int same);
    void *mamalloc(size_t size);

Here:

    sort(keys, rids=None, config=..., timing=False)
        -> SortResult(keys, rids, times)           # single chip
    check(keys, rids=None, same=False)  -> checksum  (utils.checking)
    mamalloc(n, dtype, fudge)           -> padded device buffer

``threads``/``numa`` have no meaning on a single chip; their role (the
two-level parallel topology) is played by the device mesh in
``parallel.dsort.distributed_sort``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import DEFAULT_CONFIG, ENGINES, SortConfig
from .ops import keycodec, xla_engine
from .utils.checking import check  # re-exported
from .utils.timing import PhaseTimer

# mamalloc rounds buffers up to whole lines of this many bytes (the
# reference aligns to 64-byte cache lines, msb_64.c:111-115; 128 bytes
# is the GPU's global-memory transaction size)
LINE_BYTES = 128


@dataclasses.dataclass
class SortResult:
    keys: jax.Array
    rids: Optional[jax.Array]
    times: List[Tuple[str, float]]          # the 10-row phase report

    def pretty_times(self) -> str:
        out = [f"{'phase':<14}{'seconds':>12}"]
        for lbl, t in self.times:
            out.append(f"{lbl:<14}{t:>12.6f}")
        return "\n".join(out)


def mamalloc(n: int, dtype=jnp.uint32, fudge: float = 1.0) -> jax.Array:
    """Zeroed device buffer of ``n * fudge`` elements rounded up to whole
    ``LINE_BYTES`` lines (reference mamalloc analog, msb_64.c:111-115)."""
    per_line = max(1, LINE_BYTES // np.dtype(dtype).itemsize)
    cap = int(np.ceil(n * fudge / per_line)) * per_line
    return jnp.zeros((cap,), dtype=dtype)


def sort(
    keys: jax.Array,
    rids: Optional[jax.Array] = None,
    config: SortConfig = DEFAULT_CONFIG,
    timing: bool = False,
) -> SortResult:
    """Sort ``keys`` (optionally permuting ``rids`` along) on one chip.

    - keys of any integer dtype, or float32 (uint32 and uint64 are the
      reference's key types, msb_64.h:37; 64-bit dtypes need
      ``jax.enable_x64``)
    - ``rids`` any payload of the same length; sorted stably.
    - ``timing=True`` synchronizes on the result and fills the 10-row
      report (msb_64.c:2384-2412 contract).

    Traceable: callers may ``jax.jit`` a function that calls it.
    """
    if config.engine not in ENGINES:
        raise ValueError(
            f"unknown engine {config.engine!r}; expected one of {ENGINES}")
    keys = jnp.asarray(keys)
    if rids is not None:
        rids = jnp.asarray(rids)
        if rids.shape != keys.shape:
            raise ValueError(
                f"rids shape {rids.shape} != keys shape {keys.shape}")
    # float32 keys sort as their order-preserving uint32 codes: IEEE
    # total order (-0 < +0, denormals kept) on every backend, where a
    # float comparison ties -0 with +0 and XLA:CPU flushes denormals
    codec = keys.dtype == jnp.float32
    if codec:
        keys = keycodec.encode_f32(keys)
    timer = PhaseTimer(enabled=timing)
    with timer.phase("local_sort"):
        if rids is None:
            out_k, out_r = xla_engine.sort_keys(keys), None
        else:
            out_k, out_r = xla_engine.sort_pairs(keys, rids)
        if codec:
            out_k = keycodec.decode_f32(out_k)
        timer.sync(out_k, out_r)
    return SortResult(keys=out_k, rids=out_r, times=timer.report())


def sort_with_indices(
    keys: jax.Array, config: SortConfig = DEFAULT_CONFIG
) -> Tuple[jax.Array, jax.Array]:
    """Sorted keys + the stable sorting permutation (uint32 row ids).

    The reference carries explicit rowid payloads (rids); generating the
    identity payload here mirrors its benchmark setup where rids start as a
    permutation to be dragged along.
    """
    idx = jnp.arange(keys.shape[0], dtype=jnp.uint32)
    res = sort(keys, idx, config=config)
    return res.keys, res.rids
