"""Typed configuration for the radix partition/sort engine.

The reference exposes its tuning knobs as compile-time constants and the
``sort()`` parameters ``threads, numa, fudge`` (reference:
/root/reference/include/msb_64.h:37-39, /root/reference/src/msb_64.c:2266-2322).
Here the knobs that still steer code are fields of one dataclass:

- ``sample_rate`` / ``sample_cap`` <- 0.005 * N capped at 500k
                          (msb_64.c:2320-2322)
"""

from __future__ import annotations

import dataclasses

# single-chip engines ``api.sort`` accepts: XLA's own sort
ENGINES = ("xla",)


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Configuration for single-chip and distributed radix sort."""

    # --- partitioning / planner ---
    sample_rate: float = 0.005    # sample fraction of N (msb_64.c:2320)
    sample_cap: int = 500_000     # max sample size       (msb_64.c:2321-2322)

    # --- engine selection (one of ENGINES) ---
    engine: str = "xla"

    # --- distributed ---
    # segment-packed exchange: S ppermute rounds, each padded only to its
    # own worst segment (exact wire bytes under skew); False = dense
    # exact-cap all_to_all + compaction.  The ppermute rounds stand in
    # for lax.ragged_all_to_all, which runs on GPUs but hangs on XLA:CPU,
    # so that the same path runs on the virtual CPU mesh of the tests.
    ragged_exchange: bool = True


DEFAULT_CONFIG = SortConfig()
