"""Phase timing & the 10-row report.

The reference instruments every phase of ``sort_thread`` with ``micro_time()``
(reference: /root/reference/src/msb_64.c:60-66, 1459-1475) and returns averaged
per-phase times through the ``times[0..9]`` / ``description[]`` out-parameters
(msb_64.c:2384-2412).  We keep the same 10-row public contract; rows that have
no analog here (the block bookkeeping phases that XLA collectives subsume)
stay at zero.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List

import jax

# Reference row labels, msb_64.c:2384-2412.
PHASE_LABELS: List[str] = [
    "sample",          # P1-P3: sampling + sample sort + splitters
    "part_first",      # P4: first-chunk partition (we fold into histogram)
    "part_blocks",     # P5: partition to blocks  -> tile sort + histogram
    "combine",         # P6: combine open blocks  -> offsets/prefix scan
    "compact",         # P7: per-node compaction  -> (collective) exchange prep
    "balance",         # P8: inter-node balance   -> exchange (all_to_all)
    "swap_online",     # P9: online block permute -> distribute scatter
    "swap_offline",    # P10: offline block place -> distribute tail
    "inject",          # P11: splice half blocks  -> compaction/slicing
    "local_sort",      # P12: local MSD radix sort -> bucket sort
]


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase.

    Device work is dispatched asynchronously, so a timed phase ends with
    ``sync`` (``jax.block_until_ready``) on its results.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.times: Dict[str, float] = {}

    @contextmanager
    def phase(self, label: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        self.times[label] = self.times.get(label, 0.0) + (
            time.perf_counter() - t0
        )

    def sync(self, *values):
        """Block until device values are ready (phase boundary)."""
        if self.enabled:
            jax.block_until_ready(values)
        return values[0] if len(values) == 1 else values

    def report(self) -> List[tuple]:
        """The 10-row (description, seconds) report, reference order."""
        return [(lbl, self.times.get(lbl, 0.0)) for lbl in PHASE_LABELS]

    def pretty(self) -> str:
        rows = self.report()
        total = sum(t for _, t in rows)
        out = [f"{'phase':<14}{'seconds':>12}{'share':>9}"]
        for lbl, t in rows:
            share = (t / total * 100.0) if total else 0.0
            out.append(f"{lbl:<14}{t:>12.6f}{share:>8.1f}%")
        out.append(f"{'total':<14}{total:>12.6f}")
        return "\n".join(out)


def micro_time() -> int:
    """Microsecond wall clock (reference micro_time, msb_64.c:60-66)."""
    return time.perf_counter_ns() // 1000
