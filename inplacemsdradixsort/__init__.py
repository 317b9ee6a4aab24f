"""inplacemsdradixsort — radix partitioning & sort engine on JAX.

A from-scratch JAX/XLA re-design of the capabilities of
``MichaelAxtmann/InPlaceMSDradixsort`` (Polychroniou & Ross, SIGMOD 2014):
multi-pass MSD radix partitioning with sample-based skew-aware splitters,
key+payload sorting, verification, phase-timing reports, and a multi-chip
range-partitioned distributed sort over a device mesh.

Public API:
    sort, sort_with_indices, check, mamalloc, SortConfig, SortResult
    parallel.distributed_sort — mesh-sharded sort (the NUMA analog)
"""

from .api import SortResult, check, mamalloc, sort, sort_with_indices
from .config import DEFAULT_CONFIG, SortConfig

__all__ = [
    "sort",
    "sort_with_indices",
    "check",
    "mamalloc",
    "SortConfig",
    "DEFAULT_CONFIG",
    "SortResult",
]

__version__ = "0.1.0"
