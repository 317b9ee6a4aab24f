"""What XLA made of a program's sorts, read from its optimized HLO."""

from __future__ import annotations

import re


def sort_lowering(hlo_text: str) -> dict:
    """Which sorts of an optimized HLO module became library calls:
    CUB radix-sort custom calls against XLA's own ``sort`` ops left
    (``compiled.as_text()`` of a ``jax.jit(...).lower(...).compile()``)."""
    targets = re.findall(r'custom_call_target="([^"]+)"', hlo_text)
    return {
        "cub_radix_sort": sum("DeviceRadixSort" in t for t in targets),
        "xla_sort": len(re.findall(r"[\]\)\}] sort\(", hlo_text)),
        "custom_calls": sorted(set(targets)),
    }
