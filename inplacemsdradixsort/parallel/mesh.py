"""Device mesh topology — the hosts × chips analog of NUMA × threads.

The reference maps logical threads onto a two-level NUMA-node × core
topology (``schedule_threads``, /root/reference/src/msb_64.c:206-237) with
cheap communication inside a node and expensive across nodes.  The analog
here is a (hosts, chips) mesh: the cards of one host are joined all to
all by NVLink, hosts by the network.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_sort_mesh(
    num_shards: Optional[int] = None,
    axis_name: str = "shard",
) -> Mesh:
    """1-D mesh over all (or the first ``num_shards``) devices.

    The distributed sort treats every chip as one shard (the reference's
    NUMA node).  The cards of one host reach each other at the same rate,
    so one axis is the whole topology there.
    """
    devs = jax.devices()
    if num_shards is not None:
        if len(devs) < num_shards:
            raise RuntimeError(
                f"make_sort_mesh: need {num_shards} devices, backend has "
                f"{len(devs)} — for a virtual mesh set XLA_FLAGS="
                f"--xla_force_host_platform_device_count={num_shards} and "
                "jax_platforms=cpu before jax initializes"
            )
        devs = devs[:num_shards]
    # Auto axes: XLA propagates shardings through the jitted steps and
    # the gates that read their results
    return jax.make_mesh((len(devs),), (axis_name,), devices=devs,
                         axis_types=(jax.sharding.AxisType.Auto,))


def make_host_chip_mesh(
    hosts: int, chips: int, axis_names: Tuple[str, str] = ("host", "chip")
) -> Mesh:
    """2-D (hosts, chips) mesh — the NUMA×thread analog
    (msb_64.c:206-237).  Collectives over the ("host", "chip") tuple are
    lowered by XLA over both axes: the network across the host axis,
    NVLink inside."""
    have = jax.devices()
    if len(have) < hosts * chips:
        raise RuntimeError(
            f"make_host_chip_mesh: need {hosts * chips} devices, backend "
            f"has {len(have)}"
        )
    devs = np.array(have[: hosts * chips]).reshape(hosts, chips)
    return Mesh(devs, axis_names)


def shard_spec(mesh: Mesh) -> NamedSharding:
    """Sharding that splits the leading data axis over all mesh axes."""
    return NamedSharding(mesh, P(mesh.axis_names))
