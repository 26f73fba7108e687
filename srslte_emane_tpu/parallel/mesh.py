"""Multi-chip sharding of the PHY pipeline.

Reference parallelism being replaced (SURVEY.md §2.8): one OS process per
network node (eNB/UE/EPC) communicating over the EMANE OTA bus, with
`sf_worker` thread pools pipelining TTIs inside each process.

Design: a 2-D logical mesh
    ('node', 'sf')
where 'node' shards emulated cells/links (the process axis of the reference)
and 'sf' shards subframe batches (the sf_worker axis).  The PHY step is pure
data parallelism over (node x subframe) — HARQ softbuffers shard with their
links and stay device-resident between steps; cross-node OTA exchange rides
device collectives (parallel/ota_collective.py).  Every device reaches every
other at the same rate, so the (node, sf) shape follows the algorithm
only.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int = None, node_axis: int = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if node_axis is None:
        # prefer a 2-D factorization when possible
        node_axis = 1
        for f in (4, 2):
            if n % f == 0 and n > f:
                node_axis = f
                break
    grid = np.array(devs).reshape(node_axis, n // node_axis)
    return Mesh(grid, axis_names=("node", "sf"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading batch axis over both mesh axes (node*sf flattened)."""
    return NamedSharding(mesh, P(("node", "sf")))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
