"""Multi-host entry: ``jax.distributed`` process meshes (SURVEY §2.4).

The reference has no distributed runtime at all — its native MSM path
(pasta-msm, /root/reference/Cargo.toml:18) is single-node.  Here
multi-host is first-class: N processes (each owning a slice of chips)
form one global mesh; the same ``sharded_msm`` / ``sharded_matvec``
executables from parallel/mesh.py then run with their collectives
riding NVLink within a host and the network across hosts — XLA inserts the
transport, the code is identical to the single-process path.

Usage (one call per process, before any jax op):

    from vdf_nova.parallel import distributed
    distributed.initialize(coordinator="host0:9876", num_processes=N,
                           process_id=k)
    mesh = distributed.global_mesh()          # all chips, every host
    out  = sharded_msm(curve, pts, scalars, mesh)

Data placement: host data becomes a global sharded array with
``distribute`` below — each process contributes only its local shard
(``jax.make_array_from_callback`` pulls the per-device slice), so no
host ever materializes a remote device's bytes.

Tested with N=2 CPU processes in tests/test_multihost.py (the CI story
for the BASELINE "N>=2 hosts" axis; real multi-host clusters use the
same entry unchanged).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import SHARD_AXIS


def initialize(
    coordinator: str, num_processes: int, process_id: int, **kwargs
) -> None:
    """Join the distributed system (idempotent per process)."""
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )


def global_mesh(axis: str = SHARD_AXIS) -> Mesh:
    """1-D mesh over every device of every process, in process order."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def distribute(mesh: Mesh, host_array: np.ndarray, axis: str = SHARD_AXIS):
    """Host ndarray (replicated on every process) -> global device array
    sharded over ``axis`` along dim 0.

    Every process holds the same logical array and contributes only the
    slices its local devices own; for host-local data sources, replace
    the callback with a per-shard loader (the pattern is unchanged).
    Dim 0 must divide evenly — pad upstream (sharded_msm/sharded_matvec
    already pad their operands).
    """
    sharding = NamedSharding(mesh, P(axis, *([None] * (host_array.ndim - 1))))
    return jax.make_array_from_callback(
        host_array.shape, sharding, lambda idx: host_array[idx]
    )


def replicate(mesh: Mesh, host_array: np.ndarray):
    """Host ndarray -> globally replicated device array."""
    sharding = NamedSharding(mesh, P(*([None] * host_array.ndim)))
    return jax.make_array_from_callback(
        host_array.shape, sharding, lambda idx: host_array[idx]
    )
