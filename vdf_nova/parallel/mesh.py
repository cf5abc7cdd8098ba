"""Device mesh + sharding helpers — the framework's communication layer.

The reference has no distributed runtime (SURVEY.md §2.4); here the mesh
is first-class.  Axes:

  * ``lanes`` — data-parallel independent VDF chains (no steady-state
    comms; pure DP).
  * ``shard`` — tensor-parallel axis for proving math: MSM points /
    buckets and R1CS constraint rows are partitioned over it and reduced
    with ``psum`` collectives (NVLink between the cards of a host).

On a single host these map onto all local devices; multi-host extends
the same names over ``jax.distributed`` process meshes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..minroot.vdf import State

LANES_AXIS = "lanes"
SHARD_AXIS = "shard"


def make_mesh(n_devices: int | None = None, axis: str = LANES_AXIS) -> Mesh:
    """1-D mesh over the first n devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def lane_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (lane) axis of a limb array; limbs replicated."""
    return NamedSharding(mesh, P(LANES_AXIS, None))


def shard_state(state: State, mesh: Mesh) -> State:
    s = lane_sharding(mesh)
    return State(*(jax.device_put(a, s) for a in state))


def sharded_eval(vdf, t: int, mesh: Mesh):
    """Jitted lane-sharded eval: State(lanes, 17) -> State(lanes, 17).

    Pure data parallelism: XLA partitions the batched scan over the lane
    axis; zero collectives in steady state (SURVEY.md §2.4 DP row).
    """
    s = lane_sharding(mesh)
    shardings = State(s, s, s)
    return jax.jit(
        lambda st: vdf.eval_uncached(st, t),
        in_shardings=(shardings,),
        out_shardings=shardings,
    )


def sharded_matvec(field, dev_mat, z: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """Row-sharded sparse matvec: COO entries partition over the mesh,
    each device segment-sums its slice, partial row sums reduce with
    psum over NVLink (SURVEY.md §2.4 TP row; the Nova prover's matvec
    sharding).  z is replicated (it is small next to the matrices)."""
    from jax.experimental.shard_map import shard_map
    from ..fields import NLIMBS
    from ..fields.ops import resolve

    n_dev = mesh.devices.size
    nnz = dev_mat.rows.shape[0]
    pad = (-nnz) % n_dev
    rows = jnp.pad(dev_mat.rows, (0, pad))
    cols = jnp.pad(dev_mat.cols, (0, pad))
    # Padded entries multiply by zero so they contribute nothing.
    vals = jnp.pad(dev_mat.vals, ((0, pad), (0, 0)))
    num_rows = dev_mat.num_rows

    def local(rows_s, cols_s, vals_s, z_rep):
        prods = field.mul(vals_s, z_rep[cols_s])
        acc = jax.ops.segment_sum(prods, rows_s, num_segments=num_rows)
        return jax.lax.psum(acc, SHARD_AXIS)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS, None), P(None, None)),
        out_specs=P(None, None),
    )
    acc = fn(rows, cols, vals, z)
    return field.partial_reduce(resolve(acc, NLIMBS), k_max=15)


def sharded_msm(curve, points, scalars_mont: jnp.ndarray, mesh: Mesh):
    """Mesh-sharded Pippenger MSM (BASELINE config 5; reference's native
    pasta-msm is single-node, Cargo.toml:18 — sharding is new capability).

    Points and scalars partition over the ``shard`` axis; every device
    runs the full sorted-bucket Pippenger on its slice; the per-device
    partial sums are all-gathered (one point each — O(n_dev) bytes over
    NVLink) and tree-added.  Group addition is not an arithmetic psum, so
    the gather+tree is the natural collective."""
    from jax.experimental.shard_map import shard_map

    from ..curves.msm import _tree_sum, _window_bits, msm_pippenger_traceable
    from ..curves.point import Point

    n_dev = mesh.devices.size
    n = points.x.shape[0]
    pad = (-n) % n_dev
    if pad:
        # Padded scalars are zero: their digits land in bucket 0 (dumped).
        zero = jnp.zeros((pad, scalars_mont.shape[-1]), scalars_mont.dtype)
        scalars_mont = jnp.concatenate([scalars_mont, zero])
        points = Point(
            *(jnp.concatenate([v, jnp.broadcast_to(v[-1:], (pad, v.shape[-1]))])
              for v in points)
        )
    c = _window_bits(max(points.x.shape[0] // n_dev, 2))

    def local(pts, s):
        acc = msm_pippenger_traceable(curve, Point(*pts), s, c)
        return tuple(v[None] for v in acc)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=((P(SHARD_AXIS, None),) * 3, P(SHARD_AXIS, None)),
        out_specs=(P(SHARD_AXIS, None),) * 3,
        # the scan carries inside Pippenger start as unvarying constants;
        # skip the varying-manual-axes (replication) check
        check_rep=False,
    )
    partials = Point(*fn(tuple(points), scalars_mont))  # (n_dev, 17) each
    return _tree_sum(curve, partials)


def sharded_check(vdf, t: int, mesh: Mesh):
    """Jitted sharded verify: returns the number of valid lanes (psum'd
    into a replicated scalar) — exercises a real collective."""
    s = lane_sharding(mesh)
    shardings = State(s, s, s)

    def check(result: State, original: State) -> jnp.ndarray:
        ok = vdf.check_uncached(result, t, original)
        return jnp.sum(ok.astype(jnp.int32))

    return jax.jit(
        check,
        in_shardings=(shardings, shardings),
        out_shardings=NamedSharding(mesh, P()),
    )
