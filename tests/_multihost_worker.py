"""Worker for tests/test_multihost.py: one process of an N-process mesh.

Joins the distributed system, builds the global shard mesh, and runs
the TP executables (row-sharded matvec + mesh-sharded Pippenger MSM)
against exact host-int references.  Env: VDF_COORD, VDF_NPROC, VDF_PID.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")


def main() -> None:
    from vdf_nova.parallel import distributed

    distributed.initialize(
        coordinator=os.environ["VDF_COORD"],
        num_processes=int(os.environ["VDF_NPROC"]),
        process_id=int(os.environ["VDF_PID"]),
    )
    n_dev = len(jax.devices())
    assert n_dev == 8, f"expected 8 global devices, got {n_dev}"
    mesh = distributed.global_mesh()

    from vdf_nova.fields import get_field
    from vdf_nova.parallel.mesh import sharded_matvec, sharded_msm

    # --- row-sharded R1CS matvec over the process mesh -----------------
    from vdf_nova.nova import public_params

    pp = public_params(2)
    f = pp.field
    shape = pp.dev_shape
    p_mod = f.params.modulus
    z_ints = list(range(1, shape.shape.num_vars + 1))
    z = f.encode(z_ints)
    got = sharded_matvec(f, shape.a, z, mesh)
    rows_h, cols_h, vals_h = shape.shape.a_coo
    want = [0] * shape.shape.num_cons
    for r, c_, v in zip(rows_h, cols_h, vals_h):
        want[int(r)] = (want[int(r)] + int(v) * z_ints[int(c_)]) % p_mod
    assert f.decode(got) == want, "multihost sharded matvec mismatch"
    print("matvec ok", flush=True)

    # --- mesh-sharded Pippenger MSM over the process mesh --------------
    from vdf_nova.curves import get_curve
    from vdf_nova.curves.int_ops import IDENTITY, get_int_curve
    from vdf_nova.curves.point import Point, hash_to_curve_ints

    curve = get_curve("pallas")
    int_curve = get_int_curve("pallas")
    n_pts = 64
    aff = hash_to_curve_ints("pallas", n_pts, domain=b"multihost")
    pts = curve.from_affine_ints(aff)
    scal_ints = [7 * k + 3 for k in range(n_pts)]
    scal = curve.scalar.encode(scal_ints)
    got_pt = sharded_msm(curve, pts, scal, mesh)
    got_aff = curve.to_affine_ints(Point(*(v[None] for v in got_pt)))[0]
    acc = IDENTITY
    for a, s in zip(aff, scal_ints):
        acc = int_curve.add(acc, int_curve.scalar_mul(int_curve.from_affine(a), s))
    assert got_aff == int_curve.to_affine(acc), "multihost sharded MSM mismatch"
    print("msm ok", flush=True)

    print("MULTIHOST_OK", flush=True)


if __name__ == "__main__":
    main()
