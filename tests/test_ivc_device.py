"""The IVC prover on the device data plane (engine="device") on the CPU.

Folds, cross terms, matvecs, SAT checks and the deferred strict-witness
commitment all run through the device plane's executables.  Only the
Pedersen MSM inside them is swapped for the native C++ Pippenger (a
host callback): the XLA Pippenger at the prover's 2^14 generators runs
for minutes per commit on XLA:CPU.  Its arithmetic is tested by
tests/test_curves.py here and at 2^20 points by chip_smoke.py on the GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vdf_nova.curves import get_curve
from vdf_nova.curves.point import Point
from vdf_nova.fields import NLIMBS, int_to_limbs, limbs_to_int
from vdf_nova.nova.ivc import RecursiveIVC, Side, ivc_public_params, ivc_verify

from test_ivc import forward_eval

T = 1
START = [5, 6, 0]


def _native_commit_t(self, tables, w):
    """Side._commit_t through msm_native: Montgomery scalars in, the
    commitment as projective Montgomery limbs out."""
    p = self.field.params.modulus
    r_inv = pow(self.field.params.r, -1, p)
    base = get_curve(self.curve_name).field.params

    def host(w_np):
        scalars = [limbs_to_int(row) * r_inv % p for row in np.asarray(w_np)]
        aff = self.host_plane._msm(scalars)
        xyz = (0, 1, 0) if aff is None else (aff[0], aff[1], 1)
        return np.stack([int_to_limbs(base.to_mont(v)) for v in xyz])

    out = jax.pure_callback(host, jax.ShapeDtypeStruct((3, NLIMBS), jnp.uint32), w)
    return Point(out[0], out[1], out[2])


@pytest.fixture(scope="module")
def provers():
    """A device-plane prover and a native one over the same 2-step chain."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Side, "_commit_t", _native_commit_t)
        pp = ivc_public_params.__wrapped__(T, engine="device")  # fresh sides
        z0 = list(forward_eval(*START, 2 * T))
        dev = RecursiveIVC(pp, z0)
        dev.prove_step()
        deferred = dev.l_u_secondary.comm_w is None
        proof = dev.proof()
        ref = RecursiveIVC(ivc_public_params(T, engine="native"), z0)
        ref.prove_step()
        yield pp, z0, proof, ref.proof(), deferred


def test_sides_run_on_device(provers):
    pp, *_ = provers
    assert pp.primary.use_device and pp.secondary.use_device


def test_proof_finalizes_deferred_commit(provers):
    """The dangling instance's commit is deferred by the device prover and
    computed by proof(); its witness stays in the Montgomery domain, so
    it decodes to the native prover's witness."""
    pp, _, proof, ref, deferred = provers
    assert deferred
    assert proof.l_u_secondary == ref.l_u_secondary
    assert pp.secondary.field.decode(proof.l_w_secondary) == ref.l_w_secondary


def test_fold_matches_native(provers):
    pp, _, proof, ref, _ = provers
    assert proof.r_U_primary == ref.r_U_primary
    assert proof.r_U_secondary == ref.r_U_secondary
    for side, name in ((pp.primary, "primary"), (pp.secondary, "secondary")):
        for vec in ("W", "E"):
            got = side.field.decode(getattr(proof, f"r_{vec}_{name}"))
            assert got == getattr(ref, f"r_{vec}_{name}")


def test_device_proof_verifies(provers):
    pp, z0, proof, _, _ = provers
    assert ivc_verify(pp, proof, 2, z0, START)
    assert not ivc_verify(pp, proof, 2, z0, [START[0] + 1, *START[1:]])


def test_chip_smoke_phase_ivc(provers):
    """chip_smoke's IVC phase at the smallest shape: device prover, first
    fold against the native plane, verify, host-tier compression."""
    import chip_smoke

    out = chip_smoke.phase_ivc(t=T, n=3, engine="device")
    assert out["n"] == 3 and out["folds_per_s"] > 0


def test_chip_smoke_cards_ivc_on_virtual_mesh(provers):
    """The --cards 4 IVC path (ProverConfig(shards=4): row-sharded
    matvecs) against the native plane, on 4 virtual CPU devices."""
    import chip_smoke

    out = chip_smoke.cards_ivc(4, t=T, steps=3, engine="device")
    assert out["steps"] == 3
