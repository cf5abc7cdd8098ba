"""Two-curve Nova IVC tests: O(1)-size proof, O(1) verify, tamper cases.

Mirrors the reference RecursiveSNARK usage (test_nova_proof,
/root/reference/src/nova/proof.rs:403-451) but against the augmented
circuit + cycle engine (vdf_nova/nova/ivc.py): the proof carries only the
two running relaxed instances + one strict instance regardless of the
number of steps, and verification does no per-step replay.
"""

import copy
import dataclasses

import pytest

from vdf_nova.fields.int_field import get_int_field
from vdf_nova.nova.ivc import (
    HostRelaxedInstance,
    IVCProof,
    RecursiveIVC,
    ivc_public_params,
    ivc_verify,
)
from vdf_nova.utils import TEST_SEED, XorShiftRng, field_random

T, N = 2, 3  # iters/step, steps


def forward_eval(x: int, y: int, i: int, total: int):
    """Host-int forward MinRoot over Fq (the slow direction)."""
    f = get_int_field("Fq")
    invalpha = pow(5, -1, f.p - 1)
    for _ in range(total):
        x, y, i = pow((x + y) % f.p, invalpha, f.p), (x + i) % f.p, i + 1
    return x, y, i


@pytest.fixture(scope="module")
def proven():
    pp = ivc_public_params(T, engine="native")
    rng = XorShiftRng(TEST_SEED)
    x0 = field_random(rng, get_int_field("Fq").p)
    start = (x0, 0, 1)
    z0 = list(forward_eval(*start, N * T))  # circuits walk backward
    ivc = RecursiveIVC(pp, z0)
    for _ in range(N - 1):
        ivc.prove_step()
    return pp, ivc.proof(), z0, list(start)


class TestIVC:
    def test_z_chain_reaches_initial_state(self, proven):
        pp, proof, z0, zn = proven
        assert proof.z_i == zn

    def test_verifies(self, proven):
        pp, proof, z0, zn = proven
        assert ivc_verify(pp, proof, N, z0, zn)

    def test_wrong_num_steps_rejected(self, proven):
        pp, proof, z0, zn = proven
        assert not ivc_verify(pp, proof, N + 1, z0, zn)
        assert not ivc_verify(pp, proof, 0, z0, zn)

    def test_wrong_output_rejected(self, proven):
        pp, proof, z0, zn = proven
        assert not ivc_verify(pp, proof, N, z0, [1, 2, 3])

    def test_wrong_input_rejected(self, proven):
        pp, proof, z0, zn = proven
        bad_z0 = [z0[0] + 1, z0[1], z0[2]]
        assert not ivc_verify(pp, proof, N, bad_z0, zn)

    def test_tampered_state_hash_rejected(self, proven):
        pp, proof, z0, zn = proven
        bad = copy.copy(proof)
        bad.l_u_secondary = dataclasses.replace(
            proof.l_u_secondary, X=[proof.l_u_secondary.X[0] ^ 1, proof.l_u_secondary.X[1]]
        )
        assert not ivc_verify(pp, bad, N, z0, zn)

    def test_tampered_accumulator_rejected(self, proven):
        pp, proof, z0, zn = proven
        U = proof.r_U_primary
        bad = copy.copy(proof)
        bad.r_U_primary = HostRelaxedInstance(U.comm_w, U.comm_e, [U.X[0] + 1, U.X[1]], U.u)
        assert not ivc_verify(pp, bad, N, z0, zn)

    def test_tampered_witness_rejected(self, proven):
        pp, proof, z0, zn = proven
        bad = copy.copy(proof)
        w = list(proof.r_W_primary)
        w[0] = (w[0] + 1) % pp.primary.field.params.modulus
        bad.r_W_primary = w
        assert not ivc_verify(pp, bad, N, z0, zn)

    def test_forged_claim_rejected(self, proven):
        """A proof for n steps cannot claim a different output even with a
        consistent-looking hash: recomputing the hash over forged z breaks
        the SAT of the dangling instance."""
        pp, proof, z0, zn = proven
        from vdf_nova.nova.ivc import state_hash

        forged_zn = [7, 8, 9]
        bad = copy.copy(proof)
        bad.z_i = forged_zn
        h = state_hash("Fq", pp.digest, N, z0, forged_zn, proof.r_U_secondary)
        bad.l_u_secondary = dataclasses.replace(
            proof.l_u_secondary, X=[h, proof.l_u_secondary.X[1]]
        )
        assert not ivc_verify(pp, bad, N, z0, forged_zn)

    def test_proof_is_constant_size(self, proven):
        """The running proof holds exactly 3 instances however long the
        chain (reference proof.rs:370-387 verifier inputs)."""
        pp, proof, z0, zn = proven
        flat = dataclasses.asdict(proof)
        # no per-step lists anywhere in the proof object
        assert isinstance(proof.r_U_primary, HostRelaxedInstance)
        assert len(flat) == 11
        # witness vectors sized by the *shape*, not by N
        assert len(proof.r_W_primary) == pp.primary.shape.num_aux
        assert len(proof.r_W_secondary) == pp.secondary.shape.num_aux

    def test_single_step_chain(self):
        """n=1: base case only (no folds yet) must verify."""
        pp = ivc_public_params(T, engine="native")
        z0 = list(forward_eval(5, 6, 0, T))
        ivc = RecursiveIVC(pp, z0)
        proof = ivc.proof()
        assert proof.z_i == [5, 6, 0]
        assert ivc_verify(pp, proof, 1, z0, [5, 6, 0])


class TestAugmentedShape:
    def test_shapes_synthesize_consistently(self):
        pp = ivc_public_params(T, engine="native")
        assert pp.primary.shape.num_inputs == 2
        assert pp.secondary.shape.num_inputs == 2
        # witness-mode synthesis matches the shape pass exactly (checked
        # inside RecursiveIVC._synth as well; assert the invariant here)
        assert pp.primary.shape.num_aux > 0
        assert pp.digest == ivc_public_params(T, engine="native").digest

    def test_debug_synthesis_satisfied(self):
        """Witness-mode synthesis satisfies every constraint (the augmented
        circuit's own satisfiability — TestConstraintSystem analog)."""
        pp = ivc_public_params(T, engine="native")
        z0 = list(forward_eval(11, 22, 0, T))
        ivc = RecursiveIVC(pp, z0, debug=True)  # raises if unsatisfied
        ivc.prove_step()
        assert ivc.i == 2

# (fast lane: first-compile cost is tamed by the persistent cache)
