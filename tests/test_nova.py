"""End-to-end Nova folding tests (mirrors test_nova_proof,
/root/reference/src/nova/proof.rs:403-451: t=5 iters/step, n=3 steps)."""

import numpy as np
import pytest

from vdf_nova.fields import FQ
from vdf_nova.minroot import pallas_vdf
from vdf_nova.nova import (
    NovaVDFProof,
    eval_and_make_circuits,
    public_params,
)
from vdf_nova.utils import TEST_SEED, XorShiftRng, field_random


@pytest.fixture(scope="module")
def proven():
    """One proven instance shared across checks (proving is the slow part)."""
    t, n = 2, 3
    vdf = pallas_vdf()
    rng = XorShiftRng(TEST_SEED)
    x = field_random(rng, FQ.modulus)
    s0 = vdf.state_from_ints(x, 0, 1)  # initial i = 1 like the reference test
    zi = [s0.x, s0.y, s0.i]

    pp = public_params(t)
    z0, circuits = eval_and_make_circuits(vdf, t, n, s0)
    proof = NovaVDFProof.prove_recursively(pp, circuits, z0)
    return pp, proof, z0, zi, t, n, vdf


class TestNovaProof:
    def test_proof_verifies(self, proven):
        pp, proof, z0, zi, t, n, vdf = proven
        assert proof.verify(pp, n, z0, zi)

    def test_wrong_num_steps_rejected(self, proven):
        pp, proof, z0, zi, t, n, _ = proven
        assert not proof.verify(pp, n + 1, z0, zi)

    def test_wrong_zi_rejected(self, proven):
        pp, proof, z0, zi, t, n, vdf = proven
        bad = vdf.state_from_ints(123, 0, 1)
        assert not proof.verify(pp, n, z0, [bad.x, bad.y, bad.i])

    def test_wrong_z0_rejected(self, proven):
        pp, proof, z0, zi, t, n, vdf = proven
        bad = vdf.state_from_ints(321, 0, 1)
        assert not proof.verify(pp, n, [bad.x, bad.y, bad.i], zi)

    def test_tampered_final_witness_rejected(self, proven):
        import dataclasses
        import jax.numpy as jnp

        pp, proof, z0, zi, t, n, _ = proven
        f = pp.field
        snark = proof.snark
        w_bad = snark.W.w.at[0].set(f.encode(999))
        from vdf_nova.nova import RecursiveSNARK, RelaxedWitness

        tampered = NovaVDFProof(
            RecursiveSNARK(
                snark.step_instances, snark.U, RelaxedWitness(w_bad, snark.W.e)
            ),
            proof.comm_ts,
        )
        assert not tampered.verify(pp, n, z0, zi)

    def test_tampered_instance_rejected(self, proven):
        pp, proof, z0, zi, t, n, _ = proven
        from vdf_nova.nova import R1CSInstance, RecursiveSNARK

        snark = proof.snark
        inst = snark.step_instances
        # swap a commitment between steps — transcript must catch it
        bad_list = list(inst)
        bad_list[0] = R1CSInstance(inst[1].comm_w, inst[0].x)
        tampered = NovaVDFProof(
            RecursiveSNARK(bad_list, snark.U, snark.W), proof.comm_ts
        )
        assert not tampered.verify(pp, n, z0, zi)


class TestFoldingInternals:
    def test_cross_term_zero_for_identical_satisfied(self):
        """Folding a satisfied instance into the zero relaxed instance
        keeps E consistent (E' = r*T must satisfy the relaxed relation)."""
        # covered implicitly by test_proof_verifies; here check shape sizes:
        # 3 constraints + 3 allocations per round (reference size,
        # /root/reference/src/nova/proof.rs:155-230) + 2 output bindings
        # + 3 output-IO bindings from shape().
        pp = public_params(2)
        s = pp.dev_shape.shape
        assert s.num_cons == 3 * 2 + 2 + 3
        assert s.num_aux == 3 * 2 + 2


class TestStepCircuitSoundness:
    """The x-chain must be bound: a forged witness with an arbitrary
    intermediate new_x (satisfiable under the reference's unconstrained
    allocation — every field element has a 5th root) must be REJECTED."""

    @staticmethod
    def _shape_and_inputs(t=1):
        from vdf_nova.nova.circuit import InverseMinRootCircuit

        circ = InverseMinRootCircuit(t)
        shape = circ.shape(FQ.modulus).shape()
        return shape

    def test_honest_witness_satisfies(self):
        p = FQ.modulus
        shape = self._shape_and_inputs()
        x, y, i = 12345, 67890, 7
        new_x = (y - (i - 1)) % p
        tmp1 = x * x % p
        tmp2 = tmp1 * tmp1 % p
        new_y = (tmp2 * x - new_x) % p
        w = [tmp1, tmp2, new_y, new_x, (i - 1) % p]
        xio = [x, y, i, new_x, new_y, (i - 1) % p]
        assert shape.is_satisfied(w, xio)

    def test_forged_new_x_rejected(self):
        p = FQ.modulus
        shape = self._shape_and_inputs()
        x, y, i = 12345, 67890, 7
        forged_x = 999  # != y - (i-1): a free choice under the old circuit
        tmp1 = x * x % p
        tmp2 = tmp1 * tmp1 % p
        new_y = (tmp2 * x - forged_x) % p  # consistent with the forgery
        w = [tmp1, tmp2, new_y, forged_x, (i - 1) % p]
        xio = [x, y, i, forged_x, new_y, (i - 1) % p]
        assert not shape.is_satisfied(w, xio)


class TestCompressedProof:
    # Execution-bound ~20 min on XLA:CPU even with a warm compile cache
    # (the device-plane Spartan pipeline runs 255-bit limb arithmetic on
    # the CPU backend); the two-curve compression path keeps its slow-
    # lane coverage in tests/test_compressed.py.
    @pytest.mark.nightly
    def test_compress_verify_and_reject(self, proven):
        import dataclasses

        pp, proof, z0, zi, t, n, vdf = proven
        comp = proof.compress(pp)
        assert comp.verify(pp, n, z0, zi)
        bad = dataclasses.replace(
            comp, spartan=comp.spartan._replace(vW=pp.field.encode(1))
        )
        assert not bad.verify(pp, n, z0, zi)
import pytest as _pytest

pytestmark = _pytest.mark.slow  # heavy XLA compiles: slow CI lane
