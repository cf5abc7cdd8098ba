"""R1CS builder + inverse-MinRoot circuit tests.

Checks the circuit has the reference's size (3 constraints + 3 allocs
per round + final_i, /root/reference/src/nova/proof.rs:155-230) and that
witnesses generated from real VDF segment outputs satisfy the shape
exactly (host-int verification)."""

import numpy as np
import pytest

from vdf_nova.fields import FQ, get_field
from vdf_nova.minroot import pallas_vdf, State
from vdf_nova.nova.circuit import InverseMinRootCircuit
from vdf_nova.r1cs import ShapeCS, AllocatedNum, LinearCombination, ONE


def decode_col(f, arr):
    return f.decode(arr)


class TestShape:
    def test_circuit_size_matches_reference(self):
        t = 5
        shape = InverseMinRootCircuit(t).shape(FQ.modulus).shape()
        # Per round: tmp1, tmp2, round = 3 constraints; tmp1, tmp2,
        # new_y = 3 allocations (new_x is a bound Num, not an alloc).
        # Plus final_x/final_i (2 allocs + 2 constraints) and 3 output
        # bindings (standalone-mode IO).
        assert shape.num_cons == 3 * t + 2 + 3
        assert shape.num_aux == 3 * t + 2
        assert shape.num_inputs == 6  # z in (3) + z out (3)

    def test_satisfied_by_real_trace(self):
        t = 4
        vdf = pallas_vdf()
        f = vdf.field
        # Evaluate forward; circuit walks the inverse direction from the
        # result back to the input.
        s0 = vdf.state_from_ints(987654321, 0, 0)
        result = vdf.eval(s0, t)

        circuit = InverseMinRootCircuit(t)
        shape = circuit.shape(FQ.modulus).shape()
        cs, outs = circuit.witness(
            f, [result.x, result.y, result.i], check=True
        )
        assert cs.failed == []

        # Outputs must be the original state.
        assert f.decode(outs[0]) == f.decode(s0.x)
        assert f.decode(outs[1]) == f.decode(s0.y)
        assert f.decode(outs[2]) == f.decode(s0.i)

        # Full exact satisfaction of the extracted matrices.
        w = [f.decode(a) for a in cs.aux]
        x_io = [f.decode(v) for v in (result.x, result.y, result.i)] + [
            f.decode(o) for o in outs
        ]
        assert shape.is_satisfied(w, x_io)

    def test_unsatisfied_with_tampered_witness(self):
        t = 3
        vdf = pallas_vdf()
        f = vdf.field
        s0 = vdf.state_from_ints(13579, 0, 0)
        result = vdf.eval(s0, t)
        circuit = InverseMinRootCircuit(t)
        shape = circuit.shape(FQ.modulus).shape()
        cs, outs = circuit.witness(f, [result.x, result.y, result.i])
        w = [f.decode(a) for a in cs.aux]
        x_io = [f.decode(v) for v in (result.x, result.y, result.i)] + [
            f.decode(o) for o in outs
        ]
        w[1] = (w[1] + 1) % FQ.modulus
        assert not shape.is_satisfied(w, x_io)

    def test_batched_witness(self):
        """Witness generation is natively lane-batched."""
        t = 2
        vdf = pallas_vdf()
        f = vdf.field
        lanes = 3
        s0 = State(
            f.encode([11, 22, 33]), f.encode([0] * lanes), f.encode([0] * lanes)
        )
        result = vdf.eval(s0, t)
        circuit = InverseMinRootCircuit(t)
        cs, outs = circuit.witness(f, [result.x, result.y, result.i], check=True)
        assert cs.failed == []
        assert f.decode(outs[0]) == [11, 22, 33]
        assert cs.witness().shape[0] == 3 * t + 2


class TestConstraintSystemCore:
    def test_simple_mul_constraint(self):
        cs = ShapeCS(FQ.modulus)
        a = AllocatedNum.alloc_input(cs, "a")
        b = AllocatedNum.alloc(cs, "b")
        c = AllocatedNum.alloc(cs, "c")
        cs.enforce(a.lc(), b.lc(), c.lc(), name="a*b=c")
        shape = cs.shape()
        assert shape.num_cons == 1
        # w = [b, c], x = [a]; 3*4=12
        assert shape.is_satisfied([4, 12], [3])
        assert not shape.is_satisfied([4, 13], [3])

    def test_lc_arithmetic(self):
        lc = LinearCombination.of(ONE, 2).add(ONE, 3)
        assert lc.terms[ONE] == 5
        lc2 = lc - LinearCombination.of(ONE, 1)
        assert lc2.terms[ONE] == 4
        assert lc.scale(3).terms[ONE] == 15
