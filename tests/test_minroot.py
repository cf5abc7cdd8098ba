"""MinRoot VDF tests, mirroring the reference suite (SURVEY.md §4).

Covers the reference's five tests (src/minroot.rs:449-542) plus an exact
trace comparison against a Python-int oracle on the reference's TEST_SEED
inputs — our stand-in for "bit-exact vs the Rust traces", since both
compute the same deterministic function of the same inputs.
"""

import numpy as np
import pytest

from vdf_nova.fields import FP, FQ
from vdf_nova.minroot import EvalMode, Evaluation, MinRootVDF, State, pallas_vdf, vesta_vdf
from vdf_nova.utils import TEST_SEED, XorShiftRng, field_random

VDFS = [("pallas", pallas_vdf, FQ), ("vesta", vesta_vdf, FP)]


def oracle_round(p, inv_alpha, s):
    x, y, i = s
    return (pow((x + y) % p, inv_alpha, p), (x + i) % p, (i + 1) % p)


def oracle_eval(p, inv_alpha, s, t):
    for _ in range(t):
        s = oracle_round(p, inv_alpha, s)
    return s


@pytest.fixture(params=VDFS, ids=[n for n, _, _ in VDFS])
def vdf_and_params(request):
    _, mk, P = request.param
    return mk(), P


class TestSteps:
    def test_inverse_exponent(self, vdf_and_params):
        vdf, _ = vdf_and_params
        assert vdf.INVERSE_EXPONENT == 5

    def test_forward_inverse_roundtrip(self, vdf_and_params):
        """inverse_step(forward_step(x)) == x on reference TEST_SEED inputs
        (mirrors test_steps, src/minroot.rs:460-477, with 100 samples)."""
        vdf, P = vdf_and_params
        rng = XorShiftRng(TEST_SEED)
        xs = [field_random(rng, P.modulus) for _ in range(100)]
        X = vdf.field.encode(xs)
        Z = vdf.inverse_step(vdf.forward_step(X))
        assert vdf.field.decode(Z) == xs

    def test_forward_step_is_fifth_root(self, vdf_and_params):
        vdf, P = vdf_and_params
        xs = [12345, 67890]
        got = vdf.field.decode(vdf.forward_step(vdf.field.encode(xs)))
        assert got == [pow(x, P.inv_alpha, P.modulus) for x in xs]


class TestEval:
    @pytest.mark.parametrize("mode", EvalMode.all(), ids=[m.value for m in EvalMode])
    def test_eval_roundtrip_all_modes(self, mode):
        """eval then inverse_eval returns the input; check() passes
        (mirrors test_eval, src/minroot.rs:479-510, t=10)."""
        vdf = pallas_vdf(mode)
        P = FQ
        rng = XorShiftRng(TEST_SEED)
        t = 10
        for _ in range(3):
            x, y = field_random(rng, P.modulus), field_random(rng, P.modulus)
            s = vdf.state_from_ints(x, y, 0)
            result = vdf.eval(s, t)
            again = vdf.inverse_eval(result, t)
            assert vdf.state_to_ints(again) == (x, y, 0)
            assert bool(np.all(np.asarray(vdf.check(result, t, s))))

    def test_modes_agree(self):
        """All four schedules compute the identical trace."""
        P = FQ
        s0 = (99999, 12345, 0)
        results = []
        for mode in EvalMode.all():
            vdf = pallas_vdf(mode)
            r = vdf.eval(vdf.state_from_ints(*s0), 5)
            results.append(vdf.state_to_ints(r))
        assert all(r == results[0] for r in results)

    def test_trace_matches_int_oracle(self, vdf_and_params):
        """Exact trace equality vs Python-int MinRoot on TEST_SEED input."""
        vdf, P = vdf_and_params
        rng = XorShiftRng(TEST_SEED)
        x = field_random(rng, P.modulus)
        t = 7
        s = vdf.state_from_ints(x, 0, 0)
        got = vdf.state_to_ints(vdf.eval(s, t))
        want = oracle_eval(P.modulus, P.inv_alpha, (x, 0, 0), t)
        assert got == want

    def test_lane_batched_eval(self):
        """Many independent lanes evaluate correctly in one call."""
        vdf = pallas_vdf()
        P = FQ
        lanes = 5
        xs = [1000 + k for k in range(lanes)]
        s = State(
            vdf.field.encode(xs),
            vdf.field.encode([0] * lanes),
            vdf.field.encode([0] * lanes),
        )
        r = vdf.eval(s, 3)
        got_x = vdf.field.decode(r.x)
        for k in range(lanes):
            want = oracle_eval(P.modulus, P.inv_alpha, (xs[k], 0, 0), 3)
            assert got_x[k] == want[0]


class TestVanillaProof:
    def test_append_chain(self, vdf_and_params):
        """Chain n=3 proofs of t=4 (mirrors test_vanilla_proof,
        src/minroot.rs:512-542): final i == n*t, verify passes."""
        vdf, P = vdf_and_params
        rng = XorShiftRng(TEST_SEED)
        x = field_random(rng, P.modulus)
        s0 = vdf.state_from_ints(x, 0, 0)
        t, n = 4, 3

        _, proof = Evaluation.eval(vdf, s0, t)
        acc = proof
        for _ in range(1, n):
            _, nxt = Evaluation.eval(vdf, acc.result, t)
            acc = acc.append(nxt)
            assert acc is not None

        assert acc.t == n * t
        assert vdf.field.decode(acc.result.i) == n * t
        assert acc.verify(s0)

    def test_append_rejects_bad_proof(self, vdf_and_params):
        vdf, _ = vdf_and_params
        s0 = vdf.state_from_ints(777, 0, 0)
        _, proof = Evaluation.eval(vdf, s0, 4)
        bogus = Evaluation(
            result=vdf.state_from_ints(1, 2, 3),
            t=4,
            field_name=proof.field_name,
            mode=proof.mode,
        )
        assert proof.append(bogus) is None

    def test_verify_rejects_wrong_original(self, vdf_and_params):
        vdf, _ = vdf_and_params
        s0 = vdf.state_from_ints(777, 0, 0)
        _, proof = Evaluation.eval(vdf, s0, 4)
        assert not proof.verify(vdf.state_from_ints(778, 0, 0))
