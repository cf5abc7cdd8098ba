"""Spartan component tests (sumcheck, multilinear, IPA) + compressed
pipeline smoke (kept small: CPU-eager point ops dominate runtime)."""

import random
import types

import jax.numpy as jnp
import numpy as np
import pytest

from vdf_nova.fields import FQ, get_field
from vdf_nova.poseidon import Transcript
from vdf_nova.spartan import (
    eq_table,
    eval_univariate,
    evaluate,
    ipa_prove,
    ipa_verify,
    num_vars,
    pad_to_pow2,
    sumcheck_prove,
    sumcheck_verify,
)


@pytest.fixture
def f():
    return get_field("Fq")


class TestMultilinear:
    def test_eq_table_matches_direct(self, f):
        p = FQ.modulus
        rs_int = [3, 7]
        rs = [f.encode(v) for v in rs_int]
        table = f.decode(eq_table(f, rs))
        # eq(r, x) for x in {00, 01, 10, 11}; index bit order: top var first
        for idx in range(4):
            bits = [(idx >> 1) & 1, idx & 1]  # [x0 (top), x1]
            want = 1
            for r, b in zip(rs_int, bits):
                want = want * ((r * b + (1 - r) * (1 - b)) % p) % p
            assert table[idx] == want

    def test_evaluate_matches_eq_inner_product(self, f):
        p = FQ.modulus
        rng = random.Random(0)
        vals_int = [rng.randrange(p) for _ in range(8)]
        vals = f.encode(vals_int)
        rs = [f.encode(rng.randrange(p)) for _ in range(3)]
        got = f.decode(evaluate(f, vals, rs))
        table = f.decode(eq_table(f, rs))
        want = sum(v * t for v, t in zip(vals_int, table)) % p
        assert got == want


class TestSumcheck:
    def test_eval_univariate(self, f):
        p = FQ.modulus
        # g(x) = 2 + 3x + x^2 -> evals at 0,1,2
        g = lambda x: (2 + 3 * x + x * x) % p
        evals = [f.encode(g(k)) for k in range(3)]
        r = 123456789
        got = f.decode(eval_univariate(f, evals, f.encode(r)))
        assert got == g(r)

    def test_sumcheck_product_roundtrip(self, f):
        p = FQ.modulus
        rng = random.Random(7)
        n = 8
        a_int = [rng.randrange(p) for _ in range(n)]
        b_int = [rng.randrange(p) for _ in range(n)]
        a, b = f.encode(a_int), f.encode(b_int)
        claim_int = sum(x * y for x, y in zip(a_int, b_int)) % p
        claim = f.encode(claim_int)

        tr = Transcript("Fq")
        tr.absorb(f.encode(1))
        rs, finals, msgs = sumcheck_prove(f, tr, [a, b], 2, "product", claim)

        tr2 = Transcript("Fq")
        tr2.absorb(f.encode(1))
        rs_v, final_claim, ok = sumcheck_verify(f, tr2, msgs, claim, degree=2)
        assert bool(np.all(np.asarray(ok)))
        # final claim must equal a(r)*b(r)
        got = f.decode(f.mul(finals[0], finals[1]))
        assert f.decode(final_claim) == got
        # and a(r) really is the multilinear evaluation
        assert f.decode(finals[0]) == f.decode(evaluate(f, a, rs))

    def test_sumcheck_wrong_claim_rejected(self, f):
        p = FQ.modulus
        a = f.encode([1, 2, 3, 4])
        b = f.encode([5, 6, 7, 8])
        claim = f.encode(999)  # wrong
        tr = Transcript("Fq")
        rs, finals, msgs = sumcheck_prove(f, tr, [a, b], 2, "product", claim)
        tr2 = Transcript("Fq")
        rs_v, _, ok = sumcheck_verify(f, tr2, msgs, claim, degree=2)
        # messages are honest sums, so g(0)+g(1) != claimed 999
        assert not bool(np.all(np.asarray(ok)))


class TestIPA:
    def test_ipa_roundtrip_and_reject(self, f):
        from vdf_nova.curves import get_curve
        from vdf_nova.nova.pedersen import commitment_key

        c = get_curve("pallas")
        n = 4
        ck = commitment_key("pallas", n)
        p = FQ.modulus
        rng = random.Random(5)
        a_int = [rng.randrange(p) for _ in range(n)]
        b_int = [rng.randrange(p) for _ in range(n)]
        a, b = f.encode(a_int), f.encode(b_int)
        comm = ck.commit(a)
        v = sum(x * y for x, y in zip(a_int, b_int)) % p

        tr = Transcript("Fq")
        proof = ipa_prove(f, c, ck.gens, ck.h, a, b, tr)
        tr2 = Transcript("Fq")
        assert bool(np.asarray(ipa_verify(f, c, ck.gens, ck.h, comm, b, f.encode(v), proof, tr2)))
        tr3 = Transcript("Fq")
        assert not bool(np.asarray(ipa_verify(
            f, c, ck.gens, ck.h, comm, b, f.encode((v + 1) % p), proof, tr3
        )))
class TestHostTier:
    """Host-int tier (spartan/host.py): roundtrip, tamper rejection, and
    bit-compatibility with the device tier (same transcripts, same
    proofs) on a tiny hand-built relaxed R1CS instance."""

    def _tiny_side(self):
        from vdf_nova.nova.ivc import HostRelaxedInstance, Side
        from vdf_nova.r1cs.cs import R1CSShape
        from vdf_nova.spartan.host import _ck_n, _msm_aff, host_ck

        p = FQ.modulus
        # 3 constraints over 4 aux + u + 2 inputs (z layout: W | u | X)
        a_coo = (np.array([0, 1, 1, 2]), np.array([0, 1, 2, 5]), [1, 1, 2, 1])
        b_coo = (np.array([0, 1, 2]), np.array([1, 4, 3]), [1, 1, 3])
        c_coo = (np.array([0, 1, 2]), np.array([6, 0, 2]), [1, 5, 1])
        shape = R1CSShape(3, 4, 2, p, a_coo, b_coo, c_coo)
        side = Side(None, shape, get_field("Fq"), "pallas", "Fp", "native")

        rng = random.Random(17)
        W = [rng.randrange(p) for _ in range(4)]
        X = [rng.randrange(p) for _ in range(2)]
        u = rng.randrange(1 << 128)
        z = W + [u % p] + X
        az, bz, cz = side.host_plane._matvecs(z)
        # E := Az∘Bz − u·Cz always satisfies the relaxed relation.
        E = [(a * b - u * c) % p for a, b, c in zip(az, bz, cz)]

        gens, _h = host_ck("pallas", _ck_n(shape))
        q = p
        U = HostRelaxedInstance(
            _msm_aff("pallas", list(gens[:4]), W, q),
            _msm_aff("pallas", list(gens[:3]), E, q),
            X,
            u,
        )
        return side, U, W, E

    @staticmethod
    def _spartan_ctx(side):
        """The surface spartan_prove/verify read (field, curve_name,
        dev_shape, nifs.ck), from an IVC Side."""
        return types.SimpleNamespace(
            field=side.field,
            curve_name=side.curve_name,
            dev_shape=side.dev_shape,
            nifs=types.SimpleNamespace(ck=side.ck),
        )

    @staticmethod
    def _encode_relaxed(side, U):
        from vdf_nova.nova.nifs import RelaxedInstance

        f = side.field
        return RelaxedInstance(
            side._encode_point(U.comm_w),
            side._encode_point(U.comm_e),
            f.encode([int(v) for v in U.X]),
            f.encode(int(U.u)),
        )

    def test_host_prove_verify_and_tamper(self):
        from vdf_nova.poseidon.int_poseidon import IntTranscript
        from vdf_nova.spartan.host import host_spartan_prove, host_spartan_verify

        side, U, W, E = self._tiny_side()
        tr = lambda: IntTranscript("Fq")
        proof = host_spartan_prove(side, U, W, E, tr())
        assert host_spartan_verify(side, U, proof, tr())

        bad = proof._replace(vA=(proof.vA + 1) % FQ.modulus)
        assert not host_spartan_verify(side, U, bad, tr())

        import dataclasses

        U_bad = dataclasses.replace(U, X=[(U.X[0] + 1) % FQ.modulus, U.X[1]])
        assert not host_spartan_verify(side, U_bad, proof, tr())

    def test_cross_tier_host_prove_device_verify(self):
        from vdf_nova.poseidon.int_poseidon import IntTranscript
        from vdf_nova.spartan.host import host_spartan_prove, spartan_to_device
        from vdf_nova.spartan.snark import spartan_verify

        side, U, W, E = self._tiny_side()
        proof = host_spartan_prove(side, U, W, E, IntTranscript("Fq"))
        dev = spartan_to_device(side, proof)
        ok = spartan_verify(
            self._spartan_ctx(side), self._encode_relaxed(side, U), dev, Transcript("Fq")
        )
        assert bool(np.asarray(ok))

    def test_cross_tier_device_prove_host_verify(self):
        from vdf_nova.nova.nifs import RelaxedWitness
        from vdf_nova.poseidon.int_poseidon import IntTranscript
        from vdf_nova.spartan.host import host_spartan_verify, spartan_from_device
        from vdf_nova.spartan.snark import spartan_prove

        side, U, W, E = self._tiny_side()
        f = side.field
        dev = spartan_prove(
            self._spartan_ctx(side),
            self._encode_relaxed(side, U),
            RelaxedWitness(f.encode(W), f.encode(E)),
            Transcript("Fq"),
        )
        host = spartan_from_device(side, dev)
        assert host_spartan_verify(side, U, host, IntTranscript("Fq"))

    def test_ipa_cross_tier(self):
        from vdf_nova.curves import get_curve
        from vdf_nova.nova.pedersen import commitment_key
        from vdf_nova.poseidon.int_poseidon import IntTranscript
        from vdf_nova.spartan.host import (
            host_ck,
            ipa_prove_ints,
            ipa_verify_ints,
            _msm_aff,
        )
        from vdf_nova.spartan.ipa import ipa_prove, ipa_verify

        f = get_field("Fq")
        c = get_curve("pallas")
        q = FQ.modulus
        n = 4
        ck = commitment_key("pallas", n)
        gens_i, h_i = host_ck("pallas", n)
        rng = random.Random(23)
        a = [rng.randrange(q) for _ in range(n)]
        b = [rng.randrange(q) for _ in range(n)]
        comm = _msm_aff("pallas", list(gens_i), a, q)
        v = sum(x * y for x, y in zip(a, b)) % q

        # host prove -> device verify
        hp = ipa_prove_ints("pallas", q, gens_i, h_i, a, b, IntTranscript("Fq"))
        from vdf_nova.curves.point import Point

        def enc_pt(aff):
            if aff is None:
                return c.identity(())
            pt = c.from_affine_ints([aff])
            return Point(*(w[0] for w in pt))

        from vdf_nova.spartan.ipa import IPAProof

        dev_form = IPAProof(
            tuple(enc_pt(x) for x in hp.ls),
            tuple(enc_pt(x) for x in hp.rs),
            f.encode(hp.a_final),
        )
        ok = ipa_verify(
            f, c, ck.gens, ck.h, enc_pt(comm), f.encode(b), f.encode(v),
            dev_form, Transcript("Fq"),
        )
        assert bool(np.asarray(ok))

        # device prove -> host verify
        dev = ipa_prove(f, c, ck.gens, ck.h, f.encode(a), f.encode(b), Transcript("Fq"))
        to_aff = lambda pt: c.to_affine_ints(Point(*(w[None] for w in pt)))[0]
        from vdf_nova.spartan.host import HostIPAProof

        host_form = HostIPAProof(
            tuple(to_aff(x) for x in dev.ls),
            tuple(to_aff(x) for x in dev.rs),
            f.decode(dev.a_final[None])[0],
        )
        assert ipa_verify_ints(
            "pallas", q, gens_i, h_i, comm, b, v, host_form, IntTranscript("Fq")
        )
        assert not ipa_verify_ints(
            "pallas", q, gens_i, h_i, comm, b, (v + 1) % q, host_form,
            IntTranscript("Fq"),
        )


import pytest as _pytest

pytestmark = _pytest.mark.slow  # heavy XLA compiles: slow CI lane
