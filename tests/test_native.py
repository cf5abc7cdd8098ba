"""Native C++ tier tests: cross-check against exact int oracles and the
JAX field path (independent implementations agreeing = strong evidence)."""

import random

import pytest

from vdf_nova.fields import FP, FQ

native = pytest.importorskip("vdf_nova.native")


def oracle_eval(p, e, x, y, i, t):
    for _ in range(t):
        x, y, i = pow((x + y) % p, e, p), (x + i) % p, (i + 1) % p
    return (x, y, i)


class TestNativeVDF:
    @pytest.mark.parametrize("field_name,P", [("Fq", FQ), ("Fp", FP)])
    def test_eval_matches_oracle(self, field_name, P):
        got = native.minroot_eval_native(field_name, 12345, 6789, 0, 8)
        assert got == oracle_eval(P.modulus, P.inv_alpha, 12345, 6789, 0, 8)

    def test_inverse_roundtrip(self):
        fwd = native.minroot_eval_native("Fq", 55555, 0, 0, 12)
        assert native.minroot_inverse_native("Fq", *fwd, 12) == (55555, 0, 0)

    def test_native_matches_jax_path(self):
        from vdf_nova.minroot import pallas_vdf

        vdf = pallas_vdf()
        s = vdf.state_from_ints(424242, 17, 0)
        r = vdf.eval(s, 5)
        assert vdf.state_to_ints(r) == native.minroot_eval_native(
            "Fq", 424242, 17, 0, 5
        )


class TestNativeMSM:
    def test_msm_matches_jax_msm(self):
        from vdf_nova.curves import get_curve, hash_to_curve_ints, msm

        c = get_curve("pallas")
        mod = FP.modulus
        n = 7
        pts = hash_to_curve_ints("pallas", n)
        rng = random.Random(3)
        scalars = [rng.randrange(FQ.modulus) for _ in range(n)]
        jax_res = c.to_affine_ints(msm(c, c.from_affine_ints(pts), c.scalar.encode(scalars)))[0]
        nat = native.msm_native("pallas", pts, scalars)
        x, y, z = nat
        zi = pow(z, -1, mod)
        nat_aff = (x * zi * zi % mod, y * zi * zi * zi % mod)  # Jacobian
        assert jax_res == nat_aff

    def test_msm_zero_scalars(self):
        pts = native.msm_native(
            "pallas", [(FP.modulus - 1, 2)], [0]
        )
        assert pts is None

    @pytest.mark.parametrize("curve_name", ["pallas", "vesta"])
    def test_fold_points_matches_int_curve(self, curve_name):
        """out[i] = a*P[i] + b*Q[i] (the IPA generator fold) vs the exact
        int-curve oracle."""
        from vdf_nova.curves import hash_to_curve_ints
        from vdf_nova.curves.int_ops import get_int_curve

        ic = get_int_curve(curve_name)
        n = 5
        pts = hash_to_curve_ints(curve_name, 2 * n, domain=b"fold-test")
        P, Q = pts[:n], pts[n:]
        rng = random.Random(11)
        q_mod = (FQ if curve_name == "pallas" else FP).modulus
        a, b = rng.randrange(1, q_mod), rng.randrange(1, q_mod)
        got = native.fold_points_native(curve_name, P, Q, a, b)
        for i in range(n):
            want = ic.add(
                ic.scalar_mul(ic.from_affine(P[i]), a),
                ic.scalar_mul(ic.from_affine(Q[i]), b),
            )
            assert got[i] == ic.to_affine(want)

# (fast lane: first-compile cost is tamed by the persistent cache)
