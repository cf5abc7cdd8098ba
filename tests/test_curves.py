"""Curve group-law and MSM tests vs exact Python-int EC arithmetic."""

import numpy as np
import pytest

from vdf_nova.curves import Point, get_curve, hash_to_curve_ints, msm, sqrt_mod
from vdf_nova.fields import FP, FQ


def ec_add_int(p, q, mod):
    """Exact affine addition (None = identity)."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2 and (y1 + y2) % mod == 0:
        return None
    if p == q:
        lam = (3 * x1 * x1) * pow(2 * y1, -1, mod) % mod
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, mod) % mod
    x3 = (lam * lam - x1 - x2) % mod
    y3 = (lam * (x1 - x3) - y1) % mod
    return (x3, y3)


def ec_mul_int(p, k, mod):
    acc = None
    add = p
    while k:
        if k & 1:
            acc = ec_add_int(acc, add, mod)
        add = ec_add_int(add, add, mod)
        k >>= 1
    return acc


CURVES = [("pallas", FP), ("vesta", FQ)]


@pytest.fixture(params=CURVES, ids=[c for c, _ in CURVES])
def curve_and_field(request):
    name, P = request.param
    return get_curve(name), P


class TestGroupLaw:
    def test_generator_on_curve(self, curve_and_field):
        c, P = curve_and_field
        g = c.to_affine_ints(c.generator((1,)))[0]
        x, y = g
        assert (y * y) % P.modulus == (x * x * x + 5) % P.modulus
        assert g == (P.modulus - 1, 2)

    def test_add_double_vs_int_oracle(self, curve_and_field):
        c, P = curve_and_field
        mod = P.modulus
        g = (mod - 1, 2)
        G = c.generator((1,))
        # 2G, 3G, 4G via device ops
        G2 = c.double(G)
        G3 = c.add(G2, G)
        G4 = c.double(G2)
        G4b = c.add(G3, G)
        for dev, k in [(G2, 2), (G3, 3), (G4, 4), (G4b, 4)]:
            assert c.to_affine_ints(dev)[0] == ec_mul_int(g, k, mod)

    def test_complete_edge_cases(self, curve_and_field):
        """Identity and inverse inputs flow through the complete adder."""
        c, _ = curve_and_field
        G = c.generator((1,))
        O = c.identity((1,))
        assert bool(np.asarray(c.eq(c.add(G, O), G)).all())
        assert bool(np.asarray(c.eq(c.add(O, G), G)).all())
        assert bool(np.asarray(c.is_identity(c.add(G, c.neg(G)))).all())
        assert bool(np.asarray(c.eq(c.add(G, G), c.double(G))).all())
        assert bool(np.asarray(c.is_identity(c.double(O))).all())

    def test_scalar_mul(self, curve_and_field):
        import jax.numpy as jnp

        c, P = curve_and_field
        mod = P.modulus
        k = 0xDEADBEEF12345
        bits = jnp.asarray([[(k >> b) & 1] for b in range(64)], dtype=jnp.uint8)
        got = c.scalar_mul_bits(c.generator((1,)), bits)
        assert c.to_affine_ints(got)[0] == ec_mul_int((mod - 1, 2), k, mod)


class TestHashToCurve:
    def test_points_on_curve_and_distinct(self):
        pts = hash_to_curve_ints("pallas", 8)
        mod = FP.modulus
        assert len(set(pts)) == 8
        for x, y in pts:
            assert (y * y) % mod == (x * x * x + 5) % mod


class TestMSM:
    def test_msm_matches_oracle(self, curve_and_field):
        c, P = curve_and_field
        mod = P.modulus
        smod = c.scalar.params.modulus
        n = 5
        pts_int = hash_to_curve_ints(c.params.name, n)
        pts = c.from_affine_ints(pts_int)
        import random

        rng = random.Random(99)
        scalars = [rng.randrange(smod) for _ in range(n)]
        got = c.to_affine_ints(msm(c, pts, c.scalar.encode(scalars)))[0]
        want = None
        for (pt, s) in zip(pts_int, scalars):
            want = ec_add_int(want, ec_mul_int(pt, s, mod), mod)
        assert got == want

    def test_msm_zero_and_one_scalars(self, curve_and_field):
        c, _ = curve_and_field
        pts_int = hash_to_curve_ints(c.params.name, 3)
        pts = c.from_affine_ints(pts_int)
        s = c.scalar.encode([0, 1, 0])
        got = c.to_affine_ints(msm(c, pts, s))[0]
        assert got == pts_int[1]

# (fast lane: first-compile cost is tamed by the persistent cache)
