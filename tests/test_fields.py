"""Field-arithmetic tests against an exact Python-int oracle.

Mirrors the reference's testing stance (SURVEY.md §4): deterministic
seeded inputs, property checks per op, cross-checked against exact
integer arithmetic (our stand-in for pasta_curves' canonical behavior —
the math is identical, so equality here is bit-exactness of traces).
"""

import random

import numpy as np
import pytest

import dataclasses

from vdf_nova.fields import FP, FQ, Field, get_field, limbs_to_int, pow_fixed, program_cost
from vdf_nova.fields.ops import resolve
from vdf_nova.utils import backend
import jax.numpy as jnp

FIELDS = [("Fq", FQ), ("Fp", FP)]


@pytest.fixture(params=FIELDS, ids=[n for n, _ in FIELDS])
def field_and_params(request):
    name, params = request.param
    return get_field(name), params


def rand_ints(p, n, seed=1234):
    rng = random.Random(seed)
    return [rng.randrange(p) for _ in range(n)]


class TestBasicOps:
    def test_encode_decode_roundtrip(self, field_and_params):
        f, P = field_and_params
        vals = [0, 1, 2, P.modulus - 1, P.modulus // 2] + rand_ints(P.modulus, 5)
        assert f.decode(f.encode(vals)) == vals

    def test_mul(self, field_and_params):
        f, P = field_and_params
        a = rand_ints(P.modulus, 16, seed=1)
        b = rand_ints(P.modulus, 16, seed=2)
        got = f.decode(f.mul(f.encode(a), f.encode(b)))
        assert got == [(x * y) % P.modulus for x, y in zip(a, b)]

    def test_sqr(self, field_and_params):
        f, P = field_and_params
        a = rand_ints(P.modulus, 16, seed=3)
        assert f.decode(f.sqr(f.encode(a))) == [(x * x) % P.modulus for x in a]

    def test_add_sub(self, field_and_params):
        f, P = field_and_params
        a = rand_ints(P.modulus, 16, seed=4)
        b = rand_ints(P.modulus, 16, seed=5)
        A, B = f.encode(a), f.encode(b)
        assert f.decode(f.add(A, B)) == [(x + y) % P.modulus for x, y in zip(a, b)]
        assert f.decode(f.sub(A, B)) == [(x - y) % P.modulus for x, y in zip(a, b)]
        assert f.decode(f.sub(B, A)) == [(y - x) % P.modulus for x, y in zip(a, b)]

    def test_neg(self, field_and_params):
        f, P = field_and_params
        a = rand_ints(P.modulus, 8, seed=6) + [0]
        assert f.decode(f.neg(f.encode(a))) == [(-x) % P.modulus for x in a]

    def test_edge_values(self, field_and_params):
        """p-1, 1, 0 behave correctly under every op."""
        f, P = field_and_params
        p = P.modulus
        edge = [0, 1, p - 1, p - 2]
        A = f.encode(edge)
        assert f.decode(f.mul(A, A)) == [(x * x) % p for x in edge]
        assert f.decode(f.add(A, A)) == [(2 * x) % p for x in edge]
        assert f.decode(f.sub(A, f.encode([1, 1, 1, 1]))) == [
            (x - 1) % p for x in edge
        ]

    def test_chained_ops_stay_bounded(self, field_and_params):
        """Long chains of mixed ops keep producing exact results (the
        magnitude invariants hold under composition)."""
        f, P = field_and_params
        p = P.modulus
        a, b = rand_ints(p, 4, seed=7), rand_ints(p, 4, seed=8)
        A, B = f.encode(a), f.encode(b)
        ai, bi = list(a), list(b)
        for _ in range(20):
            A, B = f.add(A, B), f.sub(f.mul(A, B), A)
            ai, bi = (
                [(x + y) % p for x, y in zip(ai, bi)],
                [(x * y - x) % p for x, y in zip(ai, bi)],
            )
        assert f.decode(A) == ai
        assert f.decode(B) == bi

    def test_eq_is_zero(self, field_and_params):
        f, P = field_and_params
        a = f.encode([5, 0, P.modulus - 1])
        b = f.encode([5, 1, P.modulus - 1])
        assert list(np.asarray(f.eq(a, b))) == [True, False, True]
        assert list(np.asarray(f.is_zero(a))) == [False, True, False]

    def test_broadcasting_shapes(self, field_and_params):
        """Ops broadcast over arbitrary leading axes (lane batching)."""
        f, P = field_and_params
        a = rand_ints(P.modulus, 12, seed=9)
        A = f.encode(a).reshape(3, 4, -1)
        got = f.decode(f.mul(A, A).reshape(12, -1))
        assert got == [(x * x) % P.modulus for x in a]


class TestConvolution:
    """The limb convolution is the exact product (mod 2^272 truncated)."""

    @pytest.mark.parametrize("full", [True, False], ids=["full", "truncated"])
    def test_conv_matches_ints(self, field_and_params, full):
        f, _ = field_and_params
        rng = np.random.default_rng(13)
        a = rng.integers(0, 1 << 16, size=(64, 17), dtype=np.uint32)
        b = rng.integers(0, 1 << 16, size=(64, 17), dtype=np.uint32)
        a[0], b[0] = 0xFFFF, 0xFFFF  # largest limbs: the exactness bound
        out = np.asarray(f._conv(jnp.asarray(a), jnp.asarray(b), full))
        assert out.shape == (64, 35 if full else 17)
        mod = 1 << (16 * out.shape[1])
        for x, y, o in zip(a, b, out):
            val = sum(int(v) << (16 * k) for k, v in enumerate(o))
            assert val % mod == limbs_to_int(x) * limbs_to_int(y) % mod


class TestMulChunking:
    @pytest.mark.parametrize("rows", [64, 200])
    def test_mul_across_chunk_boundary(self, field_and_params, monkeypatch, rows):
        """Batches past the chunk size run as a lax.map over padded chunks
        and still give every row's exact product."""
        _, P = field_and_params
        prof = backend.profile()
        monkeypatch.setitem(
            backend._PROFILES, prof.platform,
            dataclasses.replace(prof, mul_chunk_rows=64),
        )
        f = Field(P)  # fresh jitted ops: they read the profile when traced
        a = rand_ints(P.modulus, rows, seed=14)
        b = rand_ints(P.modulus, rows, seed=15)
        A = f.encode(a).reshape(rows // 8, 8, -1) if rows % 8 == 0 else f.encode(a)
        got = f.decode(f.mul(A, f.encode(b).reshape(A.shape)).reshape(rows, -1))
        assert got == [(x * y) % P.modulus for x, y in zip(a, b)]


@pytest.mark.gpu
class TestGpuProfile:
    """Reproduce the GPU profile's choices on the card: the f32 limb
    convolution at Precision.HIGHEST is exact at the prover's sizes, and
    the unchunked multiply (mul_chunk_rows=None) is exact at 2^15, 2^17
    and 2^20 rows."""

    @staticmethod
    def _sampled_rows(rows, sample=4096, seed=21):
        rng = np.random.default_rng(seed)
        a = rng.integers(0, 1 << 16, size=(rows, 17), dtype=np.uint32)
        b = rng.integers(0, 1 << 16, size=(rows, 17), dtype=np.uint32)
        for v in (a, b):  # below 2^255: the range mul's operands take
            v[:, 15] &= 0x7FFF
            v[:, 16] = 0
        idx = np.sort(rng.choice(rows, size=min(sample, rows), replace=False))
        return a, b, idx

    @pytest.mark.parametrize("log_rows", [14, 18])
    def test_conv_exact_at_size(self, field_and_params, log_rows):
        f, _ = field_and_params
        a, b, idx = self._sampled_rows(1 << log_rows)
        out = np.asarray(f._conv(jnp.asarray(a), jnp.asarray(b), True))[idx]
        for x, y, o in zip(a[idx], b[idx], out):
            val = sum(int(v) << (16 * k) for k, v in enumerate(o))
            assert val == limbs_to_int(x) * limbs_to_int(y)

    @pytest.mark.parametrize("log_rows", [15, 17, 20])
    def test_unchunked_mul_exact(self, field_and_params, log_rows):
        f, P = field_and_params
        assert backend.profile().mul_chunk_rows is None
        p = P.modulus
        r_inv = pow(1 << 272, -1, p)
        a, b, idx = self._sampled_rows(1 << log_rows)
        got = f.decode(f.mul(jnp.asarray(a), jnp.asarray(b))[jnp.asarray(idx)])
        want = [
            (limbs_to_int(x) * r_inv) * (limbs_to_int(y) * r_inv) % p
            for x, y in zip(a[idx], b[idx])
        ]
        assert got == want


class TestResolve:
    def test_resolve_redundant_limbs(self):
        """Parallel carry resolution matches exact integer semantics."""
        rng = np.random.default_rng(0)
        raw = rng.integers(0, 1 << 23, size=(50, 17), dtype=np.uint32)
        out = np.asarray(resolve(jnp.asarray(raw), 19))
        from vdf_nova.fields import limbs_to_int

        for r, o in zip(raw, out):
            assert limbs_to_int(r) == limbs_to_int(o)
            assert (o <= 0xFFFF).all()

    def test_resolve_worst_case_ripple(self):
        """0xffff...ffff + 1 must carry across the whole number."""
        v = np.full((1, 17), 0xFFFF, dtype=np.uint32)
        v[0, 0] += 1
        out = np.asarray(resolve(jnp.asarray(v), 18))
        from vdf_nova.fields import limbs_to_int

        assert limbs_to_int(out[0]) == 1 << (16 * 17)


class TestPow:
    @pytest.mark.parametrize(
        "mode", ["ltr_sequential", "ltr_add_chain", "rtl_sequential", "rtl_add_chain"]
    )
    def test_invalpha_all_modes(self, field_and_params, mode):
        f, P = field_and_params
        a = rand_ints(P.modulus, 4, seed=10)
        got = f.decode(pow_fixed(f, f.encode(a), P.inv_alpha, mode))
        assert got == [pow(x, P.inv_alpha, P.modulus) for x in a]

    def test_chain_costs_documented(self):
        """The structured LTR chain must stay near the reference's 254+33."""
        sq, mul = program_cost(FQ.inv_alpha, "ltr_add_chain")
        assert sq <= 254 and mul <= 60

    def test_generic_exponents(self, field_and_params):
        f, P = field_and_params
        a = rand_ints(P.modulus, 2, seed=11)
        for e in [1, 2, 3, 5, 31, 65537, (1 << 64) - 59]:
            got = f.decode(pow_fixed(f, f.encode(a), e, "ltr_add_chain"))
            assert got == [pow(x, e, P.modulus) for x in a]

    def test_inv(self, field_and_params):
        f, P = field_and_params
        a = rand_ints(P.modulus, 4, seed=12)
        assert f.decode(f.inv(f.encode(a))) == [pow(x, -1, P.modulus) for x in a]
