"""Pasta curve points over limb field elements (batched, branch-free).

Plays the role of ``pasta_curves``' group ops (SURVEY.md §2 D1): Pallas
(y^2 = x^3 + 5 over Fp, scalar field Fq) and Vesta (the reverse cycle).

Design:
  * Homogeneous projective coordinates with the **complete** addition
    formulas of Renes–Costello–Batina 2015 (Algorithm 7/9, a=0 case).
    Completeness means no branches for identity/doubling special cases —
    essential for batched SIMD execution and for masked/padded MSM
    reductions where identity padding flows through the adder.
  * Points are pytrees of limb arrays, batched over leading axes like
    every field op.

Host-side exact-int helpers (generator derivation, Tonelli–Shanks sqrt)
support setup; the device never needs a square root.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..fields import Field, get_field

B_COEFF = 5  # y^2 = x^3 + 5 for both Pasta curves
B3 = 15  # 3*b, used by the complete formulas


class Point(NamedTuple):
    """Projective (X : Y : Z); identity is (0 : 1 : 0)."""

    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class CurveParams:
    name: str
    base_field: str  # coordinates live here
    scalar_field: str  # group order field


PALLAS = CurveParams("pallas", base_field="Fp", scalar_field="Fq")
VESTA = CurveParams("vesta", base_field="Fq", scalar_field="Fp")


class Curve:
    def __init__(self, params: CurveParams):
        self.params = params
        self.field: Field = get_field(params.base_field)
        self.scalar: Field = get_field(params.scalar_field)
        self._b3 = self.field.encode(B3)

    # -- constructors ---------------------------------------------------

    def identity(self, shape=()) -> Point:
        f = self.field
        zero = jnp.broadcast_to(f.zero, (*shape, f.zero.shape[-1]))
        one = jnp.broadcast_to(f.one, (*shape, f.one.shape[-1]))
        return Point(zero, one, zero)

    def generator(self, shape=()) -> Point:
        """The pasta_curves generator (-1, 2) — on both curves since
        (-1)^3 + 5 = 4 = 2^2."""
        f = self.field
        p = f.params.modulus
        x = jnp.broadcast_to(f.encode(p - 1), (*shape, 17))
        y = jnp.broadcast_to(f.encode(2), (*shape, 17))
        z = jnp.broadcast_to(f.one, (*shape, 17))
        return Point(x, y, z)

    def from_affine_ints(self, coords: list[tuple[int, int]]) -> Point:
        """Host ints [(x, y), ...] -> batched projective points."""
        f = self.field
        xs = f.encode([c[0] for c in coords])
        ys = f.encode([c[1] for c in coords])
        zs = jnp.broadcast_to(f.one, xs.shape)
        return Point(xs, ys, zs)

    # -- group law (complete, RCB15 algorithm 7/9 for a=0) --------------

    def add(self, p: Point, q: Point) -> Point:
        f = self.field
        b3 = jnp.broadcast_to(self._b3, p.x.shape)
        x1, y1, z1 = p
        x2, y2, z2 = q
        t0 = f.mul(x1, x2)
        t1 = f.mul(y1, y2)
        t2 = f.mul(z1, z2)
        t3 = f.mul(f.add(x1, y1), f.add(x2, y2))
        t3 = f.sub(t3, f.add(t0, t1))
        t4 = f.mul(f.add(y1, z1), f.add(y2, z2))
        t4 = f.sub(t4, f.add(t1, t2))
        x3 = f.mul(f.add(x1, z1), f.add(x2, z2))
        y3 = f.sub(x3, f.add(t0, t2))
        x3 = f.add(t0, f.add(t0, t0))  # 3*t0
        t2b = f.mul(b3, t2)
        z3 = f.add(t1, t2b)
        t1 = f.sub(t1, t2b)
        y3 = f.mul(b3, y3)
        x3_out = f.sub(f.mul(t3, t1), f.mul(t4, y3))
        y3_out = f.add(f.mul(t1, z3), f.mul(y3, x3))
        z3_out = f.add(f.mul(z3, t4), f.mul(x3, t3))
        return Point(x3_out, y3_out, z3_out)

    def double(self, p: Point) -> Point:
        """Complete doubling (RCB15 algorithm 9, a=0): 6M+2S."""
        f = self.field
        b3 = jnp.broadcast_to(self._b3, p.x.shape)
        x, y, z = p
        t0 = f.sqr(y)
        z3 = f.add(t0, f.add(t0, f.add(t0, f.add(t0, f.add(t0, f.add(t0, f.add(t0, t0)))))))  # 8*t0
        t1 = f.mul(y, z)
        t2 = f.mul(b3, f.sqr(z))
        x3 = f.mul(t2, z3)
        y3 = f.add(t0, t2)
        z3 = f.mul(t1, z3)
        t1 = f.add(t2, f.add(t2, t2))  # 3*t2
        t0 = f.sub(t0, t1)
        y3 = f.add(f.mul(t0, y3), x3)
        x3 = f.mul(f.mul(x, y), t0)
        x3 = f.add(x3, x3)
        return Point(x3, y3, z3)

    def neg(self, p: Point) -> Point:
        return Point(p.x, self.field.neg(p.y), p.z)

    def select(self, mask: jnp.ndarray, p: Point, q: Point) -> Point:
        """mask ? p : q, elementwise over the batch (mask shape = batch)."""
        m = mask[..., None]
        return Point(
            jnp.where(m, p.x, q.x), jnp.where(m, p.y, q.y), jnp.where(m, p.z, q.z)
        )

    # -- conversions / predicates --------------------------------------

    def is_identity(self, p: Point) -> jnp.ndarray:
        return self.field.is_zero(p.z)

    def eq(self, p: Point, q: Point) -> jnp.ndarray:
        """Projective equality: X1*Z2 == X2*Z1 and Y1*Z2 == Y2*Z1 (plus
        both-identity)."""
        f = self.field
        cross_x = f.eq(f.mul(p.x, q.z), f.mul(q.x, p.z))
        cross_y = f.eq(f.mul(p.y, q.z), f.mul(q.y, p.z))
        both_id = self.is_identity(p) & self.is_identity(q)
        return (cross_x & cross_y) | both_id

    def to_affine_ints(self, p: Point) -> list[tuple[int, int] | None]:
        """Host-side exact affine decode (None = identity)."""
        f = self.field
        mod = f.params.modulus
        xs, ys, zs = (f.decode(a) for a in p)
        if isinstance(xs, int):
            xs, ys, zs = [xs], [ys], [zs]
        out = []
        for x, y, z in zip(xs, ys, zs):
            if z == 0:
                out.append(None)
            else:
                zi = pow(z, -1, mod)
                out.append(((x * zi) % mod, (y * zi) % mod))
        return out

    # -- scalar multiplication -----------------------------------------

    def scalar_mul_bits(self, p: Point, bits: jnp.ndarray) -> Point:
        """Batched double-and-add over little-endian bit array (n_bits, ...).
        Constant sequence of complete adds — no data-dependent branching.
        Dispatches through a shape-keyed cached jit (eager callers reuse
        one executable; inside jit it inlines)."""
        return _scalar_mul_jit(
            self.params.name, tuple(p.x.shape), tuple(bits.shape)
        )(p, bits)

    def _scalar_mul_bits_traced(self, p: Point, bits: jnp.ndarray) -> Point:
        def body(carry, bit):
            acc, base = carry
            added = self.add(acc, base)
            acc = self.select(bit.astype(bool), added, acc)
            return (acc, self.double(base)), None

        shape = p.x.shape[:-1]
        (acc, _), _ = jax.lax.scan(body, (self.identity(shape), p), bits)
        return acc


@functools.cache
def get_curve(name: str) -> Curve:
    return Curve({"pallas": PALLAS, "vesta": VESTA}[name])


@functools.lru_cache(maxsize=None)
def _scalar_mul_jit(curve_name: str, p_shape: tuple, bits_shape: tuple):
    curve = get_curve(curve_name)
    return jax.jit(curve._scalar_mul_bits_traced)


# ---------------------------------------------------------------------
# host-side exact helpers (setup only)
# ---------------------------------------------------------------------


def sqrt_mod(a: int, p: int) -> int | None:
    """Tonelli–Shanks square root mod p (None if non-residue)."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    # p - 1 = q * 2^s
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    # find a non-residue
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t = t * c % p
        r = r * b % p
    return r


def hash_to_curve_ints(curve_name: str, n: int, domain: bytes = b"vdf_nova/pedersen") -> list[tuple[int, int]]:
    """Derive n independent curve points by try-and-increment over a
    hash-derived x-stream (setup-time; exact ints).

    Independence rests on the x-coordinates being hash outputs with no
    known discrete logs — the standard Pedersen setup assumption.
    Cached: the device commitment key, the host plane and the host
    Spartan tier all derive the same 2^14-point keys.
    """
    return list(_hash_to_curve_cached(curve_name, n, domain))


@functools.lru_cache(maxsize=16)
def _hash_to_curve_cached(curve_name: str, n: int, domain: bytes) -> tuple:
    import hashlib

    params = {"pallas": PALLAS, "vesta": VESTA}[curve_name]
    p = get_field(params.base_field).params.modulus
    out = []
    ctr = 0
    while len(out) < n:
        h = hashlib.sha512(domain + curve_name.encode() + ctr.to_bytes(8, "little")).digest()
        ctr += 1
        x = int.from_bytes(h, "little") % p
        y2 = (x * x * x + B_COEFF) % p
        y = sqrt_mod(y2, p)
        if y is None:
            continue
        out.append((x, min(y, p - y)))  # canonical sign
    return tuple(out)
