"""Batched Pasta field arithmetic in JAX (uint32 limb vectors).

Design (see also fields/params.py):

  * A field element is ``(..., NLIMBS=17)`` uint32 limbs, radix ``2^16``,
    little-endian, in Montgomery form with ``R = 2^272``.
  * All ops are natively batched over leading axes — no ``vmap`` needed —
    and contain no data-dependent control flow, so they trace/jit/shard
    cleanly.
  * Carry propagation is *fully parallel*: two digit-folding passes bring
    limbs to at most ``base``, then a Kogge–Stone generate/propagate
    prefix resolves ripple carries in ``log2(n)`` steps.  No sequential
    scan anywhere.

Reference parity: this layer plays the role of ``pasta_curves``' Fp/Fq
(``ff::Field`` ops used at /root/reference/src/minroot.rs:2-4), re-designed
as batched limb arrays whose products run as one matmul each, instead of
u64 Montgomery scalars.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.backend import profile
from .params import (
    LIMB_BITS,
    LIMB_MASK,
    MONT_BITS,
    NLIMBS,
    FieldParams,
    int_to_limbs,
    limbs_to_int,
)

_BASE = 1 << LIMB_BITS


def _shift_limbs_up(v: jnp.ndarray, k: int) -> jnp.ndarray:
    """Multiply by 2^(16k): move limbs toward the high end, keep length."""
    if k == 0:
        return v
    pad = [(0, 0)] * (v.ndim - 1) + [(k, 0)]
    return jnp.pad(v, pad)[..., : v.shape[-1]]


def resolve(v: jnp.ndarray, out_len: int) -> jnp.ndarray:
    """Exact parallel carry resolution to canonical limbs (< 2^16).

    ``v`` may hold redundant limbs up to ~2^23.  The value is preserved
    exactly when it fits in ``out_len`` limbs; otherwise the result is
    correct modulo ``2^(16*out_len)`` (used deliberately for mod-R math).
    """
    L = v.shape[-1]
    if L < out_len:
        v = jnp.pad(v, [(0, 0)] * (v.ndim - 1) + [(0, out_len - L)])
    elif L > out_len:
        raise ValueError("resolve cannot shrink the limb axis")

    # Two folding passes: limbs <= 2^23 -> <= base (carries become 0/1).
    for _ in range(2):
        lo = v & LIMB_MASK
        c = v >> LIMB_BITS
        v = lo + _shift_limbs_up(c, 1)

    # v's digits are now in [0, base].  Resolve the remaining 0/1 ripple
    # carries with a Kogge-Stone prefix over (generate, propagate).
    g = v >= _BASE  # this digit overflows regardless of carry-in
    p = v == (_BASE - 1)  # this digit overflows iff carry-in
    d = 1
    while d < out_len:
        g_lo = _shift_limbs_up(g.astype(jnp.uint32), d).astype(bool)
        p_lo = _shift_limbs_up(p.astype(jnp.uint32), d).astype(bool)
        g = g | (p & g_lo)
        p = p & p_lo
        d *= 2
    carry_in = _shift_limbs_up(g.astype(jnp.uint32), 1)
    return (v + carry_in) & LIMB_MASK


class Field:
    """Device-side op set for one Pasta prime field.

    Invariants maintained between ops:
      * elements are 17 canonical limbs (< 2^16 each);
      * values are < 2p after ``mul``/``sqr``/``sub``; ``add`` returns the
        raw sum (still canonical-limbed) and is safe to feed anywhere.
    """

    def __init__(self, params: FieldParams):
        self.params = params
        self.p_limbs = jnp.asarray(params.p_limbs)
        self.pinv_limbs = jnp.asarray(params.pinv_limbs)
        self.r2_limbs = jnp.asarray(params.r2_limbs)
        self.one = jnp.asarray(params.mont_one_limbs)  # R mod p (Montgomery 1)
        self.zero = jnp.zeros(NLIMBS, dtype=jnp.uint32)
        self.sub_pad = jnp.asarray(params.sub_pad_limbs)  # 8p - 2^256 + 1
        # comp17(p * 2^k) + 1 for conditional subtraction, k = 0..7.
        comp = []
        for k in range(16):
            pk = params.modulus << k
            comp.append(int_to_limbs((1 << MONT_BITS) - pk))  # 2^272 - pk
        self._condsub_comp = jnp.asarray(np.stack(comp))
        # Scatter matrices turning a flattened outer product of limbs into
        # positional convolution sums via one matmul (Field._conv).
        idx = np.arange(NLIMBS)
        i_grid, j_grid = np.meshgrid(idx, idx, indexing="ij")
        k_lo = (i_grid + j_grid).reshape(-1)  # lo half lands at limb i+j
        k_hi = (i_grid + j_grid + 1).reshape(-1)  # hi half at limb i+j+1

        def scatter_mat(ks, out_len):
            m = np.zeros((ks.size, out_len), dtype=np.float32)
            valid = ks < out_len
            m[np.arange(ks.size)[valid], ks[valid]] = 1.0
            return m

        def conv_mat(out_len):
            # the lo/hi 16-bit halves of each outer product land at limb
            # i+j / i+j+1 with weight 1
            return jnp.asarray(
                np.concatenate([scatter_mat(k_lo, out_len), scatter_mat(k_hi, out_len)])
            )

        self._conv_mats = conv_mat(2 * NLIMBS + 1), conv_mat(NLIMBS)  # full, truncated
        # Jit the public ops: compiled once per input shape, then cheap to
        # dispatch eagerly; inside an enclosing jit/scan they inline.
        # _mul_core stays its own jitted sub-computation: inlining it into
        # the chunking lax.map body re-triggers the XLA:CPU miscompile the
        # chunking exists to dodge (see Field.mul).
        for name in ("_mul_core", "add", "sub", "mul", "sqr", "neg", "canon", "from_mont"):
            setattr(self, name, jax.jit(getattr(self, name)))
        self.partial_reduce = jax.jit(self.partial_reduce, static_argnames=("k_max",))

    # ------------------------------------------------------------------
    # basic ops
    # ------------------------------------------------------------------

    def add(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """a + b (no reduction; value grows, limbs stay canonical)."""
        return resolve(a + b, NLIMBS)

    def _cond_sub_pk(self, v: jnp.ndarray, k: int) -> jnp.ndarray:
        """If v >= p*2^k, subtract p*2^k.  Requires canonical v."""
        # v + (2^272 - pk): the 2^272 overflows into limb 17 iff v >= pk.
        w = resolve(v + self._condsub_comp[k], NLIMBS + 1)
        borrow_free = w[..., NLIMBS] > 0
        return jnp.where(borrow_free[..., None], w[..., :NLIMBS], v)

    def partial_reduce(self, v: jnp.ndarray, k_max: int = 7) -> jnp.ndarray:
        """Reduce canonical v < 2*p*2^k_max to < p by conditional subtracts
        (k_max <= 15)."""
        for k in range(k_max, -1, -1):
            v = self._cond_sub_pk(v, k)
        return v

    def sub(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """a - b mod p, result < 2p.  Accepts a < 2^258, b < 2^259."""
        # Bring b below 2p (< 2^256) so the 16-limb complement trick applies.
        for k in (4, 3, 2, 1):
            b = self._cond_sub_pk(b, k)
        # a + (8p - 2^256 + 1) + (2^256 - 1 - b) == a - b + 8p  (all nonneg).
        comp_b = jnp.where(
            jnp.arange(NLIMBS) < NLIMBS - 1, LIMB_MASK - b, jnp.uint32(0)
        )
        r = resolve(a + self.sub_pad + comp_b, NLIMBS)
        # a - b + 8p < 2^259: sweep down to < 2p.
        for k in (4, 3, 2, 1):
            r = self._cond_sub_pk(r, k)
        return r

    def neg(self, a: jnp.ndarray) -> jnp.ndarray:
        return self.sub(jnp.broadcast_to(self.zero, a.shape), a)

    # ------------------------------------------------------------------
    # multiplication
    # ------------------------------------------------------------------

    def _conv(self, a: jnp.ndarray, b: jnp.ndarray, full: bool) -> jnp.ndarray:
        """Schoolbook limb convolution as one float32 matmul.

        The flattened outer product of canonical limbs (exact 16x16-bit
        products in uint32) is split into 16-bit halves and scattered
        into positional sums by a constant 0/1 matrix.  Every operand is
        < 2^16 and each output dot sums <= 34 such terms (< 2^22), exact
        in float32's 24-bit mantissa — provided the matmul really runs in
        float32: a GPU runs a default-precision float32 matmul in TF32
        (10-bit mantissa), hence HIGHEST.  ``full=False`` truncates to 17
        limbs (mod R, for the Montgomery m factor).

        A library gemm also keeps XLA:CPU off the giant fused integer
        loops of shifted-MAC formulations, which it miscompiled above
        ~40k rows and fed into minutes-long algebraic-simplifier loops.
        """
        outer = a[..., :, None] * b[..., None, :]
        outer = outer.reshape(*outer.shape[:-2], NLIMBS * NLIMBS)
        planes = jnp.concatenate([outer & 0xFFFF, outer >> 16], axis=-1)
        return jnp.matmul(
            planes.astype(jnp.float32),
            self._conv_mats[0 if full else 1],
            precision=jax.lax.Precision.HIGHEST,
        ).astype(jnp.uint32)

    def mul(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """Montgomery product a*b*R^-1 mod p; result < 2p, canonical limbs.

        Batches above the backend's ``mul_chunk_rows`` run in chunks via
        ``lax.map`` over a separately-jitted core: XLA:CPU miscompiles the
        big fused conv/resolve composite above a batch threshold — wrong
        limbs for every row, while each stage is exact in isolation.
        Chunking also sidesteps the XLA:CPU algebraic-simplifier blowups
        that dominated compile times.
        """
        shape = jnp.broadcast_shapes(a.shape, b.shape)
        rows = int(np.prod(shape[:-1], dtype=np.int64)) if len(shape) > 1 else 1
        chunk = profile().mul_chunk_rows
        if chunk is None or rows <= chunk:
            return self._mul_core(a, b)
        a = jnp.broadcast_to(a, shape).reshape(-1, NLIMBS)
        b = jnp.broadcast_to(b, shape).reshape(-1, NLIMBS)
        k = -(-rows // chunk)
        pad = k * chunk - rows
        if pad:
            a = jnp.pad(a, ((0, pad), (0, 0)))
            b = jnp.pad(b, ((0, pad), (0, 0)))
        out = jax.lax.map(
            lambda ab: self._mul_core(ab[0], ab[1]),
            (a.reshape(k, chunk, NLIMBS), b.reshape(k, chunk, NLIMBS)),
        )
        return out.reshape(k * chunk, NLIMBS)[:rows].reshape(shape)

    def _mul_core(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """One-chunk Montgomery product (see ``mul``).

        The m factor is computed from the *resolved* low half of T; its own
        redundancy only shifts the quotient by a small multiple of p, which
        the output bound absorbs (see fields/params.py notes).
        """
        t = resolve(self._conv(a, b, full=True), 2 * NLIMBS + 1)
        # m = (t mod R) * (-p^-1) mod R
        m = resolve(self._conv(t[..., :NLIMBS], self.pinv_limbs, full=False), NLIMBS)
        mp = self._conv(m, jnp.broadcast_to(self.p_limbs, m.shape), full=True)
        total = resolve(t + mp, 2 * NLIMBS + 2)
        # (t + m*p) is divisible by R: low limbs are zero; shift right by R.
        return total[..., NLIMBS : 2 * NLIMBS]

    def sqr(self, a: jnp.ndarray) -> jnp.ndarray:
        return self.mul(a, a)

    # ------------------------------------------------------------------
    # canonical form / io
    # ------------------------------------------------------------------

    def canon(self, v: jnp.ndarray) -> jnp.ndarray:
        """Fully reduce to the canonical representative < p."""
        return self.partial_reduce(resolve(v, NLIMBS))

    def eq(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        return jnp.all(self.canon(a) == self.canon(b), axis=-1)

    def is_zero(self, a: jnp.ndarray) -> jnp.ndarray:
        return jnp.all(self.canon(a) == 0, axis=-1)

    def to_mont(self, x: jnp.ndarray) -> jnp.ndarray:
        """Canonical-integer limbs -> Montgomery form."""
        return self.mul(x, jnp.broadcast_to(self.r2_limbs, x.shape))

    def from_mont(self, a: jnp.ndarray) -> jnp.ndarray:
        """Montgomery form -> canonical-integer limbs (< p)."""
        one = jnp.zeros_like(a).at[..., 0].set(1)
        return self.canon(self.mul(a, one))

    # field-agnostic helpers (same surface as IntField, so gadget code is
    # polymorphic over device-limb and host-int execution) ------------------

    def const_like(self, like: jnp.ndarray, k: int) -> jnp.ndarray:
        return jnp.broadcast_to(self.encode(k), like.shape)

    def zero_like(self, like: jnp.ndarray) -> jnp.ndarray:
        return jnp.broadcast_to(self.zero, like.shape)

    def one_like(self, like: jnp.ndarray) -> jnp.ndarray:
        return jnp.broadcast_to(self.one, like.shape)

    # host-side conversions -------------------------------------------------

    def encode(self, values) -> jnp.ndarray:
        """Python int (or sequence of ints) -> Montgomery limb array."""
        p = self.params.modulus
        to_mont = self.params.to_mont
        if isinstance(values, (int, np.integer)):
            return jnp.asarray(int_to_limbs(to_mont(int(values) % p)))
        # bytes fast path (bit-identical to int_to_limbs): one to_bytes
        # per element + a single frombuffer beats 17 shift/mask ops per
        # element ~5x — witness encoding is on the per-fold critical path
        # (nova/ivc.py::Side.encode_w, ~15k elements per step).
        buf = b"".join(
            to_mont(int(v) % p).to_bytes(2 * NLIMBS, "little") for v in values
        )
        arr = np.frombuffer(buf, dtype="<u2").reshape(-1, NLIMBS)
        return jnp.asarray(arr.astype(np.uint32))

    def decode(self, a: jnp.ndarray) -> list[int]:
        """Montgomery limb array -> canonical Python ints."""
        canon = np.asarray(jax.device_get(self.from_mont(a)))
        if canon.ndim == 1:
            return limbs_to_int(canon)
        return [limbs_to_int(row) for row in canon.reshape(-1, NLIMBS)]

    # ------------------------------------------------------------------
    # inversion / exponentiation helpers (chains live in chains.py)
    # ------------------------------------------------------------------

    def inv(self, a: jnp.ndarray) -> jnp.ndarray:
        """a^(p-2): multiplicative inverse (0 maps to 0).

        Uses the compact scan form: inversion appears inside large jitted
        regions (point normalization, IPA folds), where an unrolled
        300-op chain would bloat every enclosing graph.
        """
        from .chains import pow_fixed_scan

        return pow_fixed_scan(self, a, self.params.modulus - 2, window=4)


@functools.cache
def get_field(name: str) -> Field:
    from . import params as P

    return Field({"Fp": P.FP, "Fq": P.FQ}[name])
