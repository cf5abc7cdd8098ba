"""Pasta field parameters and host-side (Python int) derived constants.

The Pasta curve cycle has two 255-bit prime fields:

  * ``Fp`` — the base field of Pallas and scalar field of Vesta
    (reference: pasta_curves ``Fp``; used by ``VestaVDF``,
    /root/reference/src/minroot.rs:199-262).
  * ``Fq`` — the base field of Vesta and scalar field of Pallas
    (reference: pasta_curves ``Fq``; used by ``PallasVDF``,
    /root/reference/src/minroot.rs:38-197).

Both primes have the pseudo-Mersenne-ish form ``2^254 + c`` with a 126-bit
``c``, and both have 2-adicity 32 (p - 1 = 2^32 * odd), which matters for
Poseidon/FFT-style tooling later.

Device representation
---------------------
A field element on device is a vector of ``NLIMBS = 17`` radix ``2^16``
limbs stored little-endian in ``uint32``.  Rationale:

  * 16-bit limb products fit *exactly* in a single uint32 multiply
    (``(2^16-1)^2 < 2^32``), so schoolbook convolution needs no widening
    multiplies and maps onto one matmul (fields/ops.py ``Field._conv``).
  * 17 limbs give 272 bits of headroom, so Montgomery reduction with
    ``R = 2^272`` keeps every intermediate nonnegative and the standard
    bound ``t = (T + m*p)/R < B^2/R + p`` stays below ``2p`` for any
    inputs below ``2^263`` — far above anything our ops produce.

All constants below are computed from the primes at import time with exact
Python integers; nothing is transcribed from the reference beyond the two
moduli and the published inverse-alpha exponents (which are verified
against their defining property ``5 * e == 1 (mod p-1)`` at import time).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

# Number of 16-bit limbs per field element, and the Montgomery radix.
LIMB_BITS = 16
NLIMBS = 17
MONT_BITS = LIMB_BITS * NLIMBS  # 272
LIMB_MASK = (1 << LIMB_BITS) - 1

# The Pasta primes (pasta_curves 0.4; cited in SURVEY.md §2 D1).
P_FP = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
P_FQ = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001

# Inverse-alpha exponents: e = 5^{-1} mod (p - 1), so that
# (x^5)^e == x for all x.  Values match the reference's
# FP_RESCUE_INVALPHA / FQ_RESCUE_INVALPHA (/root/reference/src/minroot.rs:273-285)
# but are *derived* here and checked against the defining property.
FP_INVALPHA = pow(5, -1, P_FP - 1)
FQ_INVALPHA = pow(5, -1, P_FQ - 1)
assert (5 * FP_INVALPHA) % (P_FP - 1) == 1
assert (5 * FQ_INVALPHA) % (P_FQ - 1) == 1


def int_to_limbs(v: int, n: int = NLIMBS) -> np.ndarray:
    """Little-endian radix-2^16 limb decomposition as uint32."""
    if v < 0:
        raise ValueError("int_to_limbs requires a nonnegative value")
    out = np.zeros(n, dtype=np.uint32)
    for i in range(n):
        out[i] = v & LIMB_MASK
        v >>= LIMB_BITS
    if v:
        raise ValueError(f"value does not fit in {n} limbs")
    return out


def limbs_to_int(limbs) -> int:
    """Inverse of :func:`int_to_limbs`; accepts redundant (non-canonical) limbs."""
    v = 0
    for i, l in enumerate(np.asarray(limbs, dtype=np.uint64).tolist()):
        v += int(l) << (LIMB_BITS * i)
    return v


@dataclasses.dataclass(frozen=True)
class FieldParams:
    """Host-side description of one Pasta prime field.

    Device code consumes the precomputed numpy constant arrays; everything
    else (exact ints) serves host-side setup, testing, and I/O.
    """

    name: str
    modulus: int
    inv_alpha: int  # 5^{-1} mod (p-1): the slow-direction exponent

    # -- derived Montgomery constants (computed in __post_init__) --
    r: int = dataclasses.field(init=False)
    r2: int = dataclasses.field(init=False)
    pinv: int = dataclasses.field(init=False)  # -p^{-1} mod R
    mont_one: int = dataclasses.field(init=False)  # R mod p

    def __post_init__(self):
        R = 1 << MONT_BITS
        object.__setattr__(self, "r", R)
        object.__setattr__(self, "r2", (R * R) % self.modulus)
        object.__setattr__(self, "pinv", (-pow(self.modulus, -1, R)) % R)
        object.__setattr__(self, "mont_one", R % self.modulus)

    # ---- numpy constant tables (cached) ----

    @functools.cached_property
    def p_limbs(self) -> np.ndarray:
        return int_to_limbs(self.modulus)

    @functools.cached_property
    def pinv_limbs(self) -> np.ndarray:
        return int_to_limbs(self.pinv)

    @functools.cached_property
    def r2_limbs(self) -> np.ndarray:
        return int_to_limbs(self.r2)

    @functools.cached_property
    def mont_one_limbs(self) -> np.ndarray:
        return int_to_limbs(self.mont_one)

    @functools.cached_property
    def sub_pad_limbs(self) -> np.ndarray:
        """``8p - 2^256 + 1``: additive pad making subtraction borrow-free.

        ``sub(a, b) = a + sub_pad + comp16(b)`` where ``comp16`` is the
        limb-wise complement of the low 16 limbs; the total adds exactly
        ``8p - b`` (valid for ``b < 2^256``), so the result is congruent
        to ``a - b`` and strictly nonnegative.
        """
        v = 8 * self.modulus - (1 << 256) + 1
        assert v > 0
        return int_to_limbs(v)

    @functools.cached_property
    def p_multiples_limbs(self) -> np.ndarray:
        """``[p*2^k for k in 0..7]`` stacked, for partial reduction sweeps."""
        return np.stack([int_to_limbs(self.modulus << k) for k in range(8)])

    # ---- host-side exact arithmetic (test oracle / setup) ----

    def to_mont(self, v: int) -> int:
        return (v * self.r) % self.modulus

    def from_mont(self, v: int) -> int:
        return (v * pow(self.r, -1, self.modulus)) % self.modulus


FP = FieldParams("Fp", P_FP, FP_INVALPHA)
FQ = FieldParams("Fq", P_FQ, FQ_INVALPHA)

# The reference's canonical VDF field: PallasVDF evaluates over Pallas'
# *scalar* field, which is Fq (/root/reference/src/minroot.rs:38-44).
PALLAS_SCALAR = FQ
VESTA_SCALAR = FP
