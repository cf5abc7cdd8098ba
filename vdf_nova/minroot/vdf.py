"""MinRoot VDF over the Pasta scalar fields — lane-batched device evaluation.

Semantics mirror the reference trait ``MinRootVDF``
(/root/reference/src/minroot.rs:287-374):

  forward round (slow):   x' = (x + y)^invalpha,  y' = x + i,  i' = i + 1
  inverse round (fast):   i' = i - 1,  x' = y - i',  y' = x^5 - x'

Design differences from the reference:

  * State components are batched limb arrays ``(lanes..., 17)`` — every op
    is data-parallel over lanes, so thousands of independent VDF chains
    evaluate in lockstep ("VDF lanes", SURVEY.md §2.4 DP row).
  * ``t`` is static: ``eval`` is a ``lax.scan`` over rounds whose body is
    the compact exponentiation scan for the fixed exponent
    (fields/chains.py); there is no data-dependent control flow anywhere.
  * ``EvalMode`` selects the exponentiation schedule, mirroring the four
    reference strategies (/root/reference/src/minroot.rs:14-31).
"""

from __future__ import annotations

import enum
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..fields import Field, get_field
from ..fields.chains import pow_fixed, pow_fixed_scan, pow_fixed_scan_rtl


class EvalMode(str, enum.Enum):
    """Forward-step strategy (reference EvalMode, src/minroot.rs:14-31).

    All four compute the identical trace; they differ only in schedule.
    On the JAX path each maps to a compact uniform scan (window size
    below); the unrolled addition-chain programs (fields/chains.py
    generators) are the schedule a per-lane kernel would follow, and the
    parity tests use them.
    """

    LTR_SEQUENTIAL = "ltr_sequential"  # binary LTR scan
    LTR_ADD_CHAIN = "ltr_add_chain"  # windowed LTR scan, w=4
    RTL_SEQUENTIAL = "rtl_sequential"  # binary RTL scan
    RTL_ADD_CHAIN = "rtl_add_chain"  # windowed LTR scan, w=5

    @classmethod
    def all(cls) -> list["EvalMode"]:
        return list(cls)


_MODE_IMPL = {
    EvalMode.LTR_SEQUENTIAL: ("ltr", 1),
    EvalMode.LTR_ADD_CHAIN: ("ltr", 4),
    EvalMode.RTL_SEQUENTIAL: ("rtl", None),
    EvalMode.RTL_ADD_CHAIN: ("ltr", 5),
}


class State(NamedTuple):
    """VDF state triple; each leaf is a limb array (..., 17) in Montgomery
    form.  Mirrors reference ``State<T>`` (src/minroot.rs:267-272)."""

    x: jnp.ndarray
    y: jnp.ndarray
    i: jnp.ndarray


class MinRootVDF:
    """MinRoot over one Pasta field.

    ``PallasVDF`` ≙ ``MinRootVDF(get_field("Fq"))`` (Pallas' scalar field),
    ``VestaVDF``  ≙ ``MinRootVDF(get_field("Fp"))``.
    """

    INVERSE_EXPONENT = 5

    def __init__(self, field: Field, mode: EvalMode = EvalMode.LTR_SEQUENTIAL):
        self.field = field
        self.mode = EvalMode(mode)

    # -- steps ---------------------------------------------------------

    def forward_step(self, x: jnp.ndarray) -> jnp.ndarray:
        """x^invalpha — the slow 5th-root direction."""
        kind, window = _MODE_IMPL[self.mode]
        e = self.field.params.inv_alpha
        if kind == "rtl":
            return pow_fixed_scan_rtl(self.field, x, e)
        return pow_fixed_scan(self.field, x, e, window)

    def forward_step_unrolled(self, x: jnp.ndarray) -> jnp.ndarray:
        """Unrolled addition-chain form (mode-faithful schedule; the
        parity tests use this)."""
        return pow_fixed(self.field, x, self.field.params.inv_alpha, self.mode.value)

    def inverse_step(self, x: jnp.ndarray) -> jnp.ndarray:
        """x^5 — the fast direction (x * (x^2)^2)."""
        f = self.field
        return f.mul(f.sqr(f.sqr(x)), x)

    # -- rounds --------------------------------------------------------

    def round(self, s: State) -> State:
        f = self.field
        x = self.forward_step(f.add(s.x, s.y))
        y = f.add(s.x, s.i)
        # Keep the counter fully reduced so its magnitude cannot creep over
        # many rounds (x and y are re-reduced every round by mul/sub).
        i = f.partial_reduce(f.add(s.i, f.one), k_max=2)
        return State(x, y, i)

    def inverse_round(self, s: State) -> State:
        f = self.field
        i = f.sub(s.i, jnp.broadcast_to(f.one, s.i.shape))
        x = f.sub(s.y, i)
        y = f.sub(self.inverse_step(s.x), x)
        return State(x, y, i)

    # -- evaluation ----------------------------------------------------

    def eval(self, s: State, t: int) -> State:
        """t slow rounds (cached jitted lax.scan over the unrolled chain)."""
        return jit_eval(self.field.params.name, self.mode.value, t)(s)

    def inverse_eval(self, s: State, t: int) -> State:
        return jit_eval(self.field.params.name, self.mode.value, t, inverse=True)(s)

    def eval_uncached(self, s: State, t: int) -> State:
        """Traceable form (used inside enclosing jit/pjit)."""
        return jax.lax.scan(lambda c, _: (self.round(c), None), s, None, length=t)[0]

    def inverse_eval_uncached(self, s: State, t: int) -> State:
        return jax.lax.scan(
            lambda c, _: (self.inverse_round(c), None), s, None, length=t
        )[0]

    def check(self, result: State, t: int, original: State) -> jnp.ndarray:
        """Verify by inverting: original == inverse_eval(result, t).
        Returns a boolean array over lanes."""
        return self._check(self.inverse_eval(result, t), original)

    def check_uncached(self, result: State, t: int, original: State) -> jnp.ndarray:
        """Traceable form of check (for enclosing jit/pjit)."""
        return self._check(self.inverse_eval_uncached(result, t), original)

    def _check(self, back: State, original: State) -> jnp.ndarray:
        f = self.field
        return f.eq(back.x, original.x) & f.eq(back.y, original.y) & f.eq(
            back.i, original.i
        )

    # -- host-side conveniences ----------------------------------------

    def state_from_ints(self, x: int, y: int = 0, i: int = 0) -> State:
        f = self.field
        return State(f.encode(x), f.encode(y), f.encode(i))

    def state_to_ints(self, s: State):
        f = self.field
        return (f.decode(s.x), f.decode(s.y), f.decode(s.i))


def pallas_vdf(mode: EvalMode = EvalMode.LTR_SEQUENTIAL) -> MinRootVDF:
    """The reference's ``PallasVDF`` (MinRoot over Fq, src/minroot.rs:38-44)."""
    return MinRootVDF(get_field("Fq"), mode)


def vesta_vdf(mode: EvalMode = EvalMode.LTR_SEQUENTIAL) -> MinRootVDF:
    """The reference's ``VestaVDF`` (MinRoot over Fp, src/minroot.rs:199-262)."""
    return MinRootVDF(get_field("Fp"), mode)


@functools.lru_cache(maxsize=64)
def jit_eval(field_name: str, mode: str, t: int, inverse: bool = False):
    """Cached jitted evaluator: State -> State for fixed (field, mode, t)."""
    vdf = MinRootVDF(get_field(field_name), EvalMode(mode))
    fn = vdf.inverse_eval_uncached if inverse else vdf.eval_uncached
    return jax.jit(functools.partial(fn, t=t))
