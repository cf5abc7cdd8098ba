"""Fixed-exponent exponentiation programs (addition chains).

The VDF's slow direction is ``x^invalpha`` with a fixed 254-bit exponent
(reference: the four ``EvalMode`` strategies,
/root/reference/src/minroot.rs:14-31,77-196).  Because exponents are
compile-time constants in this framework, every strategy is expressed as a
straight-line *program* of square/multiply ops generated on the host and
unrolled into the XLA graph (or a kernel) at trace time.

Four generators mirror the reference's four strategies in spirit, but the
chains themselves are derived here from the exponent's value:

  * ``ltr_sequential``  — plain left-to-right binary square-and-multiply.
  * ``ltr_add_chain``   — exploits the Pasta invalpha structure
    ``e = u * 2^128 + v`` with ``u = 0x33 repeated`` (a consequence of
    ``e = 5^{-1} mod (p-1)``): Horner over the repeating byte, then a
    sliding-window scan of the low 128 bits (~253 sq + ~50 mul).  Falls
    back to a generic sliding window for unstructured exponents.
  * ``rtl_sequential``  — right-to-left binary.
  * ``rtl_add_chain``   — RTL over the low 128 bits, then the repeating
    byte tail handled with one multiply per byte period.

Every generated program is verified against Python-int ``pow`` at build
time, so a generator bug cannot silently produce wrong chains.
"""

from __future__ import annotations

import functools

REPEAT_BYTE_SECTION_BITS = 128


class _Builder:
    """Straight-line SSA program builder: reg 0 is the input."""

    def __init__(self):
        self.ops: list[tuple] = []
        self.n = 1

    def sqr(self, a: int) -> int:
        self.ops.append(("sqr", self.n, a))
        self.n += 1
        return self.n - 1

    def mul(self, a: int, b: int) -> int:
        self.ops.append(("mul", self.n, a, b))
        self.n += 1
        return self.n - 1

    def sqr_n(self, a: int, n: int) -> int:
        for _ in range(n):
            a = self.sqr(a)
        return a


def _odd_power_table(b: _Builder, w: int) -> dict[int, int]:
    """Registers holding x^k for odd k < 2^w (x^2 built as a stepping stone)."""
    tbl = {1: 0}
    if w <= 1:
        return tbl
    x2 = b.sqr(0)
    cur = 0
    for odd in range(3, 1 << w, 2):
        cur = b.mul(cur, x2)
        tbl[odd] = cur
    return tbl


def _window_scan(b: _Builder, bits: str, acc: int | None, tbl: dict, w: int) -> int:
    """Continue an LTR scan over `bits` using sliding windows of width <= w."""
    i = 0
    while i < len(bits):
        if bits[i] == "0":
            if acc is not None:
                acc = b.sqr(acc)
            i += 1
        else:
            j = min(i + w, len(bits))
            while bits[j - 1] == "0":
                j -= 1
            val = int(bits[i:j], 2)
            if acc is None:
                acc = tbl[val]
            else:
                acc = b.sqr_n(acc, j - i)
                acc = b.mul(acc, tbl[val])
            i = j
    assert acc is not None
    return acc


def _repeat_byte_structure(e: int) -> tuple[int, int] | None:
    """If the bits of e above the low 128 form a repeating byte, return
    (byte, low128).  Both Pasta invalpha exponents have byte 0x33 there."""
    v = e & ((1 << REPEAT_BYTE_SECTION_BITS) - 1)
    u = e >> REPEAT_BYTE_SECTION_BITS
    if u == 0:
        return None
    byte = u & 0xFF
    n_bytes, rem = divmod(u.bit_length() + 7, 8)
    expect = int.from_bytes(bytes([byte]) * n_bytes, "little")
    if byte != 0 and expect == u:
        return byte, v
    return None


def gen_ltr_sequential(e: int) -> tuple[list[tuple], int]:
    b = _Builder()
    bits = bin(e)[2:]
    acc = 0
    for bit in bits[1:]:
        acc = b.sqr(acc)
        if bit == "1":
            acc = b.mul(acc, 0)
    return b.ops, acc


def gen_rtl_sequential(e: int) -> tuple[list[tuple], int]:
    b = _Builder()
    s = 0
    acc = None
    nbits = e.bit_length()
    for k in range(nbits):
        if (e >> k) & 1:
            acc = s if acc is None else b.mul(acc, s)
        if k + 1 < nbits:
            s = b.sqr(s)
    assert acc is not None
    return b.ops, acc


def gen_sliding_window(e: int, w: int = 4) -> tuple[list[tuple], int]:
    b = _Builder()
    tbl = _odd_power_table(b, w)
    acc = _window_scan(b, bin(e)[2:], None, tbl, w)
    return b.ops, acc


def gen_ltr_add_chain(e: int, w: int = 4) -> tuple[list[tuple], int]:
    structure = _repeat_byte_structure(e)
    if structure is None:
        return gen_sliding_window(e, w)
    byte, v = structure
    u = e >> REPEAT_BYTE_SECTION_BITS
    n_bytes = (u.bit_length() + 7) // 8
    b = _Builder()
    tbl = _odd_power_table(b, w)
    # x^byte via the shared window table, then Horner over the byte string:
    # acc <- acc^(2^8) * x^byte, repeated.
    acc_byte = _window_scan(b, bin(byte)[2:], None, tbl, w)
    acc = acc_byte
    for _ in range(n_bytes - 1):
        acc = b.sqr_n(acc, 8)
        acc = b.mul(acc, acc_byte)
    # Continue LTR through the low 128 bits (with leading zeros as squarings).
    low_bits = bin(v)[2:].zfill(REPEAT_BYTE_SECTION_BITS)
    acc = _window_scan(b, low_bits, acc, tbl, w)
    return b.ops, acc


def gen_rtl_add_chain(e: int) -> tuple[list[tuple], int]:
    structure = _repeat_byte_structure(e)
    if structure is None:
        return gen_rtl_sequential(e)
    byte, v = structure
    u = e >> REPEAT_BYTE_SECTION_BITS
    n_bytes = (u.bit_length() + 7) // 8
    b = _Builder()
    # RTL over the low 128 bits, keeping the running square.
    s = 0
    acc = None
    for k in range(REPEAT_BYTE_SECTION_BITS):
        if (v >> k) & 1:
            acc = s if acc is None else b.mul(acc, s)
        s = b.sqr(s)
    # s == x^(2^128).  t = s^byte (tiny LTR chain), then one multiply per
    # byte period: acc *= t^(2^(8k)).
    t = None
    for bit in bin(byte)[2:]:
        t = b.sqr(t) if t is not None else None
        if bit == "1":
            t = s if t is None else b.mul(t, s)
    assert t is not None
    acc = t if acc is None else b.mul(acc, t)
    for _ in range(n_bytes - 1):
        t = b.sqr_n(t, 8)
        acc = b.mul(acc, t)
    return b.ops, acc


_GENERATORS = {
    "ltr_sequential": gen_ltr_sequential,
    "ltr_add_chain": gen_ltr_add_chain,
    "rtl_sequential": gen_rtl_sequential,
    "rtl_add_chain": gen_rtl_add_chain,
}


def _check_program(ops: list[tuple], out_reg: int, e: int) -> None:
    """Verify exactly: track each register's exponent as an integer."""
    exp = {0: 1}
    for op in ops:
        if op[0] == "sqr":
            exp[op[1]] = 2 * exp[op[2]]
        else:
            exp[op[1]] = exp[op[2]] + exp[op[3]]
    assert exp[out_reg] == e, f"generated chain computes x^{exp[out_reg]}, not x^{e}"


@functools.lru_cache(maxsize=None)
def get_program(e: int, mode: str) -> tuple[tuple[tuple, ...], int]:
    if e <= 0:
        raise ValueError("exponent must be positive")
    ops, out = _GENERATORS[mode](e)
    _check_program(ops, out, e)
    return tuple(ops), out


def program_cost(e: int, mode: str) -> tuple[int, int]:
    """(num_squarings, num_muls) of the generated chain — for benchmarks."""
    ops, _ = get_program(e, mode)
    sq = sum(1 for op in ops if op[0] == "sqr")
    return sq, len(ops) - sq


def _digits_msb(e: int, window: int) -> list[int]:
    bits = bin(e)[2:]
    pad = (-len(bits)) % window
    bits = "0" * pad + bits
    return [int(bits[k : k + window], 2) for k in range(0, len(bits), window)]


import functools as _ft


@_ft.lru_cache(maxsize=None)
def _pow_scan_jit(field_name: str, e: int, window: int, shape: tuple):
    """Shape-keyed jitted wrapper: eager callers would otherwise
    recompile the scan on every call (fresh body closure each time)."""
    import jax

    from .ops import get_field

    f = get_field(field_name)
    return jax.jit(lambda x: _pow_fixed_scan_traced(f, x, e, window))


def pow_fixed_scan(field, x, e: int, window: int = 4):
    """x^e as a uniform windowed LTR scan — see _pow_fixed_scan_traced.

    Dispatches through a cached jit so repeated eager calls reuse one
    executable; under an enclosing jit the wrapper simply inlines.
    """
    return _pow_scan_jit(field.params.name, e, window, tuple(x.shape))(x)


def _pow_fixed_scan_traced(field, x, e: int, window: int = 4):
    """x^e as a *uniform* windowed LTR scan (compact XLA graph).

    The chain programs from the generators above unroll ~300 ops — ideal
    inside a hand-written kernel, but bloated as an XLA scan body.  This variant
    compiles one (window-squarings + table-multiply) body and scans it
    over the static digit string, trading ~10% extra multiplies for a
    ~50x smaller graph.  Used by the pure-JAX VDF evaluation path.
    """
    import jax
    import jax.numpy as jnp

    if e == 0:
        return jnp.broadcast_to(field.one, x.shape)
    digits = _digits_msb(e, window)
    # table[k] = x^k (k < 2^window); table[0] = Montgomery one.
    entries = [jnp.broadcast_to(field.one, x.shape), x]
    for _ in range(2, 1 << window):
        entries.append(field.mul(entries[-1], x))
    table = jnp.stack(entries[: 1 << window])

    acc = table[digits[0]]  # static index
    if len(digits) > 1:
        def body(acc, d):
            for _ in range(window):
                acc = field.sqr(acc)
            return field.mul(acc, jnp.take(table, d, axis=0)), None

        acc, _ = jax.lax.scan(body, acc, jnp.asarray(digits[1:], dtype=jnp.int32))
    return acc


@_ft.lru_cache(maxsize=None)
def _pow_scan_rtl_jit(field_name: str, e: int, shape: tuple):
    import jax

    from .ops import get_field

    f = get_field(field_name)
    return jax.jit(lambda x: _pow_fixed_scan_rtl_traced(f, x, e))


def pow_fixed_scan_rtl(field, x, e: int):
    """Cached-jit eager entry for the RTL scan form."""
    return _pow_scan_rtl_jit(field.params.name, e, tuple(x.shape))(x)


def _pow_fixed_scan_rtl_traced(field, x, e: int):
    """x^e as a uniform RTL binary scan (square both; select multiply)."""
    import jax
    import jax.numpy as jnp

    if e == 0:
        return jnp.broadcast_to(field.one, x.shape)
    bits = jnp.asarray([(e >> k) & 1 for k in range(e.bit_length())], jnp.bool_)

    def body(carry, bit):
        acc, s = carry
        acc = jnp.where(bit, field.mul(acc, s), acc)
        return (acc, field.sqr(s)), None

    (acc, _), _ = jax.lax.scan(
        body, (jnp.broadcast_to(field.one, x.shape), x), bits
    )
    return acc


def pow_fixed(field, x, e: int, mode: str = "ltr_add_chain"):
    """x^e elementwise over the field, via the cached chain for (e, mode)."""
    if e == 0:
        import jax.numpy as jnp

        return jnp.broadcast_to(field.one, x.shape)
    ops, out = get_program(e, mode)
    regs = {0: x}
    for op in ops:
        if op[0] == "sqr":
            regs[op[1]] = field.sqr(regs[op[2]])
        else:
            regs[op[1]] = field.mul(regs[op[2]], regs[op[3]])
    return regs[out]
