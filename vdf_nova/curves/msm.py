"""Multi-scalar multiplication on the device (pasta-msm equivalent, SURVEY §2 D5).

The reference links supranational's native Pippenger through
``pasta-msm``; here MSM is built from batched complete point ops so the
whole reduction runs as wide device passes and shards over the mesh.

Two evaluators:

  * ``msm`` (v1, default): windowless select+tree — processes scalar bits
    MSB-first; per bit, a masked identity-padded tree reduction of all
    points.  O(bits * N) point-adds of width-N batches; simple, exact,
    fully data-parallel.  Fine for the witness sizes Nova folding needs
    per step (10^3..10^5 points).
  * ``msm_windowed``: c-bit windowed variant that reduces the doubling
    chain (bits/c tree passes, digit mini-MSM per window) — the stepping
    stone to the sorted-bucket Pippenger for large MSMs.

Scalars arrive in Montgomery form (like every field element here) and
are converted to canonical bits on device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..utils.backend import profile
from .point import Curve, Point


def _scalar_bits(curve: Curve, scalars_mont: jnp.ndarray, n_bits: int) -> jnp.ndarray:
    """(N, 17) Montgomery -> (n_bits, N) bit planes (little-endian)."""
    canon = curve.scalar.from_mont(scalars_mont)
    limb = canon[..., jnp.arange(n_bits) // 16]  # (N, n_bits)
    bits = (limb >> (jnp.arange(n_bits) % 16)) & 1
    return bits.T.astype(jnp.uint8)  # (n_bits, N)


def _pad_pow2(curve: Curve, p: Point) -> Point:
    n = p.x.shape[0]
    m = 1 << (n - 1).bit_length()
    if m == n:
        return p
    pad = curve.identity((m - n,))
    return Point(*(jnp.concatenate([a, b], axis=0) for a, b in zip(p, pad)))


def _tree_sum(curve: Curve, p: Point) -> Point:
    """Reduce a batch of points to one by pairwise complete adds."""
    n = p.x.shape[0]
    while n > 1:
        half = n // 2
        a = Point(*(v[0:2 * half:2] for v in p))
        b = Point(*(v[1:2 * half:2] for v in p))
        s = curve.add(a, b)
        if n % 2:
            s = Point(*(jnp.concatenate([v, w[-1:]], axis=0) for v, w in zip(s, p)))
        p = s
        n = p.x.shape[0]
    return Point(*(v[0] for v in p))


def _tree_sum_axis1(curve: Curve, p: Point) -> Point:
    """Reduce (B, N) points over axis 1 by pairwise adds -> (B,) points.
    Each level is one wide batched add."""
    n = p.x.shape[1]
    while n > 1:
        half = n // 2
        a = Point(*(v[:, 0 : 2 * half : 2] for v in p))
        b = Point(*(v[:, 1 : 2 * half : 2] for v in p))
        s = curve.add(a, b)
        if n % 2:
            s = Point(
                *(jnp.concatenate([v, w[:, -1:]], axis=1) for v, w in zip(s, p))
            )
        p = s
        n = p.x.shape[1]
    return Point(*(v[:, 0] for v in p))


def msm_traceable(curve: Curve, points: Point, scalars_mont: jnp.ndarray) -> Point:
    """Σ s_i · P_i (traceable form; see ``msm`` for the jitted entry).

    Shape strategy: select every scalar bit-plane up front (n_bits, N),
    tree-reduce the point axis with the bit-plane axis batched (log2(N)
    wide adds instead of n_bits sequential trees), then combine the
    n_bits partials with a short Horner doubling chain.
    """
    n_bits = curve.scalar.params.modulus.bit_length()
    bits = _scalar_bits(curve, scalars_mont, n_bits)  # (bits, N)
    points = _pad_pow2(curve, points)
    nbatch = points.x.shape[0]
    bits = jnp.pad(bits, ((0, 0), (0, nbatch - bits.shape[1])))
    ident = curve.identity((n_bits, nbatch))
    planes = Point(*(jnp.broadcast_to(v[None], (n_bits, *v.shape)) for v in points))
    selected = curve.select(bits.astype(bool), planes, ident)

    partials = _tree_sum_axis1(curve, selected)  # (n_bits,) points, LSB first

    def body(acc, q):
        acc = curve.double(acc)
        acc = curve.add(acc, q)
        return acc, None

    acc0 = curve.identity(())
    acc, _ = jax.lax.scan(
        body, acc0, Point(*(v[::-1] for v in partials))
    )
    return acc


# ---------------------------------------------------------------------
# sorted-bucket Pippenger (the pasta-msm equivalent proper)
# ---------------------------------------------------------------------
#
# Per c-bit window: sort points by digit, reduce each same-digit run
# with a *blocked segmented scan*, scatter the run tails into the bucket
# array, then the classic suffix-sum  Σ_b b·B_b = Σ_b S_b  and a Horner
# double chain across windows.
#
# The segmented scan is the compile-critical piece.  jax's
# associative_scan inlines ~2·log2(N) distinct instances of the
# complete-add graph (minutes of XLA time at Nova witness sizes); here
# every scan is a lax loop whose body is traced ONCE:
#
#   phase 1  column-chunked sequential scan — reshape the sorted array
#            column-major to (R, L) so each of L lanes owns a contiguous
#            chunk, then lax.scan down the R rows (N adds total, exactly
#            work-efficient, one traced add of width L);
#   phase 2  segmented Hillis–Steele over the L per-column summaries
#            (log2(L) levels via fori_loop, one traced add) to produce
#            the carry flowing into each column;
#   phase 3  one masked wide add applying carries to each column's first
#            run.
#
# No bucket-capacity assumption anywhere: adversarially skewed digit
# distributions change nothing.


def _seg_combine(curve: Curve):
    """The segmented-scan monoid on (point, head_flag) pairs:
    combine((va,fa),(vb,fb)) = (fb ? vb : va+vb, fa|fb)."""

    def combine(a, b):
        pa, fa = a
        pb, fb = b
        s = curve.add(pa, pb)
        out = curve.select(fb.astype(bool), pb, s)
        return out, fa | fb

    return combine


def _segmented_scan_sorted(
    curve: Curve, pts: Point, heads: jnp.ndarray, lanes: int
) -> Point:
    """Inclusive segmented scan over a (padded) sorted point array.

    ``heads[i] = 1`` marks the start of a run; returns per-position run
    prefixes.  N must be a multiple of ``lanes``.
    """
    n = pts.x.shape[0]
    assert n % lanes == 0
    rows = n // lanes
    combine = _seg_combine(curve)

    # column-major: lane j owns sorted positions j*rows .. (j+1)*rows-1.
    col = Point(*(v.reshape(lanes, rows, *v.shape[1:]).swapaxes(0, 1) for v in pts))
    hcol = heads.reshape(lanes, rows).T  # (R, L)

    def step(state, xs):
        row, hrow = xs
        acc = combine(state, (row, hrow))
        return acc, acc

    init = (curve.identity((lanes,)), jnp.zeros((lanes,), jnp.uint8))
    (last_v, last_f), (ys_v, ys_f) = jax.lax.scan(step, init, (col, hcol))

    # phase 2: exclusive segmented scan of the column summaries.
    def hs_level(k, state):
        v, f = state
        d = 1 << k
        sh_v = Point(*(jnp.roll(x, d, axis=0) for x in v))
        sh_f = jnp.roll(f, d, axis=0)
        cv, cf = combine((sh_v, sh_f), (v, f))
        mask = jnp.arange(lanes) >= d
        out_v = curve.select(mask, cv, v)
        out_f = jnp.where(mask, cf, f)
        return out_v, out_f

    n_levels = max((lanes - 1).bit_length(), 0)
    inc_v, _ = jax.lax.fori_loop(0, n_levels, hs_level, (last_v, last_f))
    # shift right one column: carry INTO column j = inclusive scan of j-1.
    carry = Point(*(jnp.roll(x, 1, axis=0) for x in inc_v))
    carry = curve.select(jnp.arange(lanes) == 0, curve.identity((lanes,)), carry)

    # phase 3: positions not yet past a head absorb the column carry.
    carried = curve.add(Point(*(jnp.broadcast_to(x, y.shape) for x, y in zip(carry, ys_v))), ys_v)
    out = curve.select(ys_f.astype(bool), ys_v, carried)
    return Point(*(v.swapaxes(0, 1).reshape(n, *v.shape[2:]) for v in out))


def _hs_scan(curve: Curve, pts: Point) -> Point:
    """Plain inclusive scan (prefix point-sums) via Hillis–Steele:
    log2(n) levels, ONE traced add."""
    n = pts.x.shape[0]

    def level(k, v):
        d = 1 << k
        sh = Point(*(jnp.roll(x, d, axis=0) for x in v))
        s = curve.add(sh, v)
        return curve.select(jnp.arange(n) >= d, s, v)

    return jax.lax.fori_loop(0, max((n - 1).bit_length(), 0), level, pts)


def _scan_lanes(n: int) -> int:
    """Lane count for the blocked scan: wide enough to keep the device fed,
    shallow enough that the sequential chunk walk stays short."""
    return max(1, min(1 << 12, n // 8))


def msm_pippenger_traceable(
    curve: Curve, points: Point, scalars_mont: jnp.ndarray, c: int = 12
) -> Point:
    """Σ s_i · P_i via sorted-bucket Pippenger: ~2N + 2^c·log(2^c) adds
    per window vs the bit-plane evaluator's N per *bit*.

    ALL windows run batched (vmap over the window axis): the sorted
    segmented scans, bucket scatters, and suffix sums execute as single
    wide device passes of shape (W, ...).  Only the closing Horner
    double-and-add chain over the ~W per-window sums is sequential —
    running windows one by one would pay ~W× the per-pass dispatch
    overhead of the wide point adds."""
    n = points.x.shape[0]
    lanes = _scan_lanes(n)
    n_pad = -(-n // lanes) * lanes
    if n_pad != n:
        pad = curve.identity((n_pad - n,))
        points = Point(*(jnp.concatenate([a, b]) for a, b in zip(points, pad)))
    n_bits = curve.scalar.params.modulus.bit_length()
    n_windows = -(-n_bits // c)

    bits = _scalar_bits(curve, scalars_mont, n_bits)  # (bits, N) u8
    bits = jnp.pad(bits, ((0, n_windows * c - n_bits), (0, n_pad - n)))
    weights = (1 << jnp.arange(c, dtype=jnp.uint32))[None, :, None]
    digits = jnp.sum(
        bits.reshape(n_windows, c, n_pad).astype(jnp.uint32) * weights, axis=1
    )  # (W, N), LSB window first.  Padded points land in digit 0 (dumped).

    n_buckets = 1 << c

    def window_sum(digits_w: jnp.ndarray) -> Point:
        order = jnp.argsort(digits_w)
        d_s = digits_w[order]
        pts = Point(*(v[order] for v in points))
        head = jnp.concatenate(
            [jnp.ones((1,), jnp.uint8), (d_s[1:] != d_s[:-1]).astype(jnp.uint8)]
        )
        run_sums = _segmented_scan_sorted(curve, pts, head, lanes)
        tail = jnp.concatenate([(d_s[1:] != d_s[:-1]), jnp.ones((1,), bool)])
        # scatter run tails to their buckets (digit 0 excluded via the
        # dump row n_buckets, dropped below).  One tail per digit, so
        # .set never collides.
        idx = jnp.where(tail & (d_s != 0), d_s, n_buckets)
        ident = curve.identity((n_buckets + 1,))
        buckets = Point(*(iv.at[idx].set(sv) for iv, sv in zip(ident, run_sums)))
        buckets = Point(*(v[1:n_buckets] for v in buckets))  # b = 1..B-1
        # suffix sums S_b = Σ_{j>=b} B_j, then  Σ_b b·B_b = Σ_b S_b.
        rev = Point(*(v[::-1] for v in buckets))
        suffix = _hs_scan(curve, rev)
        total = _hs_scan(curve, suffix)
        return Point(*(v[-1] for v in total))

    # Window groups bound peak memory: each batched window materializes
    # ~N sorted points + run prefixes, so cap the gathered footprint per
    # pass and lax.map over groups (body compiled once, groups
    # sequential).  Where Field.mul chunks its batches, the budget also
    # keeps the vmapped field-mul batches under that chunk size: vmap
    # multiplies the executed batch past what Field.mul's own chunking
    # can see (utils/backend.py).
    budget = profile().msm_slot_budget
    group = max(1, min(n_windows, budget // n_pad))
    n_groups = -(-n_windows // group)
    w_pad = n_groups * group - n_windows
    # Extra windows are MSB-side zeros: their window sum is the identity
    # and the Horner chain below stays at the identity through them.
    digits = jnp.pad(digits, ((0, w_pad), (0, 0)))
    grouped = digits.reshape(n_groups, group, n_pad)
    window_sums = jax.lax.map(jax.vmap(window_sum), grouped)  # (G, g) points
    window_sums = Point(
        *(v.reshape(n_groups * group, *v.shape[2:]) for v in window_sums)
    )  # (W_pad,), LSB first

    def body(acc, q):
        # windows consumed MSB-first: shift then add.
        def dbl(_, a):
            return curve.double(a)

        acc = jax.lax.fori_loop(0, c, dbl, acc)
        acc = curve.add(acc, q)
        return acc, None

    acc, _ = jax.lax.scan(
        body, curve.identity(()), Point(*(v[::-1] for v in window_sums))
    )
    return acc


@functools.lru_cache(maxsize=32)
def _msm_jit(curve_name: str, pippenger: bool, c: int = 12):
    from .point import get_curve

    curve = get_curve(curve_name)
    if pippenger:
        return jax.jit(lambda pts, s: msm_pippenger_traceable(curve, pts, s, c))
    return jax.jit(lambda pts, s: msm_traceable(curve, pts, s))


# Below this size the bit-plane evaluator's simpler graph wins.
_PIPPENGER_MIN_N = 256


def _window_bits(n: int) -> int:
    """Window size balancing scan work (~2N per window) against bucket
    work (~2·c·2^c Hillis–Steele adds per window)."""
    return max(4, min(12, n.bit_length() - 7))


def msm(curve: Curve, points: Point, scalars_mont: jnp.ndarray) -> Point:
    """Jitted MSM entry point (cached per curve + shape + algorithm)."""
    n = points.x.shape[0]
    if n >= _PIPPENGER_MIN_N:
        return _msm_jit(curve.params.name, True, _window_bits(n))(
            points, scalars_mont
        )
    return _msm_jit(curve.params.name, False)(points, scalars_mont)
