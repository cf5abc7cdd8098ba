"""Multilinear polynomial utilities for Spartan (dense eval form).

A polynomial over {0,1}^m is its evaluation table, a ``(2^m, 17)`` limb
array (index bit 0 = most significant variable).  All ops are batched
field arithmetic — sumcheck folding is array halving.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..fields import Field, NLIMBS


def num_vars(n: int) -> int:
    m = max(1, (n - 1).bit_length())
    return m


def pad_to_pow2(field: Field, arr: jnp.ndarray) -> jnp.ndarray:
    n = arr.shape[0]
    m = 1 << num_vars(n)
    if m == n:
        return arr
    pad = jnp.broadcast_to(field.zero, (m - n, NLIMBS))
    return jnp.concatenate([arr, pad], axis=0)


def eq_table(field: Field, rs: list[jnp.ndarray]) -> jnp.ndarray:
    """eq(r, x) table over all x in {0,1}^m; rs[0] is the top variable.

    Built by repeated doubling: table_{j+1} = [table_j*(1-r), table_j*r].
    """
    f = field
    table = f.one[None, :]
    # Each concat makes the newly-processed variable the high index bit;
    # process in reverse so rs[0] governs the top bit, matching
    # evaluate()/fold_top() which bind rs[0] against the top half.
    for r in reversed(rs):
        one_minus = f.sub(jnp.broadcast_to(f.one, r.shape), r)
        left = f.mul(table, jnp.broadcast_to(one_minus, table.shape))
        right = f.mul(table, jnp.broadcast_to(r, table.shape))
        table = jnp.concatenate([left, right], axis=0)
    return table


def evaluate(field: Field, evals: jnp.ndarray, rs: list[jnp.ndarray]) -> jnp.ndarray:
    """Evaluate the multilinear extension at point rs (top var first)."""
    f = field
    cur = evals
    for r in rs:
        half = cur.shape[0] // 2
        lo, hi = cur[:half], cur[half:]
        diff = f.sub(hi, lo)
        cur = f.add(lo, f.mul(jnp.broadcast_to(r, diff.shape), diff))
        cur = f.partial_reduce(cur, k_max=2)
    return cur[0]


def fold_top(field: Field, evals: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """Bind the top variable to r: (2^m,17) -> (2^(m-1),17)."""
    f = field
    half = evals.shape[0] // 2
    lo, hi = evals[:half], evals[half:]
    out = f.add(lo, f.mul(jnp.broadcast_to(r, lo.shape), f.sub(hi, lo)))
    return f.partial_reduce(out, k_max=2)
