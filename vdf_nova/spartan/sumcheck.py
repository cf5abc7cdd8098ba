"""Generic sumcheck protocol (prover + verifier), device-vectorized.

Each round binds the top variable of every oracle table: the prover's
per-round univariate is evaluated at the small points 0..degree from the
lo/hi halves (pure batched field ops), and challenges come from the Poseidon transcript.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp

from ..fields import Field, NLIMBS
from ..fields.ops import resolve
from ..poseidon import Transcript


def _sum_rows(field: Field, arr: jnp.ndarray) -> jnp.ndarray:
    """Exact field sum over axis 0 (lazy limb accumulation + one reduce).

    Limb sums of up to 2^14 canonical rows stay within uint32 and the
    summed *value* stays within the conditional-subtract sweep's range;
    larger inputs split recursively.
    """
    f = field
    n = arr.shape[0]
    if n > (1 << 14):
        half = n // 2
        return f.partial_reduce(
            f.add(_sum_rows(f, arr[:half]), _sum_rows(f, arr[half:])), k_max=2
        )
    acc = jnp.sum(arr.astype(jnp.uint32), axis=0)  # (17,), limbs < 2^31
    return f.partial_reduce(resolve(acc, NLIMBS), k_max=15)


@functools.cache
def _lagrange_denominators(degree: int, modulus: int) -> tuple:
    """1 / prod_{j != k} (k - j) mod p for nodes 0..degree."""
    inv = []
    for k in range(degree + 1):
        d = 1
        for j in range(degree + 1):
            if j != k:
                d = d * (k - j) % modulus
        inv.append(pow(d, -1, modulus))
    return tuple(inv)


def eval_univariate(field: Field, evals: list[jnp.ndarray], r: jnp.ndarray) -> jnp.ndarray:
    """Evaluate the degree-d univariate from evals at 0..d, at point r."""
    f = field
    d = len(evals) - 1
    denoms = _lagrange_denominators(d, f.params.modulus)
    # factors (r - j) for j = 0..d
    factors = [f.sub(r, jnp.broadcast_to(f.encode(j), r.shape)) for j in range(d + 1)]
    out = None
    for k in range(d + 1):
        term = jnp.broadcast_to(f.encode(denoms[k]), r.shape)
        for j in range(d + 1):
            if j != k:
                term = f.mul(term, factors[j])
        term = f.mul(term, evals[k])
        out = term if out is None else f.partial_reduce(f.add(out, term), k_max=2)
    return out


def _bind_at_point(field: Field, lo: jnp.ndarray, hi: jnp.ndarray, t: int) -> jnp.ndarray:
    """lo + t*(hi-lo) for small integer t."""
    if t == 0:
        return lo
    if t == 1:
        return hi
    f = field
    d = f.sub(hi, lo)
    acc = hi
    for _ in range(t - 1):
        acc = f.partial_reduce(f.add(acc, d), k_max=3)
    return acc


# Registry of combination functions, so per-round jitted pieces can be
# cached by a stable key instead of a Python closure identity.
_COMBS: dict = {}


def register_comb(name: str):
    def deco(builder):
        _COMBS[name] = builder
        return builder

    return deco


@register_comb("product")
def _comb_product(f: Field):
    return lambda m, z: f.mul(m, z)


@register_comb("spartan_outer")
def _comb_spartan_outer(f: Field):
    def comb(eqv, a, b, c, ev, u):
        inner = f.sub(f.mul(a, b), f.add(f.mul(jnp.broadcast_to(u, c.shape), c), ev))
        return f.mul(eqv, inner)

    return comb


@functools.lru_cache(maxsize=None)
def _round_eval_fn(field_name: str, comb_key: str, degree: int, n: int, n_aux: int):
    from ..fields import get_field

    f = get_field(field_name)
    comb = _COMBS[comb_key](f)

    def fn(polys, aux):
        half = n // 2
        evals = []
        for t in range(degree + 1):
            bound = [_bind_at_point(f, p[:half], p[half:], t) for p in polys]
            evals.append(_sum_rows(f, comb(*bound, *aux)))
        return tuple(evals)

    import jax

    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _round_fold_fn(field_name: str, n: int, n_polys: int):
    from ..fields import get_field

    f = get_field(field_name)

    def fn(polys, r):
        half = n // 2
        rb = jnp.broadcast_to(r, (half, NLIMBS))
        return tuple(
            f.partial_reduce(
                f.add(p[:half], f.mul(rb, f.sub(p[half:], p[:half]))), k_max=3
            )
            for p in polys
        )

    import jax

    return jax.jit(fn)


def sumcheck_prove(
    field: Field,
    tr: Transcript,
    polys: list[jnp.ndarray],
    degree: int,
    comb_key: str,
    claim: jnp.ndarray,
    aux: tuple = (),
):
    """Prove Σ_x comb(p_1(x), ..., p_k(x), *aux) == claim.

    Rounds run as cached jitted pieces (one eval + one fold executable
    per round size).  Returns (rs, final_values, round_messages).
    """
    f = field
    polys = tuple(polys)
    n = polys[0].shape[0]
    m = (n - 1).bit_length()
    rs, messages = [], []
    for _ in range(m):
        cur_n = polys[0].shape[0]
        evals = _round_eval_fn(f.params.name, comb_key, degree, cur_n, len(aux))(
            polys, aux
        )
        for e in evals:
            tr.absorb(e)
        messages.append(list(evals))
        r = tr.squeeze()
        rs.append(r)
        polys = _round_fold_fn(f.params.name, cur_n, len(polys))(polys, r)
    finals = [p[0] for p in polys]
    return rs, finals, messages


def sumcheck_verify(
    field: Field,
    tr: Transcript,
    messages: list[list[jnp.ndarray]],
    claim: jnp.ndarray,
    degree: int,
):
    """Replay rounds; returns (rs, final_claim, ok) with ``ok`` a device
    bool (traceable) — the caller must also check final_claim against the
    combined oracle evaluations at rs.

    Each round message must carry exactly ``degree + 1`` evaluations:
    over-long messages would silently raise the effective degree, and
    short ones would crash — both are rejected up front.
    """
    import jax.numpy as _jnp

    f = field
    rs = []
    cur = claim
    ok = _jnp.asarray(True)
    if any(len(evals) != degree + 1 for evals in messages):
        return [f.encode(0) for _ in messages], claim, _jnp.asarray(False)
    for evals in messages:
        # g(0) + g(1) must equal the running claim.
        s = f.partial_reduce(f.add(evals[0], evals[1]), k_max=2)
        ok &= _jnp.all(f.eq(s, cur))
        for e in evals:
            tr.absorb(e)
        r = tr.squeeze()
        rs.append(r)
        cur = eval_univariate(f, evals, r)
    return rs, cur, ok
