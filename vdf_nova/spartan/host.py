"""Host-int Spartan/IPA tier — the control/CPU-plane twin of snark.py/ipa.py.

Same two-plane split as the IVC engine (nova/ivc.py): the device tier
(spartan/snark.py) runs batched limb-vector field ops under jit — right
for an accelerator, pathological for XLA:CPU (a compression compile of
60+ min / 46 GB for one proof).  This tier runs the identical
protocol on Python ints with the native C++ Pippenger (native/pasta.cpp)
doing the MSMs and the batched generator folds — the same role
pasta-msm plays for the Rust reference (/root/reference/Cargo.toml:18,
used via src/nova/proof.rs:360-368).

Every transcript interaction mirrors the device tier element for
element (absorb_point framing = nova/nifs.py:68-87, 128-bit challenge
truncation = nifs.py:98-107), so the two tiers produce and accept
IDENTICAL proofs — locked by tests/test_spartan.py's cross-tier cases.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

from ..curves.int_ops import get_int_curve
from ..curves.point import hash_to_curve_ints
from ..nova.pedersen import CK_LABEL
from ..poseidon.int_poseidon import IntTranscript
from .multilinear import num_vars

_M128 = (1 << 128) - 1


# ---------------------------------------------------------------------
# transcript twins (framing parity with nova/nifs.py)
# ---------------------------------------------------------------------


def absorb_point_ints(tr: IntTranscript, aff: tuple | None) -> None:
    """Twin of nifs.absorb_point: affine coords as two 128-bit chunks
    each, plus an identity flag (the device path normalizes z=0 to
    x=y=0 via inv(0)=0, so the identity absorbs as all-zero coords)."""
    if aff is None:
        tr.absorb(0, 0, 0, 0, 1)
    else:
        x, y = int(aff[0]), int(aff[1])
        tr.absorb(x & _M128, x >> 128, y & _M128, y >> 128, 0)


def squeeze_challenge_128(tr: IntTranscript) -> int:
    """Twin of nifs.squeeze_challenge_bits: keep the low 128 bits."""
    return tr.squeeze() & _M128


# ---------------------------------------------------------------------
# commitment key (int form of nova/pedersen.commitment_key)
# ---------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def host_ck(curve_name: str, n: int, label: bytes = CK_LABEL):
    """(gens, h) as affine int tuples; same derivation as the device
    CommitmentKey so commitments agree across tiers."""
    pts = hash_to_curve_ints(curve_name, n + 1, domain=label)
    return tuple(pts[:n]), pts[n]


def _msm_aff(curve_name: str, pts: list, scalars: list[int], q: int) -> tuple | None:
    """Native Pippenger MSM -> affine | None (identity)."""
    from ..native import msm_native

    nz = [(s % q, g) for s, g in zip(scalars, pts) if s % q and g is not None]
    if not nz:
        return None
    out = msm_native(curve_name, [g for _, g in nz], [s for s, _ in nz])
    if out is None:
        return None
    x, y, z = out  # Jacobian
    p = get_int_curve(curve_name).p
    zi = pow(z, -1, p)
    return (x * zi * zi % p, y * zi * zi % p * zi % p)


# ---------------------------------------------------------------------
# sumcheck over ints (twin of spartan/sumcheck.py)
# ---------------------------------------------------------------------


def _bind(poly: list[int], t: int, half: int, q: int) -> list[int]:
    if t == 0:
        return poly[:half]
    if t == 1:
        return poly[half:]
    return [(lo + t * (hi - lo)) % q for lo, hi in zip(poly[:half], poly[half:])]


def sumcheck_prove_ints(q, tr: IntTranscript, polys, degree: int, comb):
    """Returns (rs, finals, messages); comb takes one value per poly and
    may return an unreduced int (summed then reduced once per eval)."""
    polys = [list(p_) for p_ in polys]
    n = len(polys[0])
    m = (n - 1).bit_length()
    rs, messages = [], []
    for _ in range(m):
        half = len(polys[0]) // 2
        evals = []
        for t in range(degree + 1):
            bound = [_bind(p_, t, half, q) for p_ in polys]
            evals.append(sum(comb(*vals) for vals in zip(*bound)) % q)
        tr.absorb(*evals)
        messages.append(evals)
        r = tr.squeeze()
        rs.append(r)
        polys = [
            [(lo + r * (hi - lo)) % q for lo, hi in zip(p_[:half], p_[half:])]
            for p_ in polys
        ]
    return rs, [p_[0] for p_ in polys], messages


def eval_univariate_ints(q: int, evals: list[int], r: int) -> int:
    """Lagrange-evaluate the degree-d univariate (values at 0..d) at r."""
    d = len(evals) - 1
    total = 0
    for k in range(d + 1):
        denom, numer = 1, 1
        for j in range(d + 1):
            if j != k:
                denom = denom * (k - j) % q
                numer = numer * (r - j) % q
        total += evals[k] * numer % q * pow(denom, -1, q)
    return total % q


def sumcheck_verify_ints(q, tr: IntTranscript, messages, claim: int, degree: int):
    """Returns (rs, final_claim, ok); rejects malformed message lengths
    up front (like the device verifier, spartan/sumcheck.py:199-207)."""
    if any(len(evals) != degree + 1 for evals in messages):
        return [0] * len(messages), claim, False
    rs, cur, ok = [], claim % q, True
    for evals in messages:
        if (evals[0] + evals[1]) % q != cur:
            ok = False
        tr.absorb(*evals)
        r = tr.squeeze()
        rs.append(r)
        cur = eval_univariate_ints(q, evals, r)
    return rs, cur, ok


def eq_table_ints(q: int, rs: list[int]) -> list[int]:
    """eq(r, x) over all x in {0,1}^m, rs[0] = top variable (twin of
    multilinear.eq_table's reversed doubling)."""
    table = [1]
    for r in reversed(rs):
        om = (1 - r) % q
        table = [v * om % q for v in table] + [v * r % q for v in table]
    return table


# ---------------------------------------------------------------------
# IPA over ints + native MSM (twin of spartan/ipa.py)
# ---------------------------------------------------------------------


class HostIPAProof(NamedTuple):
    ls: tuple  # per-round L commitments, affine | None
    rs: tuple
    a_final: int


def ipa_prove_ints(curve_name, q, gens, h, a, b, tr: IntTranscript) -> HostIPAProof:
    from ..native import fold_points_native

    n = len(a)
    assert n & (n - 1) == 0, "IPA needs power-of-two length"
    a = [int(v) % q for v in a]
    b = [int(v) % q for v in b]
    g = list(gens[:n])
    ls, rs = [], []
    while n > 1:
        half = n // 2
        cl = sum(x * y for x, y in zip(a[:half], b[half:])) % q
        cr = sum(x * y for x, y in zip(a[half:], b[:half])) % q
        l_aff = _msm_aff(curve_name, g[half:] + [h], a[:half] + [cl], q)
        r_aff = _msm_aff(curve_name, g[:half] + [h], a[half:] + [cr], q)
        absorb_point_ints(tr, l_aff)
        absorb_point_ints(tr, r_aff)
        ls.append(l_aff)
        rs.append(r_aff)
        x = squeeze_challenge_128(tr)
        xi = pow(x, -1, q)  # x == 0 has probability 2^-128; let it raise
        a = [(al * x + ah * xi) % q for al, ah in zip(a[:half], a[half:])]
        b = [(bl * xi + bh * x) % q for bl, bh in zip(b[:half], b[half:])]
        g = fold_points_native(curve_name, g[:half], g[half:], xi, x)
        n = half
    return HostIPAProof(tuple(ls), tuple(rs), a[0])


def ipa_verify_ints(
    curve_name, q, gens, h, comm: tuple | None, b, value, proof: HostIPAProof,
    tr: IntTranscript,
) -> bool:
    ic = get_int_curve(curve_name)
    n = len(b)
    if n != 1 << len(proof.ls) or len(proof.rs) != len(proof.ls):
        return False
    b = [int(v) % q for v in b]

    xs = []
    for l_aff, r_aff in zip(proof.ls, proof.rs):
        absorb_point_ints(tr, l_aff)
        absorb_point_ints(tr, r_aff)
        xs.append(squeeze_challenge_128(tr))
    if any(x == 0 for x in xs):
        return False  # untrusted-proof surface: fail closed, don't raise
    xinvs = [pow(x, -1, q) for x in xs]

    # s_i = prod_j x_j^{±1}, challenge j governing index bit rounds-1-j.
    s = [1]
    for x, xi in zip(reversed(xs), reversed(xinvs)):
        s = [v * xi % q for v in s] + [v * x % q for v in s]

    g_final = _msm_aff(curve_name, list(gens[:n]), s, q)
    b_final = sum(si * bi for si, bi in zip(s, b)) % q

    # P' = comm + v*Q + sum(x_j^2 L_j + x_j^-2 R_j)
    p_acc = ic.add(
        ic.from_affine(comm), ic.scalar_mul(ic.from_affine(h), int(value) % q)
    )
    for x, xi, l_aff, r_aff in zip(xs, xinvs, proof.ls, proof.rs):
        p_acc = ic.add(p_acc, ic.scalar_mul(ic.from_affine(l_aff), x * x % q))
        p_acc = ic.add(p_acc, ic.scalar_mul(ic.from_affine(r_aff), xi * xi % q))

    a_fin = int(proof.a_final) % q
    lhs = ic.add(
        ic.scalar_mul(ic.from_affine(g_final), a_fin),
        ic.scalar_mul(ic.from_affine(h), a_fin * b_final % q),
    )
    return ic.eq(lhs, p_acc)


# ---------------------------------------------------------------------
# Spartan prover/verifier over ints (twin of spartan/snark.py)
# ---------------------------------------------------------------------


class HostSpartanProof(NamedTuple):
    sc1_messages: tuple
    vA: int
    vB: int
    vC: int
    vE: int
    sc2_messages: tuple
    vW: int
    ipa_e: HostIPAProof
    ipa_w: HostIPAProof


def _absorb_instance_ints(tr: IntTranscript, U) -> None:
    """Twin of snark._absorb_instance (points, then X[0], X[1], u)."""
    absorb_point_ints(tr, U.comm_w)
    absorb_point_ints(tr, U.comm_e)
    tr.absorb(int(U.X[0]), int(U.X[1]), int(U.u))


def _ck_n(shape) -> int:
    n = max(shape.num_aux, shape.num_cons)
    return 1 << (n - 1).bit_length()


def host_spartan_prove(side, U, W, E, tr: IntTranscript) -> HostSpartanProof:
    """Prove the relaxed instance U opens to witness (W, E); int lists.

    ``side`` is a nova.ivc.Side; U a HostRelaxedInstance."""
    q = side.field.params.modulus
    s = side.shape
    s1, s2 = num_vars(s.num_cons), num_vars(s.num_vars)
    n1, n2 = 1 << s1, 1 << s2

    _absorb_instance_ints(tr, U)

    W = [int(v) % q for v in W]
    E = [int(v) % q for v in E]
    u_int = int(U.u) % q
    z = W + [u_int] + [int(v) % q for v in U.X]
    z_pad = z + [0] * (n2 - len(z))
    az, bz, cz = side.host_plane._matvecs(z)
    pad1 = lambda v: list(v) + [0] * (n1 - len(v))
    az, bz, cz, e_pad = pad1(az), pad1(bz), pad1(cz), pad1(E)

    tau = [tr.squeeze() for _ in range(s1)]
    eq_t = eq_table_ints(q, tau)

    comb1 = lambda eqv, a, b, c, e: eqv * (a * b - u_int * c - e)
    rs_x, finals1, msgs1 = sumcheck_prove_ints(
        q, tr, [eq_t, az, bz, cz, e_pad], 3, comb1
    )
    vA, vB, vC, vE = finals1[1], finals1[2], finals1[3], finals1[4]
    tr.absorb(vA, vB, vC, vE)
    gamma = tr.squeeze()

    eq_rx = eq_table_ints(q, rs_x)
    m_vec = _gamma_mvec_ints(q, side.host_plane.coo, eq_rx, gamma, n2)
    claim2 = (vA + gamma * vB + gamma * gamma % q * vC) % q
    rs_y, _, msgs2 = sumcheck_prove_ints(
        q, tr, [m_vec, z_pad], 2, lambda m_, z_: m_ * z_
    )

    n_w = 1 << num_vars(s.num_aux)
    eq_ry = eq_table_ints(q, rs_y)
    w_pad = (W + [0] * (n_w - len(W)))[:n_w]
    b_w = eq_ry[:n_w]
    vW = sum(wp * bw for wp, bw in zip(w_pad, b_w)) % q
    tr.absorb(vW)

    gens, h = host_ck(side.curve_name, _ck_n(s))
    ipa_e = ipa_prove_ints(side.curve_name, q, gens, h, e_pad, eq_rx, tr)
    ipa_w = ipa_prove_ints(side.curve_name, q, gens, h, w_pad, b_w, tr)
    return HostSpartanProof(
        tuple(tuple(m) for m in msgs1), vA, vB, vC, vE,
        tuple(tuple(m) for m in msgs2), vW, ipa_e, ipa_w,
    )


def _gamma_mvec_ints(q, coo, eq_rx, gamma, n_cols):
    """m(y) = sum_rows (A + γB + γ²C)[row, y] · eq_rx[row], by column."""
    out = [0] * n_cols
    g2 = gamma * gamma % q
    for (rows, cols, vals), wgt in zip(coo, (1, gamma, g2)):
        for r_, c_, v in zip(rows, cols, vals):
            out[c_] += v * eq_rx[r_] % q * wgt
    return [o % q for o in out]


def _gamma_eval_ints(q, coo, eq_rx, eq_ry, gamma):
    """M_γ(r_x, r_y) = Σ entries v·eq_rx[row]·eq_ry[col]·γ^k."""
    g2 = gamma * gamma % q
    total = 0
    for (rows, cols, vals), wgt in zip(coo, (1, gamma, g2)):
        part = 0
        for r_, c_, v in zip(rows, cols, vals):
            part += v * eq_rx[r_] % q * eq_ry[c_]
        total += part % q * wgt
    return total % q


def _eq_point_ints(q, a, b):
    out = 1
    for x, y in zip(a, b):
        out = out * ((x * y + (1 - x) * (1 - y)) % q) % q
    return out


def host_spartan_verify(side, U, proof: HostSpartanProof, tr: IntTranscript) -> bool:
    q = side.field.params.modulus
    s = side.shape
    s1, s2 = num_vars(s.num_cons), num_vars(s.num_vars)
    n1, n2 = 1 << s1, 1 << s2

    _absorb_instance_ints(tr, U)
    if len(proof.sc1_messages) != s1 or len(proof.sc2_messages) != s2:
        return False

    tau = [tr.squeeze() for _ in range(s1)]
    rs_x, final1, ok = sumcheck_verify_ints(q, tr, proof.sc1_messages, 0, 3)
    u_int = int(U.u) % q
    vA, vB, vC, vE = (int(v) % q for v in (proof.vA, proof.vB, proof.vC, proof.vE))
    inner = (vA * vB - (u_int * vC + vE)) % q
    ok &= final1 == _eq_point_ints(q, tau, rs_x) * inner % q

    tr.absorb(vA, vB, vC, vE)
    gamma = tr.squeeze()
    claim2 = (vA + gamma * vB + gamma * gamma % q * vC) % q
    rs_y, final2, ok2 = sumcheck_verify_ints(q, tr, proof.sc2_messages, claim2, 2)
    ok &= ok2

    eq_rx = eq_table_ints(q, rs_x)
    eq_ry = eq_table_ints(q, rs_y)
    m_ry = _gamma_eval_ints(q, side.host_plane.coo, eq_rx, eq_ry, gamma)

    vW = int(proof.vW) % q
    pub = u_int * eq_ry[s.num_aux] % q
    for i in range(s.num_inputs):
        pub = (pub + int(U.X[i]) % q * eq_ry[s.num_aux + 1 + i]) % q
    ok &= final2 == m_ry * ((vW + pub) % q) % q

    tr.absorb(vW)
    gens, h = host_ck(side.curve_name, _ck_n(s))
    n_w = 1 << num_vars(s.num_aux)
    ok &= ipa_verify_ints(
        side.curve_name, q, gens, h, U.comm_e, eq_rx, vE, proof.ipa_e, tr
    )
    ok &= ipa_verify_ints(
        side.curve_name, q, gens, h, U.comm_w, eq_ry[:n_w], vW, proof.ipa_w, tr
    )
    return bool(ok)


# ---------------------------------------------------------------------
# device <-> host proof conversion (one canonical proof, two tiers)
# ---------------------------------------------------------------------


def spartan_to_device(side, hp: HostSpartanProof):
    """HostSpartanProof -> device SpartanProof (same values)."""
    from .snark import SpartanProof
    from .ipa import IPAProof

    f = side.field
    enc = lambda v: f.encode(int(v))
    msgs = lambda ms: tuple(tuple(enc(e) for e in m) for m in ms)

    def ipa(ip: HostIPAProof) -> IPAProof:
        return IPAProof(
            tuple(side._encode_point(a) for a in ip.ls),
            tuple(side._encode_point(a) for a in ip.rs),
            enc(ip.a_final),
        )

    return SpartanProof(
        msgs(hp.sc1_messages), enc(hp.vA), enc(hp.vB), enc(hp.vC), enc(hp.vE),
        msgs(hp.sc2_messages), enc(hp.vW), ipa(hp.ipa_e), ipa(hp.ipa_w),
    )


def spartan_from_device(side, sp) -> HostSpartanProof:
    """Device SpartanProof -> int form (same values)."""
    f = side.field

    def dec(arr) -> int:
        out = f.decode(arr)
        return out if isinstance(out, int) else out[0]

    msgs = lambda ms: tuple(tuple(dec(e) for e in m) for m in ms)

    def ipa(ip) -> HostIPAProof:
        return HostIPAProof(
            tuple(side._decode_point(p_) for p_ in ip.ls),
            tuple(side._decode_point(p_) for p_ in ip.rs),
            dec(ip.a_final),
        )

    return HostSpartanProof(
        msgs(sp.sc1_messages), dec(sp.vA), dec(sp.vB), dec(sp.vC), dec(sp.vE),
        msgs(sp.sc2_messages), dec(sp.vW), ipa(sp.ipa_e), ipa(sp.ipa_w),
    )
