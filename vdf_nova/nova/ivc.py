"""The two-curve Nova IVC engine: O(1)-size running proof, O(1) verify.

Reference capability: nova-snark's PublicParams / RecursiveSNARK
(/root/reference/src/nova/proof.rs:232-237, 301-358, 370-391).  The
split:

  * **Control plane (host ints)**: instance folding, Fiat–Shamir
    transcripts, and augmented-circuit witness synthesis are tiny,
    branchy, and strictly sequential — wrong for a wide device.  They
    run on Python ints (fields/int_field.py, curves/int_ops.py,
    poseidon/int_poseidon.py), whose outputs the circuits re-derive
    bit-for-bit.
  * **Data plane (device)**: the per-fold heavy lifting — Pedersen MSM
    commitments of ~2^14-element witnesses and the NIFS cross-term's
    sparse matvecs — runs jitted on device.

Chain invariant (established by nova/augmented.py, checked here):

    l_u_secondary.X[0] == H_Fq(d, n, z0, zn, r_U_secondary)
    l_u_secondary.X[1] == H_Fp(d, n, [0], [0], r_U_primary)

so the verifier touches exactly three instances however long the chain:
the two running relaxed instances (one per curve) and the single
dangling strict secondary instance.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np

from ..curves import get_curve
from ..errors import NovaError, SynthesisError
from ..curves.int_ops import IDENTITY, IntCurve, get_int_curve
from ..fields import Field, NLIMBS, get_field
from ..poseidon.int_poseidon import IntTranscript
from ..r1cs.cs import R1CSShape
from ..utils.backend import use_device
from ..utils.profiling import PhaseTimer
from .augmented import (
    AugmentedCircuit,
    AugmentedInputs,
    CHALLENGE_BITS,
    HASH_BITS,
    make_circuits,
)
from .pedersen import CK_LABEL, CommitmentKey, commitment_key
from .r1cs_device import DeviceShape

# ---------------------------------------------------------------------
# host-side instance types
# ---------------------------------------------------------------------

Affine = "tuple[int, int] | None"  # None = identity


@dataclasses.dataclass
class HostInstance:
    """Strict (u=1, E=0) R1CS instance; X values are 250-bit hashes."""

    comm_w: tuple | None
    X: list[int]


@dataclasses.dataclass
class HostRelaxedInstance:
    comm_w: tuple | None
    comm_e: tuple | None
    X: list[int]  # full field range
    u: int  # integer < 2^250 (grows by one 128-bit challenge per fold)

    @classmethod
    def default(cls) -> "HostRelaxedInstance":
        return cls(None, None, [0, 0], 0)

    @classmethod
    def from_strict(cls, u: HostInstance) -> "HostRelaxedInstance":
        return cls(u.comm_w, None, list(u.X), 1)


# -- canonical transcript encodings (circuit twins: gadgets/instance.py)


def _limbs85(v: int) -> list[int]:
    return [(v >> (85 * k)) & ((1 << 85) - 1) for k in range(3)]


def _point_els(pt: tuple | None) -> list[int]:
    return [0, 0, 1] if pt is None else [int(pt[0]), int(pt[1]), 0]


def _relaxed_els(U: HostRelaxedInstance) -> list[int]:
    return (
        _point_els(U.comm_w)
        + _point_els(U.comm_e)
        + [U.u]
        + _limbs85(U.X[0])
        + _limbs85(U.X[1])
    )


def _strict_els(u: HostInstance) -> list[int]:
    return _point_els(u.comm_w) + [u.X[0], u.X[1]]


def state_hash(
    field_name: str, d: int, i: int, z0: list[int], z_i: list[int], U: HostRelaxedInstance
) -> int:
    tr = IntTranscript(field_name)
    tr.absorb(d, i, *z0, *z_i, *_relaxed_els(U))
    return tr.squeeze() % (1 << HASH_BITS)


def fold_challenge(
    field_name: str,
    d: int,
    U: HostRelaxedInstance,
    u: HostInstance,
    comm_t: tuple | None,
) -> int:
    tr = IntTranscript(field_name)
    tr.absorb(d, *_relaxed_els(U), *_strict_els(u), *_point_els(comm_t))
    return tr.squeeze() % (1 << CHALLENGE_BITS)


# ---------------------------------------------------------------------
# host-int data plane (native C++ MSM + exact int matvec)
# ---------------------------------------------------------------------


class HostPlane:
    """Exact host-int data plane: the CPU-offload analog of the
    reference's native pasta-msm path (Cargo.toml:18) — Pippenger MSM in
    C++ (native/pasta.cpp) plus Python-int sparse matvecs.  Used when
    engine="native", and by engine="auto" on backends whose profile has
    no device plane (the CPU, e.g. the unit suite).  Witness handles are
    plain int lists here, jnp arrays on the device plane."""

    def __init__(self, field_name: str, curve_name: str, shape: R1CSShape):
        from ..fields.int_field import get_int_field

        self.f = get_int_field(field_name)
        self.curve_name = curve_name
        self.shape = shape
        self.coo = [
            (list(map(int, r)), list(map(int, c)), [int(v) for v in vals])
            for (r, c, vals) in (shape.a_coo, shape.b_coo, shape.c_coo)
        ]
        n = max(shape.num_aux, shape.num_cons)
        n = 1 << (n - 1).bit_length()
        from ..curves.point import hash_to_curve_ints

        self.gens = hash_to_curve_ints(curve_name, n + 1, domain=CK_LABEL)[:n]
        self._gens_packed = None  # lazy: packed u64 buffer, reused per commit

    def _msm(self, scalars: list[int]) -> tuple | None:
        from ..native import msm_native_packed, pack_points_u64, pack_scalars_u64

        if self._gens_packed is None:
            self._gens_packed = pack_points_u64(self.gens)
        # zero scalars are skipped inside the kernel; no host-side filter
        out = msm_native_packed(
            self.curve_name, self._gens_packed, pack_scalars_u64(scalars)
        )
        if out is None:
            return None
        x, y, z = out  # Jacobian
        mod = get_int_curve(self.curve_name).p
        zi = pow(z, -1, mod)
        return (x * zi * zi % mod, y * zi * zi % mod * zi % mod)

    def commit(self, w: list[int]) -> tuple | None:
        return self._msm([int(v) for v in w])

    def _matvecs(self, z: list[int]) -> list[list[int]]:
        p = self.f.p
        outs = []
        for rows, cols, vals in self.coo:
            acc = [0] * self.shape.num_cons
            for r, c, v in zip(rows, cols, vals):
                acc[r] += v * z[c]
            outs.append([a % p for a in acc])
        return outs

    def z_vec(self, w: list[int], x: list[int], u: int) -> list[int]:
        return list(w) + [u] + list(x)

    def cross(self, w1, x1, u1, w2, x2):
        """T = Az1∘Bz2 + Az2∘Bz1 − u1·Cz2 − u2·Cz1, comm_T."""
        p = self.f.p
        az1, bz1, cz1 = self._matvecs(self.z_vec(w1, x1, u1))
        az2, bz2, cz2 = self._matvecs(self.z_vec(w2, x2, 1))
        t = [
            (a1 * b2 + a2 * b1 - u1 * c2 - c1) % p
            for a1, b1, c1, a2, b2, c2 in zip(az1, bz1, cz1, az2, bz2, cz2)
        ]
        return t, self.commit(t)

    def fold_w(self, W, E, w2, t, r: int):
        p = self.f.p
        W2 = [(a + r * b) % p for a, b in zip(W, w2)]
        E2 = [(a + r * b) % p for a, b in zip(E, t)]
        return W2, E2

    def default_w(self, n: int) -> list[int]:
        return [0] * n

    def sat(self, W, E, x, u, comm_w, comm_e) -> bool:
        p = self.f.p
        az, bz, cz = self._matvecs(self.z_vec(W, x, u))
        for a, b, c, e in zip(az, bz, cz, E):
            if (a * b) % p != (u * c + e) % p:
                return False
        return self.commit(W) == comm_w and self.commit(E) == comm_e


# ---------------------------------------------------------------------
# one curve side: shapes + device executables
# ---------------------------------------------------------------------


@dataclasses.dataclass
class Side:
    """Everything attached to one circuit of the cycle."""

    circuit: AugmentedCircuit
    shape: R1CSShape
    field: Field  # device field of the circuit
    curve_name: str  # commitment curve (points live on the *other* base)
    tr_field: str  # transcript field for folding THIS side's instances
    # (= the other circuit's field, which re-derives the challenge)
    engine: str = "auto"  # "device" (JAX) | "native" (host C++/int) | "auto"
    mesh: object = None  # jax Mesh over the "shard" axis: TP for MSM/matvec

    @functools.cached_property
    def use_device(self) -> bool:
        return use_device(self.engine)

    @functools.cached_property
    def host_plane(self) -> HostPlane:
        return HostPlane(self.field.params.name, self.curve_name, self.shape)

    @functools.cached_property
    def dev_shape(self) -> DeviceShape:
        return DeviceShape.build(self.field, self.shape)

    @functools.cached_property
    def int_curve(self) -> IntCurve:
        return get_int_curve(self.curve_name)

    @functools.cached_property
    def ck(self) -> CommitmentKey:
        n = max(self.shape.num_aux, self.shape.num_cons)
        n = 1 << (n - 1).bit_length()
        return commitment_key(self.curve_name, n)

    # -- host <-> device conversions -----------------------------------

    def encode_w(self, w_ints: list[int]) -> jnp.ndarray:
        return self.field.encode(w_ints)

    @functools.cached_property
    def _decode_stack_fn(self):
        """One dispatch and one device_get for all three coords."""
        f = get_curve(self.curve_name).field
        return jax.jit(lambda pt: f.from_mont(jnp.stack(list(pt))))

    def _affine_of_canon(self, canon) -> tuple | None:
        """(3, 17) canonical limb stack (on device or host) -> affine."""
        from ..fields.params import limbs_to_int

        canon = np.asarray(jax.device_get(canon))
        x, y, z = (limbs_to_int(row) for row in canon)
        if z == 0:
            return None
        mod = get_curve(self.curve_name).field.params.modulus
        zi = pow(z, -1, mod)
        return (x * zi % mod, y * zi % mod)

    def _decode_point(self, p) -> tuple | None:
        return self._affine_of_canon(self._decode_stack_fn(p))

    def _encode_point(self, aff: tuple | None):
        c = get_curve(self.curve_name)
        if aff is None:
            return c.identity(())
        pt = c.from_affine_ints([aff])
        return type(pt)(*(v[0] for v in pt))

    def _x_u_enc(self, U) -> tuple[jnp.ndarray, jnp.ndarray]:
        if isinstance(U, HostInstance):
            return self.field.encode(U.X), jnp.asarray(self.field.one)
        return self.field.encode(U.X), self.field.encode(U.u)

    # -- device executables (one compile per side) ----------------------
    #
    # The R1CS matrices (~200k nnz x 17 limbs) and Pedersen generators
    # (~2^14 points) are passed to every jitted executable as ARGUMENTS,
    # never closed over: captured concrete arrays become XLA constants,
    # and constant-folding >10MB literals sends compile time through the
    # roof (the round-2 multichip-dryrun timeout).

    @functools.cached_property
    def _use_tp(self) -> bool:
        return self.mesh is not None and self.mesh.devices.size > 1

    @functools.cached_property
    def _tables(self):
        """Pytree of the big device arrays, passed as jit operands."""
        self._materialize()
        dev = self.dev_shape
        return {
            "mats": tuple((m.rows, m.cols, m.vals) for m in (dev.a, dev.b, dev.c)),
            "gens": tuple(self.ck.gens),
        }

    def _commit_t(self, tables, w):
        """Pedersen commit, mesh-sharded when a shard mesh is attached
        (SURVEY §2.4 TP row: points partition over chips, one partial
        point gathered per chip)."""
        from ..curves.point import Point

        gens = Point(*(v[: w.shape[0]] for v in tables["gens"]))
        if not self._use_tp:
            from ..curves.msm import (
                _PIPPENGER_MIN_N,
                _window_bits,
                msm_pippenger_traceable,
                msm_traceable,
            )

            curve = get_curve(self.curve_name)
            n = w.shape[0]
            if n >= _PIPPENGER_MIN_N:
                return msm_pippenger_traceable(curve, gens, w, _window_bits(n))
            return msm_traceable(curve, gens, w)
        from ..parallel.mesh import sharded_msm

        return sharded_msm(get_curve(self.curve_name), gens, w, self.mesh)

    def _matvec_t(self, mat_arrs, z):
        """Row-sharded sparse matvec under TP, plain matvec otherwise."""
        from .r1cs_device import DeviceMatrix

        mat = DeviceMatrix(*mat_arrs, num_rows=self.shape.num_cons)
        if not self._use_tp:
            return mat.matvec(self.field, z)
        from ..parallel.mesh import sharded_matvec

        return sharded_matvec(self.field, mat, z, self.mesh)

    def _cross_term_t(self, tables, z1, u1, z2, u2):
        f = self.field
        ma, mb, mc = tables["mats"]
        az1, bz1, cz1 = (self._matvec_t(m, z1) for m in (ma, mb, mc))
        az2, bz2, cz2 = (self._matvec_t(m, z2) for m in (ma, mb, mc))
        t = f.add(f.mul(az1, bz2), f.mul(az2, bz1))
        t = f.sub(t, f.mul(jnp.broadcast_to(u1, cz2.shape), cz2))
        t = f.sub(t, f.mul(jnp.broadcast_to(u2, cz1.shape), cz1))
        return t

    def _materialize(self):
        """Build ck/dev_shape eagerly (outside any jit trace): their
        construction encodes host constants to device arrays, which must
        not happen first under tracing."""
        _ = self.ck, self.dev_shape

    @functools.cached_property
    def _commit_pad(self) -> int:
        """Common padded length for every commit on this side, so ONE
        executable serves witness (num_aux), cross-term and error
        (num_cons) commitments.  Inlining a commit into each of
        the cross-term/sat executables instead compiled the
        (compile-dominant) MSM graph 3x per side.  Padded to the
        commitment key's power-of-two length."""
        n = max(self.shape.num_aux, self.shape.num_cons)
        return 1 << (n - 1).bit_length()

    @functools.cached_property
    def _commit_fn(self):
        """(n_pad, 17) scalars -> commitment point.  Callers zero-pad to
        ``_commit_pad`` (zero scalars contribute identity)."""
        pad = self._commit_pad

        def padded(w):
            n = w.shape[0]
            if n < pad:
                w = jnp.concatenate(
                    [w, jnp.zeros((pad - n, w.shape[1]), w.dtype)], axis=0
                )
            return w

        f_base = get_curve(self.curve_name).field

        def commit_canon(tables, w):
            pt = self._commit_t(tables, w)
            return pt, f_base.from_mont(jnp.stack(list(pt)))

        jitted = jax.jit(commit_canon)
        tables = self._tables
        return lambda w: jitted(tables, padded(w))

    def commit_ints(self, w_ints: list[int]):
        """-> (witness handle, affine commitment).  The handle is a jnp
        array on the device plane, a plain int list on the host plane."""
        if not self.use_device:
            w = [int(v) for v in w_ints]
            return w, self.host_plane.commit(w)
        w = self.encode_w(w_ints)
        return w, self.commit_w(w)

    def commit_w(self, w) -> tuple | None:
        """Pedersen-commit an already-encoded device witness handle."""
        _, canon = self._commit_fn(w)
        return self._affine_of_canon(canon)

    def zero_w(self):
        if not self.use_device:
            return self.host_plane.default_w(self.shape.num_aux)
        return jnp.broadcast_to(self.field.zero, (self.shape.num_aux, NLIMBS))

    def zero_e(self):
        if not self.use_device:
            return self.host_plane.default_w(self.shape.num_cons)
        return jnp.broadcast_to(self.field.zero, (self.shape.num_cons, NLIMBS))

    # -- incremental cross-term: cached (Az, Bz, Cz) of the running z ----
    #
    # The NIFS cross term needs the matrix products of BOTH operands'
    # z-vectors.  The running accumulator's products are linear in the
    # fold (A(z1 + r z2) = Az1 + r Az2), so the prover caches them and
    # folds them alongside W/E instead of recomputing them — 3 sparse
    # matvecs per fold instead of 6.  nova-snark recomputes all six per
    # fold (the reference's fold body, proof.rs:342-349); this is a
    # prover-only optimization with no transcript or proof change: T,
    # comm_T and every folded value are bit-identical (locked by
    # tests/test_ivc.py cross-plane checks).

    @functools.cached_property
    def _products_fn(self):
        """(tables, w, x, u) -> (Az, Bz, Cz) — seeds the cache for a
        non-trivial accumulator (resume, or the base step's lifted
        primary instance)."""
        f = self.field

        def products(tables, w, x, u):
            z = self.dev_shape.z_vector(f, w, x, u)
            return tuple(self._matvec_t(m, z) for m in tables["mats"])

        jitted = jax.jit(products)
        tables = self._tables
        return lambda w, x, u: jitted(tables, w, x, u)

    @functools.cached_property
    def _cross_cached_fn(self):
        """(az1, bz1, cz1, u1, w2, x2) -> (T, (az2, bz2, cz2), comm_T).

        Only the STRICT operand's three matvecs run; the running side's
        products come from the cache.  u2 == 1 always (strict instance),
        so its Cz1 term subtracts directly."""
        f = self.field

        def cross(tables, az1, bz1, cz1, u1, w2, x2):
            one = jnp.asarray(f.one)
            z2 = self.dev_shape.z_vector(f, w2, x2, one)
            az2, bz2, cz2 = (self._matvec_t(m, z2) for m in tables["mats"])
            t = f.add(f.mul(az1, bz2), f.mul(az2, bz1))
            t = f.sub(t, f.mul(jnp.broadcast_to(u1, cz2.shape), cz2))
            t = f.sub(t, cz1)  # u2 = 1
            return t, az2, bz2, cz2

        tables = self._tables

        jitted = jax.jit(cross)

        def run(az1, bz1, cz1, u1, w2, x2):
            t, az2, bz2, cz2 = jitted(tables, az1, bz1, cz1, u1, w2, x2)
            _, canon = self._commit_fn(t)
            return t, (az2, bz2, cz2), self._affine_of_canon(canon)

        return run

    @functools.cached_property
    def _wfoldp_fn(self):
        """Witness fold extended to the cached products: six linear
        a + r*b folds in one executable."""
        f = self.field

        def foldp(W1, E1, zp1, w2, t, zp2, r):
            def lin(a, b):
                return f.partial_reduce(
                    f.add(a, f.mul(jnp.broadcast_to(r, b.shape), b)), k_max=2
                )

            W = lin(W1, w2)
            E = lin(E1, t)
            return W, E, tuple(lin(a, b) for a, b in zip(zp1, zp2))

        return jax.jit(foldp)

    def _zero_products(self):
        z = jnp.broadcast_to(self.field.zero, (self.shape.num_cons, NLIMBS))
        return (z, z, z)

    @functools.cached_property
    def _sat_fn(self):
        """Relaxed satisfaction + commitment-opening check.  The two
        commitment openings go through the shared Pippenger executable
        (_commit_fn) instead of inlining two more MSM graphs here."""
        f = self.field
        c = get_curve(self.curve_name)

        def sat(tables, W, E, x, u):
            z = self.dev_shape.z_vector(f, W, x, u)
            az, bz, cz = (self._matvec_t(m, z) for m in tables["mats"])
            lhs = f.mul(az, bz)
            rhs = f.add(f.mul(jnp.broadcast_to(u, cz.shape), cz), E)
            return jnp.all(f.eq(lhs, rhs))

        jitted = jax.jit(sat)
        tables = self._tables

        def _eq_pt(a_pt, b_pt):
            return bool(jax.device_get(jnp.all(c.eq(a_pt, b_pt))))

        def run(W, E, x, u, comm_w_pt, comm_e_pt):
            ok = bool(jax.device_get(jitted(tables, W, E, x, u)))
            ok &= _eq_pt(self._commit_fn(W)[0], comm_w_pt)
            ok &= _eq_pt(self._commit_fn(E)[0], comm_e_pt)
            return ok

        return run

    def check_sat(self, U, W, E) -> bool:
        comm_e = U.comm_e if isinstance(U, HostRelaxedInstance) else None
        u_int = U.u if isinstance(U, HostRelaxedInstance) else 1
        if not self.use_device:
            if E is None:
                E = self.host_plane.default_w(self.shape.num_cons)
            return self.host_plane.sat(W, E, list(U.X), u_int, U.comm_w, comm_e)
        x, u = self._x_u_enc(U)
        if E is None:
            E = jnp.broadcast_to(self.field.zero, (self.shape.num_cons, NLIMBS))
        ok = self._sat_fn(
            W, E, x, u, self._encode_point(U.comm_w), self._encode_point(comm_e)
        )
        return bool(jax.device_get(ok))

    # -- the NIFS prover fold (host instances + device witnesses) -------

    def fold(
        self,
        d: int,
        U: HostRelaxedInstance,
        W,
        E,
        u: HostInstance,
        w2,
    ):
        """Returns (U', W', E', comm_T affine, r).  On the device plane
        this is ``fold_cached`` with the running products seeded afresh."""
        if not self.use_device:
            t, comm_t = self.host_plane.cross(W, list(U.X), U.u, w2, list(u.X))
            r = fold_challenge(self.tr_field, d, U, u, comm_t)
            U_new = self.fold_instance(U, u, comm_t, r)
            W_new, E_new = self.host_plane.fold_w(W, E, w2, t, r)
            return U_new, W_new, E_new, comm_t, r
        return self.fold_cached(d, U, W, E, u, w2, None)[:5]

    def fold_cached(
        self,
        d: int,
        U: HostRelaxedInstance,
        W,
        E,
        u: HostInstance,
        w2,
        zprod,
        check_cache: bool = False,
    ):
        """`fold` with the running z-products cached across steps (3
        matvecs per fold instead of 6).  ``zprod`` is the (Az, Bz, Cz)
        tuple of the running accumulator, or None to (re)seed — zeros
        when U is the default accumulator, one _products_fn dispatch
        otherwise (base step / checkpoint resume).

        INVARIANT: a non-None ``zprod`` MUST be the matrix products of
        exactly the (U, W) pair passed here — i.e. the ``zprod'`` this
        method returned when it produced that accumulator.  A stale or
        mismatched cache silently yields a wrong T and an unverifiable
        proof; pass ``check_cache=True`` (the prover's debug mode) to
        recompute the products and fail loudly instead.

        When ``u.comm_w is None`` (deferred strict-witness commit, the
        device prover's default) the commitment is computed here and
        written back to ``u``.

        Returns (U', W', E', comm_T, r, zprod').  Device plane only; the
        host plane keeps the reference-shaped 6-matvec fold (it is the
        bench's stand-in for nova-snark's per-fold body)."""
        if not self.use_device:
            U2, W2, E2, comm_t, r = self.fold(d, U, W, E, u, w2)
            return U2, W2, E2, comm_t, r, None
        x1, u1 = self._x_u_enc(U)
        x2, _ = self._x_u_enc(u)
        if zprod is None:
            if U.comm_w is None and U.u == 0 and not any(U.X):
                zprod = self._zero_products()
            else:
                zprod = self._products_fn(W, x1, u1)
        elif check_cache:
            ref = self._products_fn(W, x1, u1)
            for a, b in zip(zprod, ref):
                if not bool(jax.device_get(jnp.all(self.field.eq(a, b)))):
                    raise NovaError(
                        "fold_cached: stale z-product cache for (U, W)"
                    )
        if u.comm_w is None:
            u.comm_w = self.commit_w(w2)
        t, zprod2, comm_t = self._cross_cached_fn(*zprod, u1, w2, x2)
        r = fold_challenge(self.tr_field, d, U, u, comm_t)
        U_new = self.fold_instance(U, u, comm_t, r)
        W_new, E_new, zprod_new = self._wfoldp_fn(
            W, E, zprod, w2, t, zprod2, self.field.encode(r)
        )
        return U_new, W_new, E_new, comm_t, r, zprod_new

    def fold_instance(
        self, U: HostRelaxedInstance, u: HostInstance, comm_t: tuple | None, r: int
    ) -> HostRelaxedInstance:
        """Instance-side fold (the part the augmented circuit re-derives)."""
        c = self.int_curve
        p = self.field.params.modulus

        def scaled_add(base: tuple | None, pt: tuple | None) -> tuple | None:
            acc = c.add(
                c.from_affine(base), c.scalar_mul(c.from_affine(pt), r)
            )
            return c.to_affine(acc)

        return HostRelaxedInstance(
            scaled_add(U.comm_w, u.comm_w),
            scaled_add(U.comm_e, comm_t),
            [(U.X[k] + r * u.X[k]) % p for k in range(2)],
            U.u + r,
        )


# ---------------------------------------------------------------------
# public params
# ---------------------------------------------------------------------


@dataclasses.dataclass
class IVCParams:
    """Both augmented shapes + commitment keys (reference public_params,
    proof.rs:232-237 — which likewise synthesizes the two augmented
    circuits and their generators)."""

    t: int
    primary: Side
    secondary: Side
    digest: int

    @property
    def arity(self) -> int:
        return self.primary.circuit.arity


def _params_digest(*shapes: R1CSShape) -> int:
    """Digest of both augmented shapes and the commitment keys' domain
    label: params whose keys differ never share a digest."""
    h = hashlib.sha256()
    h.update(CK_LABEL)
    for shape in shapes:
        for coo in (shape.a_coo, shape.b_coo, shape.c_coo):
            h.update(np.asarray(coo[0]).tobytes())
            h.update(np.asarray(coo[1]).tobytes())
            for c in coo[2]:
                h.update(int(c).to_bytes(32, "little"))
        h.update(
            b"%d/%d/%d" % (shape.num_cons, shape.num_aux, shape.num_inputs)
        )
    return int.from_bytes(h.digest(), "little") % (1 << HASH_BITS)


@functools.lru_cache(maxsize=8)
def ivc_public_params(t: int, engine: str = "auto", mesh=None) -> IVCParams:
    """Synthesize both augmented shapes once; derive the params digest.

    ``engine``: "device" forces the JAX device data plane, "native" the
    host C++/int plane, "auto" lets the backend profile decide
    (utils/backend.py: the device on a GPU, the host plane on the CPU).
    ``mesh``: optional jax Mesh over the "shard" axis — the device
    plane's MSMs and matvecs then run tensor-parallel across it.
    """
    primary_c, secondary_c = make_circuits(t)
    shape_p = primary_c.shape()
    shape_s = secondary_c.shape()
    digest = _params_digest(shape_p, shape_s)
    primary = Side(primary_c, shape_p, get_field("Fq"), "pallas", "Fp", engine, mesh)
    secondary = Side(secondary_c, shape_s, get_field("Fp"), "vesta", "Fq", engine, mesh)
    return IVCParams(t, primary, secondary, digest)


# ---------------------------------------------------------------------
# RecursiveSNARK
# ---------------------------------------------------------------------


@dataclasses.dataclass
class IVCProof:
    """The O(1)-size running proof: two relaxed accumulators + the one
    dangling strict secondary instance (matches nova-snark's
    RecursiveSNARK verifier inputs, proof.rs:370-387)."""

    i: int
    z0: list[int]
    z_i: list[int]
    r_U_primary: HostRelaxedInstance
    r_W_primary: object  # witness handle: jnp array (device) | int list (host)
    r_E_primary: object
    r_U_secondary: HostRelaxedInstance
    r_W_secondary: object
    r_E_secondary: object
    l_u_secondary: HostInstance
    l_w_secondary: object


class RecursiveIVC:
    """Prover state machine: new() runs the base step, prove_step extends."""

    def __init__(self, pp: IVCParams, z0: list[int], debug: bool = False):
        self.pp = pp
        self.debug = debug
        self.timer = PhaseTimer()  # per-phase observability (SURVEY §5)
        p = pp.primary.field.params.modulus
        self.z0 = [int(z) % p for z in z0]

        # base step: primary folds nothing; secondary lifts the first
        # primary instance into the running accumulator.
        d = pp.digest
        inp = AugmentedInputs(
            d, 0, self.z0, self.z0, HostRelaxedInstance.default(), None, None
        )
        # The base primary instance becomes the running accumulator and
        # is hashed into the secondary circuit's input, so its commit
        # cannot be deferred to a later fold.
        l_u_p, l_w_p, z1 = self._synth(pp.primary, inp, defer_commit=False)
        self.r_U_primary = HostRelaxedInstance.from_strict(l_u_p)
        self.r_W_primary = l_w_p
        self.r_E_primary = pp.primary.zero_e()

        inp_s = AugmentedInputs(
            d, 0, [0], [0], HostRelaxedInstance.default(), l_u_p, None
        )
        l_u_s, l_w_s, _ = self._synth(pp.secondary, inp_s)
        self.r_U_secondary = HostRelaxedInstance.default()
        self.r_W_secondary = pp.secondary.zero_w()
        self.r_E_secondary = pp.secondary.zero_e()
        self.l_u_secondary = l_u_s
        self.l_w_secondary = l_w_s
        self.i = 1
        self.z_i = z1
        # cached (Az, Bz, Cz) of each running accumulator (fold_cached);
        # None = seed on first fold.
        self._zp_primary = None
        self._zp_secondary = None

    @classmethod
    def resume(cls, pp: IVCParams, proof: "IVCProof", debug: bool = False) -> "RecursiveIVC":
        """Rehydrate a live prover from a proof: the IVCProof carries the
        prover's complete state (nova-snark's prove_step likewise resumes
        from Option<RecursiveSNARK>, proof.rs:316,342-349).  Used by the
        checkpoint/restore path (vdf_nova/checkpoint.py)."""
        self = cls.__new__(cls)
        self.pp = pp
        self.debug = debug
        self.timer = PhaseTimer()
        self.z0 = list(proof.z0)
        self.i = proof.i
        self.z_i = list(proof.z_i)
        self.r_U_primary = proof.r_U_primary
        self.r_W_primary = proof.r_W_primary
        self.r_E_primary = proof.r_E_primary
        self.r_U_secondary = proof.r_U_secondary
        self.r_W_secondary = proof.r_W_secondary
        self.r_E_secondary = proof.r_E_secondary
        self.l_u_secondary = proof.l_u_secondary
        self.l_w_secondary = proof.l_w_secondary
        self._zp_primary = None  # reseeded by the next fold_cached
        self._zp_secondary = None
        return self

    def _synth(self, side: Side, inp: AugmentedInputs, defer_commit: bool = True):
        """Synthesize one augmented-circuit witness.  On the device
        plane the Pedersen commit is DEFERRED (comm_w=None): the next
        fold_cached computes it, and proof() finalizes any
        still-dangling instance.
        The host plane (and ``defer_commit=False`` callers that need the
        commitment immediately, e.g. the base step's primary instance)
        commit here."""
        with self.timer.phase(f"synthesize/{side.field.params.name}"):
            cs, z_next = side.circuit.witness(inp, check=self.debug)
        if self.debug and cs.failed:
            raise SynthesisError(f"unsatisfied: {cs.failed[:10]}")
        if len(cs.aux) != side.shape.num_aux:
            raise SynthesisError(
                f"witness/shape mismatch: {len(cs.aux)} vs {side.shape.num_aux}"
            )
        if defer_commit and side.use_device:
            w_dev = side.encode_w(cs.aux)
            return HostInstance(None, [int(v) for v in cs.inputs]), w_dev, z_next
        with self.timer.phase(f"commit/{side.curve_name}"):
            w_dev, comm = side.commit_ints(cs.aux)
        return HostInstance(comm, [int(v) for v in cs.inputs]), w_dev, z_next

    def prove_step(self) -> None:
        """One IVC step (reference prove_step loop, proof.rs:342-349)."""
        pp, d = self.pp, self.pp.digest

        # 1. fold the dangling secondary instance into its accumulator.
        U_sec_old = self.r_U_secondary
        timer_fold = self.timer.phase("fold/secondary")
        timer_fold.__enter__()
        (
            self.r_U_secondary,
            self.r_W_secondary,
            self.r_E_secondary,
            comm_t_sec,
            _,
            self._zp_secondary,
        ) = pp.secondary.fold_cached(
            d,
            U_sec_old,
            self.r_W_secondary,
            self.r_E_secondary,
            self.l_u_secondary,
            self.l_w_secondary,
            self._zp_secondary,
            check_cache=self.debug,
        )
        timer_fold.__exit__(None, None, None)

        # 2. primary circuit: verifies that fold, applies F.
        inp_p = AugmentedInputs(
            d, self.i, self.z0, self.z_i, U_sec_old, self.l_u_secondary, comm_t_sec
        )
        l_u_p, l_w_p, z_next = self._synth(pp.primary, inp_p)

        # 3. fold the fresh primary instance into its accumulator.
        U_prim_old = self.r_U_primary
        timer_fold = self.timer.phase("fold/primary")
        timer_fold.__enter__()
        (
            self.r_U_primary,
            self.r_W_primary,
            self.r_E_primary,
            comm_t_prim,
            _,
            self._zp_primary,
        ) = pp.primary.fold_cached(
            d,
            U_prim_old,
            self.r_W_primary,
            self.r_E_primary,
            l_u_p,
            l_w_p,
            self._zp_primary,
            check_cache=self.debug,
        )
        timer_fold.__exit__(None, None, None)

        # 4. secondary circuit: verifies THAT fold (trivial F).
        inp_s = AugmentedInputs(
            d, self.i, [0], [0], U_prim_old, l_u_p, comm_t_prim
        )
        l_u_s, l_w_s, _ = self._synth(pp.secondary, inp_s)
        self.l_u_secondary = l_u_s
        self.l_w_secondary = l_w_s

        self.i += 1
        self.z_i = z_next

    def proof(self) -> IVCProof:
        # Finalize the dangling secondary instance: its witness commit
        # is deferred by _synth (the NEXT fold would compute it); a proof
        # handed to the verifier needs it now.
        if self.l_u_secondary.comm_w is None:
            side = self.pp.secondary
            with self.timer.phase(f"commit/{side.curve_name}"):
                self.l_u_secondary.comm_w = side.commit_w(self.l_w_secondary)
        return IVCProof(
            self.i,
            self.z0,
            self.z_i,
            self.r_U_primary,
            self.r_W_primary,
            self.r_E_primary,
            self.r_U_secondary,
            self.r_W_secondary,
            self.r_E_secondary,
            self.l_u_secondary,
            self.l_w_secondary,
        )


def ivc_verify(pp: IVCParams, proof: IVCProof, num_steps: int, z0: list[int], zn: list[int]) -> bool:
    """O(1) verification — three hash comparisons + three SAT checks,
    independent of num_steps (reference verify, proof.rs:370-387)."""
    if num_steps == 0 or proof.i != num_steps:
        return False
    p = pp.primary.field.params.modulus
    z0 = [int(v) % p for v in z0]
    zn = [int(v) % p for v in zn]
    if proof.z0 != z0 or [int(v) % p for v in proof.z_i] != zn:
        return False

    d = pp.digest
    h_p = state_hash("Fq", d, num_steps, z0, zn, proof.r_U_secondary)
    if proof.l_u_secondary.X[0] != h_p:
        return False
    h_s = state_hash("Fp", d, num_steps, [0], [0], proof.r_U_primary)
    if proof.l_u_secondary.X[1] != h_s:
        return False

    # range sanity on the running scalars (see gadget docstrings).
    for U in (proof.r_U_primary, proof.r_U_secondary):
        if not (0 <= U.u < (1 << HASH_BITS)):
            return False

    if not pp.primary.check_sat(proof.r_U_primary, proof.r_W_primary, proof.r_E_primary):
        return False
    if not pp.secondary.check_sat(
        proof.r_U_secondary, proof.r_W_secondary, proof.r_E_secondary
    ):
        return False
    return pp.secondary.check_sat(proof.l_u_secondary, proof.l_w_secondary, None)
