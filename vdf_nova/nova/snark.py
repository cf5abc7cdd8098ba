"""Recursive VDF proving via NIFS folding (Nova RecursiveSNARK surface).

API mirrors the reference (/root/reference/src/nova/proof.rs:232-392):
``public_params(t)``, ``eval_and_make_circuits``, ``prove_recursively``,
``verify``, with the same segment-reversal convention (circuits walk the
inverse direction from the final result back to the initial state).

This module is the framework's **transparent tier**: the prover folds
every per-segment step instance into one running relaxed R1CS instance
(all device math: witness synthesis, Pedersen MSM commits, cross-term
matvecs), and the verifier replays the Poseidon transcript to
re-derive every fold challenge, checks public-IO chaining across
segments, and checks the final folded relaxed instance directly
against its witness — sound by Nova's folding theorem, but O(n)
verification (a transcript replay per fold) with no augmented circuit.

The flagship engine is ``nova/ivc.py``: the two-curve augmented-circuit
IVC with O(1)-size proofs and O(1) verification (plus ``nova/
compressed.py`` for constant-size Spartan+IPA compression).  Keep this
tier when the verifier is trusted with linear work and the in-circuit
fold-verifier's ~10^4 extra constraints per step are not wanted —
e.g. short chains, debugging, and the row-sharded matvec dryrun.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np

from ..curves import get_curve
from ..fields import Field, NLIMBS, get_field
from ..minroot import Evaluation, MinRootVDF, State
from ..poseidon import Transcript
from ..errors import NovaError
from .circuit import InverseMinRootCircuit
from .nifs import NIFS, R1CSInstance, RelaxedInstance, RelaxedWitness
from .pedersen import commitment_key
from .r1cs_device import DeviceShape


@dataclasses.dataclass
class PublicParams:
    t: int  # iterations per step
    field: Field
    curve_name: str
    dev_shape: DeviceShape
    digest: jnp.ndarray  # transcript domain separator (field element)

    @functools.cached_property
    def nifs(self) -> NIFS:
        # Generators cover the next power of two so IPA openings over
        # zero-padded vectors commit to the identical points.
        n = max(self.dev_shape.shape.num_aux, self.dev_shape.shape.num_cons)
        n = 1 << (n - 1).bit_length()
        ck = commitment_key(self.curve_name, n)
        return NIFS(self.field, get_curve(self.curve_name), self.dev_shape, ck)

    @functools.cached_property
    def prove_step_fn(self):
        """Jitted per-step prover: witness synthesis + commit + fold.

        One compiled executable reused for every fold — no per-op
        dispatch, and a bounded jit arena on the CPU.
        """
        from ..r1cs.gadgets import AllocatedNum
        from ..r1cs.witness import WitnessCS

        nifs = self.nifs
        f = self.field
        circ = InverseMinRootCircuit(self.t)

        def step(tr_state, U, W, z_in):
            tr = Transcript.from_state(f.params.name, tr_state)
            cs = WitnessCS(f, inputs=list(z_in), check=False)
            z_alloc = [
                AllocatedNum(v, val)
                for v, val in zip(InverseMinRootCircuit._input_vars(), z_in)
            ]
            outs = circ.synthesize(cs, z_alloc)
            w_vec = cs.witness()
            x_vec = jnp.stack(list(z_in) + [o.value for o in outs])
            comm_w = nifs.ck.commit(w_vec)
            u2 = R1CSInstance(comm_w, x_vec)
            U2, W2, comm_t = nifs.prove(tr, U, W, u2, w_vec)
            return tr.export_state(), U2, W2, u2, comm_t

        return jax.jit(step)

    @functools.cached_property
    def verify_fold_fn(self):
        """Jitted per-step verifier fold (transcript replay)."""
        nifs = self.nifs
        f = self.field

        def vstep(tr_state, U, u2, comm_t):
            tr = Transcript.from_state(f.params.name, tr_state)
            U2, _ = nifs.fold_instance(tr, U, u2, comm_t)
            return tr.export_state(), U2

        return jax.jit(vstep)

    @functools.cached_property
    def final_check_fn(self):
        """Jitted final relaxed-satisfaction + opening check."""
        nifs = self.nifs
        f = self.field
        c = nifs.curve

        def final(U, W):
            ok = self.dev_shape.check_relaxed_dev(f, W.w, W.e, U.x, U.u)
            ok &= jnp.all(c.eq(nifs.ck.commit(W.w), U.comm_w))
            ok &= jnp.all(c.eq(nifs.ck.commit(W.e), U.comm_e))
            return ok

        return jax.jit(final)

    # Spartan prove/verify orchestrate cached jitted *pieces* (per
    # sumcheck round / IPA round) rather than one monolithic jit: the
    # whole-protocol graph is too large for a single XLA compile.


def _shape_digest(field: Field, shape) -> jnp.ndarray:
    h = hashlib.sha256()
    for coo in (shape.a_coo, shape.b_coo, shape.c_coo):
        h.update(np.asarray(coo[0]).tobytes())
        h.update(np.asarray(coo[1]).tobytes())
        for c in coo[2]:
            h.update(int(c).to_bytes(32, "little"))
    h.update(bytes([shape.num_cons & 0xFF, shape.num_aux & 0xFF]))
    return field.encode(int.from_bytes(h.digest(), "little") % field.params.modulus)


def public_params(num_iters_per_step: int, field_name: str = "Fq") -> PublicParams:
    """Setup: synthesize the step-circuit shape once, build commitment
    generators (reference public_params, proof.rs:232-237)."""
    field = get_field(field_name)
    circuit = InverseMinRootCircuit(num_iters_per_step)
    shape = circuit.shape(field.params.modulus).shape()
    dev = DeviceShape.build(field, shape)
    curve_name = "pallas" if field_name == "Fq" else "vesta"
    return PublicParams(
        num_iters_per_step, field, curve_name, dev, _shape_digest(field, shape)
    )


def eval_and_make_circuits(
    vdf: MinRootVDF, num_iters_per_step: int, num_steps: int, initial_state: State
):
    """Run the slow VDF for n segments; emit circuits in reverse order
    (reference proof.rs:262-298).  Returns (z0, circuits)."""
    if num_steps <= 0:
        raise NovaError("num_steps must be positive")
    t = num_iters_per_step
    states = [initial_state]
    s = initial_state
    for _ in range(num_steps):
        _, proof = Evaluation.eval(vdf, s, t)
        s = proof.result
        states.append(s)
    z0 = [s.x, s.y, s.i]  # final result state: circuits walk backward
    circuits = []
    for k in range(num_steps - 1, -1, -1):
        circuits.append(
            InverseMinRootCircuit(
                t, result=states[k + 1], input=states[k]
            )
        )
    return z0, circuits


def _replay_folds(pp: "PublicParams", instances: list, comm_ts: list) -> RelaxedInstance:
    """Verifier-side transcript replay over all folds (jitted per step)."""
    f = pp.field
    tr = Transcript(f.params.name)
    tr.absorb(pp.digest)
    tr.flush()
    tr_state = tr.export_state()
    U = RelaxedInstance.default(pp.nifs.curve, f, pp.dev_shape.shape.num_inputs)
    vstep = pp.verify_fold_fn
    for u2, comm_t in zip(instances, comm_ts):
        tr_state, U = vstep(tr_state, U, u2, comm_t)
    return U


@dataclasses.dataclass
class RecursiveSNARK:
    """Folded proof: per-step instances + final relaxed accumulator."""

    step_instances: list  # [R1CSInstance] in fold order
    U: RelaxedInstance
    W: RelaxedWitness  # final witness (compressed away by Spartan later)


@dataclasses.dataclass
class NovaVDFProof:
    """Recursive(…) | Compressed(…) surface like the reference enum."""

    snark: RecursiveSNARK
    comm_ts: list  # cross-term commitments, one per fold

    @classmethod
    def prove_recursively(cls, pp: PublicParams, circuits: list, z0: list):
        f = pp.field
        nifs = pp.nifs
        tr = Transcript(f.params.name)
        tr.absorb(pp.digest)
        tr.flush()  # uniform exported structure for every step
        tr_state = tr.export_state()
        n_io = pp.dev_shape.shape.num_inputs
        U = RelaxedInstance.default(nifs.curve, f, n_io)
        W = RelaxedWitness.default(
            f, pp.dev_shape.shape.num_aux, pp.dev_shape.shape.num_cons
        )
        step = pp.prove_step_fn
        instances, comm_ts = [], []
        for circ in circuits:
            z_in = (circ.result.x, circ.result.y, circ.result.i)
            tr_state, U, W, u2, comm_t = step(tr_state, U, W, z_in)
            instances.append(u2)
            comm_ts.append(comm_t)
        return cls(RecursiveSNARK(instances, U, W), comm_ts)

    def verify(self, pp: PublicParams, num_steps: int, z0: list, zi: list) -> bool:
        """Replay transcript, refold instances, check chaining + final
        relaxed satisfaction + commitment openings
        (reference verify, proof.rs:370-387)."""
        f = pp.field
        nifs = pp.nifs
        snark = self.snark
        if len(snark.step_instances) != num_steps or num_steps == 0:
            return False

        # 1. public-IO chaining: first z_in == z0; z_out_k == z_in_{k+1};
        #    last z_out == zi.
        def eq_state(a, b) -> bool:
            return bool(
                np.all(jax.device_get(f.eq(jnp.stack(list(a)), jnp.stack(list(b)))))
            )

        first = snark.step_instances[0].x
        if not eq_state([first[0], first[1], first[2]], z0):
            return False
        for k in range(num_steps - 1):
            xk = snark.step_instances[k].x
            xn = snark.step_instances[k + 1].x
            if not eq_state([xk[3], xk[4], xk[5]], [xn[0], xn[1], xn[2]]):
                return False
        last = snark.step_instances[-1].x
        if not eq_state([last[3], last[4], last[5]], zi):
            return False

        # 2. transcript replay + instance-side refold (jitted per step).
        U = _replay_folds(pp, snark.step_instances, self.comm_ts)
        c = nifs.curve
        same = (
            bool(np.all(jax.device_get(c.eq(U.comm_w, snark.U.comm_w))))
            and bool(np.all(jax.device_get(c.eq(U.comm_e, snark.U.comm_e))))
            and bool(np.all(jax.device_get(f.eq(U.x, snark.U.x))))
            and bool(np.all(jax.device_get(f.eq(U.u, snark.U.u))))
        )
        if not same:
            return False

        # 3. final relaxed satisfaction + openings (one jitted check).
        return bool(jax.device_get(pp.final_check_fn(U, snark.W)))

    def compress(self, pp: PublicParams) -> "CompressedVDFProof":
        """Replace the final witness transmission with a Spartan SNARK
        (reference compress, proof.rs:360-368)."""
        from ..spartan.snark import spartan_prove

        f = pp.field
        tr = Transcript(f.params.name)
        tr.absorb(pp.digest)
        tr.flush()
        sp = spartan_prove(pp, self.snark.U, self.snark.W, tr)
        return CompressedVDFProof(
            self.snark.step_instances, self.comm_ts, self.snark.U, sp
        )


@dataclasses.dataclass
class CompressedVDFProof:
    """Folded instances + Spartan argument for the final accumulator —
    the final (W, E) vectors are no longer transmitted."""

    step_instances: list
    comm_ts: list
    U: RelaxedInstance
    spartan: object

    def verify(self, pp: PublicParams, num_steps: int, z0: list, zi: list) -> bool:
        f = pp.field
        nifs = pp.nifs

        if len(self.step_instances) != num_steps or num_steps == 0:
            return False

        def eq_state(a, b) -> bool:
            return bool(
                np.all(jax.device_get(f.eq(jnp.stack(list(a)), jnp.stack(list(b)))))
            )

        first = self.step_instances[0].x
        if not eq_state([first[0], first[1], first[2]], z0):
            return False
        for k in range(num_steps - 1):
            xk = self.step_instances[k].x
            xn = self.step_instances[k + 1].x
            if not eq_state([xk[3], xk[4], xk[5]], [xn[0], xn[1], xn[2]]):
                return False
        last = self.step_instances[-1].x
        if not eq_state([last[3], last[4], last[5]], zi):
            return False

        U = _replay_folds(pp, self.step_instances, self.comm_ts)
        c = nifs.curve
        same = (
            bool(np.all(jax.device_get(c.eq(U.comm_w, self.U.comm_w))))
            and bool(np.all(jax.device_get(c.eq(U.comm_e, self.U.comm_e))))
            and bool(np.all(jax.device_get(f.eq(U.x, self.U.x))))
            and bool(np.all(jax.device_get(f.eq(U.u, self.U.u))))
        )
        if not same:
            return False

        from ..spartan.snark import spartan_verify

        tr2 = Transcript(f.params.name)
        tr2.absorb(pp.digest)
        tr2.flush()
        return bool(jax.device_get(spartan_verify(pp, U, self.spartan, tr2)))
