"""Pipeline-parallel VDF proving (the SURVEY §2.4 PP axis).

Fold order forbids eval-vs-fold overlap *inside* one statement: Nova
folding consumes inverse-direction segments starting from the FINAL
state (the reference reverses its segment list before proving,
/root/reference/src/nova/proof.rs:294), so the first fold already
requires the completed slow evaluation.  The pipeline therefore
overlaps at *statement* granularity: a proving service receives a
stream of VDF statements; stage E (device) runs statement k+1's slow
evaluation — the XLA scan of minroot/vdf.py — while stage F (host-dominated witness synthesis plus device MSM
folds) proves statement k.

Stage E runs in a background thread.  It spends its wall time blocked
on device execution (``block_until_ready`` releases the GIL), so stage
F's host-Python witness synthesis genuinely runs concurrently on the
CPU; device work from the two stages interleaves on the chip's queue.

Reference anchor: the sequential prove loop this pipelines around is
``prove_recursively``'s fold loop (/root/reference/src/nova/proof.rs:
316-355) fed by ``eval_and_make_circuits`` (:262-298).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import jax

from ..minroot import MinRootVDF, State
from ..minroot.vdf import jit_eval
from .ivc import IVCParams, IVCProof, RecursiveIVC, ivc_verify


@dataclasses.dataclass(frozen=True)
class VDFStatement:
    """One proving request: run ``num_steps * pp.t`` slow MinRoot rounds
    from ``start`` and produce an IVC proof of the chain."""

    start: tuple[int, int, int]  # (x, y, i) as canonical ints
    num_steps: int

    def __post_init__(self):
        # Mirror the reference's assert num_steps > 0
        # (/root/reference/src/nova/proof.rs:268): a zero-step statement
        # would otherwise come back silently as verified=False.
        if self.num_steps < 1:
            raise ValueError("VDFStatement.num_steps must be >= 1")


@dataclasses.dataclass
class StatementProof:
    statement: VDFStatement
    z0: list[int]  # final VDF state = the IVC chain's input
    proof: IVCProof
    verified: bool
    eval_seconds: float
    fold_seconds: float


def _eval_statement(pp: IVCParams, vdf: MinRootVDF, stmt: VDFStatement):
    """Slow direction on device; returns (z0_ints, wall_seconds)."""
    f = vdf.field
    t0 = time.perf_counter()
    s = State(*(f.encode([v]) for v in stmt.start))
    res = jit_eval(f.params.name, vdf.mode.value, pp.t * stmt.num_steps)(s)
    jax.block_until_ready(res.x)
    z0 = [f.decode(a)[0] for a in (res.x, res.y, res.i)]
    return z0, time.perf_counter() - t0


def _fold_statement(pp: IVCParams, stmt: VDFStatement, z0: list[int]):
    """Prove the statement's inverse chain; returns (proof, ok, wall)."""
    t0 = time.perf_counter()
    ivc = RecursiveIVC(pp, z0)
    for _ in range(stmt.num_steps - 1):
        ivc.prove_step()
    proof = ivc.proof()
    ok = ivc_verify(pp, proof, stmt.num_steps, z0, list(stmt.start))
    return proof, ok, time.perf_counter() - t0


def prove_stream(
    pp: IVCParams,
    statements: list[VDFStatement],
    vdf: MinRootVDF | None = None,
    pipelined: bool = True,
    depth: int = 2,
) -> list[StatementProof]:
    """Prove a stream of VDF statements, overlapping stage E (device
    eval of statement k+1) with stage F (folding of statement k).

    ``pipelined=False`` runs the two stages strictly in sequence per
    statement — the reference's execution model — and is the baseline
    the pipeline's speedup is measured against.  ``depth`` bounds how
    many evaluated-but-unproven statements may be in flight.
    """
    if vdf is None:
        from ..minroot import pallas_vdf

        vdf = pallas_vdf()

    if not pipelined:
        out = []
        for stmt in statements:
            z0, dt_e = _eval_statement(pp, vdf, stmt)
            proof, ok, dt_f = _fold_statement(pp, stmt, z0)
            out.append(StatementProof(stmt, z0, proof, ok, dt_e, dt_f))
        return out

    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    err: list[BaseException] = []
    consumer_dead = threading.Event()

    def stage_e():
        try:
            for stmt in statements:
                item = (stmt, *_eval_statement(pp, vdf, stmt))
                # bounded put that notices a dead consumer: otherwise a
                # consumer failure leaks this thread blocked on q.put
                # forever (advisor r3)
                while not consumer_dead.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if consumer_dead.is_set():
                    return
        except BaseException as exc:  # surface in the consumer
            err.append(exc)
        finally:
            while True:
                try:
                    q.put(None, timeout=0.2)
                    break
                except queue.Full:
                    if consumer_dead.is_set():
                        break

    th = threading.Thread(target=stage_e, name="vdf-eval-stage", daemon=True)
    th.start()
    out = []
    try:
        while True:
            item = q.get()
            if item is None:
                break
            stmt, z0, dt_e = item
            proof, ok, dt_f = _fold_statement(pp, stmt, z0)
            out.append(StatementProof(stmt, z0, proof, ok, dt_e, dt_f))
    except BaseException as exc:
        consumer_dead.set()
        th.join()
        # attach partial progress so a proving service can resume from
        # the failed statement (advisor r3)
        exc.partial_proofs = out
        raise
    th.join()
    if err:
        err[0].partial_proofs = out
        raise err[0]
    return out


def prove_interleaved(
    pp: IVCParams,
    z0s: list[list[int]],
    num_steps: int,
    starts: list[tuple[int, int, int]] | None = None,
) -> list[IVCProof]:
    """Fold several independent IVC chains concurrently on one chip.

    A single chain's fold loop alternates host work (witness synthesis,
    Fiat–Shamir) with device work (matvecs, MSM commits) and pays a
    host<->device sync ~4x per step — neither side is ever fully busy.
    Running K chains on K threads hides each chain's host time under
    the other chains' device executables: JAX dispatch is thread-safe and ``device_get`` blocks
    with the GIL released, so the other threads' Python synthesis runs
    meanwhile.  This is the proving-service throughput mode — aggregate
    folds/s across chains is the BASELINE north-star's "aggregate"
    axis; per-chain latency is unchanged (single-chain mode).

    Returns one IVCProof per chain, in z0s order.  Each chain is
    verified here when its ``starts`` entry (the chain's original VDF
    input) is provided; any failure raises NovaError.
    """
    from ..errors import NovaError

    # Warm every lazily-built jitted executable once, single-threaded:
    # functools.cached_property is not thread-safe under concurrent
    # first access.
    for side in (pp.primary, pp.secondary):
        if side.use_device:
            side._materialize()
            _ = side._cross_cached_fn, side._wfoldp_fn, side._products_fn
            _ = side._commit_fn

    chains = [RecursiveIVC(pp, z0) for z0 in z0s]
    errs: list[BaseException | None] = [None] * len(chains)

    def run(k: int):
        try:
            for _ in range(num_steps - 1):
                chains[k].prove_step()
        except BaseException as exc:
            errs[k] = exc

    threads = [
        threading.Thread(target=run, args=(k,), name=f"ivc-chain-{k}")
        for k in range(len(chains))
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for exc in errs:
        if exc is not None:
            raise exc
    proofs = [c.proof() for c in chains]
    if starts is not None:
        for proof, z0, start in zip(proofs, z0s, starts):
            if not ivc_verify(pp, proof, num_steps, z0, list(start)):
                raise NovaError("interleaved chain failed verification")
    return proofs
