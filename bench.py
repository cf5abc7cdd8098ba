"""Benchmark driver: incremental JSON lines for the round harness.

Headline metric: **Nova folding steps/sec** on the two-curve IVC engine
— the BASELINE north star.  ``value``/``vs_baseline`` are SINGLE-CHAIN
numbers against the host-plane engine (native C++ Pippenger MSM + int
matvec — the same acceleration tier the reference gets from pasta-msm,
Cargo.toml:18) on the identical workload; the interleaved multi-chain
aggregate is reported separately in detail (the baseline is never run
interleaved, so folding it into the headline ratio would compare
apples to oranges — advisor r4).

Delivery contract (an all-or-nothing print would lose every finished
section to a timeout): this harness

  * prints a full merged JSON line after EVERY completed section (the
    driver takes the last line; a timeout mid-run keeps everything
    already printed),
  * checks a wall-clock budget (``VDF_NOVA_BENCH_BUDGET_S``, default
    420 s) between sections and sweep points, skipping remaining work
    with a ``detail.skipped`` note,
  * flushes the current merged result on SIGTERM/SIGINT and exits 0.

Outside ``--smoke`` the bench measures the GPU and exits non-zero when
JAX finds none; ``--smoke`` runs small shapes on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

RUST_SINGLE_CHAIN_ITERS_PER_SEC = 1.0e5  # fallback estimate

_T0 = time.monotonic()


def _budget_s() -> float:
    try:
        return float(os.environ.get("VDF_NOVA_BENCH_BUDGET_S", "600"))
    except ValueError:
        return 600.0


def _remaining() -> float:
    return _budget_s() - (time.monotonic() - _T0)


def measure_native_baseline() -> tuple[float, str]:
    try:
        from vdf_nova.native import minroot_eval_native

        minroot_eval_native("Fq", 7, 0, 0, 200)  # warm/build
        t0 = time.perf_counter()
        n = 20000
        minroot_eval_native("Fq", 7, 0, 0, n)
        dt = time.perf_counter() - t0
        return n / dt, "native C++ single-chain, measured"
    except Exception as exc:  # build/toolchain failure: fall back
        return RUST_SINGLE_CHAIN_ITERS_PER_SEC, f"estimate (native failed: {exc})"


def _jax_setup(args):
    import jax

    from vdf_nova.utils.backend import setup_compile_cache

    if args.smoke:
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py: no GPU found (platform {jax.devices()[0].platform!r})")
    setup_compile_cache()
    return jax


def _forward_eval_ints(x, y, i, total):
    from vdf_nova.fields.int_field import get_int_field

    p = get_int_field("Fq").p
    e = pow(5, -1, p - 1)
    for _ in range(total):
        x, y, i = pow((x + y) % p, e, p), (x + i) % p, i + 1
    return x, y, i


def _ivc_steps_per_sec(t: int, n: int, engine: str, phases: dict | None = None):
    """Time n IVC steps of the two-curve engine; returns (steps/s, ok).

    ``n`` counts proven steps (the proof covers n*t VDF iterations);
    steps/s is measured over the steps after the compile-warming first
    two.  When ``phases`` is given, the prover's PhaseTimer split for
    the timed steps is merged into it."""
    from vdf_nova.nova.ivc import RecursiveIVC, ivc_public_params, ivc_verify

    pp = ivc_public_params(t, engine=engine)
    start = (987654321, 0, 1)
    z0 = list(_forward_eval_ints(*start, n * t))
    ivc = RecursiveIVC(pp, z0)  # base step warms/compiles both sides
    ivc.prove_step()  # warm the fold path too
    ivc.timer = type(ivc.timer)()
    t0 = time.perf_counter()
    for _ in range(n - 2):
        ivc.prove_step()
    dt = time.perf_counter() - t0
    ok = ivc_verify(pp, ivc.proof(), n, z0, list(start))
    if phases is not None:
        for name, secs in ivc.timer.totals.items():
            phases[name] = round(
                phases.get(name, 0.0) + secs / max(n - 2, 1), 4
            )
    return (n - 2) / dt, ok


def _interleaved_result(t: int, n: int, engine: str, ks=(4, 8)) -> dict:
    """Aggregate folds/s across K interleaved chains (best K).
    Wall time includes each chain's base step, so the rate is slightly
    conservative; folds counted = K*(n-1) prove_step calls."""
    from vdf_nova.nova.ivc import ivc_public_params, ivc_verify
    from vdf_nova.nova.pipeline import prove_interleaved

    pp = ivc_public_params(t, engine=engine)
    best = None
    for k in ks:
        starts = [(987654321 + 17 * j, j, 1) for j in range(k)]
        z0s = [list(_forward_eval_ints(*s, n * t)) for s in starts]
        t0 = time.perf_counter()
        proofs = prove_interleaved(pp, z0s, n)  # verify outside the clock
        dt = time.perf_counter() - t0
        for proof, z0, s in zip(proofs, z0s, starts):
            assert ivc_verify(pp, proof, n, z0, list(s)), "interleaved proof invalid"
        rate = k * (n - 1) / dt
        if best is None or rate > best["aggregate_folds_per_sec"]:
            best = {
                "chains": k,
                "num_steps": n,
                "aggregate_folds_per_sec": round(rate, 3),
                "verified": True,
            }
        if _remaining() < 30:
            break
    return best


def _folding_headline(args, partial_emit=None) -> dict:
    """Nova IVC folding steps/sec (BASELINE config 2/3): two augmented-
    circuit witness syntheses + two strict-side folds (matvecs +
    Pedersen commits) per step on the two-curve engine.
    Headline value = single-chain folds/s; vs_baseline = single-chain
    rate of the host-plane engine on the same workload (reference
    per-fold body: /root/reference/src/nova/proof.rs:342-349).

    ``partial_emit``, when given, is called with the single-chain-only
    result BEFORE the interleaved-aggregate stage runs, so a timeout
    during interleaving cannot destroy the headline."""
    import jax

    t = args.iters or (2 if args.smoke else 32)
    n = args.steps or (4 if args.smoke else 8)
    engine = "native" if args.smoke else "auto"

    phases: dict = {}
    sps, ok = _ivc_steps_per_sec(t, n, engine, phases=phases)
    assert ok, f"folding bench proof invalid at t={t}"
    base_sps, base_ok = _ivc_steps_per_sec(t, n, "native")
    assert base_ok

    from vdf_nova.nova.ivc import ivc_public_params

    pp = ivc_public_params(t, engine=engine)

    # Aggregate throughput over K interleaved chains: the proving-
    # service mode.  Reported SEPARATELY from the headline ratio — the
    # native baseline is single-chain (advisor r4).
    interleaved = None
    if not args.smoke and _remaining() > 60:
        if partial_emit is not None:
            partial = _fold_dict(t, n, sps, base_sps, None, pp, phases)
            partial_emit(partial)
        try:
            interleaved = _interleaved_result(t, n, engine)
        except Exception as exc:  # fail-soft section
            interleaved = {"error": f"{type(exc).__name__}: {exc}"}

    return _fold_dict(t, n, sps, base_sps, interleaved, pp, phases)


def _fold_dict(t, n, sps, base_sps, interleaved, pp, phases) -> dict:
    import jax

    detail = {
        "t_iters_per_step": t,
        "num_steps": n,
        "single_chain_folds_per_sec": round(sps, 3),
        "interleaved": interleaved,
        "constraints_primary": pp.primary.shape.num_cons,
        "constraints_secondary": pp.secondary.shape.num_cons,
        "baseline_folds_per_sec": round(base_sps, 3),
        "baseline_note": "host-plane engine: native C++ Pippenger MSM + int matvec, single-chain",
        "verified": True,
        "backend": jax.devices()[0].platform,
        "phases_seconds_per_step": phases,
    }
    if interleaved and "aggregate_folds_per_sec" in (interleaved or {}):
        detail["aggregate_folds_per_sec"] = interleaved["aggregate_folds_per_sec"]
        detail["aggregate_note"] = (
            "K interleaved chains on one chip; baseline above is single-chain "
            "(not interleaved), so no aggregate ratio is claimed"
        )
    return {
        "metric": "nova_folding_steps_per_sec",
        "value": round(sps, 3),
        "unit": "folds/s",
        "vs_baseline": round(sps / base_sps, 3),
        "detail": detail,
    }


def _sweep_point(t_i: int, n_full: int, n_run: int, engine: str) -> dict:
    """One reference-workload point (t iters/step, n steps) at constant
    t*n=2000 (/root/reference/benches/nova.rs:62-66).  Steps/s is a
    steady-state per-fold rate, so each point times (and verifies) a
    capped prefix of its fold chain; the cap is recorded."""
    n_run = max(min(n_run, n_full + 2), 3)  # >=1 timed step
    sps, ok = _ivc_steps_per_sec(t_i, n_run, engine)
    assert ok, f"sweep proof invalid at t={t_i}"
    base_sps, base_ok = _ivc_steps_per_sec(t_i, n_run, "native")
    assert base_ok
    return {
        "t": t_i,
        "n": n_full,
        "steps_timed": n_run,
        "folds_per_sec": round(sps, 3),
        "baseline": round(base_sps, 3),
        "vs_baseline": round(sps / base_sps, 3),
    }


def _folding_result(args) -> dict:
    """Headline + (budget permitting) the full reference sweep; used by
    the --folding subcommand.  bench_default drives the same pieces
    incrementally instead."""
    result = _folding_headline(args)
    if args.sweep:
        cap = 6 if args.smoke else 12
        engine = "native" if args.smoke else "auto"
        result["detail"]["sweep"] = [
            _sweep_point(t_i, n_full, n_run, engine)
            for t_i, n_full, n_run in ((10, 200, cap), (100, 20, cap), (1000, 2, 4))
        ]
    return result


def bench_folding(args):
    _jax_setup(args)
    print(json.dumps(_folding_result(args)), flush=True)


def _msm_result(args) -> dict:
    """Pippenger MSM points/sec/chip (BASELINE metric 3 / config 5).

    Correctness-gated against the native C++ Pippenger oracle at a
    smaller size, then timed at the target size (default 2^20 points,
    2^14 in smoke)."""
    import jax
    import numpy as np

    from vdf_nova.curves import get_curve
    from vdf_nova.curves.msm import msm
    from vdf_nova.curves.point import Point, hash_to_curve_ints

    curve = get_curve("pallas")
    f = curve.scalar
    n = args.points or (1 << 14 if args.smoke else 1 << 20)
    n_check = min(n, 1 << 12)

    rng = np.random.default_rng(7)
    base_aff = hash_to_curve_ints("pallas", 1024, domain=b"vdf_nova/bench")
    aff = [base_aff[k % 1024] for k in range(n)]
    pts = curve.from_affine_ints(aff)
    q = f.params.modulus
    scal_ints = [int.from_bytes(rng.bytes(32), "little") % q for k in range(n)]
    s = f.encode(scal_ints)

    # correctness gate vs the native C++ oracle
    sub = Point(*(v[:n_check] for v in pts))
    got = msm(curve, sub, s[:n_check])
    got_aff = curve.to_affine_ints(Point(*(v[None] for v in got)))[0]
    want = None
    try:
        from vdf_nova.native import msm_native

        out = msm_native("pallas", aff[:n_check], scal_ints[:n_check])
        if out is not None:
            x, y, z = out
            mod = get_curve("pallas").field.params.modulus
            zi = pow(z, -1, mod)
            want = (x * zi * zi % mod, y * zi * zi % mod * zi % mod)
    except Exception:
        pass
    if want is not None:
        assert got_aff == want, "MSM bench correctness gate failed"

    # native baseline points/s at the SAME n as the device measurement
    # (a cross-size baseline skews the ratio because Pippenger
    # throughput grows with n).
    base_pps = None
    n_base = min(n, 1 << 12) if args.smoke else n
    try:
        from vdf_nova.native import msm_native

        msm_native("pallas", aff[:256], scal_ints[:256])  # warm/build
        t0 = time.perf_counter()
        msm_native("pallas", aff[:n_base], scal_ints[:n_base])
        base_pps = n_base / (time.perf_counter() - t0)
    except Exception:
        pass

    r = msm(curve, pts, s)  # warm/compile at full size
    jax.block_until_ready(r.x)
    reps = 1 if args.smoke else 3
    t0 = time.perf_counter()
    for _ in range(reps):
        r = msm(curve, pts, s)
    jax.block_until_ready(r.x)
    dt = (time.perf_counter() - t0) / reps

    pps = n / dt
    return {
        "metric": "msm_points_per_sec_per_chip",
        "value": round(pps, 1),
        "unit": "points/s",
        "vs_baseline": round(pps / base_pps, 3) if base_pps else None,
        "detail": {
            "points": n,
            "wall_seconds": round(dt, 3),
            "oracle_checked_at": n_check if want is not None else None,
            "baseline_points_per_sec": round(base_pps, 1) if base_pps else None,
            "baseline_points": n_base,
            "baseline_note": "native C++ Pippenger (pasta-msm equivalent), "
            + ("measured at same n" if n_base == n else f"measured at n={n_base} (cross-size)"),
            "backend": jax.devices()[0].platform,
        },
    }


def bench_msm(args):
    _jax_setup(args)
    print(json.dumps(_msm_result(args)), flush=True)


def _permode_result(args) -> dict:
    """Per-EvalMode eval timings (reference benches/vdf.rs:16-23 runs
    one bench per mode; C17).  The four modes are distinct forward-step
    schedules on the XLA path (fields/chains.py)."""
    import functools
    import jax

    from vdf_nova.minroot import EvalMode, State, pallas_vdf

    f = pallas_vdf().field
    p, e = f.params.modulus, f.params.inv_alpha
    modes = {}
    m_lanes, m_t = 2048, 64
    for mode in EvalMode:
        if _remaining() < 20:
            modes[mode.value] = {"skipped": "budget"}
            continue
        try:
            mvdf = pallas_vdf(mode)
            ms0 = State(
                f.encode([3 + k for k in range(m_lanes)]),
                f.encode([0] * m_lanes),
                f.encode([0] * m_lanes),
            )
            m_fn = jax.jit(functools.partial(mvdf.eval_uncached, t=m_t))
            r = m_fn(ms0)
            jax.block_until_ready(r.x)  # compile + correctness ref below
            t0 = time.perf_counter()
            r = m_fn(ms0)
            jax.block_until_ready(r.x)
            dt_m = time.perf_counter() - t0
            got = f.decode(r.x[:1])[0]
            x0, y0, i0 = 3, 0, 0
            for _ in range(m_t):
                x0, y0, i0 = pow((x0 + y0) % p, e, p), (x0 + i0) % p, (i0 + 1) % p
            assert got == x0, f"mode {mode.value} wrong"
            modes[mode.value] = {
                "iters_per_sec": round(m_lanes * m_t / dt_m, 1),
                "lanes": m_lanes,
                "t": m_t,
            }
        except Exception as exc:  # fail-soft per mode
            modes[mode.value] = {"error": f"{type(exc).__name__}: {exc}"}
    return modes


def _minroot_result(args, with_modes: bool = True) -> dict:
    import jax

    from vdf_nova.minroot import EvalMode, State, pallas_vdf

    lanes = args.lanes or (64 if args.smoke else 16384)
    t = args.iters or (8 if args.smoke else 256)

    vdf = pallas_vdf(EvalMode(args.mode))
    f = vdf.field
    s0 = State(
        f.encode([3 + k for k in range(lanes)]),
        f.encode([0] * lanes),
        f.encode([0] * lanes),
    )

    import functools

    eval_fn = jax.jit(functools.partial(vdf.eval_uncached, t=t))

    # Warmup/compile + correctness gate: never report timings for wrong
    # math (backend numeric quirks must fail loudly, not skew numbers).
    r = eval_fn(s0)
    jax.block_until_ready(r.x)
    check = f.decode(r.x[:2])
    p, e = f.params.modulus, f.params.inv_alpha
    for lane in range(2):
        x, y, i = 3 + lane, 0, 0
        for _ in range(t):
            x, y, i = pow((x + y) % p, e, p), (x + i) % p, (i + 1) % p
        assert check[lane] == x, f"bench correctness gate failed on lane {lane}"

    # Timed runs (chain segments end-to-end, like Evaluation.append use).
    n_rep = 2 if args.smoke else 4
    t0 = time.perf_counter()
    s = s0
    for _ in range(n_rep):
        s = eval_fn(s)
    jax.block_until_ready(s.x)
    dt = time.perf_counter() - t0

    total_iters = lanes * t * n_rep
    iters_per_sec = total_iters / dt
    per_lane = iters_per_sec / lanes
    baseline, baseline_src = measure_native_baseline()

    # Verify direction (benches/vdf.rs:25-43; BASELINE config 1 is
    # eval+verify): the fast x^5 chain.
    verify_fn = jax.jit(functools.partial(vdf.inverse_eval_uncached, t=t))
    back = verify_fn(s)
    jax.block_until_ready(back.x)
    # correctness gate on the inverse kernel: walk 2 lanes back one
    # segment with exact ints and compare.
    chk_x = f.decode(s.x[:2]); chk_y = f.decode(s.y[:2]); chk_i = f.decode(s.i[:2])
    for lane in range(2):
        x, y, i = chk_x[lane], chk_y[lane], chk_i[lane]
        for _ in range(t):
            i = (i - 1) % p
            nx = (y - i) % p
            x, y = nx, (pow(x, 5, p) - nx) % p
        got = (f.decode(back.x[lane : lane + 1])[0],
               f.decode(back.y[lane : lane + 1])[0],
               f.decode(back.i[lane : lane + 1])[0])
        assert got == (x, y, i), f"verify kernel gate failed on lane {lane}"
    t0 = time.perf_counter()
    back = verify_fn(s)
    jax.block_until_ready(back.x)
    dt_v = time.perf_counter() - t0
    verify_iters_per_sec = lanes * t / dt_v

    modes = {}
    if not args.smoke and with_modes:
        modes = _permode_result(args)

    return {
        "metric": "minroot_aggregate_iters_per_sec",
        "value": round(iters_per_sec, 1),
        "unit": "vdf_iters/s",
        "vs_baseline": round(iters_per_sec / baseline, 3),
        "detail": {
            "lanes": lanes,
            "t_per_segment": t,
            "segments": n_rep,
            "iters_per_sec_per_lane": round(per_lane, 2),
            "wall_seconds": round(dt, 3),
            "mode": args.mode,
            "backend": jax.devices()[0].platform,
            "baseline_iters_per_sec": round(baseline, 1),
            "baseline_note": baseline_src,
            "verify_iters_per_sec": round(verify_iters_per_sec, 1),
            "verify_wall_seconds": round(dt_v, 3),
            "per_mode_eval": modes,
        },
    }


def bench_minroot(args):
    _jax_setup(args)
    print(json.dumps(_minroot_result(args)), flush=True)


class _Assembler:
    """Merged-result assembler: re-prints the FULL current JSON line
    after every completed section so a driver timeout at any point
    keeps all results gathered so far (the last printed line wins)."""

    def __init__(self):
        self.minroot = None
        self.folding = None
        self.msm = None
        self.sweep: list = []
        self.skipped: list = []
        self.walls: dict = {}
        self.errors: dict = {}

    def merged(self) -> dict:
        headline = None
        if self.folding and "error" not in self.folding:
            headline = self.folding
        elif self.minroot and "error" not in self.minroot:
            headline = self.minroot
        result = (
            dict(headline)
            if headline is not None
            else {
                "metric": "bench_incomplete",
                "value": 0,
                "unit": "",
                "vs_baseline": 0,
                "detail": {},
            }
        )
        detail = dict(result.get("detail", {}))
        for name, sub in (("minroot", self.minroot), ("msm", self.msm)):
            if sub is None or sub is headline or "error" in sub:
                continue
            detail[name] = sub
        if self.sweep:
            detail["sweep"] = self.sweep
        if self.skipped:
            detail["skipped"] = self.skipped
        if self.errors:
            detail["section_errors"] = self.errors
        detail["section_wall_seconds"] = self.walls
        detail["budget_seconds"] = _budget_s()
        detail["elapsed_seconds"] = round(time.monotonic() - _T0, 1)
        result["detail"] = detail
        return result

    def emit(self):
        print(json.dumps(self.merged()), flush=True)

    def section(self, name: str, fn, min_remaining: float = 0.0):
        """Run one fail-soft section if the budget allows, then emit."""
        if _remaining() < min_remaining:
            self.skipped.append(name)
            return None
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception as exc:
            out = {"error": f"{type(exc).__name__}: {exc}"}
            self.errors[name] = out["error"]
        self.walls[name] = round(time.perf_counter() - t0, 1)
        return out


def bench_default(args):
    """The driver's `python bench.py`: JSON line per completed section,
    headline = the BASELINE north star (single-chain Nova folding
    steps/sec vs the native host plane), with MinRoot / MSM component
    metrics and the reference (t,n) sweep in detail."""
    _jax_setup(args)
    asm = _Assembler()

    def _flush_and_exit(signum, frame):
        asm.skipped.append(f"signal_{signum}")
        asm.emit()
        sys.exit(0)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _flush_and_exit)
        except ValueError:
            pass

    # 1. Folding headline (the metric) runs FIRST: with warm executable
    # caches it lands in ~3 min, and every later section only adds to
    # the artifact.  The single-chain result is emitted BEFORE the
    # interleaved stage via partial_emit.
    def _partial(fold_partial):
        asm.folding = fold_partial
        asm.emit()

    out = asm.section("folding", lambda: _folding_headline(args, _partial))
    if out is not None:
        if "error" not in out:
            asm.folding = out
        asm.emit()

    # 2. MSM points/sec/chip.
    out = asm.section("msm", lambda: _msm_result(args), min_remaining=45)
    if out is not None:
        asm.msm = out
        asm.emit()

    # 3. MinRoot throughput/latency/verify.
    out = asm.section(
        "minroot", lambda: _minroot_result(args, with_modes=False),
        min_remaining=45,
    )
    if out is not None:
        asm.minroot = out
        asm.emit()

    # 4. Per-mode eval table (merged into the minroot detail).
    if asm.minroot is not None and not args.smoke:
        out = asm.section("per_mode", lambda: _permode_result(args), min_remaining=45)
        if out is not None and "error" not in out:
            asm.minroot["detail"]["per_mode_eval"] = out
            asm.emit()

    # 5. Reference sweep (benches/nova.rs:62-66), point by point.  Each
    # new t compiles a fresh augmented shape, so each point is
    # separately budget-gated ((1000,2) is the largest shape).
    if not args.smoke:
        engine = "auto"
        cap = 12
        for t_i, n_full, n_run, need in (
            (10, 200, cap, 90),
            (100, 20, cap, 90),
            (1000, 2, 4, 180),
        ):
            name = f"sweep_t{t_i}"
            out = asm.section(
                name,
                lambda t_i=t_i, n_full=n_full, n_run=n_run: _sweep_point(
                    t_i, n_full, n_run, engine
                ),
                min_remaining=need,
            )
            if out is not None and "error" not in out:
                asm.sweep.append(out)
                asm.emit()

    asm.emit()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="small CPU-friendly shapes")
    ap.add_argument("--lanes", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--mode", default="ltr_sequential")
    ap.add_argument(
        "--minroot",
        action="store_true",
        help="bench raw VDF throughput only (the r01/r02 headline)",
    )
    ap.add_argument(
        "--folding",
        action="store_true",
        help="bench Nova folding steps/sec only",
    )
    ap.add_argument(
        "--msm",
        action="store_true",
        help="bench Pippenger MSM points/sec/chip only (BASELINE metric 3)",
    )
    ap.add_argument("--points", type=int, default=None, help="MSM size")
    ap.add_argument("--steps", type=int, default=None, help="IVC steps for --folding")
    ap.add_argument(
        "--sweep",
        action="store_true",
        help="with --folding: include the reference (t,n) sweep "
        "{(10,200),(100,20),(1000,2)} (benches/nova.rs:62-66)",
    )
    args = ap.parse_args()

    if args.folding:
        return bench_folding(args)
    if args.msm:
        return bench_msm(args)
    if args.minroot:
        return bench_minroot(args)
    return bench_default(args)


if __name__ == "__main__":
    main()
