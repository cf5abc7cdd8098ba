"""Smoke run of the main path on the GPU, through the public API.

One card (default), phases in order, one line of results each:

  0. device check: platform "gpu", the card's name and power limit, the
     compile-cache directory;
  1. field exactness: Field.mul/sqr/add/sub over Fp and Fq at 2^18 rows,
     1,024 sampled rows against Python ints;
  2. MinRoot: Evaluation.eval + verify at the reference's t = 10,000
     (benches/vdf.rs) over Pallas' Fq and Vesta's Fp, checked against
     the native C++ evaluator; a 16,384-lane batch at t = 256, eval and
     inverse, 2 lanes gated against host ints;
  3. MSM: curves.msm.msm at 2^20 Pallas points against native.msm_native;
  4. IVC: the reference's Nova point (t, n) = (100, 20) (benches/nova.rs)
     through ProverConfig(engine="auto") -> RecursiveIVC on the device
     plane, the first fold bit for bit against engine="native", then
     ivc_verify, ivc_compress and ivc_verify_compressed with the same
     params (compression's Spartan arguments run on the host tier, see
     nova/compressed.py);
  5. compile time of the fold executables, cold and after
     jax.clear_caches() (read back from the persistent cache).

``--cards 4`` runs only the sharded paths on four cards:
sharded_eval/sharded_check over 16,384 lanes against the one-card eval,
ProverConfig(shards=4) for 4 IVC steps at t = 100, and sharded_msm at
2^20 points.  The last two are checked against the native C++/int plane,
which phases 3 and 4 show equal to the one-card device results bit for
bit, so no one-card executable has to be compiled for them.

Any failed check raises, so the process exits non-zero.  The last line
of standard output is the JSON verdict, printed only when every phase
passed.  Usage:

    python chip_smoke.py
    python chip_smoke.py --cards 4
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np

SEED = 20240611


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------
# phase 0: device
# ---------------------------------------------------------------------


def phase_device(cards: int) -> dict:
    """Fail unless JAX's devices are ``cards`` GPUs or more."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU found (JAX platform {devs[0].platform!r})")
    if len(devs) < cards:
        sys.exit(f"chip_smoke: needs {cards} GPUs, JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    from vdf_nova.utils.backend import setup_compile_cache

    cache_dir = setup_compile_cache()
    print(f"nvidia-smi: {smi}", flush=True)
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "nvidia_smi": smi,
        "compile_cache_dir": cache_dir,
    }


# ---------------------------------------------------------------------
# phase 1: field exactness
# ---------------------------------------------------------------------


def _random_elements(rng, rows: int) -> np.ndarray:
    """Random (rows, 17) limb arrays below 2^255 (< 2p for both fields):
    Montgomery representatives of the same range mul/sub produce."""
    from vdf_nova.fields import NLIMBS

    limbs = rng.integers(0, 1 << 16, size=(rows, NLIMBS), dtype=np.uint32)
    limbs[:, 15] &= 0x7FFF
    limbs[:, 16] = 0
    return limbs


def phase_fields(rows: int = 1 << 18, sample: int = 1024) -> dict:
    """Field.mul/sqr/add/sub over Fp and Fq at ``rows`` rows; ``sample``
    rows of each result decoded and compared with Python ints."""
    import jax.numpy as jnp

    from vdf_nova.fields import get_field, limbs_to_int

    rng = np.random.default_rng(SEED)
    out = {}
    for name in ("Fp", "Fq"):
        f = get_field(name)
        p = f.params.modulus
        r_inv = pow(1 << 272, -1, p)
        a_h, b_h = _random_elements(rng, rows), _random_elements(rng, rows)
        a, b = jnp.asarray(a_h), jnp.asarray(b_h)
        idx = np.sort(rng.choice(rows, size=min(sample, rows), replace=False))
        a_i = [limbs_to_int(a_h[k]) * r_inv % p for k in idx]
        b_i = [limbs_to_int(b_h[k]) * r_inv % p for k in idx]
        want = {
            "mul": [x * y % p for x, y in zip(a_i, b_i)],
            "sqr": [x * x % p for x in a_i],
            "add": [(x + y) % p for x, y in zip(a_i, b_i)],
            "sub": [(x - y) % p for x, y in zip(a_i, b_i)],
        }
        secs = {}
        for op, fn in (("mul", f.mul), ("sqr", lambda x, y: f.sqr(x)),
                       ("add", f.add), ("sub", f.sub)):
            jax.block_until_ready(fn(a, b))  # compile
            t0 = time.perf_counter()
            res = jax.block_until_ready(fn(a, b))
            secs[op] = time.perf_counter() - t0
            got = f.decode(res[jnp.asarray(idx)])
            bad = sum(g != w for g, w in zip(got, want[op]))
            check(bad == 0, f"{name}.{op}: {bad}/{len(idx)} sampled rows wrong")
        out[name] = {op: f"{rows / s:.4g} rows/s" for op, s in secs.items()}
    out.update(rows=rows, checked_rows=int(min(sample, rows)))
    return out


# ---------------------------------------------------------------------
# phase 2: MinRoot
# ---------------------------------------------------------------------


def _int_forward(p: int, e: int, x: int, y: int, i: int, t: int):
    for _ in range(t):
        x, y, i = pow((x + y) % p, e, p), (x + i) % p, (i + 1) % p
    return x, y, i


def _int_inverse(p: int, x: int, y: int, i: int, t: int):
    for _ in range(t):
        i = (i - 1) % p
        nx = (y - i) % p
        x, y = nx, (pow(x, 5, p) - nx) % p
    return x, y, i


def phase_minroot(t_single: int = 10_000, lanes: int = 1 << 14, t_lanes: int = 256) -> dict:
    """Evaluation.eval + verify per field; a lane batch, eval and inverse."""
    from vdf_nova.minroot import Evaluation, State, pallas_vdf, vesta_vdf
    from vdf_nova.minroot.vdf import jit_eval
    from vdf_nova.native import minroot_eval_native
    from vdf_nova.utils import TEST_SEED, XorShiftRng, field_random

    out = {"t": t_single}
    rng = XorShiftRng(TEST_SEED)
    for vdf in (pallas_vdf(), vesta_vdf()):
        f = vdf.field
        name = f.params.name
        x0, y0 = field_random(rng, f.params.modulus), field_random(rng, f.params.modulus)
        s0 = vdf.state_from_ints(x0, y0, 0)
        # compile both directions first: the timed calls below reuse them
        jit_eval(name, vdf.mode.value, t_single).lower(s0).compile()
        jit_eval(name, vdf.mode.value, t_single, inverse=True).lower(s0).compile()
        jax.block_until_ready(f.eq(s0.x, s0.x))  # and verify's comparison
        t0 = time.perf_counter()
        z0, proof = Evaluation.eval(vdf, s0, t_single)
        jax.block_until_ready(proof.result)
        dt_eval = time.perf_counter() - t0
        got = tuple(f.decode(v) for v in z0)
        want = minroot_eval_native(name, x0, y0, 0, t_single)
        check(got == tuple(want), f"MinRoot {name} t={t_single}: eval != native C++")
        t0 = time.perf_counter()
        ok = proof.verify(s0)
        dt_verify = time.perf_counter() - t0
        check(ok, f"MinRoot {name} t={t_single}: proof.verify failed")
        out[name] = {
            "eval_iters_per_s": round(t_single / dt_eval, 1),
            "verify_iters_per_s": round(t_single / dt_verify, 1),
        }

    # lane batch (Fq): eval then inverse, 2 lanes gated against ints
    vdf = pallas_vdf()
    f = vdf.field
    p, e = f.params.modulus, f.params.inv_alpha
    s0 = State(
        f.encode([3 + k for k in range(lanes)]),
        f.encode([k for k in range(lanes)]),
        f.encode([0] * lanes),
    )
    fwd = jit_eval("Fq", vdf.mode.value, t_lanes)
    inv = jit_eval("Fq", vdf.mode.value, t_lanes, inverse=True)
    fwd.lower(s0).compile()
    inv.lower(s0).compile()
    t0 = time.perf_counter()
    s1 = fwd(s0)
    jax.block_until_ready(s1.x)
    dt_f = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = inv(s1)
    jax.block_until_ready(back.x)
    dt_i = time.perf_counter() - t0
    for lane in range(2):
        want = _int_forward(p, e, 3 + lane, lane, 0, t_lanes)
        got = tuple(f.decode(v[lane : lane + 1])[0] for v in s1)
        check(got == want, f"lane {lane}: batched eval != host ints")
        want_back = _int_inverse(p, *got, t_lanes)
        got_back = tuple(f.decode(v[lane : lane + 1])[0] for v in back)
        check(got_back == want_back == (3 + lane, lane, 0), f"lane {lane}: inverse wrong")
    out["lanes"] = {
        "lanes": lanes,
        "t": t_lanes,
        "eval_iters_per_s_per_lane": round(t_lanes / dt_f, 2),
        "eval_iters_per_s_aggregate": round(lanes * t_lanes / dt_f, 1),
        "inverse_iters_per_s_aggregate": round(lanes * t_lanes / dt_i, 1),
    }
    return out


# ---------------------------------------------------------------------
# phase 3: MSM
# ---------------------------------------------------------------------


def msm_inputs(n: int, distinct: int = 4096):
    """``n`` Pallas points (``distinct`` hashed points, tiled) and random
    scalars: (the distinct affine ints, device points, scalar ints,
    device scalars).  Point ``k`` is ``distinct[k % len(distinct)]``."""
    import jax.numpy as jnp

    from vdf_nova.curves import get_curve
    from vdf_nova.curves.point import Point, hash_to_curve_ints

    curve = get_curve("pallas")
    base = hash_to_curve_ints("pallas", min(n, distinct), domain=b"chip_smoke/msm")
    reps = -(-n // len(base))
    pts = Point(*(jnp.tile(v, (reps, 1))[:n] for v in curve.from_affine_ints(base)))
    q = curve.scalar.params.modulus
    rng = np.random.default_rng(SEED + 1)
    raw = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.uint64)
    sc = [int.from_bytes(row.tobytes(), "little") % q for row in raw]
    return base, pts, sc, curve.scalar.encode(sc)


def native_affine(curve_name: str, aff, sc):
    """msm_native's Jacobian result as affine ints (None = identity)."""
    from vdf_nova.curves import get_curve
    from vdf_nova.native import msm_native

    out = msm_native(curve_name, aff, sc)
    if out is None:
        return None
    x, y, z = out
    mod = get_curve(curve_name).field.params.modulus
    zi = pow(z, -1, mod)
    return (x * zi * zi % mod, y * zi * zi % mod * zi % mod)


def _to_affine(curve, pt):
    from vdf_nova.curves.point import Point

    return curve.to_affine_ints(Point(*(v[None] for v in pt)))[0]


def phase_msm(n: int = 1 << 20) -> dict:
    """curves.msm.msm at ``n`` Pallas points against the native C++."""
    from vdf_nova.curves import get_curve
    from vdf_nova.curves.msm import msm

    curve = get_curve("pallas")
    base, pts, sc, s = msm_inputs(n)
    aff = [base[k % len(base)] for k in range(n)]
    t0 = time.perf_counter()
    want = native_affine("pallas", aff, sc)
    dt_native = time.perf_counter() - t0
    jax.block_until_ready(msm(curve, pts, s).x)  # compile
    t0 = time.perf_counter()
    r = msm(curve, pts, s)
    jax.block_until_ready(r.x)
    dt = time.perf_counter() - t0
    check(_to_affine(curve, r) == want, f"MSM at {n} points != native C++")
    return {
        "points": n,
        "points_per_s": round(n / dt, 1),
        "native_points_per_s": round(n / dt_native, 1),
    }


# ---------------------------------------------------------------------
# phases 4 and 5: IVC, compression, compile cache
# ---------------------------------------------------------------------


class CompileMeter:
    """Seconds JAX spends compiling (or loading from the persistent
    cache), and persistent-cache hits/misses, since ``reset``."""

    _EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        self.reset()
        jax.monitoring.register_event_duration_secs_listener(self._on_duration)
        jax.monitoring.register_event_listener(self._on_event)

    def reset(self):
        self.seconds, self.hits, self.misses = 0.0, 0, 0

    def _on_duration(self, event, duration_secs, **kw):
        if event == self._EVENT:
            self.seconds += duration_secs

    def _on_event(self, event, **kw):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1

    def read(self) -> dict:
        return {"seconds": round(self.seconds, 2), "cache_hits": self.hits,
                "cache_misses": self.misses}


def ivc_start(t: int, n: int):
    """(start, z0): a seeded VDF input and the chain input the IVC walks
    back from — the forward evaluation over n*t rounds."""
    from vdf_nova.fields.params import FQ
    from vdf_nova.native import minroot_eval_native
    from vdf_nova.utils import TEST_SEED, XorShiftRng, field_random

    x0 = field_random(XorShiftRng(TEST_SEED), FQ.modulus)
    start = [x0, 0, 1]
    return start, list(minroot_eval_native("Fq", *start, n * t))


def compare_to_native(dev, ref) -> None:
    """Bit-for-bit: running instances (commitments, X, u), folded
    witnesses and error vectors — E' = E + r*T with the same r, so equal
    E' means equal cross terms T — and the dangling instance."""
    pp = dev.pp
    for side_name in ("primary", "secondary"):
        side = getattr(pp, side_name)
        U_d, U_r = getattr(dev, f"r_U_{side_name}"), getattr(ref, f"r_U_{side_name}")
        check(U_d == U_r, f"first fold: r_U_{side_name} differs from native")
        for vec in ("W", "E"):
            got = side.field.decode(getattr(dev, f"r_{vec}_{side_name}"))
            want = [int(v) for v in getattr(ref, f"r_{vec}_{side_name}")]
            check(got == want, f"first fold: r_{vec}_{side_name} differs from native")
    check(dev.l_u_secondary.X == ref.l_u_secondary.X, "first fold: l_u_secondary.X differs")
    comm = dev.l_u_secondary.comm_w
    if comm is None:  # deferred on the device plane: compute it to compare
        comm = pp.secondary.commit_w(dev.l_w_secondary)
    check(comm == ref.l_u_secondary.comm_w, "first fold: l_u_secondary.comm_w differs")


def decoded(pp, proof):
    """``proof`` with its device witness vectors decoded to ints: the
    host plane's form of the same proof."""
    import dataclasses

    fp, fs = pp.primary.field, pp.secondary.field
    return dataclasses.replace(
        proof,
        r_W_primary=fp.decode(proof.r_W_primary),
        r_E_primary=fp.decode(proof.r_E_primary),
        r_W_secondary=fs.decode(proof.r_W_secondary),
        r_E_secondary=fs.decode(proof.r_E_secondary),
        l_w_secondary=fs.decode(proof.l_w_secondary),
    )


def phase_ivc(t: int = 100, n: int = 20, engine: str = "auto", meter=None) -> dict:
    """Prove n steps at t on the device plane, first fold against the
    native plane, then verify, compress and verify the compressed proof.
    With a ``meter``, also returns the cold compile of the fold
    executables (the base step and the first fold)."""
    from vdf_nova import ProverConfig
    from vdf_nova.nova.compressed import ivc_compress, ivc_verify_compressed
    from vdf_nova.nova.ivc import RecursiveIVC, ivc_public_params, ivc_verify
    from vdf_nova.utils.profiling import PhaseTimer

    check(n >= 3, "phase_ivc needs n >= 3 (base step, checked fold, timed folds)")
    cfg = ProverConfig(t=t, engine=engine)
    pp = cfg.public_params()
    check(pp.primary.use_device and pp.secondary.use_device,
          f"engine={engine!r}: a side is not on the device plane")
    start, z0 = ivc_start(t, n)

    if meter is not None:
        meter.reset()
    t0 = time.perf_counter()
    ivc = cfg.prover(z0)  # base step
    ivc.prove_step()  # first fold
    first_secs = time.perf_counter() - t0
    cold = meter.read() if meter is not None else None

    ref = RecursiveIVC(ivc_public_params(t, engine="native"), z0)
    ref.prove_step()
    compare_to_native(ivc, ref)

    ivc.timer = PhaseTimer()
    t0 = time.perf_counter()
    for _ in range(n - 2):
        ivc.prove_step()
    dt = time.perf_counter() - t0
    phases = {k: round(v / (n - 2), 4) for k, v in sorted(ivc.timer.totals.items())}

    t_end = time.perf_counter()
    proof = ivc.proof()
    cproof = ivc_compress(pp, proof)
    ok_c = ivc_verify_compressed(pp, cproof, n, z0, start)
    to_compressed = time.perf_counter() - t_end
    check(ok_c, "compressed proof rejected")
    check(proof.z_i == start, "IVC chain did not reach the VDF input")
    check(ivc_verify(pp, proof, n, z0, start), "ivc_verify rejected the proof")
    check(not ivc_verify(pp, proof, n, z0, [start[0] + 1, 0, 1]), "wrong input verified")
    return {
        "t": t,
        "n": n,
        "constraints": [pp.primary.shape.num_cons, pp.secondary.shape.num_cons],
        "base_plus_first_fold_s": round(first_secs, 2),
        "folds_per_s": round((n - 2) / dt, 3),
        "phase_s_per_fold": phases,
        "last_step_to_verified_compressed_s": round(to_compressed, 2),
        "cold_compile": cold,
        "_resume": (cfg, z0),
    }


def phase_compile(cfg, z0, meter) -> dict:
    """Clear JAX's in-memory caches and build the fold executables again
    (base step + one fold): they come back from the persistent cache."""
    jax.clear_caches()
    meter.reset()
    t0 = time.perf_counter()
    ivc = cfg.prover(z0)
    ivc.prove_step()
    jax.block_until_ready(ivc.r_W_primary)
    return {"warm_compile": meter.read(), "base_plus_first_fold_s": round(time.perf_counter() - t0, 2)}


# ---------------------------------------------------------------------
# --cards 4: the sharded paths
# ---------------------------------------------------------------------


def cards_eval(n_cards: int, lanes: int = 1 << 14, t: int = 16) -> dict:
    """Lane-sharded eval and check against the one-card eval."""
    import jax.numpy as jnp

    from vdf_nova.minroot import State, pallas_vdf
    from vdf_nova.minroot.vdf import jit_eval
    from vdf_nova.parallel import make_mesh, shard_state, sharded_check, sharded_eval

    vdf = pallas_vdf()
    f = vdf.field
    mesh = make_mesh(n_cards)
    s0 = State(
        f.encode([3 + k for k in range(lanes)]),
        f.encode([k for k in range(lanes)]),
        f.encode([0] * lanes),
    )
    one = jit_eval("Fq", vdf.mode.value, t)(s0)
    s0_sh = shard_state(s0, mesh)
    run = sharded_eval(vdf, t, mesh)
    run.lower(s0_sh).compile()
    t0 = time.perf_counter()
    res = run(s0_sh)
    jax.block_until_ready(res.x)
    dt = time.perf_counter() - t0
    for a, b in zip(res, one):
        check(bool(jnp.all(jax.device_get(f.canon(a)) == jax.device_get(f.canon(b)))),
              "sharded_eval differs from the one-card eval")
    n_ok = int(jax.device_get(sharded_check(vdf, t, mesh)(res, s0_sh)))
    check(n_ok == lanes, f"sharded_check: {n_ok}/{lanes} lanes valid")
    return {"lanes": lanes, "t": t, "iters_per_s_aggregate": round(lanes * t / dt, 1)}


def cards_msm_prepare(n_cards: int, n: int = 1 << 20, distinct: int = 4096):
    """phase 3's inputs, their native C++ MSM and the first (compiling)
    call of sharded_msm.  The reference MSM runs over the distinct
    points with each one's scalars summed mod q: the same group element
    as the n-term sum.  Returns what ``cards_msm`` times and checks."""
    from jax.sharding import Mesh

    from vdf_nova.curves import get_curve
    from vdf_nova.parallel import SHARD_AXIS
    from vdf_nova.parallel.mesh import sharded_msm

    t0 = time.perf_counter()
    curve = get_curve("pallas")
    base, pts, sc, s = msm_inputs(n, distinct)
    q = curve.scalar.params.modulus
    summed = [0] * len(base)
    for k, v in enumerate(sc):
        summed[k % len(base)] += v
    want = native_affine("pallas", base, [v % q for v in summed])
    mesh = Mesh(np.asarray(jax.devices()[:n_cards]), (SHARD_AXIS,))
    run = jax.jit(lambda p, q: sharded_msm(curve, p, q, mesh))
    jax.block_until_ready(run(pts, s).x)
    return {"run": run, "inputs": (pts, s), "want": want, "n": n,
            "prepare_s": round(time.perf_counter() - t0, 2)}


def cards_msm(prep: dict) -> dict:
    """Time sharded_msm on ``cards_msm_prepare``'s inputs; check it."""
    from vdf_nova.curves import get_curve

    t0 = time.perf_counter()
    r = prep["run"](*prep["inputs"])
    jax.block_until_ready(r.x)
    dt = time.perf_counter() - t0
    check(_to_affine(get_curve("pallas"), r) == prep["want"],
          "sharded_msm differs from the native MSM")
    return {"points": prep["n"], "points_per_s": round(prep["n"] / dt, 1),
            "prepare_s": prep["prepare_s"]}


def warm_commits(pp) -> None:
    """Compile both sides' commit executables at once: XLA compiles
    release the GIL, and these two are most of a cold start."""
    with ThreadPoolExecutor(2) as ex:
        for fut in [ex.submit(lambda sd=sd: sd.commit_w(sd.zero_w()))
                    for sd in (pp.primary, pp.secondary)]:
            fut.result()


def cards_ivc(n_cards: int, t: int = 100, steps: int = 4, engine: str = "auto") -> dict:
    """ProverConfig(shards=n_cards) against the native plane, step by
    step: running instances (commitments, X, u) and the dangling one."""
    from vdf_nova import ProverConfig
    from vdf_nova.nova.ivc import RecursiveIVC, ivc_public_params, ivc_verify

    start, z0 = ivc_start(t, steps)
    cfg = ProverConfig(t=t, engine=engine, shards=n_cards)
    warm_commits(cfg.public_params())
    sharded = cfg.prover(z0)
    check(sharded.pp.primary._use_tp and sharded.pp.primary.use_device, "mesh not attached")
    native_pp = ivc_public_params(t, engine="native")
    ref = RecursiveIVC(native_pp, z0)

    def same(step):
        for name in ("r_U_primary", "r_U_secondary"):
            check(getattr(sharded, name) == getattr(ref, name), f"step {step}: {name} differs")
        check(sharded.l_u_secondary.X == ref.l_u_secondary.X, f"step {step}: l_u X differs")

    same(0)
    t0 = time.perf_counter()
    for step in range(1, steps):
        sharded.prove_step()
        ref.prove_step()
        same(step)
    dt = time.perf_counter() - t0
    proof = sharded.proof()
    check(proof.l_u_secondary == ref.proof().l_u_secondary, "final instance differs")
    check(ivc_verify(native_pp, decoded(sharded.pp, proof), steps, z0, start),
          "sharded IVC proof rejected")
    return {"t": t, "steps": steps, "sharded_and_native_s": round(dt, 2)}


# ---------------------------------------------------------------------


def run(phases: list) -> None:
    """Run (name, fn) phases in order; each prints one line."""
    for name, fn in phases:
        t0 = time.perf_counter()
        res = fn()
        res["wall_s"] = round(time.perf_counter() - t0, 2)
        log(name, **res)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded paths on four cards")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    dev = phase_device(args.cards)
    log("phase0_device", **dev)
    if args.cards == 4:
        # the MSM's inputs, reference and compile overlap the other two
        # phases; its timed call runs alone at the end
        with ThreadPoolExecutor(1) as ex:
            msm_prep = ex.submit(cards_msm_prepare, 4)
            run([
                ("cards4_eval", lambda: cards_eval(4)),
                ("cards4_ivc", lambda: cards_ivc(4)),
                ("cards4_msm", lambda: cards_msm(msm_prep.result())),
            ])
    else:
        meter = CompileMeter()
        state = {}

        def ivc():
            res = phase_ivc(meter=meter)
            state["resume"] = res.pop("_resume")
            return res

        run([
            ("phase1_fields", phase_fields),
            ("phase2_minroot", phase_minroot),
            ("phase3_msm", phase_msm),
            ("phase4_ivc", ivc),
            ("phase5_compile", lambda: phase_compile(*state["resume"], meter)),
        ])
    log("total", wall_s=round(time.perf_counter() - t0, 2))
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                             "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
