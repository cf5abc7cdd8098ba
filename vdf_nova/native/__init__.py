"""Native (C++) runtime tier: build shim + ctypes bindings.

The reference's only native component is pasta-msm (C/C++ Pippenger
under Rust bindings, SURVEY.md §2 D5).  Here the native tier provides:

  * ``msm_native``       — CPU Pippenger MSM (cross-check oracle and
    host-side accelerator for setup/verification),
  * ``minroot_eval/inverse_native`` — a reference-grade scalar MinRoot
    evaluator, used to measure the honest single-chain CPU baseline the
    bench compares against.

The shared object builds on first use with g++ -O3 (constants header is
generated from fields/params.py so both sides share one source of
truth) and is cached next to the sources.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import subprocess

import numpy as np

from ..fields.params import FP, FQ

_DIR = pathlib.Path(__file__).parent


def _fmt_limbs(v: int, n: int = 4) -> str:
    limbs = [(v >> (64 * k)) & ((1 << 64) - 1) for k in range(n)]
    return "{" + ", ".join(f"0x{x:016x}ULL" for x in limbs) + "}"


def _write_constants_header() -> None:
    lines = ["// Generated by vdf_nova.native — do not edit.", "#pragma once",
             "#include <cstdint>"]
    for name, P in (("FP", FP), ("FQ", FQ)):
        mod = P.modulus
        r = 1 << 256
        lines += [
            f"static const uint64_t {name}_MOD[4] = {_fmt_limbs(mod)};",
            f"static const uint64_t {name}_PINV = 0x{(-pow(mod, -1, 1 << 64)) % (1 << 64):016x}ULL;",
            f"static const uint64_t {name}_R2[4] = {_fmt_limbs((r * r) % mod)};",
            f"static const uint64_t {name}_ONE[4] = {_fmt_limbs(r % mod)};",
            f"static const uint64_t {name}_INVALPHA[4] = {_fmt_limbs(P.inv_alpha)};",
        ]
    (_DIR / "pasta_constants.h").write_text("\n".join(lines) + "\n")


@functools.cache
def load() -> ctypes.CDLL:
    so = _DIR / "libpasta_native.so"
    src = _DIR / "pasta.cpp"
    if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
        _write_constants_header()
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", str(src),
             "-o", str(so)],
            check=True,
            capture_output=True,
        )
    lib = ctypes.CDLL(str(so))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.minroot_eval_native.argtypes = [ctypes.c_int, u64p, ctypes.c_uint64]
    lib.minroot_inverse_native.argtypes = [ctypes.c_int, u64p, ctypes.c_uint64]
    lib.msm_native.argtypes = [ctypes.c_int, u64p, u64p, ctypes.c_uint64, u64p]
    lib.fold_points_native.argtypes = [
        ctypes.c_int, u64p, u64p, u64p, u64p, ctypes.c_uint64, u64p, u64p,
    ]
    lib.poseidon_witness_native.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u64p, u64p, u64p, u64p,
    ]
    lib.ec_fold_witness_native.argtypes = [
        ctypes.c_int, u64p, u64p, u64p, ctypes.c_int, u64p,
    ]
    return lib


def _to_u64(v: int, n: int = 4) -> list[int]:
    return [(v >> (64 * k)) & ((1 << 64) - 1) for k in range(n)]


def _from_u64(arr) -> int:
    return sum(int(x) << (64 * k) for k, x in enumerate(arr))


def minroot_eval_native(field_name: str, x: int, y: int, i: int, t: int):
    """Forward MinRoot eval over exact ints (canonical in/out)."""
    lib = load()
    st = np.asarray(_to_u64(x) + _to_u64(y) + _to_u64(i), dtype=np.uint64)
    lib.minroot_eval_native(
        1 if field_name == "Fq" else 0,
        st.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        t,
    )
    return _from_u64(st[0:4]), _from_u64(st[4:8]), _from_u64(st[8:12])


def minroot_inverse_native(field_name: str, x: int, y: int, i: int, t: int):
    lib = load()
    st = np.asarray(_to_u64(x) + _to_u64(y) + _to_u64(i), dtype=np.uint64)
    lib.minroot_inverse_native(
        1 if field_name == "Fq" else 0,
        st.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        t,
    )
    return _from_u64(st[0:4]), _from_u64(st[4:8]), _from_u64(st[8:12])


def pack_points_u64(points: list[tuple[int, int]]) -> np.ndarray:
    """Affine int pairs -> flat (n*8,) uint64 buffer for msm_native.
    int.to_bytes runs in C — ~30x faster than per-limb Python shifts,
    and fixed point sets (Pedersen generators) pack ONCE and are reused
    across every commit (the marshalling was the host-plane commit's
    dominant cost, not the C++ Pippenger itself)."""
    buf = b"".join(
        px.to_bytes(32, "little") + py.to_bytes(32, "little") for (px, py) in points
    )
    return np.frombuffer(buf, dtype=np.uint64).copy()


def pack_scalars_u64(scalars: list[int]) -> np.ndarray:
    """Canonical ints -> flat (n*4,) uint64 buffer."""
    buf = b"".join(int(s).to_bytes(32, "little") for s in scalars)
    return np.frombuffer(buf, dtype=np.uint64).copy()


def msm_native_packed(curve_name: str, pts_u64: np.ndarray, sc_u64: np.ndarray):
    """Pippenger MSM over pre-packed u64 buffers (see pack_points_u64);
    zero scalars are skipped inside the kernel (digit-0 bucket dump), so
    callers need not filter.  Returns canonical projective (x, y, z) or
    None for the identity."""
    lib = load()
    n = sc_u64.shape[0] // 4
    assert pts_u64.shape[0] >= 8 * n
    out = np.zeros(12, dtype=np.uint64)
    lib.msm_native(
        1 if curve_name == "vesta" else 0,
        pts_u64.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        sc_u64.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    x, y, z = _from_u64(out[0:4]), _from_u64(out[4:8]), _from_u64(out[8:12])
    if z == 0:
        return None
    return x, y, z


def msm_native(curve_name: str, points: list[tuple[int, int]], scalars: list[int]):
    """Pippenger MSM over exact ints; returns canonical projective
    (x, y, z) or None for the identity."""
    return msm_native_packed(
        curve_name, pack_points_u64(points), pack_scalars_u64(scalars)
    )


@functools.lru_cache(maxsize=8)
def _poseidon_packed(field_name: str, width: int):
    from ..poseidon.int_poseidon import _constants
    from ..poseidon.params import FULL_ROUNDS, partial_rounds

    rc, mds = _constants(field_name, width)
    rc_buf = b"".join(int(c).to_bytes(32, "little") for row in rc for c in row)
    mds_buf = b"".join(int(c).to_bytes(32, "little") for row in mds for c in row)
    r_p = partial_rounds(width)
    half = FULL_ROUNDS // 2
    n_sbox = half * width + r_p + (FULL_ROUNDS - half) * width
    return (
        np.frombuffer(rc_buf, dtype=np.uint64).copy(),
        np.frombuffer(mds_buf, dtype=np.uint64).copy(),
        half,
        r_p,
        FULL_ROUNDS,
        n_sbox,
    )


def poseidon_permute_native(
    field_name: str, state: list[int], emit_triples: bool = False
):
    """One Poseidon permutation over canonical ints (bit-identical to
    poseidon/int_poseidon.py::permute_ints).  With ``emit_triples``,
    also returns every S-box's (x^2, x^4, x^5) in the in-circuit
    sponge's allocation order (nova/gadgets/sponge.py) — the witness
    fast path for the augmented circuit's transcript gadgets."""
    lib = load()
    width = len(state)
    rc, mds, half, r_p, fr, n_sbox = _poseidon_packed(field_name, width)
    st = np.frombuffer(
        b"".join(int(v).to_bytes(32, "little") for v in state), dtype=np.uint64
    ).copy()
    u64p = ctypes.POINTER(ctypes.c_uint64)
    tri = np.zeros(n_sbox * 12, dtype=np.uint64) if emit_triples else None
    lib.poseidon_witness_native(
        1 if field_name == "Fq" else 0,
        width,
        half,
        r_p,
        fr,
        rc.ctypes.data_as(u64p),
        mds.ctypes.data_as(u64p),
        st.ctypes.data_as(u64p),
        tri.ctypes.data_as(u64p) if tri is not None else None,
    )
    buf = st.tobytes()
    out = [int.from_bytes(buf[32 * j : 32 * (j + 1)], "little") for j in range(width)]
    if not emit_triples:
        return out
    tbuf = tri.tobytes()
    triples = [
        int.from_bytes(tbuf[32 * k : 32 * (k + 1)], "little")
        for k in range(n_sbox * 3)
    ]
    return out, triples


def ec_fold_witness_native(
    field_name: str,
    base_proj: tuple[int, int, int],
    pt_proj: tuple[int, int, int],
    r_bits_msb: list[int],
):
    """All witness values of one in-circuit scaled_add
    (nova/gadgets/instance.py fold(): base + r*pt via MSB-first
    double-and-add over complete projective ops), in exact gadget
    allocation order.  Returns a flat list of canonical ints of length
    n_bits*23 + 12 + 4; the last 4 are (inf, zinv, x, y) of the affine
    result."""
    lib = load()
    n_bits = len(r_bits_msb)
    bp = np.asarray(
        _to_u64(base_proj[0]) + _to_u64(base_proj[1]) + _to_u64(base_proj[2]),
        dtype=np.uint64,
    )
    pp = np.asarray(
        _to_u64(pt_proj[0]) + _to_u64(pt_proj[1]) + _to_u64(pt_proj[2]),
        dtype=np.uint64,
    )
    bits = np.asarray(r_bits_msb, dtype=np.uint64)
    n_out = n_bits * 23 + 12 + 4
    out = np.zeros(n_out * 4, dtype=np.uint64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.ec_fold_witness_native(
        1 if field_name == "Fq" else 0,
        bp.ctypes.data_as(u64p),
        pp.ctypes.data_as(u64p),
        bits.ctypes.data_as(u64p),
        n_bits,
        out.ctypes.data_as(u64p),
    )
    buf = out.tobytes()
    return [
        int.from_bytes(buf[32 * k : 32 * (k + 1)], "little") for k in range(n_out)
    ]


def fold_points_native(
    curve_name: str,
    pts_p: list[tuple[int, int]],
    pts_q: list[tuple[int, int]],
    a: int,
    b: int,
) -> list[tuple[int, int]]:
    """out[i] = a*P[i] + b*Q[i], batched (the IPA prover's generator
    fold, host-int tier).  Affine canonical in/out; raises if any result
    is the identity (cryptographically unreachable for transcript
    challenges — failing loudly beats an unrepresentable encoding)."""
    lib = load()
    n = len(pts_p)
    assert len(pts_q) == n
    pp = np.asarray(
        [l for (x, y) in pts_p for l in (_to_u64(x) + _to_u64(y))], dtype=np.uint64
    )
    qq = np.asarray(
        [l for (x, y) in pts_q for l in (_to_u64(x) + _to_u64(y))], dtype=np.uint64
    )
    sa = np.asarray(_to_u64(a), dtype=np.uint64)
    sb = np.asarray(_to_u64(b), dtype=np.uint64)
    out = np.zeros(n * 8, dtype=np.uint64)
    flags = np.zeros(n, dtype=np.uint64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.fold_points_native(
        1 if curve_name == "vesta" else 0,
        pp.ctypes.data_as(u64p),
        qq.ctypes.data_as(u64p),
        sa.ctypes.data_as(u64p),
        sb.ctypes.data_as(u64p),
        n,
        out.ctypes.data_as(u64p),
        flags.ctypes.data_as(u64p),
    )
    if flags.any():
        raise ValueError("fold_points_native produced an identity point")
    return [
        (_from_u64(out[i * 8 : i * 8 + 4]), _from_u64(out[i * 8 + 4 : i * 8 + 8]))
        for i in range(n)
    ]
