"""The one place that decides what the program does on each backend.

Every choice that depends on the machine the program runs on — which
data plane ``engine="auto"`` proves on, how large a batch one compiled
field multiply may take, how many point slots a Pippenger window group
may hold — is read from ``profile()``.  No other module branches on
``jax.default_backend()``.

The GPU values were measured on an NVIDIA H100 (see PERF.md, Findings);
the CPU values come from the XLA:CPU behaviour documented beside each
field.  A platform without a profile is an error, not a default.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib

import jax

# The checkout that holds this package: the compile cache lives there.
CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


@dataclasses.dataclass(frozen=True)
class BackendProfile:
    platform: str
    # engine="auto" proves on the device plane (else the host C++/int plane).
    device_plane: bool
    # Largest flat batch one compiled Field._mul_core takes; larger
    # batches run as a lax.map over chunks.  None: no chunking.
    mul_chunk_rows: int | None
    # Point slots (sorted copies + run prefixes) one Pippenger window
    # group may materialize at once (curves/msm.py).
    msm_slot_budget: int


_PROFILES = {
    # XLA:CPU returns wrong limbs for every row of the fused
    # conv/resolve composite above ~40k rows (jax 0.9.0; onset between
    # 40000 and 49152), so multiplies run in 16k-row chunks, and the MSM
    # budget keeps vmapped window batches under the same onset.
    "cpu": BackendProfile(
        platform="cpu",
        device_plane=False,
        mul_chunk_rows=1 << 14,
        msm_slot_budget=1 << 14,
    ),
    # XLA:GPU (H100, jax 0.9.0) multiplies exactly unchunked at 2^15,
    # 2^17 and 2^20 rows, so nothing is chunked; the MSM budget only
    # bounds memory (2^22 slots: ~0.9 GB per copy of a group's points).
    "gpu": BackendProfile(
        platform="gpu",
        device_plane=True,
        mul_chunk_rows=None,
        msm_slot_budget=1 << 22,
    ),
}


def profile(platform: str | None = None) -> BackendProfile:
    """The profile of ``platform`` (default: JAX's default backend)."""
    platform = platform or jax.default_backend()
    try:
        return _PROFILES[platform]
    except KeyError:
        raise ValueError(
            f"no backend profile for platform {platform!r} "
            f"(supported: {sorted(_PROFILES)})"
        ) from None


def use_device(engine: str, platform: str | None = None) -> bool:
    """Whether an IVC side with this ``engine`` runs on the device plane."""
    if engine == "auto":
        return profile(platform).device_plane
    return engine == "device"


def setup_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    no directory is set here.  Otherwise the cache is ``.jax_cache`` in
    the checkout: a fixed path, because the path is part of the key.
    """
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = str(CHECKOUT / ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return cache_dir
