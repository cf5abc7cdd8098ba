"""Structured per-phase timing + optional jax.profiler traces.

The reference's only observability is Criterion bench groups
(/root/reference/benches/vdf.rs:57-61); here the prover records named
phase timings (SURVEY.md §5 tracing plan) and, when ``VDF_NOVA_PROFILE``
is set to a directory, wraps work in a ``jax.profiler.trace`` so device
timelines land in TensorBoard format.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time


class PhaseTimer:
    """Accumulates wall-clock per named phase; cheap enough to always run."""

    def __init__(self):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        with jax_named_scope(name):
            yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: {"seconds": round(self.totals[name], 4), "calls": self.counts[name]}
            for name in sorted(self.totals)
        }


def jax_named_scope(name: str):
    try:
        import jax

        return jax.named_scope(name)
    except Exception:
        return contextlib.nullcontext()


@contextlib.contextmanager
def maybe_profile():
    """jax.profiler trace when VDF_NOVA_PROFILE=<dir> is set; no-op otherwise."""
    out = os.environ.get("VDF_NOVA_PROFILE")
    if not out:
        yield
        return
    import jax

    with jax.profiler.trace(out):
        yield
