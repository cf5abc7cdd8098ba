"""Pedersen vector commitments over the Pasta curves (Nova's PCS base).

Equivalent of nova-snark's CommitmentGens/Commitment (SURVEY.md §2 D3):
fixed hash-derived generators (no known discrete logs), commitments via
the batched MSM.  Commit runs on device; keys are cached per (curve, n).
"""

from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp

from ..curves import Curve, Point, get_curve, hash_to_curve_ints
from ..curves.msm import msm


@dataclasses.dataclass
class CommitmentKey:
    curve: Curve
    gens: Point  # (n,) points
    h: Point  # blinding generator (1,)

    def commit(self, values: jnp.ndarray, blind: jnp.ndarray | None = None) -> Point:
        """values: (n, 17) Montgomery scalars -> one point.

        ``blind=None`` commits deterministically (Nova folds use zero
        blinds; hiding needs the blind term)."""
        n = values.shape[0]
        gens = Point(*(v[:n] for v in self.gens))
        out = msm(self.curve, gens, values)
        if blind is not None:
            hb = msm(self.curve, Point(*(v[None] for v in self.h)), blind[None])
            out = self.curve.add(
                Point(*(v[None] for v in out)), Point(*(v[None] for v in hb))
            )
            out = Point(*(v[0] for v in out))
        return out


# Hash-to-curve domain of every IVC commitment key (device and host
# tiers).  A protocol constant: the params digest absorbs it
# (nova/ivc.py::_params_digest) and tests/test_golden.py pins the keys.
CK_LABEL = b"vdf_nova/ck"


@functools.lru_cache(maxsize=16)
def commitment_key(curve_name: str, n: int, label: bytes = CK_LABEL) -> CommitmentKey:
    curve = get_curve(curve_name)
    pts = hash_to_curve_ints(curve_name, n + 1, domain=label)
    gens = curve.from_affine_ints(pts[:n])
    h = Point(*(v[0] for v in curve.from_affine_ints(pts[n:])))  # single point
    return CommitmentKey(curve, gens, h)
