"""Unified runtime configuration (the SURVEY §5 config/flag plan).

The reference's only runtime configuration is ``EvalMode`` plus the
numeric parameters t / num_steps threaded through its APIs
(/root/reference/src/minroot.rs:15-31, src/nova/proof.rs:232,262-267);
compile-time behavior comes from Cargo features.  This framework has
more axes (engine tier, lane counts, shard mesh, checkpointing,
profiling), previously spread across kwargs and environment variables.
``ProverConfig`` gathers them in one frozen dataclass with env-variable
overrides, and ``build`` turns a config into ready-to-use objects.

Environment overrides (read by ``ProverConfig.from_env``):

  VDF_NOVA_EVAL_MODE   one of EvalMode's values
  VDF_NOVA_T           iterations folded per IVC step
  VDF_NOVA_LANES       DP lanes for batched evaluation
  VDF_NOVA_ENGINE      auto | device | native
  VDF_NOVA_SHARDS      TP mesh size (1 = no tensor parallelism)
  VDF_NOVA_CHECKPOINT  directory for proof-carrying checkpoints
  VDF_NOVA_PROFILE     jax.profiler trace directory (utils/profiling.py)
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class ProverConfig:
    """Everything needed to stand up the prover stack."""

    eval_mode: str = "ltr_sequential"  # forward-step schedule (EvalMode)
    t: int = 32  # VDF iterations per IVC step (circuit size ~ 3t + overhead)
    lanes: int = 16384  # DP lanes for batched VDF evaluation
    engine: str = "auto"  # data plane: "device" (JAX) | "native" (C++/int) | "auto"
    shards: int = 1  # TP mesh size for MSM/matvec sharding
    checkpoint_dir: str | None = None  # proof-carrying checkpoints (checkpoint.py)
    debug_synthesis: bool = False  # TestConstraintSystem-style witness checks

    def __post_init__(self):
        from .minroot import EvalMode

        EvalMode(self.eval_mode)  # validate early
        if self.t < 1:
            raise ValueError("t must be >= 1")
        if self.engine not in ("auto", "device", "native"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.shards < 1:
            raise ValueError("shards must be >= 1")

    @classmethod
    def from_env(cls, **overrides) -> "ProverConfig":
        env = os.environ
        kw = dict(
            eval_mode=env.get("VDF_NOVA_EVAL_MODE", cls.eval_mode),
            t=int(env.get("VDF_NOVA_T", cls.t)),
            lanes=int(env.get("VDF_NOVA_LANES", cls.lanes)),
            engine=env.get("VDF_NOVA_ENGINE", cls.engine),
            shards=int(env.get("VDF_NOVA_SHARDS", cls.shards)),
            checkpoint_dir=env.get("VDF_NOVA_CHECKPOINT", cls.checkpoint_dir),
        )
        kw.update(overrides)
        return cls(**kw)

    # -- materialization ------------------------------------------------

    def vdf(self):
        """The configured MinRoot VDF (lane batching is caller-shaped)."""
        from .minroot import EvalMode, pallas_vdf

        return pallas_vdf(EvalMode(self.eval_mode))

    def mesh(self):
        """The TP shard mesh, or None when shards == 1."""
        if self.shards == 1:
            return None
        import jax
        import numpy as np
        from jax.sharding import Mesh

        from .parallel import SHARD_AXIS

        return Mesh(np.asarray(jax.devices()[: self.shards]), (SHARD_AXIS,))

    def public_params(self):
        """IVC public params for this config (cached per (t, engine, mesh))."""
        from .nova.ivc import ivc_public_params

        return ivc_public_params(self.t, engine=self.engine, mesh=self.mesh())

    def prover(self, z0: list[int]):
        """A ready RecursiveIVC over this config's params."""
        from .nova.ivc import RecursiveIVC

        return RecursiveIVC(self.public_params(), z0, debug=self.debug_synthesis)
