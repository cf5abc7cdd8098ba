"""vdf_nova: a MinRoot VDF + Nova recursive-SNARK framework in JAX.

A from-scratch JAX re-design of the capability surface of the ``vdf``
reference crate (MinRoot over the Pasta fields, Nova IVC proving,
Spartan+IPA compression) — arrays-of-limbs field arithmetic, lane-batched
VDF evaluation, and mesh-shardable proving math.

Top-level surface mirrors the reference's ``lib.rs`` exports
(/root/reference/src/lib.rs:1-4): the ``minroot`` and ``nova`` modules
plus the deterministic test seed.
"""

from . import fields, minroot, nova  # noqa: F401  (reference: pub mod ...)
from .minroot import (  # noqa: F401
    EvalMode,
    Evaluation,
    MinRootVDF,
    State,
    pallas_vdf,
    vesta_vdf,
)
from .errors import (  # noqa: F401
    NovaError,
    SerializationError,
    SynthesisError,
    VDFError,
)
from .config import ProverConfig  # noqa: F401
from .utils import TEST_SEED  # noqa: F401

# The reference declares Pallas the canonical instantiation
# (``TargetVDF``, /root/reference/src/minroot.rs:265).
target_vdf = pallas_vdf

__version__ = "0.1.0"
