"""Test harness config: the CPU backend with 8 virtual devices by default.

Multi-device sharding is validated on a virtual CPU mesh
(``--xla_force_host_platform_device_count=8``).  Tests marked ``gpu``
need the card and skip elsewhere; on a machine with one, run them with

    JAX_PLATFORMS=cuda python -m pytest tests -m gpu -q

(``JAX_PLATFORMS`` is only defaulted to ``cpu`` here, never overridden.)
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import subprocess

# The jitted prover/verifier pieces create many mmap'd executables; the
# default vm.max_map_count (65530) is too low and LLVM then fails with
# spurious "Cannot allocate memory".  Raise it when we can (best effort).
try:
    with open("/proc/sys/vm/max_map_count") as fh:
        if int(fh.read()) < 1 << 20:
            subprocess.run(
                ["sysctl", "-w", "vm.max_map_count=4194304"],
                capture_output=True,
                check=False,
            )
except OSError:
    pass

import jax
import pytest

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

from vdf_nova.utils.backend import setup_compile_cache

# Persistent compile cache: the jitted prover/verifier graphs are large;
# caching them across test processes keeps the suite fast after first run.
setup_compile_cache()


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip tests marked ``gpu`` unless JAX's default backend is a GPU."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run: JAX_PLATFORMS=cuda python -m pytest tests -m gpu)")
