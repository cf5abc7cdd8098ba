"""N=2-process distributed mesh test (SURVEY §2.4 comm-backend row).

Spawns two real OS processes, each with 4 virtual CPU devices, joined
through ``jax.distributed`` into one 8-device global mesh; both run the
framework's actual TP executables (``sharded_matvec``, ``sharded_msm``)
over the process mesh and check results against exact host ints.

This is the CI-runnable stand-in for the BASELINE "N>=2 hosts" axis —
the same ``vdf_nova.parallel.distributed`` entry drives real multi-host
clusters (where the collectives ride NVLink/the network instead of
loopback).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_mesh():
    port = _free_port()
    env_base = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    procs = []
    for pid in range(2):
        env = dict(
            env_base,
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            JAX_PLATFORMS="cpu",
            VDF_COORD=f"127.0.0.1:{port}",
            VDF_NPROC="2",
            VDF_PID=str(pid),
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, _WORKER],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
                cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=1200)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-25:])
        assert p.returncode == 0, f"process {pid} failed:\n{tail}"
        assert "MULTIHOST_OK" in out, f"process {pid} missing OK:\n{tail}"
