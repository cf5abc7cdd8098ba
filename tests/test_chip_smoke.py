"""chip_smoke.py: its refusal without a GPU, its phases at the CPU
suite's shapes, and (marker ``gpu``) its phases at full size on the card."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

import chip_smoke

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    proc = _run_smoke(REPO, REPO / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    proc = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_phase_fields_small():
    out = chip_smoke.phase_fields(rows=16, sample=16)
    assert out["checked_rows"] == 16 and set(out) >= {"Fp", "Fq"}


def test_phase_minroot_small():
    out = chip_smoke.phase_minroot(t_single=2, lanes=4, t_lanes=2)
    assert out["lanes"]["lanes"] == 4 and {"Fp", "Fq"} <= set(out)


def test_phase_msm_small():
    assert chip_smoke.phase_msm(n=8)["points"] == 8


@pytest.mark.gpu
def test_phase_fields_full_size():
    chip_smoke.phase_fields()


@pytest.mark.gpu
def test_phase_msm_full_size():
    chip_smoke.phase_msm()


@pytest.mark.gpu
def test_phase_ivc_reference_point():
    out = chip_smoke.phase_ivc(t=100, n=4)
    assert out["folds_per_s"] > 0


def test_cards_eval_on_virtual_mesh():
    """The --cards 4 lane-sharded eval/check path, on 4 virtual CPU devices."""
    assert chip_smoke.cards_eval(4, lanes=16, t=2)["lanes"] == 16


def test_cards_msm_on_virtual_mesh():
    """The --cards 4 sharded MSM against the native MSM over the distinct
    points with summed scalars (32 points, 8 distinct), on 4 virtual
    CPU devices."""
    prep = chip_smoke.cards_msm_prepare(4, n=32, distinct=8)
    assert len(prep["want"]) == 2
    assert chip_smoke.cards_msm(prep)["points"] == 32
