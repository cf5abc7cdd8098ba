"""The backend profile and compile-cache helper (utils/backend.py)."""

import pathlib

import jax
import pytest

from vdf_nova.utils import backend

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize(
    "platform,engine,expected",
    [
        ("gpu", "auto", True),
        ("cpu", "auto", False),
        ("gpu", "native", False),
        ("cpu", "device", True),
    ],
)
def test_engine_resolution(platform, engine, expected):
    assert backend.use_device(engine, platform) is expected


def test_unknown_platform_is_an_error():
    with pytest.raises(ValueError, match="no backend profile"):
        backend.profile("metal")


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert backend.setup_compile_cache() == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # set nothing in code
