"""ProverConfig (vdf_nova/config.py): validation, env overrides, wiring."""

import pytest

from vdf_nova import ProverConfig


def test_defaults_and_validation():
    cfg = ProverConfig()
    assert cfg.t == 32 and cfg.engine == "auto" and cfg.shards == 1
    with pytest.raises(ValueError):
        ProverConfig(t=0)
    with pytest.raises(ValueError):
        ProverConfig(engine="gpu")
    with pytest.raises(ValueError):
        ProverConfig(eval_mode="nonsense")
    assert ProverConfig().mesh() is None


def test_from_env_overrides(monkeypatch):
    monkeypatch.setenv("VDF_NOVA_T", "7")
    monkeypatch.setenv("VDF_NOVA_ENGINE", "native")
    monkeypatch.setenv("VDF_NOVA_EVAL_MODE", "rtl_add_chain")
    cfg = ProverConfig.from_env()
    assert (cfg.t, cfg.engine, cfg.eval_mode) == (7, "native", "rtl_add_chain")
    # explicit overrides beat env
    assert ProverConfig.from_env(t=3).t == 3


def test_prover_roundtrip_native():
    """Config -> prover -> one step -> verify (tiny, native engine)."""
    from vdf_nova.nova.ivc import ivc_verify

    cfg = ProverConfig(t=2, engine="native")
    vdf = cfg.vdf()
    assert vdf.field.params.name == "Fq"
    p = vdf.field.params.modulus
    e = p  # silence linters; exponent below
    e = pow(5, -1, p - 1)
    x, y, i = 42, 0, 0
    for _ in range(2 * 2):
        x, y, i = pow((x + y) % p, e, p), (x + i) % p, i + 1
    ivc = cfg.prover([x, y, i])
    ivc.prove_step()
    assert ivc_verify(cfg.public_params(), ivc.proof(), 2, [x, y, i], [42, 0, 0])
