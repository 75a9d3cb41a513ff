"""Predictor JSON of mellon_tpu_torch against mellon_tpu: files written by
either package load in the other (plain, gzip and bz2), the reference
Mellon's own file loads, and its <1.4.0 files are migrated."""

import json
import logging
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU64, clustered, to_np
import mellon_tpu
import mellon_tpu_torch
from mellon_tpu_torch import Predictor, state_from_jax

FIXTURES = Path(__file__).resolve().parent / "fixtures"
METHODS = ("mean", "covariance", "mean_covariance", "uncertainty")


@pytest.fixture(scope="module")
def fitted():
    """mellon_tpu's fit with Laplace uncertainty (n = 200, d = 3, 30
    landmarks), its predictor, the port's copy of it, and new points."""
    x = clustered(200, 3, seed=60)
    est = mellon_tpu.DensityEstimator(n_landmarks=30, predictor_with_uncertainty=True)
    est.fit(jnp.asarray(x))
    return est.predict, state_from_jax(est.predict, **CPU64), clustered(40, 3, seed=61)


def _assert_same_surface(got, want, x_new):
    """mean, covariance, mean_covariance and uncertainty at x_new: 1e-10
    relative to the largest value of each."""
    for method in METHODS:
        a = to_np(getattr(got, method)(x_new if isinstance(got, Predictor) else jnp.asarray(x_new)))
        b = to_np(getattr(want, method)(x_new if isinstance(want, Predictor) else jnp.asarray(x_new)))
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max(), method


@pytest.mark.parametrize("compress,suffix", [(None, ".json"), ("gzip", ".json.gz"), ("bz2", ".json.bz2")])
def test_predictor_json_both_ways(fitted, tmp_path, compress, suffix):
    """A file written by mellon_tpu loads in the port and one written by the
    port loads in mellon_tpu, and both hold the same state keys."""
    pj, pt, x_new = fitted
    jax_file = str(tmp_path / "jax_predictor.json")
    port_file = str(tmp_path / "port_predictor.json")
    pj.to_json(jax_file, compress=compress)
    pt.to_json(port_file, compress=compress)

    from_jax = Predictor.from_json(jax_file + suffix[5:], **CPU64)
    assert set(from_jax._state_variables) == {
        "landmarks", "weights", "mu", "jitter", "sigma", "per_feature_sigma", "L", "W",
    }
    _assert_same_surface(from_jax, pj, x_new)
    from_port = mellon_tpu.Predictor.from_json(port_file + suffix[5:])
    _assert_same_surface(pt, from_port, x_new)
    assert set(json.loads(pt.to_json())["data"]) == set(json.loads(pj.to_json())["data"])


def test_predictor_copy_and_default_placement(fitted, monkeypatch):
    """copy() keeps device and dtype; a loaded predictor lands on
    config.DEFAULT_DEVICE in config.DEFAULT_DTYPE unless told otherwise."""
    _, pt, x_new = fitted
    twin = pt.copy()
    assert twin.dtype == torch.float64 and twin.device.type == "cpu"
    _assert_same_surface(twin, pt, x_new)
    monkeypatch.setattr(mellon_tpu_torch.config, "DEFAULT_DEVICE", "cpu")
    loaded = Predictor.from_json_str(pt.to_json())
    assert loaded.dtype == torch.float32 and loaded.landmarks.device.type == "cpu"
    assert loaded.W.dtype == torch.float32 and isinstance(loaded.cov_func, mellon_tpu_torch.Matern52)


def test_genuine_reference_density_predictor():
    """The predictor the reference Mellon 1.7.1 wrote (tests/fixtures) loads
    and reproduces its own predictions within 1e-5, as
    tests/test_serialization_compat.py holds the JAX package."""
    data = np.load(FIXTURES / "reference_fixture_data.npz")
    pred = Predictor.from_json(FIXTURES / "reference_density_predictor.json.gz", compress="gzip", **CPU64)
    np.testing.assert_allclose(to_np(pred(data["x"])), data["de_pred"], atol=1e-5)
    np.testing.assert_allclose(to_np(pred(data["x"], normalize=True)), data["de_pred_norm"], atol=1e-5)


def _as_reference(state, version):
    state["metadata"]["module_name"] = "mellon.conditional"
    state["metadata"]["module_version"] = version
    state["cov_func"]["metadata"]["module_name"] = "mellon.cov"
    return json.loads(json.dumps(state))


def test_pre_140_migration(fitted):
    """A reference file older than 1.4.0 lacks n_obs, _state_variables, d
    and d_method; the migration rebuilds them, as
    tests/test_serialization_compat.py:41 holds the JAX package."""
    pj, pt, x_new = fitted
    state = _as_reference(pt.to_dict(), "1.3.1")
    for key in ("n_obs", "_state_variables", "d", "d_method"):
        state["data"].pop(key, None)
    restored = Predictor.from_dict(state, **CPU64)
    np.testing.assert_allclose(to_np(restored(x_new)), to_np(pt(x_new)), rtol=0, atol=1e-10)
    assert restored.n_obs is None and "weights" in restored._state_variables


def test_reference_module_names_and_own_version(fitted, caplog):
    """A reference 1.7.1 state resolves by class name; the port's own
    version numbers never trip the migration; a class the port lacks is
    refused without importing the JAX package."""
    _, pt, x_new = fitted
    restored = Predictor.from_dict(_as_reference(pt.to_dict(), "1.7.1"), **CPU64)
    np.testing.assert_allclose(to_np(restored(x_new)), to_np(pt(x_new)), rtol=0, atol=1e-10)
    with caplog.at_level(logging.WARNING, logger="mellon_tpu_torch"):
        Predictor.from_json_str(pt.to_json(), **CPU64)
    assert not any("1.4.0" in r.message for r in caplog.records)
    state = pt.to_dict()
    state["metadata"]["module_name"] = "mellon_tpu.inference.conditionals"
    state["metadata"]["classname"] = "UnknownConditional"
    with pytest.raises(ValueError, match="Cannot resolve predictor class UnknownConditional"):
        Predictor.from_dict(state, **CPU64)
