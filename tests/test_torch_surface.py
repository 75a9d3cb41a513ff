"""The package surface of mellon_tpu_torch against mellon_tpu's: the
exported names, the legacy module paths, logging, PhaseTimer and trace,
the density gradient and diffusion helpers, and the reprs."""

import importlib
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU64, clustered, to_np
import mellon_tpu
import mellon_tpu_torch as mt
from mellon_tpu_torch.utils.profiling import PhaseTimer, trace

JAX_ONLY = {"setup_jax", "set_jax_config"}


def test_exports_cover_the_jax_package():
    """Every name mellon_tpu exports but its JAX setup shims is exported."""
    missing = set(mellon_tpu.__all__) - JAX_ONLY - set(mt.__all__)
    assert not missing, missing
    for name in mt.__all__:
        assert hasattr(mt, name), name


@pytest.mark.parametrize(
    "alias, module",
    [("util", "utils.util"), ("cov", "ops.kernels"), ("model", "models"),
     ("conditional", "inference.conditionals"), ("validation", "utils.validation"),
     ("derivatives", "inference.derivatives"), ("decomposition", "ops.linalg")],
)
def test_legacy_module_paths(alias, module):
    """``from mellon_tpu_torch.<alias> import ...`` works like the JAX
    package's legacy paths."""
    assert importlib.import_module(f"mellon_tpu_torch.{alias}") is importlib.import_module(
        f"mellon_tpu_torch.{module}")
    assert getattr(mt, alias) is importlib.import_module(f"mellon_tpu_torch.{module}")


def test_logging_setup_and_verbosity():
    """LOGGING_CONFIG has the JAX package's shape under this package's
    logger; setup_logging configures it and returns the logger;
    set_verbosity switches between INFO and WARNING."""
    assert set(mt.LOGGING_CONFIG) == set(mellon_tpu.LOGGING_CONFIG)
    assert "mellon_tpu_torch" in mt.LOGGING_CONFIG["loggers"]
    logger = logging.getLogger("mellon_tpu_torch")
    saved = (logger.level, logger.propagate, list(logger.handlers))
    try:
        assert mt.setup_logging() is logger is mt.logger
        assert logger.level == logging.INFO and not logger.propagate and logger.handlers
        mt.set_verbosity(False)
        assert logger.level == logging.WARNING
        mt.set_verbosity(True)
        assert logger.level == logging.INFO
    finally:
        logger.setLevel(saved[0])
        logger.propagate = saved[1]
        logger.handlers[:] = saved[2]


def test_phase_timer_collects_and_reports():
    """tests/test_profiling.py's PhaseTimer test: named phases (one ended
    by a tensor, one by values that are not tensors), the report and the
    dict."""
    timer = PhaseTimer(name="test", log=False)
    with timer.phase("alpha"):
        x = torch.ones(100) * 2.0
    with timer.phase("beta", x, 42, "not-a-tensor"):
        y = torch.sum(x)
    timer.sync()
    d = timer.as_dict()
    assert set(d) == {"alpha", "beta"} and all(t >= 0 for t in d.values())
    report = timer.report()
    assert "alpha" in report and "beta" in report and "total" in report
    assert float(y) == 200.0


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert d == log_dir and os.path.getsize(os.path.join(log_dir, "trace.json")) > 0


@pytest.fixture(scope="module")
def fitted():
    x = clustered(200, 3, seed=95)
    jest = mellon_tpu.DensityEstimator(n_landmarks=30)
    jest.fit(jnp.asarray(x))
    return x, jest, mt.state_from_jax(jest, **CPU64)


def test_density_gradient_and_diffusion_match_jax(fitted):
    """compute_density_gradient and compute_density_diffusion at new
    points against the JAX package's (1e-8 relative)."""
    x, jest, est = fitted
    xq = clustered(20, 3, seed=96)
    g = to_np(mt.parameters.compute_density_gradient(est.predict, xq))
    gj = np.asarray(mellon_tpu.parameters.compute_density_gradient(jest.predict, jnp.asarray(xq)))
    np.testing.assert_allclose(g, gj, rtol=1e-8, atol=1e-8 * np.abs(gj).max())
    sign, logdet = mt.parameters.compute_density_diffusion(est.predict, xq)
    sj, lj = mellon_tpu.parameters.compute_density_diffusion(jest.predict, jnp.asarray(xq))
    np.testing.assert_array_equal(to_np(sign), np.asarray(sj))
    np.testing.assert_allclose(to_np(logdet), np.asarray(lj), rtol=1e-8)


def test_reprs(fitted):
    """The predictor's repr lists its data as the JAX package's does (its
    first line and keys); the estimators and the predictor have an HTML
    repr."""
    _, jest, est = fitted
    text, jtext = repr(est.predict), repr(jest.predict)
    assert text.splitlines()[0] == jtext.splitlines()[0]
    keys = sorted(line.split(":")[0] for line in text.splitlines()[1:])
    assert keys == sorted(line.split(":")[0] for line in jtext.splitlines()[1:])
    assert str(est.predict) == text
    html = est.predict._repr_html_()
    assert "<table" in html and "weights" in html
    for obj in (est, mt.DimensionalityEstimator(**CPU64), mt.FunctionEstimator(**CPU64),
                mt.TimeSensitiveDensityEstimator(**CPU64)):
        assert obj._repr_html_().startswith("<h2>")
