"""The package surface of mellon_tpu_torch against mellon_tpu's: the
exported names, the legacy module paths, logging, PhaseTimer and trace,
the density gradient and diffusion helpers, and the reprs."""

import importlib
import inspect
import logging
import os
import pkgutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU64, clustered, to_np
import mellon_tpu
import mellon_tpu_torch as mt
from mellon_tpu_torch.utils.profiling import PhaseTimer, trace

# they configure JAX itself (x64, platforms, the compilation cache), which
# the port does not use
JAX_ONLY = {"setup_jax", "set_jax_config"}


def _exported(package):
    """A package's ``__all__``, or else every name its ``__init__`` binds
    but modules and dunders (the JAX subpackages have no ``__all__``)."""
    if hasattr(package, "__all__"):
        return set(package.__all__)
    return {name for name, value in vars(package).items()
            if not name.startswith("__") and not isinstance(value, types.ModuleType)}


@pytest.mark.parametrize("subpackage", ["", "inference", "ops", "utils", "models", "parallel"])
def test_exports_cover_the_jax_package(subpackage):
    """Every name mellon_tpu (and each of its subpackages) exports but its
    JAX setup shims is exported by the port's counterpart."""
    suffix = f".{subpackage}" if subpackage else ""
    jax_package = importlib.import_module("mellon_tpu" + suffix)
    port = importlib.import_module("mellon_tpu_torch" + suffix)
    missing = _exported(jax_package) - JAX_ONLY - _exported(port)
    assert not missing, missing
    for name in _exported(port):
        assert hasattr(port, name), name


# ROADMAP's "Do not port": the modules and names of mellon_tpu the port does
# not take, each with its reason, and the parameters it renames
DO_NOT_PORT_MODULES = {
    "ops.extended_precision": "double-single float64 emulation; the card has native float64",
    "ops.pallas_kernels": "the Pallas tile; its CUDA counterpart is ops.hopper_kernels (K1)",
}
DO_NOT_PORT_NAMES = {
    "default_float": "JAX's x64 switch; the port's precision is the estimator's dtype=",
    "is_x64": "JAX's x64 switch",
    "setup_jax": "configures JAX itself",
    "set_jax_config": "configures JAX itself",
    "HOST_F64_BUDGET": "the host float64 rescue; the port rescues in float64 on the card",
    "host_cholesky_f64": "the host float64 rescue",
    "MATVEC_PRECISION": "the TPU matmul precision; the port runs IEEE float32 (TF32 off)",
    "TRSM_CHUNK_ROWS": "TRSM row-chunking, a workaround for the 16 GB v5e",
    "TRSM_CHUNK_MIN_M": "TRSM row-chunking",
    "TRSM_CHUNK_MIN_N": "TRSM row-chunking",
    "chunked_whiten": "TRSM row-chunking",
    "eval_operand_spec": "covariance operand specs; PyTorch evaluates a composite eagerly",
    "operand_spec": "Covariance.operand_spec: covariance operand specs",
    "models.DEFAULT_JIT": "the models' jit default; the port accepts and ignores jit",
}
RENAMED_PARAMETERS = {
    "key": "generator",  # a torch.Generator where JAX takes a PRNG key
    "sync_arrays": "sync_tensors",  # PhaseTimer.phase's tensors to wait for
}


def _jax_modules():
    """Every module of mellon_tpu (relative names; "" the package) but
    ROADMAP's "Do not port" ones."""
    names = [""] + [m.name.split(".", 1)[1]
                    for m in pkgutil.walk_packages(mellon_tpu.__path__, "mellon_tpu.")]
    return [m for m in names if m not in DO_NOT_PORT_MODULES]


def _modules(module):
    suffix = f".{module}" if module else ""
    return (importlib.import_module("mellon_tpu" + suffix),
            importlib.import_module("mellon_tpu_torch" + suffix))


def _not_ported(module, name):
    return name in DO_NOT_PORT_NAMES or (
        module.split(".")[0] == "models" and f"models.{name}" in DO_NOT_PORT_NAMES)


def _public(module, relative=""):
    """The public names a module of mellon_tpu defines or re-exports from
    mellon_tpu (not its third-party imports, nor its ``logger``, which is
    module plumbing), less "Do not port"."""
    names = set()
    for name, value in vars(module).items():
        if name.startswith("_") or isinstance(value, (types.ModuleType, logging.Logger)) or \
                _not_ported(relative, name):
            continue
        if callable(value) and not getattr(value, "__module__", "").startswith("mellon_tpu"):
            continue
        names.add(name)
    return names


# the first two cases are the ones the test had before it took every module
_NAME_CASES = [("ops.neighbors", {"knn_ivf", "IVF_THRESHOLD", "DEFAULT_COL_BLOCK"}),
               ("ops.cluster", {"k_means", "DEFAULT_N_ITER"})]
_NAME_CASES += [(m, set()) for m in _jax_modules() if m not in dict(_NAME_CASES)]


@pytest.mark.parametrize("module, some", _NAME_CASES)
def test_module_names_cover_the_jax_module(module, some):
    """Every public name of each module of mellon_tpu (the functions,
    classes and constants it defines or re-exports from mellon_tpu) has a
    counterpart of the same name in the port's module, a constant the same
    value (but the package's own name, ops.kernels.PACKAGE_NAME); the
    modules and names of ROADMAP's "Do not port" excepted."""
    jax_module, port = _modules(module)
    names = _public(jax_module, module)
    assert some <= names
    missing = {name for name in names if not hasattr(port, name)}
    assert not missing, missing
    for name in names - {"PACKAGE_NAME"}:
        value = getattr(jax_module, name)
        if isinstance(value, (int, float, str, tuple)):
            assert getattr(port, name) == value, name


def _parameters(fn):
    """``[(name, kind)]`` of fn's signature, JAX's renamed parameters under
    the port's names; None where it has none to read."""
    try:
        parameters = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return None
    return [(RENAMED_PARAMETERS.get(p.name, p.name), p.kind) for p in parameters]


def _holds_parameters(jax_fn, port_fn):
    """The port's signature holds JAX's parameters: its positional ones
    first and in JAX's order, the same ``*args`` at the same place, JAX's
    keyword-only ones and ``**kwargs``; port-only parameters may follow."""
    want, got = _parameters(jax_fn), _parameters(port_fn)
    if want is None:
        return True
    if got is None:
        return False
    positional = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
    want_pos = [n for n, k in want if k in positional]
    got_pos = [n for n, k in got if k in positional]
    if got_pos[: len(want_pos)] != want_pos:
        return False
    got_names = [n for n, _ in got]
    for name, kind in want:
        if kind in (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD):
            if (name, kind) not in got:
                return False
            if kind == inspect.Parameter.VAR_POSITIONAL and len(got_pos) != len(want_pos):
                return False
        elif kind == inspect.Parameter.KEYWORD_ONLY and name not in got_names:
            return False
    return True


def _callables(relative):
    """(qualified name, JAX callable, the port's counterpart or None) of
    every public function of a module and every public method (and
    ``__init__``, ``__call__``) of its public classes."""
    jax_module, port = _modules(relative)
    for name in sorted(_public(jax_module, relative)):
        value = getattr(jax_module, name)
        port_value = getattr(port, name, None)
        if inspect.isclass(value):
            for attr in sorted(dir(value)):
                if (attr.startswith("_") and attr not in ("__init__", "__call__")) or \
                        _not_ported(relative, attr):
                    continue
                if isinstance(inspect.getattr_static(value, attr, None), property):
                    continue
                method = getattr(value, attr)
                if callable(method):
                    yield f"{name}.{attr}", method, getattr(port_value, attr, None)
        elif callable(value):
            yield name, value, port_value


@pytest.mark.parametrize("module", _jax_modules())
def test_callable_parameters_match_the_jax_module(module):
    """Every public function of each module of mellon_tpu, and every
    public method of its public classes, has a counterpart in the port
    whose signature holds JAX's parameter names in JAX's positional order
    (port-only parameters after them), with ROADMAP's "Do not port" names
    excepted and its renamed parameters (``key`` → ``generator``,
    ``*sync_arrays`` → ``*sync_tensors``) under the port's names."""
    mismatched = [name for name, jax_fn, port_fn in _callables(module)
                  if port_fn is None or not _holds_parameters(jax_fn, port_fn)]
    assert not mismatched, mismatched


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


def _loss_problem(n=200, k=40, seed=11):
    rng = np.random.RandomState(seed)
    return rng.randn(n, k) * 0.3, np.exp(rng.randn(n) * 0.3 - 1.0), rng.randn(k) * 0.5


def test_hessian_diagonal_matches_jax():
    """inference.hessian_diagonal of the density loss by chunked HVPs (7
    basis vectors a chunk, a ragged last one) against the JAX package's
    (1e-10 relative) and the closed form."""
    from mellon_tpu.inference.losses import density_loss as jax_density_loss
    from mellon_tpu_torch.inference.losses import density_hessian_diagonal, density_loss

    L, nn, z = _loss_problem()
    args = (torch.tensor(L), torch.tensor(nn), 4.0, -2.5)
    got = to_np(mt.inference.hessian_diagonal(density_loss, torch.tensor(z), batch_size=7,
                                              loss_args=args))
    want = np.asarray(mellon_tpu.inference.hessian_diagonal(
        jax_density_loss, jnp.asarray(z), batch_size=7,
        loss_args=(jnp.asarray(L), jnp.asarray(nn), 4.0, -2.5)))
    np.testing.assert_allclose(got, want, rtol=1e-10)
    np.testing.assert_allclose(got, to_np(density_hessian_diagonal(torch.tensor(z), *args)),
                               rtol=1e-10)


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_minimize_lbfgsb_matches_jax(precision):
    """inference.minimize_lbfgsb takes the JAX package's scalar loss and
    loss_args: in float64 both reach the optimum of the convex density loss
    (latents to 1e-6, loss to 1e-10 relative); with precision="bf16", both
    in float32, their two-phase optima correlate > 0.9999 through L (the
    bars of test_torch_inference.py).  DEFAULT_JIT is the JAX package's."""
    from _torch_parity import jax_x64_off
    from mellon_tpu.inference.losses import density_loss as jax_density_loss
    from mellon_tpu_torch.inference.losses import density_loss

    assert mt.inference.DEFAULT_JIT is mellon_tpu.inference.DEFAULT_JIT is False
    L, nn, z0 = _loss_problem(seed=12)
    dtype = np.float64 if precision is None else np.float32
    L, nn, z0 = L.astype(dtype), nn.astype(dtype), z0.astype(dtype)
    tol = 1e-10 if precision is None else 1e-5
    res = mt.inference.minimize_lbfgsb(density_loss, torch.tensor(z0), tol=tol,
                                       loss_args=(torch.tensor(L), torch.tensor(nn), 4.0, -2.5),
                                       precision=precision)
    jargs = dict(loss_args=(jnp.asarray(L), jnp.asarray(nn), 4.0, -2.5), precision=precision)
    if precision is None:
        jres = mellon_tpu.inference.minimize_lbfgsb(jax_density_loss, jnp.asarray(z0), tol=tol,
                                                    **jargs)
        np.testing.assert_allclose(to_np(res.pre_transformation),
                                   np.asarray(jres.pre_transformation), rtol=0, atol=1e-6)
        np.testing.assert_allclose(res.loss, jres.loss, rtol=1e-10)
        assert res.opt_state.phase_steps is None
    else:
        with jax_x64_off():
            jres = mellon_tpu.inference.minimize_lbfgsb(jax_density_loss, jnp.asarray(z0),
                                                        tol=tol, **jargs)
        f, fj = L @ to_np(res.pre_transformation), L @ np.asarray(jres.pre_transformation)
        assert np.corrcoef(f, fj)[0, 1] > 0.9999
        assert res.opt_state.phase_steps is not None


def test_solve_psd_from_cholesky_matches_jax():
    """ops.solve_psd_from_cholesky for a vector and a matrix right-hand side."""
    rng = np.random.RandomState(3)
    A = rng.randn(12, 12)
    A = A @ A.T + 12 * np.eye(12)
    Lc = np.linalg.cholesky(A)
    for b in (rng.randn(12), rng.randn(12, 3)):
        got = to_np(mt.ops.solve_psd_from_cholesky(torch.tensor(Lc), torch.tensor(b)))
        want = np.asarray(mellon_tpu.ops.solve_psd_from_cholesky(jnp.asarray(Lc), jnp.asarray(b)))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(A @ got, b, atol=1e-10)


def test_batched_vmap_matches_jax():
    """utils.batched_vmap over row batches (a ragged last one) with a shared
    argument: the JAX package's vstack of the batches."""
    rng = np.random.RandomState(4)
    x, w = rng.randn(23, 3), rng.randn(3, 2)
    got = to_np(mt.utils.batched_vmap(lambda r, m: torch.tanh(r @ m), torch.tensor(x),
                                      torch.tensor(w), batch_size=5))
    want = np.asarray(mellon_tpu.utils.batched_vmap(lambda r, m: jnp.tanh(r @ m), jnp.asarray(x),
                                                    jnp.asarray(w), batch_size=5))
    assert got.shape == want.shape == (23, 2)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_density_loglik_matches_jax():
    """inference.losses.density_loglik, the density model's likelihood
    term alone, against the JAX package's (1e-12 relative)."""
    from mellon_tpu.inference.losses import density_loglik as jax_density_loglik
    from mellon_tpu_torch.inference.losses import density_loglik

    L, nn, z = _loss_problem(seed=13)
    got = float(density_loglik(torch.tensor(z), torch.tensor(L), torch.tensor(nn), 4.0, -2.5))
    want = float(jax_density_loglik(jnp.asarray(z), jnp.asarray(L), jnp.asarray(nn), 4.0, -2.5))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_initial_zeros_and_ones_match_jax():
    """parameters.compute_initial_zeros (n, rank) and compute_initial_ones
    (n,): the JAX package's shapes and values, in L's dtype and on its
    device."""
    x, L = np.ones((7, 3)), np.ones((7, 4))
    for name in ("compute_initial_zeros", "compute_initial_ones"):
        got = getattr(mt.parameters, name)(torch.tensor(x), torch.tensor(L, dtype=torch.float32))
        want = np.asarray(getattr(mellon_tpu.parameters, name)(jnp.asarray(x), jnp.asarray(L)))
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(to_np(got), want)
