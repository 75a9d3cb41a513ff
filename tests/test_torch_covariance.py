"""The covariance module of mellon_tpu_torch against mellon_tpu's: every core
with and without active_dims, the Add/Mul/Pow algebra, the analytic
gradients, and covariance JSON in both directions, at float64."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import t64, to_np
from mellon_tpu.ops import kernels as jk
from mellon_tpu_torch.ops import kernels as tk

CORES = [
    ("Matern32", {}), ("Matern52", {}), ("ExpQuad", {}), ("Exponential", {}),
    ("RatQuad", {"alpha": 0.7}), ("Linear", {}),
]
ACTIVE_DIMS = [None, [0, 2], 3, slice(1, 4)]
TOL = 1e-12


def _xy(seed=30):
    rng = np.random.RandomState(seed)
    return rng.randn(30, 5), rng.randn(20, 5)


def _assert_agree(jcov, tcov, diag_atol=TOL):
    """k, diag and k_grad of the two packages' kernels at the same points."""
    x, y = _xy()
    xj, yj, xt, yt = jnp.asarray(x), jnp.asarray(y), t64(x), t64(y)
    np.testing.assert_allclose(to_np(tcov(xt, yt)), np.asarray(jcov(xj, yj)), rtol=0, atol=TOL)
    np.testing.assert_allclose(
        to_np(tcov.diag(xt)), np.asarray(jcov.diag(xj)), rtol=0, atol=diag_atol
    )
    grad = to_np(tcov.k_grad(xt)(yt))
    assert grad.shape == (30, 20, 5)
    np.testing.assert_allclose(grad, np.asarray(jcov.k_grad(xj)(yj)), rtol=0, atol=TOL)


@pytest.mark.parametrize("active_dims", ACTIVE_DIMS, ids=str)
@pytest.mark.parametrize("name,args", CORES, ids=[c[0] for c in CORES])
def test_core_matches_jax(name, args, active_dims):
    """k, diag and the analytic k_grad to 1e-12.  The diagonal is each
    point against itself at the floored distance; the JAX package computes
    |x|² − 2x·x + |x|² there with two different reductions, whose rounding
    residual (about eps·|x|² in the squared distance, so ~5e5·eps·|x|² in
    the distance) the port's exact zero does not have.  Only the
    Exponential's profile has a slope at 0 (−1/(2 ls)), so only its
    diagonal feels that residual: up to ~1e-10 on these points, atol 1e-9."""
    jcov = getattr(jk, name)(ls=1.7, active_dims=active_dims, **args)
    tcov = getattr(tk, name)(ls=1.7, active_dims=active_dims, **args)
    _assert_agree(jcov, tcov, diag_atol=1e-9 if name == "Exponential" else TOL)


COMPOSITES = {
    "matern52_times_expquad_plus_number": lambda m: (
        m.Matern52(ls=1.0, active_dims=[0, 2]) * m.ExpQuad(ls=2.0) + 0.1
    ),
    "sum_of_kernels": lambda m: m.Matern32(ls=1.3) + m.RatQuad(alpha=1.5, ls=0.8, active_dims=[1, 4]),
    "number_times_kernel": lambda m: 0.5 * m.Matern52(ls=1.1, active_dims=slice(0, 3)),
    "kernel_to_a_power": lambda m: m.ExpQuad(ls=1.9, active_dims=4) ** 2.5,
    "linear_times_matern": lambda m: m.Linear(ls=3.0) * m.Matern52(ls=2.0),
    "pair_with_active_dims": lambda m: m.Mul(
        m.Matern52(ls=1.2, active_dims=[0, 1]), m.ExpQuad(ls=0.9), active_dims=[0, 3, 4]
    ),
}


@pytest.mark.parametrize("name", sorted(COMPOSITES))
def test_composite_matches_jax(name):
    """Add/Mul/Pow with a kernel or a number on the right, active_dims on the
    parts and on the pair: k, diag and k_grad to 1e-12."""
    _assert_agree(COMPOSITES[name](jk), COMPOSITES[name](tk))


def test_kernel_grads_match_autograd():
    """The analytic k_grad of the cores and the product and chain rules of
    the composites against the base class's autograd: 1e-10.  The analytic
    radial form is the JAX package's, which divides by ‖x − y‖ + 1e-12 where
    autograd divides by ‖x − y‖: a relative 1e-12/‖x − y‖ apart."""
    x, y = _xy(31)
    xt, yt = t64(x), t64(y)
    kernels = [getattr(tk, n)(ls=1.4, **a) for n, a in CORES] + [f(tk) for f in COMPOSITES.values()]
    for cov in kernels:
        np.testing.assert_allclose(
            to_np(cov.k_grad(xt)(yt)), to_np(tk.Covariance.k_grad(cov, xt)(yt)),
            rtol=0, atol=1e-10, err_msg=repr(cov),
        )


def _keys(state):
    """The nested key structure of a covariance state, dates aside."""
    if isinstance(state, dict):
        return {k: _keys(v) for k, v in state.items() if k != "metadata"}
    return None


@pytest.mark.parametrize("name", sorted(COMPOSITES) + [c[0] for c in CORES])
def test_covariance_json_both_ways(name):
    """A kernel written by the port loads in mellon_tpu and one written by
    mellon_tpu loads in the port, with equal k (1e-12) and identical keys in
    every level of the written state."""
    if name in COMPOSITES:
        jcov, tcov = COMPOSITES[name](jk), COMPOSITES[name](tk)
    else:
        args = dict(CORES)[name]
        jcov = getattr(jk, name)(ls=1.6, active_dims=[0, 3], **args)
        tcov = getattr(tk, name)(ls=1.6, active_dims=[0, 3], **args)
    x, y = _xy(32)
    xj, yj, xt, yt = jnp.asarray(x), jnp.asarray(y), t64(x), t64(y)
    want = np.asarray(jcov(xj, yj))

    from_port = jk.Covariance.from_json(tcov.to_json())
    assert type(from_port) is type(jcov)
    np.testing.assert_allclose(np.asarray(from_port(xj, yj)), want, rtol=0, atol=TOL)
    from_jax = tk.Covariance.from_json(jcov.to_json())
    assert type(from_jax) is type(tcov)
    np.testing.assert_allclose(to_np(from_jax(xt, yt)), want, rtol=0, atol=TOL)

    assert _keys(json.loads(tcov.to_json())) == _keys(json.loads(jcov.to_json()))
    assert json.loads(tcov.to_json())["type"] == "mellon.Covariance"


def test_covariance_json_from_the_reference_names():
    """A kernel state naming the reference's module ("mellon.cov") resolves
    by class name, and an unknown class of a foreign package is refused
    without importing it."""
    state = tk.Matern52(ls=2.5).to_dict()
    state["metadata"]["module_name"] = "mellon.cov"
    restored = tk.Covariance.from_dict(json.loads(json.dumps(state)))
    assert isinstance(restored, tk.Matern52) and restored.ls == 2.5
    assert vars(restored) == {"active_dims": None, "ls": 2.5}
    state["metadata"]["classname"] = "NoSuchKernel"
    state["metadata"]["module_name"] = "mellon_tpu.ops.kernels"
    with pytest.raises(ValueError, match="Cannot resolve"):
        tk.Covariance.from_dict(state)
