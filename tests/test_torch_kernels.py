"""The Matern-5/2 tile of mellon_tpu_torch against mellon_tpu's Pallas
kernel and XLA covariance, the other covariance cores, the distance, and
the port's import rules."""

import ast
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import t64, to_np
from mellon_tpu.ops import kernels as jk
from mellon_tpu.ops.pallas_kernels import matern52_gram_pallas
from mellon_tpu.utils.util import distance as jax_distance
from mellon_tpu_torch.ops import kernels as tk
from mellon_tpu_torch.ops.hopper_kernels import matern52_gram, matern52_gram_reference
from mellon_tpu_torch.utils.util import distance

PACKAGE = Path(__file__).resolve().parent.parent / "mellon_tpu_torch"


def _xy(n, m, d, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(n, d), rng.randn(m, d)


def test_matern52_reference_matches_pallas_interpret_f32():
    """Plain version vs the Pallas tile in interpret mode at f32, the
    tolerance of tests/test_ops.py (1e-5: one f32 kernel value is O(1))."""
    x, y = _xy(100, 37, 5, 20)
    xj = jnp.asarray(x, dtype=jnp.float32)
    yj = jnp.asarray(y, dtype=jnp.float32)
    K_pallas = np.asarray(matern52_gram_pallas(xj, yj, 1.3, interpret=True))
    K_port = to_np(matern52_gram_reference(t64(x).float(), t64(y).float(), 1.3))
    assert np.abs(K_port - K_pallas).max() < 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_matern52_matches_jax_covariance(dtype, tol):
    """Plain version and the CPU route of the wrapper vs the JAX package's
    _matern52_vals (f32: 1e-5, f64: 1e-12 -- both compute the same
    expression, so only rounding separates them)."""
    x, y = _xy(120, 45, 7, 21)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    K_jax = np.asarray(jk._matern52_vals(jnp.asarray(x, jdt), jnp.asarray(y, jdt), 2.1))
    xt, yt = t64(x).to(dtype), t64(y).to(dtype)
    assert np.abs(to_np(matern52_gram_reference(xt, yt, 2.1)) - K_jax).max() < tol
    assert np.abs(to_np(tk.Matern52(ls=2.1)(xt, yt)) - K_jax).max() < tol


@pytest.mark.parametrize(
    "name,args",
    [("Matern32", {}), ("Matern52", {}), ("ExpQuad", {}), ("Exponential", {}),
     ("RatQuad", {"alpha": 0.7}), ("Linear", {})],
)
def test_covariance_cores_match_jax(name, args):
    """Every covariance core at f64, rtol 1e-12.  The diagonal sits at the
    1e-12 distance floor, where the cancellation residual of
    |x|² - 2x·x + |x|² (about eps·|x|², rounded differently by the two
    packages) moves the kernel value by up to ~1e-9: atol 1e-8."""
    x, y = _xy(30, 20, 4, 22)
    jcov = getattr(jk, name)(ls=1.7, **args)
    tcov = getattr(tk, name)(ls=1.7, **args)
    K_jax = np.asarray(jcov(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(to_np(tcov(t64(x), t64(y))), K_jax, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        to_np(tcov.diag(t64(x))), np.asarray(jcov.diag(jnp.asarray(x))), rtol=0, atol=1e-8
    )


def test_distance_matches_jax_f64():
    """The |x|² - 2x·y + |y|² distance with its 1e-12 floor: rtol 1e-12
    apart from coincident points.  Those sit at the floor plus the
    cancellation residual (about eps·|x|², rounded differently by the two
    packages): never below 1e-6, and within 1e-9 of each other."""
    x, y = _xy(50, 40, 6, 23)
    y[:5] = x[:5]
    D_jax = np.asarray(jax_distance(jnp.asarray(x), jnp.asarray(y)))
    D = to_np(distance(t64(x), t64(y)))
    coincident = np.zeros(D.shape, dtype=bool)
    coincident[np.arange(5), np.arange(5)] = True
    np.testing.assert_allclose(D[~coincident], D_jax[~coincident], rtol=1e-12)
    np.testing.assert_allclose(D[coincident], D_jax[coincident], rtol=0, atol=1e-9)
    assert np.all(D >= math.sqrt(1e-12) - 1e-18)


def test_wrapper_checks_operands():
    """Bad operands raise; an operand that requires grad gives a result with
    a gradient (the kernel itself runs on the detached operands)."""
    x = torch.randn(5, 3, dtype=torch.float64)
    K = matern52_gram(x.clone().requires_grad_(), x, 1.0)
    assert K.requires_grad and K.grad_fn is not None
    with torch.no_grad():
        assert not matern52_gram(x.clone().requires_grad_(), x, 1.0).requires_grad
    with pytest.raises(TypeError):
        matern52_gram(x, x.float(), 1.0)
    with pytest.raises(ValueError):
        matern52_gram(x, torch.randn(4, 2, dtype=torch.float64), 1.0)
    with pytest.raises(ValueError):
        matern52_gram(x, x, 0.0)
    before = matern52_gram.launches
    matern52_gram(x, x, 1.0)
    assert matern52_gram.launches == before  # the CPU route launches nothing


def _module_files():
    return sorted(PACKAGE.rglob("*.py"))


def test_port_imports_no_jax_and_calls_no_torch_compile():
    """No module of mellon_tpu_torch imports jax (or the JAX package) or
    calls torch.compile."""
    assert _module_files()
    for path in _module_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                names = []
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "optax", "mellon_tpu"), (path, name)
            if isinstance(node, ast.Attribute) and node.attr == "compile":
                assert not (isinstance(node.value, ast.Name) and node.value.id == "torch"), path
