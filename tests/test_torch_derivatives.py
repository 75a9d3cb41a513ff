"""The gradient of the Matern-5/2 kernel call and the predictor's
derivatives of mellon_tpu_torch against mellon_tpu, at float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU64, clustered, t64, to_np
import mellon_tpu
from mellon_tpu_torch import state_from_jax
from mellon_tpu_torch.ops.hopper_kernels import matern52_gram, matern52_gram_reference

REL = 1e-8


def _close(got, want, rel=REL):
    """max |got − want| <= rel · max |want|."""
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), np.abs(got - want).max()


@pytest.mark.parametrize("coincident", [False, True], ids=["apart", "coincident"])
def test_matern52_function_gradcheck(coincident):
    """gradcheck and gradgradcheck of the kernel call's autograd Function on
    the CPU in float64, also with a pair of coincident points."""
    g = torch.Generator().manual_seed(40)
    x = torch.randn(6, 3, dtype=torch.float64, generator=g)
    y = torch.randn(5, 3, dtype=torch.float64, generator=g)
    if coincident:
        y[0] = x[2]
    x.requires_grad_(True)
    y.requires_grad_(True)

    def f(a, b):
        return matern52_gram(a, b, 1.3)

    assert torch.autograd.gradcheck(f, (x, y))
    assert torch.autograd.gradgradcheck(f, (x, y))


def test_matern52_backward_matches_plain_autograd():
    """The closed-form backward against autograd through the plain version,
    away from coincident points: 1e-12."""
    g = torch.Generator().manual_seed(41)
    x = torch.randn(40, 4, dtype=torch.float64, generator=g, requires_grad=True)
    y = torch.randn(30, 4, dtype=torch.float64, generator=g, requires_grad=True)
    w = torch.randn(40, 30, dtype=torch.float64, generator=g)
    got = torch.autograd.grad((matern52_gram(x, y, 0.9) * w).sum(), (x, y))
    want = torch.autograd.grad((matern52_gram_reference(x, y, 0.9) * w).sum(), (x, y))
    for a, b in zip(got, want):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def fitted():
    """A mellon_tpu fit (n = 300, d = 3, 40 landmarks), its predictor and
    the port's predictor carried across by state_from_jax."""
    x = clustered(300, 3, seed=42)
    est = mellon_tpu.DensityEstimator(n_landmarks=40)
    est.fit(jnp.asarray(x))
    return est, est.predict, state_from_jax(est.predict, **CPU64)


def _points_apart(landmarks, n=50, seed=43):
    """n points none of which lies within 1e-3 of a landmark."""
    pts = clustered(4 * n, landmarks.shape[1], seed=seed)
    gap = np.sqrt(((pts[:, None, :] - landmarks[None]) ** 2).sum(-1)).min(1)
    pts = pts[gap > 1e-3][:n]
    assert pts.shape[0] == n
    return pts


def test_derivatives_match_jax(fitted):
    """gradient, hessian and hessian_log_determinant at 50 points away from
    the landmarks: 1e-8 relative to the largest value (the logdet to 1e-8
    relative at each point; the signs equal)."""
    _, pj, pt = fitted
    xs = _points_apart(np.asarray(pj.landmarks))
    xj = jnp.asarray(xs)
    _close(pt.gradient(xs), pj.gradient(xj))
    _close(pt.hessian(xs), pj.hessian(xj))
    sign, logdet = pt.hessian_log_determinant(xs)
    sign_j, logdet_j = pj.hessian_log_determinant(xj)
    np.testing.assert_array_equal(to_np(sign), np.asarray(sign_j))
    np.testing.assert_allclose(to_np(logdet), np.asarray(logdet_j), rtol=REL)


def test_derivatives_at_a_landmark(fitted):
    """A point placed exactly on a landmark: both packages are finite and
    the gradients agree (1e-8 relative).  The Hessian is not compared
    there.  Where the squared distance meets JAX's jnp.maximum floor
    (mellon_tpu/utils/util.py:57), autodiff halves that pair's curvature
    term −(5/(3 ls²))·w·I (an exact tie splits the derivative) or drops it
    (rounding puts it under the floor); the port's closed-form backward
    keeps it whole: a deliberate divergence (ROADMAP Queue 3)."""
    _, pj, pt = fitted
    lm = np.asarray(pj.landmarks)
    xs = np.concatenate([lm[7:8], _points_apart(lm, n=3)])
    xj = jnp.asarray(xs)
    g, gj = pt.gradient(xs), pj.gradient(xj)
    assert np.isfinite(to_np(g)).all() and np.isfinite(np.asarray(gj)).all()
    _close(g, gj)
    H, Hj = pt.hessian(xs), pj.hessian(xj)
    assert np.isfinite(to_np(H)).all() and np.isfinite(np.asarray(Hj)).all()
    _close(H[1:], Hj[1:])


def test_derivatives_of_the_ports_own_fit_are_consistent():
    """On the port's own fit, the gradient equals the Hessian's finite
    difference direction: H·e ≈ (g(x + h e) − g(x − h e)) / 2h (1e-6
    relative), and hessian_log_determinant is slogdet of hessian."""
    x = clustered(200, 3, seed=44)
    from mellon_tpu_torch import DensityEstimator

    pred = DensityEstimator(n_landmarks=30, **CPU64).fit(x).predict
    xs = t64(clustered(10, 3, seed=45))
    H = pred.hessian(xs)
    h = 1e-5
    for j in range(3):
        e = torch.zeros(3, dtype=torch.float64)
        e[j] = h
        fd = (pred.gradient(xs + e) - pred.gradient(xs - e)) / (2 * h)
        _close(H[:, :, j], fd, rel=1e-6)
    sign, logdet = pred.hessian_log_determinant(xs)
    s2, l2 = torch.linalg.slogdet(H)
    assert torch.equal(sign, s2) and torch.allclose(logdet, l2, rtol=0, atol=1e-12)
