"""The density main path of mellon_tpu_torch end to end against mellon_tpu:
the same data and the same landmarks go through both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU64, clustered, jax_x64_off, to_np
import mellon_tpu
from mellon_tpu.parameters import compute_landmarks as jax_compute_landmarks
import mellon_tpu_torch


def _agreement(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    spread = want.max() - want.min()
    return np.corrcoef(got, want)[0, 1], np.abs(got - want).max() / spread


def test_slice_f64_matches_jax():
    """n = 400, d = 4, 100 landmarks (JAX's k-means landmarks passed to the
    port).  The prepared attributes agree tightly; the fit and the
    predictor agree to corr >= 0.99999 and max |Δ| <= 1e-3 of the spread,
    the bound the optimizers' stopping rule (tol 1e-5) leaves."""
    x = clustered(400, 4, seed=21)
    jest = mellon_tpu.DensityEstimator(n_landmarks=100)
    ld_j = np.asarray(jest.fit_predict(jnp.asarray(x)))

    est = mellon_tpu_torch.DensityEstimator(landmarks=np.asarray(jest.landmarks), **CPU64)
    est.prepare_inference(x)
    np.testing.assert_allclose(to_np(est.nn_distances), np.asarray(jest.nn_distances), rtol=1e-12)
    assert est.d == jest.d == 4
    np.testing.assert_allclose(est.mu, jest.mu, rtol=1e-12)
    np.testing.assert_allclose(est.ls, jest.ls, rtol=1e-12)
    np.testing.assert_allclose(to_np(est.Lp), np.asarray(jest.Lp), rtol=0, atol=1e-10)
    np.testing.assert_allclose(to_np(est.L), np.asarray(jest.L), rtol=0, atol=1e-9)
    iv_j = mellon_tpu.parameters.compute_initial_value(jest.nn_distances, jest.d, jest.mu, jest.L)
    np.testing.assert_allclose(to_np(est.initial_value), np.asarray(iv_j), rtol=0, atol=1e-8)

    est.run_inference()
    ld = to_np(est.process_inference(build_predict=False))
    corr, err = _agreement(ld, ld_j)
    assert corr >= 0.99999 and err <= 1e-3, (corr, err)

    x_new = clustered(50, 4, seed=22)
    corr, err = _agreement(to_np(est.predict(x_new)), np.asarray(jest.predict(jnp.asarray(x_new))))
    assert corr >= 0.99999 and err <= 1e-3, (corr, err)
    np.testing.assert_allclose(to_np(est.predict(x)), ld, rtol=0, atol=1e-8)


def test_slice_f32_prunes_like_jax():
    """Float32 on both sides (JAX with x64 off): at d = 10 the length scale
    (~22) is wide against the landmark spacing, so the 400-landmark gram is
    singular at f32 and both prune by pivoted Cholesky to the same
    power-of-two count (256 of the same 400 landmarks).  The sets agree to
    at least 95%, not exactly: in float32 the two packages' residual
    updates round differently (another summation order), which reorders
    near-tied residual diagonals after ~100 pivots even on the same K
    (the float64 pivots agree exactly, tests/test_torch_ops.py).  The log
    densities agree to corr >= 0.9999 and max |Δ| <= 5e-3 of the spread
    (about ten times the gap measured on the CPU, 4e-4)."""
    x = clustered(1500, 10, seed=23, n_clusters=6, spread=1.0).astype(np.float32)
    with jax_x64_off():
        xj = jnp.asarray(x)
        xu = np.asarray(jax_compute_landmarks(xj, n_landmarks=400, random_state=42))
        jest = mellon_tpu.DensityEstimator(landmarks=jnp.asarray(xu))
        ld_j = np.asarray(jest.fit_predict(xj))
        kept_j = np.asarray(jest.landmarks)

    est = mellon_tpu_torch.DensityEstimator(landmarks=xu, device="cpu", dtype=torch.float32)
    ld = est.fit_predict(x)
    assert ld.dtype == torch.float32 and torch.isfinite(ld).all()
    assert kept_j.shape[0] == 256
    assert est.landmarks.shape[0] == 256
    kept = {tuple(r) for r in to_np(est.landmarks)}
    assert len(kept & {tuple(r) for r in kept_j}) >= 0.95 * 256
    corr, err = _agreement(to_np(ld), ld_j)
    assert corr >= 0.9999 and err <= 5e-3, (corr, err)


@pytest.mark.parametrize(
    "kwargs",
    [
        # Nyström types that validate_params admits at 20 landmarks
        {"gp_type": "sparse_nystroem"},
        {"rank": 10},
        {"gp_type": "sparse_nystroem", "rank": 0.9},
        {"precision": "bf16", "optimizer": "adam"},
        {"rank": 0.5},
        {"precision": "bf16"},
    ],
)
def test_unported_options_raise(kwargs):
    """Options the first slices refused with NotImplementedError (the
    Nyström types, the two-phase bf16 MAP) now run: on JAX's landmarks each
    fit takes the JAX package's GP type and rank and agrees with its fit
    to corr >= 0.99999 and max |Δ| <= 1e-3 of the spread (the bound the
    optimizers' stopping rule leaves)."""
    x = clustered(100, 3, seed=24)
    jest = mellon_tpu.DensityEstimator(n_landmarks=20, **kwargs)
    ld_j = np.asarray(jest.fit_predict(jnp.asarray(x)))
    est = mellon_tpu_torch.DensityEstimator(landmarks=np.asarray(jest.landmarks), **kwargs, **CPU64)
    ld = to_np(est.fit_predict(x))
    assert est.gp_type.value == jest.gp_type.value and est.L.shape == jest.L.shape
    corr, err = _agreement(ld, ld_j)
    assert corr >= 0.99999 and err <= 1e-3, (corr, err)


def test_full_gp_type_raises_and_fixed_runs():
    """Without a landmark reduction (n_landmarks >= n) the full GP type
    runs (it raised before it was ported: tests/test_torch_full_gp.py
    holds it against mellon_tpu); the fixed type keeps every cell as a
    landmark and runs."""
    x = clustered(120, 3, seed=25)
    est = mellon_tpu_torch.DensityEstimator(**CPU64)
    ld = est.fit_predict(x)
    assert est.gp_type == mellon_tpu_torch.GaussianProcessType.FULL
    assert est.landmarks is None and est.L.shape == (120, 120) and torch.isfinite(ld).all()
    est = mellon_tpu_torch.DensityEstimator(gp_type="fixed", n_landmarks=120, **CPU64)
    ld = est.fit_predict(x)
    assert est.landmarks.shape == (120, 3) and torch.isfinite(ld).all()

