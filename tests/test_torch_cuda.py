"""Tests of mellon_tpu_torch that need an NVIDIA GPU.

They skip without one.  This file imports neither JAX nor the JAX package,
so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import datetime
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mellon_tpu_torch
from mellon_tpu_torch.inference.diagnostics import summarize
from mellon_tpu_torch.inference.losses import make_density_value_and_grad_batch
from mellon_tpu_torch.inference.mcmc import run_mcmc
from mellon_tpu_torch.inference.samplers import Draws, hmc_init, hmc_kernel, nuts_kernel
from mellon_tpu_torch.ops.hopper_kernels import (
    BUILD_DIR, NVCC_FLAGS, _nvcc, matern52_gram, matern52_gram_reference,
)

ROOT = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU route)")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "shape",
    [
        (5000, 5000, 20), (8627, 2048, 20), (1000, 2048, 20),
        # m not a multiple of the 16-byte vector (guarded stores) and a
        # multiple of it on a ragged row edge
        (1000, 333, 7), (1000, 512, 20),
        # d across the staged chunk: 1, one full chunk and more, several
        (777, 1000, 1), (1000, 512, 50), (300, 260, 130),
        (1, 1, 20),
        # more row or column tiles than a grid axis of 65535 would hold
        (65535 * 64 + 5, 3, 2), (3, 65535 * 64 + 5, 2),
    ],
)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_matern52_kernel_matches_reference(cuda, shape, dtype, tol):
    """The CUDA tile vs its plain version on the card, at the benchmark
    fit's shapes (K_uu, then C and the predictor against the 2,048 kept
    landmarks), ragged and unaligned edges, feature counts below, at and
    above one staged chunk, a single element, and more row or column tiles
    than one grid axis could hold: f32 1e-5 (tests/test_ops.py's bar), f64
    1e-12."""
    n, m, d = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(n, d, device=cuda, dtype=dtype, generator=g)
    y = torch.randn(m, d, device=cuda, dtype=dtype, generator=g)
    before = matern52_gram.launches
    K = matern52_gram(x, y, 3.1)
    torch.cuda.synchronize()
    assert matern52_gram.launches == before + 1
    assert (K - matern52_gram_reference(x, y, 3.1)).abs().max().item() <= tol


@pytest.mark.parametrize("n,d", [(5000, 20), (1000, 7), (333, 50), (130, 130), (257, 3), (1, 20)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_matern52_kernel_symmetric_gram(cuda, n, d, dtype, tol):
    """k(x, x) with one buffer on both sides, as K_uu is built: the float
    tile runs the tiles on and above the diagonal and mirrors them.  Rows
    are scaled to |x|^2 ~ 1: on the diagonal |x|^2 - 2 x.x + |x|^2 is
    rounding noise that grows with |x|^2, in the plain version as much as
    in the kernel."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(n, d, device=cuda, dtype=dtype, generator=g) / d**0.5
    K = matern52_gram(x, x, 0.7)
    torch.cuda.synchronize()
    assert (K - matern52_gram_reference(x, x, 0.7)).abs().max().item() <= tol


def test_matern52_kernel_takes_noncontiguous_views(cuda):
    """Strided and transposed views go through the wrapper's copy and give
    the plain version's result."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(700, 40, device=cuda, generator=g)[:, ::2]
    y = torch.randn(20, 300, device=cuda, generator=g).T
    assert not x.is_contiguous() and not y.is_contiguous()
    K = matern52_gram(x, y, 2.2)
    torch.cuda.synchronize()
    assert K.shape == (700, 300)
    assert (K - matern52_gram_reference(x, y, 2.2)).abs().max().item() <= 1e-5


def test_tile_sqrt_is_correctly_rounded(cuda):
    """The tile's branch-free float sqrt equals sqrtf bit for bit on every
    float from 1e-12 (the epilogue's floor) up: scripts/check_sqrt_rn.cu,
    built from the kernel's own source."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = BUILD_DIR / "check_sqrt_rn"
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_nvcc(), *flags, "-o", str(exe), str(ROOT / "scripts" / "check_sqrt_rn.cu")],
                   check=True)
    run = subprocess.run([str(exe)], capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr


def test_small_fit_on_card_matches_cpu(cuda):
    """The same float64 fit with fixed landmarks on the card (kernel route)
    and on the CPU (plain route).  Rounding differs between the devices,
    so the optimizers stop at different points inside their tolerance:
    corr >= 0.99999 and max |Δ| <= 1e-3 of the spread."""
    rng = np.random.RandomState(26)
    x = rng.randn(2000, 10) * np.exp(-0.15 * np.arange(10))
    xu = x[::10]
    lds = []
    for device in ("cpu", cuda):
        est = mellon_tpu_torch.DensityEstimator(landmarks=xu, device=device, dtype=torch.float64)
        lds.append(est.fit_predict(x).cpu().numpy())
    spread = lds[0].max() - lds[0].min()
    assert np.corrcoef(lds[0], lds[1])[0, 1] >= 0.99999
    assert np.abs(lds[0] - lds[1]).max() <= 1e-3 * spread


@pytest.mark.parametrize("shape", [(1000, 2048, 20), (300, 260, 130), (777, 100, 1)])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_matern52_backward_matches_plain_autograd(cuda, shape, dtype, rel):
    """The kernel call's gradient (forward on the card, closed-form
    backward) against autograd through the plain version, with five pairs
    of coincident points.  Each gradient entry is a sum of m (or n) terms
    c·Gᵢⱼ·(yⱼ − xᵢ), G = w·(1 + r)e^{−r}, c = 5/(3 ls²), which both forms
    compute as a difference of two sums; the bar is rel (f32 1e-5, f64
    1e-12) times the largest sum of the terms' magnitudes.  (At d = 130 the
    gradients are tiny beside the coincident pairs' O(1) terms, which
    cancel exactly in value but not in rounding.)"""
    n, m, d = shape
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(n, d, device=cuda, dtype=dtype, generator=g)
    y = torch.randn(m, d, device=cuda, dtype=dtype, generator=g)
    y[:5] = x[:5]
    w = torch.randn(n, m, device=cuda, dtype=dtype, generator=g)
    grads = []
    for fn in (matern52_gram, matern52_gram_reference):
        xa, ya = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
        grads.append(torch.autograd.grad((fn(xa, ya, 2.3) * w).sum(), (xa, ya)))
    x64, y64 = x.double(), y.double()
    r = 5**0.5 * torch.cdist(x64, y64) / 2.3
    G = (w.double() * (1 + r) * torch.exp(-r)).abs() * 5 / (3 * 2.3**2)
    scale = max((G @ y64.abs() + G.sum(1)[:, None] * x64.abs()).max().item(),
                (G.T @ x64.abs() + G.sum(0)[:, None] * y64.abs()).max().item())
    for got, want in zip(*grads):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= rel * scale


def test_matern52_gradient_launches_once(cuda):
    """A call without grad and a call with grad each count one launch; the
    backward launches nothing."""
    x = torch.randn(300, 20, device=cuda)
    y = torch.randn(200, 20, device=cuda)
    before = matern52_gram.launches
    matern52_gram(x, y, 1.5)
    assert matern52_gram.launches == before + 1
    xg = x.clone().requires_grad_(True)
    K = matern52_gram(xg, y, 1.5)
    assert matern52_gram.launches == before + 2
    K.sum().backward()
    torch.cuda.synchronize()
    assert matern52_gram.launches == before + 2 and torch.isfinite(xg.grad).all()


@pytest.fixture
def card_predictor(cuda):
    """A float32 fit with Laplace uncertainty on the card (2,000 cells,
    d = 10, 200 fixed landmarks)."""
    rng = np.random.RandomState(27)
    x = rng.randn(2000, 10) * np.exp(-0.15 * np.arange(10))
    est = mellon_tpu_torch.DensityEstimator(landmarks=x[::10], predictor_with_uncertainty=True)
    return est.fit(x).predict, x


def test_predictor_json_round_trip_on_card(card_predictor, tmp_path):
    """A CUDA predictor through gzip JSON comes back on the card in float32
    with the same mean and uncertainty (1e-6 relative)."""
    pred, x = card_predictor
    path = str(tmp_path / "p.json.gz")
    pred.to_json(path, compress="gzip")
    back = mellon_tpu_torch.Predictor.from_json(path)
    assert back.device.type == "cuda" and back.dtype == torch.float32
    for method in ("mean", "uncertainty"):
        a, b = getattr(back, method)(x[:500]), getattr(pred, method)(x[:500])
        assert (a - b).abs().max().item() <= 1e-6 * b.abs().max().item()


def test_uncertainty_at_200k_points(card_predictor):
    """uncertainty, covariance and mean_covariance at 200,000 points (one
    full chunk of 200,000 x 200 kernel tiles in both orientations): finite,
    and mean_covariance >= 0."""
    pred, x = card_predictor
    g = torch.Generator(device="cuda").manual_seed(6)
    xq = torch.as_tensor(x, dtype=torch.float32, device="cuda")[
        torch.randint(0, x.shape[0], (200_000,), device="cuda", generator=g)
    ] + 0.05 * torch.randn(200_000, x.shape[1], device="cuda", generator=g)
    u, mc = pred.uncertainty(xq), pred.mean_covariance(xq)
    assert u.shape == (200_000,) and torch.isfinite(u).all()
    assert torch.isfinite(pred.covariance(xq)).all() and (mc >= 0).all()


class _HostDraws(Draws):
    """The samplers' draws from a CPU generator, moved to the operands'
    device: the same numbers on the card as on the CPU."""

    def normal(self, shape, like):
        return torch.randn(shape, generator=self.generator, dtype=like.dtype).to(like.device)

    def uniform(self, shape, like):
        return torch.rand(shape, generator=self.generator, dtype=like.dtype).to(like.device)


@pytest.mark.parametrize("kind", ["nuts", "hmc"])
def test_transition_on_card_matches_cpu(cuda, kind):
    """One NUTS (depth 8) or HMC (16 leapfrogs) transition of 8 chains on a
    float64 density potential (2,000 cells, 64 latents), on the card and on
    the CPU with the same draws: states, accept_prob to 1e-10 relative,
    step counts and divergences equal."""
    rng = np.random.RandomState(28)
    L, nn, Z0 = rng.randn(2000, 64) * 0.1, np.exp(rng.randn(2000) * 0.3 - 1), rng.randn(8, 64) * 0.3
    out = []
    for device in ("cpu", cuda):
        t = lambda a: torch.tensor(a, dtype=torch.float64, device=device)  # noqa: E731
        vg = make_density_value_and_grad_batch(t(L), t(nn), 2.0, -1.0)
        kernel = nuts_kernel(vg, max_tree_depth=8) if kind == "nuts" else hmc_kernel(vg, num_steps=16)
        state, info = kernel(hmc_init(vg, t(Z0)), _HostDraws(torch.Generator().manual_seed(0)),
                             t(0.05), t(np.ones(64)))
        out.append([v.cpu() for v in (*state, *info)])
    for got, want in zip(out[1], out[0]):
        if want.dtype.is_floating_point:
            assert torch.allclose(got, want, rtol=1e-10, atol=1e-12)
        else:
            assert torch.equal(got, want)


def test_nuts_on_card_recovers_gaussian(cuda):
    """run_mcmc on the card (a CUDA generator) recovers the correlated
    Gaussian with the bars of tests/test_mcmc.py:37-52."""
    cov = torch.tensor([[2.0, 0.9], [0.9, 1.0]], dtype=torch.float64, device=cuda)
    prec, mean = torch.linalg.inv(cov), torch.tensor([1.0, -1.0], dtype=torch.float64, device=cuda)

    def value_and_grad(Z):
        d = Z - mean
        return 0.5 * torch.sum((d @ prec) * d, dim=1), d @ prec

    res = run_mcmc(value_and_grad, torch.zeros(2, dtype=torch.float64, device=cuda),
                   torch.Generator(device=cuda).manual_seed(0), num_warmup=500, num_samples=1000)
    s = summarize(res.samples)
    np.testing.assert_allclose(s["mean"], mean.cpu().numpy(), atol=0.1)
    np.testing.assert_allclose(s["std"], np.sqrt(np.diag(cov.cpu().numpy())), rtol=0.1)
    assert np.all(s["rhat"] < 1.05) and np.all(s["ess"] > 200) and int(res.diverging.sum()) == 0


def test_sampler_refuses_a_generator_on_another_device(cuda):
    """A CPU generator with operands on the card raises; nothing is copied
    across."""
    def value_and_grad(Z):
        return 0.5 * torch.sum(Z * Z, dim=1), Z

    with pytest.raises(ValueError, match="generator"):
        run_mcmc(value_and_grad, torch.zeros(3, device=cuda), torch.Generator(), num_warmup=2, num_samples=2)


def _trend_data(n, d, p, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d) * np.exp(-0.15 * np.arange(d))
    W = rng.randn(d, p) / np.sqrt(d)
    return x, np.sin(x @ W) + 0.1 * rng.randn(n, p)


@pytest.mark.parametrize("sigma", ["scalar", "per feature"])
def test_full_function_fit_f32_matches_f64_on_card(cuda, sigma):
    """FunctionEstimator(n_landmarks=0, obs_variance=True), the full GP
    type, in float32 and float64 on the card (1,500 cells, 8 outputs):
    predictions, leverage and observation variance within 1e-3 of the
    largest float64 value, the leverage within [0, 1], the kernel
    launched."""
    x, y = _trend_data(1500, 10, 8, seed=70)
    s = 0.5 if sigma == "scalar" else np.linspace(0.3, 1.0, 8)
    outs = []
    before = matern52_gram.launches
    for dtype in (torch.float32, torch.float64):
        est = mellon_tpu_torch.FunctionEstimator(
            sigma=s, n_landmarks=0, obs_variance=True, ls=3.0, device=cuda, dtype=dtype
        )
        pred = est.fit_predict(x, y)
        assert est.gp_type.value == "full" and pred.device.type == "cuda"
        outs.append([pred, est.leverage(), est.get_obs_variance(x[:200])])
    for a, b in zip(*outs):
        assert (a.double() - b).abs().max().item() <= 1e-3 * b.abs().max().item()
    assert matern52_gram.launches > before
    lev = outs[0][1]
    assert float(lev.min()) >= 0.0 and float(lev.max()) <= 1.0


def test_full_density_fit_f32_matches_f64_on_card(cuda):
    """DensityEstimator() on 2,000 cells takes the full GP type (an n x n
    factor, L-BFGS over 2,000 latents) on the card, launching the kernel:
    float32 against float64, corr >= 0.999."""
    x, _ = _trend_data(2000, 10, 1, seed=71)
    lds = []
    before = matern52_gram.launches
    for dtype in (torch.float32, torch.float64):
        est = mellon_tpu_torch.DensityEstimator(predictor_with_uncertainty=True, device=cuda, dtype=dtype)
        lds.append(est.fit_predict(x).double().cpu().numpy())
        assert est.gp_type.value == "full" and est.L.shape == (2000, 2000)
        assert torch.isfinite(est.predict.uncertainty(x[:100])).all()
    assert np.corrcoef(lds[0], lds[1])[0, 1] >= 0.999
    assert matern52_gram.launches > before


def test_hat_diagonal_float64_rescue_stays_on_card(cuda, monkeypatch):
    """A float32 leverage whose M is singular at float32 leaves [0, 1] and
    is recomputed in float64: on the card (every factorization of the
    recomputation takes CUDA float64 tensors), clipped, returned in
    float32 on the card."""
    from mellon_tpu_torch.inference import conditionals

    rng = np.random.RandomState(72)
    cov = mellon_tpu_torch.Matern52(ls=40.0)
    x = torch.tensor(rng.randn(2000, 3), dtype=torch.float32, device=cuda)
    xu = torch.tensor(rng.randn(300, 3), dtype=torch.float32, device=cuda)
    B, K = cov(x, xu), cov(xu, xu)
    seen = []
    chunk = conditionals._hat_chunk

    def recording(M, *args):
        seen.append((M.device.type, M.dtype))
        return chunk(M, *args)

    monkeypatch.setattr(conditionals, "_hat_chunk", recording)
    h = conditionals._hat_diagonal(B, K, 1e-3, 1e-6)
    assert h.device.type == "cuda" and h.dtype == torch.float32
    assert ("cuda", torch.float64) in seen
    assert all(device == "cuda" for device, _ in seen)
    assert float(h.min()) >= 0.0 and float(h.max()) <= 1.0


def test_function_and_dimensionality_launch_the_kernel(cuda):
    """The sparse FunctionEstimator (fit, leverage, observation variance)
    and the DimensionalityEstimator (fit, both predictors) each launch the
    CUDA tile."""
    x, y = _trend_data(3000, 10, 4, seed=73)
    before = matern52_gram.launches
    est = mellon_tpu_torch.FunctionEstimator(sigma=0.2, n_landmarks=300, obs_variance=True, device=cuda)
    est.fit_predict(x, y)
    lev = est.leverage()
    torch.cuda.synchronize()
    assert matern52_gram.launches > before
    assert float(lev.min()) >= 0.0 and float(lev.max()) <= 1.0
    before = matern52_gram.launches
    dim = mellon_tpu_torch.DimensionalityEstimator(n_landmarks=300, device=cuda)
    local = dim.fit_predict(x)
    dim.predict(x[:100]), dim.predict_density(x[:100])
    torch.cuda.synchronize()
    assert matern52_gram.launches > before
    assert torch.isfinite(local).all() and (local > 0).all()


def test_same_seed_fits_are_identical_on_card(cuda):
    """Two default fits with the same seed at the benchmark shape (8,627 x
    20 cells, 5,000 k-means landmarks pruned at float32): bit-identical
    k-means landmarks, bit-identical kept landmarks and latents, and the
    same final loss.  Lloyd's update sums by one-hot products in a fixed
    order, not by float atomics."""
    from mellon_tpu_torch.parameters import compute_landmarks

    x = np.asarray(np.load(ROOT / "benchdata" / "ld_ref_8627x20_f64.npz")["x"], dtype=np.float32)
    xt = torch.as_tensor(x, device=cuda)
    first, second = (compute_landmarks(xt, n_landmarks=5000, random_state=42) for _ in range(2))
    assert torch.equal(first, second)
    fits = []
    for _ in range(2):
        est = mellon_tpu_torch.DensityEstimator(device=cuda)
        est.fit(x)
        fits.append(est)
    a, b = fits
    assert torch.equal(a.landmarks, b.landmarks)
    assert torch.equal(a.pre_transformation, b.pre_transformation)
    assert a.opt_state.loss == b.opt_state.loss and a.opt_state.n_steps == b.opt_state.n_steps


def _time_cells(n_per, seed):
    rng = np.random.RandomState(seed)
    x = np.concatenate([rng.randn(n_per, 2) + 0.5 * t for t in range(3)])
    return x, np.repeat(np.arange(3.0), n_per)


def test_time_predictor_on_card_matches_cpu_float64(cuda):
    """A time-sensitive fit's predictor, carried to the card in float64 by
    its JSON state: the mean over a time grid, the time derivative, the
    gradient and the Hessian's log-determinant at one time equal the CPU's
    (1e-10 of the largest value), and the card launches the kernel."""
    x, times = _time_cells(200, 74)
    est = mellon_tpu_torch.TimeSensitiveDensityEstimator(
        n_landmarks=150, ls_time=1.5, device="cpu", dtype=torch.float64)
    est.fit(x, times)
    cpu = est.predict
    card = mellon_tpu_torch.Predictor.from_dict(cpu.to_dict(), device=cuda, dtype=torch.float64)
    assert type(card) is mellon_tpu_torch.LandmarksConditionalCholeskyTime
    pts = x[:50] + 0.01
    grid = np.linspace(0.0, 2.0, 7)
    before = matern52_gram.launches
    pairs = [
        (card(pts, multi_time=grid), cpu(pts, multi_time=grid)),
        (card.time_derivative(pts, 0.7), cpu.time_derivative(pts, 0.7)),
        (card.gradient(pts, 0.7), cpu.gradient(pts, 0.7)),
        (card.hessian_log_determinant(pts, 0.7)[1], cpu.hessian_log_determinant(pts, 0.7)[1]),
    ]
    torch.cuda.synchronize()
    assert matern52_gram.launches > before
    for got, want in pairs:
        assert got.device.type == "cuda"
        assert (got.cpu() - want).abs().max().item() <= 1e-10 * want.abs().max().item()


def test_batched_cholesky_ladder_rescues_a_singular_group_on_card(cuda):
    """float32 time groups of near-duplicate cells that no jitter
    escalation factors: the batched ls_time fits rebuild, factor and
    predict those groups in float64 on the card, and their densities track
    the float64 fits (corr > 0.99 per group)."""
    import logging

    from mellon_tpu_torch.models import ls_time

    rng = np.random.RandomState(0)
    base = rng.randn(12, 2) * 0.02
    xs, ts = [], []
    for t in range(4):
        xs.append(base[rng.randint(0, 12, 120)] + 2e-4 * rng.randn(120, 2) + 0.005 * t)
        ts.append(np.full(120, float(t)))
    xt = torch.tensor(np.concatenate([np.concatenate(xs), np.concatenate(ts)[:, None]], axis=1),
                      dtype=torch.float32, device=cuda)
    nn = mellon_tpu_torch.parameters.compute_nn_distances_within_time_points(xt)
    ut = torch.unique(xt[:, -1])
    kw = dict(jitter=1e-15, ls=1.0)
    messages = []

    class Capture(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    logger = logging.getLogger("mellon_tpu_torch")
    handler, level = Capture(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        dens32 = ls_time._batched_ls_time_densities(xt, nn, mellon_tpu_torch.Matern52, kw, ut, 500)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    dens64 = ls_time._batched_ls_time_densities(xt.double(), nn.double(), mellon_tpu_torch.Matern52,
                                                kw, ut.double(), 500)
    assert any("factorizing those groups in float64 on the device" in m for m in messages)
    assert dens32.device.type == "cuda" and dens32.dtype == torch.float32
    assert torch.isfinite(dens32).all()
    for g in range(4):
        a, b = dens32[g].double().cpu().numpy(), dens64[g].cpu().numpy()
        assert np.corrcoef(a, b)[0, 1] > 0.99


def _clustered(n, d, seed, spread=0.3):
    rng = np.random.RandomState(seed)
    centers = rng.randn(6, d) * 2.0
    x = centers[rng.randint(0, 6, n)] + spread * rng.randn(n, d)
    return (x * np.exp(-0.15 * np.arange(d))[None, :]).astype(np.float32)


@pytest.mark.parametrize("kwargs", [dict(gp_type="sparse_nystroem", rank=0.999, n_landmarks=800),
                                    dict(gp_type="full_nystroem", rank=0.999)])
def test_nystroem_fit_f32_matches_f64_on_card(cuda, kwargs):
    """Both Nyström types on the card (3,000 cells at d = 10; the sparse
    one above 512 landmarks takes the whitened route, pruned where float32
    needs it): float32 against float64, corr >= 0.999, the kernel
    launched, L on the card."""
    x = _clustered(3000, 10, seed=72)
    before = matern52_gram.launches
    lds = []
    for dtype in (torch.float32, torch.float64):
        est = mellon_tpu_torch.DensityEstimator(device=cuda, dtype=dtype, **kwargs)
        lds.append(est.fit_predict(x).double().cpu().numpy())
        assert est.gp_type.value == kwargs["gp_type"] and est.L.device.type == "cuda"
        assert est.Lp is None and np.isfinite(lds[-1]).all()
    assert np.corrcoef(lds[0], lds[1])[0, 1] >= 0.999
    assert matern52_gram.launches > before


def test_full_capacity_on_card(cuda):
    """PRUNE_SINGULAR_LANDMARKS = False on the card: 1,500 cells at d = 10
    with 400 landmarks whose float32 kernel does not factor (test_torch_slice's
    pruning case) keep every landmark; the float64 factor and L live on the card, and L equals a
    float64 construction from the plain kernel to a relative RMS of 1e-6.
    The flag is restored."""
    from mellon_tpu_torch import config

    x = _clustered(1500, 10, seed=23, spread=1.0)
    saved = config.PRUNE_SINGULAR_LANDMARKS
    config.PRUNE_SINGULAR_LANDMARKS = False
    try:
        est = mellon_tpu_torch.DensityEstimator(n_landmarks=400, device=cuda)
        ld = est.fit_predict(x)
    finally:
        config.PRUNE_SINGULAR_LANDMARKS = saved
    assert est.landmarks.shape[0] == 400 and torch.isfinite(ld).all()
    assert est._f64_Lp is not None, "the float32 landmark kernel factored"
    assert est._f64_Lp.device.type == "cuda" and est._f64_Lp.dtype == torch.float64
    x64 = torch.as_tensor(x, device=cuda, dtype=torch.float64)
    xu = est.landmarks.double()
    K = matern52_gram_reference(xu, xu, est.ls)
    Lp = torch.linalg.cholesky(K + est.jitter * torch.eye(400, dtype=torch.float64, device=cuda))
    L = torch.linalg.solve_triangular(Lp.T, matern52_gram_reference(x64, xu, est.ls),
                                      upper=True, left=False)
    rel = ((est.L.double() - L).pow(2).mean().sqrt() / L.pow(2).mean().sqrt()).item()
    assert rel <= 1e-6


def test_bf16_map_on_card(cuda):
    """precision="bf16" on the card: L stored in bfloat16 for the first
    phase, then float32; both phases' steps reported, the fit within corr
    0.999 and std(Δ)/std < 0.05 of the float32 fit."""
    x = _clustered(20000, 10, seed=74)
    ref = mellon_tpu_torch.DensityEstimator(n_landmarks=1000, device=cuda)
    ld32 = ref.fit_predict(x).double().cpu().numpy()
    est = mellon_tpu_torch.DensityEstimator(landmarks=ref.landmarks, precision="bf16", device=cuda)
    ld16 = est.fit_predict(x).double().cpu().numpy()
    assert est.opt_state.phase_steps is not None and est.opt_state.phase_steps[0] > 0
    assert np.corrcoef(ld16, ld32)[0, 1] > 0.999
    assert np.std(ld16 - ld32) / np.std(ld32) < 0.05


def test_checkpoint_saved_on_card_loads_on_card(cuda, tmp_path):
    """A checkpoint of card tensors and a card generator, loaded with no
    ``device=``, comes back on the card, generator included, with the
    same values and the same next draws."""
    g = torch.Generator(device=cuda).manual_seed(5)
    samples = torch.randn(2, 4, 3, device=cuda, generator=g)
    state = torch.randn(2, 3, device=cuda, generator=g)
    mellon_tpu_torch.save_sampler_state(tmp_path / "c", samples=samples, state=state,
                                        step_size=torch.tensor(0.2, device=cuda), rng_key=g)
    loaded = mellon_tpu_torch.load_sampler_state(tmp_path / "c")
    for t in (loaded["samples"], loaded["state"][0], loaded["step_size"]):
        assert t.device.type == "cuda"
    assert loaded["rng_key"].device.type == "cuda"
    assert torch.equal(loaded["samples"], samples) and torch.equal(loaded["state"][0], state)
    assert torch.equal(torch.randn(5, device=cuda, generator=loaded["rng_key"]),
                       torch.randn(5, device=cuda, generator=g))


def test_two_ranks_on_two_cards(cuda, tmp_path):
    """Two NCCL ranks, one card each (this file run as a rank): the
    cell-sharded potential on the 1 x 2 mesh against the local one
    (float32, 1e-5 relative), shard_predict against the unsharded
    predictor (1e-5 of the spread) with the kernel launched on each card,
    and the kernel on cuda:1 against its plain version (1e-5)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (NCCL takes one rank per card)")
    _run_two_ranks("two_cards", tmp_path)


def test_sharded_hessian_on_two_gloo_ranks_on_one_card(cuda, tmp_path):
    """Two gloo ranks on cuda:0 (this file run as a rank; NCCL takes one
    rank per card): the cell-sharded Hessian and its diagonal on the 1 x 2
    mesh against the whole-L density_hessian and
    density_hessian_diagonal, float32 (1e-5 relative) and float64
    (1e-10), and hessian_preconditioner's z* and T, broadcast from rank 0
    with the chains split, the same bits on both ranks."""
    _run_two_ranks("gloo_hessian", tmp_path)


def _run_two_ranks(scenario, tmp_path):
    """This file as two ranks of ``scenario``; each must exit 0."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, scenario, str(rank), str(tmp_path / "store")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for rank in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("a rank hung")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


def _two_card_rank(rank, store):
    """One rank of test_two_ranks_on_two_cards, on cuda:<rank>."""
    from mellon_tpu_torch import parallel
    from mellon_tpu_torch.ops import hopper_kernels as hk

    device = torch.device("cuda", rank)
    parallel.distributed_initialize(backend="nccl", device=device, rank=rank, world_size=2,
                                    store=torch.distributed.FileStore(store, 2),
                                    timeout=datetime.timedelta(seconds=60))
    mesh = parallel.create_mesh(1, 2, devices=["cuda:0", "cuda:1"])
    x = _clustered(3001, 10, seed=77)
    est = mellon_tpu_torch.DensityEstimator(n_landmarks=300, device=device).fit(x)
    Z = est.pre_transformation + 0.1 * torch.randn(
        3, est.L.shape[1], device=device, generator=torch.Generator(device=device).manual_seed(1))
    loss, _ = parallel.shard_density_model(est.nn_distances, est.d, est.mu, est.L, mesh)
    v, g = loss.value_and_grad(Z)
    v0, g0 = make_density_value_and_grad_batch(*est._loss_args)(Z)
    assert float((v - v0).abs().max() / v0.abs().max()) <= 1e-5
    assert float((g - g0).abs().max() / g0.abs().max()) <= 1e-5
    xq = torch.as_tensor(_clustered(20001, 10, seed=78), device=device)
    before = hk.matern52_gram.launches
    got = parallel.shard_predict(est.predict, mesh)(xq)
    assert hk.matern52_gram.launches > before
    want = est.predict(xq)
    assert float((got - want).abs().max() / (want.max() - want.min())) <= 1e-5
    K = matern52_gram(xq[:1000], est.landmarks, 1.7)
    assert (K - matern52_gram_reference(xq[:1000], est.landmarks, 1.7)).abs().max().item() <= 1e-5
    torch.distributed.destroy_process_group()


def _gloo_hessian_rank(rank, store):
    """One rank of test_sharded_hessian_on_two_gloo_ranks_on_one_card."""
    import hashlib

    from mellon_tpu_torch import parallel
    from mellon_tpu_torch.inference.losses import density_hessian, density_hessian_diagonal
    from mellon_tpu_torch.inference.mcmc import hessian_preconditioner, zero_centered_potential

    device = torch.device("cuda", 0)
    parallel.distributed_initialize(backend="gloo", device=device, rank=rank, world_size=2,
                                    store=torch.distributed.FileStore(store, 2),
                                    timeout=datetime.timedelta(seconds=60))
    x = _clustered(3001, 10, seed=77)
    est = mellon_tpu_torch.DensityEstimator(n_landmarks=300, device=device).fit(x)
    z = est.pre_transformation
    for dtype, bar in ((torch.float32, 1e-5), (torch.float64, 1e-10)):
        L, nn = est.L.to(dtype), est.nn_distances.to(dtype)
        zt = z.to(dtype)
        mesh = parallel.create_mesh(1, 2, devices=[device, device])
        loss, _ = parallel.shard_density_model(nn, est.d, est.mu, L, mesh)
        H, H0 = loss.hessian(zt), density_hessian(zt, L, nn, est.d, est.mu)
        diag = loss.hessian_diagonal(zt)
        diag0 = density_hessian_diagonal(zt, L, nn, est.d, est.mu)
        assert float((H - H0).abs().max() / H0.abs().max()) <= bar
        assert float((diag - diag0).abs().max() / diag0.abs().max()) <= bar
    chains = parallel.create_mesh(2, 1, devices=[device, device])
    vg, _ = zero_centered_potential(z, *est._loss_args)
    hessian = lambda v: density_hessian(v, *est._loss_args)  # noqa: E731
    z_star, T, _ = hessian_preconditioner(vg, hessian, z,
                                          chain_sharding=parallel.chain_sharding(chains))
    digest = hashlib.sha256(z_star.cpu().numpy().tobytes() + T.cpu().numpy().tobytes()).hexdigest()
    digests = [None, None]
    torch.distributed.all_gather_object(digests, digest)
    assert digests[0] == digests[1]
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    {"two_cards": _two_card_rank, "gloo_hessian": _gloo_hessian_rank}[sys.argv[1]](
        int(sys.argv[2]), sys.argv[3])
