"""bf16 sampling in mellon_tpu_torch against mellon_tpu.

With a bfloat16 L the density forms compute the JAX package's bf16
function: z rounded to bfloat16 before the product, and the likelihood
part of the gradient (and of the Hessian) rounded to bfloat16 where
JAX's autodiff transposes that cast.  The samplers read that function
through ``sample_density_posterior(precision="bf16")`` and the
estimators' ``precision="bf16"`` with ``optimizer="nuts"`` or ``"smc"``.
The JAX side runs in float32 (``jax_x64_off``): the JAX package casts
only float32 operands to bfloat16.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxReplayDraws, clustered, jax_x64_off, to_np
import mellon_tpu
from mellon_tpu.inference import mcmc as jax_mcmc
from mellon_tpu.inference.losses import density_loglik as jax_density_loglik
from mellon_tpu.inference.losses import density_loss as jax_density_loss
from mellon_tpu.inference.losses import dimensionality_loss as jax_dimensionality_loss
import mellon_tpu_torch
from mellon_tpu_torch import state_from_jax
from mellon_tpu_torch.inference import losses, mcmc
from mellon_tpu_torch.inference.optimizers import bf16_operands
from mellon_tpu_torch.models import base

CPU32 = dict(device="cpu", dtype=torch.float32)


def _problem(n=500, k=32, seed=12):
    """tests/test_torch_inference.py's bf16 problem from a numpy seed: L
    (n, k) float32, 1-NN distances, d = 5, mu = -3, and four latent
    vectors."""
    rng = np.random.RandomState(seed)
    L = (rng.randn(n, k) / np.sqrt(k)).astype(np.float32)
    nn = (0.05 + 0.3 * rng.rand(n)).astype(np.float32)
    Z = (0.5 * rng.randn(4, k)).astype(np.float32)
    return L, nn, 5.0, -3.0, Z


def _bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits)."""
    x = np.abs(np.asarray(x, dtype=np.float64))
    return np.exp2(np.floor(np.log2(np.maximum(x, np.finfo(np.float32).tiny))) - 7)


def _port_forms(form, L, nn, d, mu, Z):
    """(values (C,), gradients (C, k)) of the port's density form at the
    rows of Z, with a bfloat16 L."""
    args = (torch.as_tensor(L).to(torch.bfloat16), torch.as_tensor(nn), d, mu)
    Zt = torch.as_tensor(Z)
    if form == "single":
        vg = losses.make_density_value_and_grad(*args)
        out = [vg(z) for z in Zt]
        return torch.stack([v for v, _ in out]), torch.stack([g for _, g in out])
    if form == "batched":
        return losses.make_density_value_and_grad_batch(*args)(Zt)
    if form == "centred":
        center = Zt.mean(dim=0)
        return losses.make_density_value_and_grad_batch(*args, center=center)(Zt)
    # the scalar density_loss, its gradient by autograd
    values = torch.stack([losses.density_loss(z, *args) for z in Zt])
    grads = torch.stack([torch.func.grad(losses.density_loss)(z, *args) for z in Zt])
    return values, grads


@pytest.mark.parametrize("form", ["single", "batched", "centred", "scalar"])
def test_bf16_density_forms_match_jax(form):
    """Every density form with a bfloat16 L against
    jax.value_and_grad(density_loss) on the same bfloat16 L: the value
    within 1e-6 relative (float32 summation order); every gradient entry
    within one bfloat16 ulp of JAX's likelihood part (plus two float32
    ulps of the entry, the rounding of z + it), at least 99% bit-equal."""
    L, nn, d, mu, Z = _problem()
    with jax_x64_off():
        Lb = jnp.asarray(L).astype(jnp.bfloat16)
        vg = jax.vmap(jax.value_and_grad(jax_density_loss), in_axes=(0, None, None, None, None))
        want_v, want_g = (np.asarray(a) for a in vg(jnp.asarray(Z), Lb, jnp.asarray(nn), d, mu))
    values, grads = (to_np(a) for a in _port_forms(form, L, nn, d, mu, Z))
    assert values.dtype == grads.dtype == np.float32
    np.testing.assert_allclose(values, want_v, rtol=1e-6)
    likelihood_part = Z - want_g
    bound = _bf16_ulp(likelihood_part) + 2 * np.spacing(np.abs(want_g))
    assert np.all(np.abs(grads - want_g) <= bound), np.max(np.abs(grads - want_g) / bound)
    assert np.mean(grads == want_g) >= 0.99


def test_bf16_density_loglik_keeps_jax_promotion():
    """density_loglik with a bfloat16 L is JAX's: bf16 × f32 promoted to
    float32, z not rounded, the gradient not rounded (its jaxpr casts
    nothing); value and autograd gradient to float32 rounding."""
    L, nn, d, mu, Z = _problem()
    args = (torch.as_tensor(L).to(torch.bfloat16), torch.as_tensor(nn), d, mu)
    with jax_x64_off():
        jargs = (jnp.asarray(L).astype(jnp.bfloat16), jnp.asarray(nn), d, mu)
        for z in Z:
            want_v, want_g = jax.value_and_grad(jax_density_loglik)(jnp.asarray(z), *jargs)
            zt = torch.as_tensor(z)
            np.testing.assert_allclose(float(losses.density_loglik(zt, *args)), float(want_v),
                                       rtol=1e-6)
            got_g = to_np(torch.func.grad(losses.density_loglik)(zt, *args))
            np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=1e-5,
                                       atol=1e-5 * np.abs(np.asarray(want_g)).max())


def test_bf16_loglik_batch_is_the_loss_likelihood():
    """SMC's batched log-likelihood with a bfloat16 L is the likelihood
    term of the bf16 loss, as the JAX package's loglik_from_loss(
    density_loss): −loss − log prior and its gradient, to float32
    rounding of the prior's terms."""
    L, nn, d, mu, Z = _problem()
    args = (torch.as_tensor(L).to(torch.bfloat16), torch.as_tensor(nn), d, mu)
    Zt = torch.as_tensor(Z)
    values, grads = losses.make_density_value_and_grad_batch(*args)(Zt)
    prior = -0.5 * torch.sum(Zt * Zt, dim=1) - 0.5 * Zt.shape[1] * np.log(2 * np.pi)
    ll, ll_grad = losses.make_density_loglik_batch(*args)(Zt)
    np.testing.assert_allclose(to_np(ll), to_np(-values - prior), rtol=1e-6)
    np.testing.assert_allclose(to_np(ll_grad), to_np(Zt - grads), rtol=0, atol=1e-5)


def test_bf16_hessian_matches_jax():
    """density_hessian and its diagonal with a bfloat16 L against
    jax.hessian of JAX's bf16 density loss: 1e-4 relative (its likelihood
    part is rounded to bfloat16 as the Hessian-vector products round it)."""
    L, nn, d, mu, Z = _problem()
    args = (torch.as_tensor(L).to(torch.bfloat16), torch.as_tensor(nn), d, mu)
    for z in Z[:2]:
        with jax_x64_off():
            H_want = np.asarray(jax.hessian(jax_density_loss)(
                jnp.asarray(z), jnp.asarray(L).astype(jnp.bfloat16), jnp.asarray(nn), d, mu))
        zt = torch.as_tensor(z)
        H = to_np(losses.density_hessian(zt, *args))
        diag = to_np(losses.density_hessian_diagonal(zt, *args))
        scale = np.abs(H_want).max()
        np.testing.assert_allclose(H, H_want, rtol=0, atol=1e-4 * scale)
        np.testing.assert_allclose(diag, np.diag(H_want), rtol=1e-4)
        batched = losses.density_potential(args)
        np.testing.assert_array_equal(to_np(batched.hessian(zt)), H)


def test_bf16_dimensionality_forms_keep_jax_promotion():
    """The dimensionality forms with L and the k-NN distances in bfloat16
    against JAX's dimensionality_loss on the same operands (JAX promotes
    bf16 × f32 to float32 there): value 1e-6, gradient 1e-4 of its largest
    entry; the Hessian diagonal against jax.hessian's, 1e-4 relative."""
    rng = np.random.RandomState(31)
    n, k = 400, 24
    L = (rng.randn(n, k) / np.sqrt(k)).astype(np.float32)
    dist = np.sort(0.05 + 0.5 * rng.rand(n, 10), axis=1).astype(np.float32)
    z = (0.3 * rng.randn(2, k)).astype(np.float32)
    ops = bf16_operands((torch.as_tensor(L), torch.as_tensor(dist), 0.7, -2.0))
    assert ops[0].dtype == ops[1].dtype == torch.bfloat16
    with jax_x64_off():
        jops = (jnp.asarray(L).astype(jnp.bfloat16), jnp.asarray(dist).astype(jnp.bfloat16),
                0.7, -2.0)
        want_v, want_g = jax.value_and_grad(jax_dimensionality_loss)(jnp.asarray(z), *jops)
        flat = lambda v: jax_dimensionality_loss(v.reshape(2, k), *jops)  # noqa: E731
        H_want = np.asarray(jax.hessian(flat)(jnp.asarray(z).reshape(-1)))
    value, grad = losses.make_dimensionality_value_and_grad(*ops)(torch.as_tensor(z).reshape(-1))
    np.testing.assert_allclose(float(value), float(want_v), rtol=1e-6)
    want_g = np.asarray(want_g).reshape(-1)
    np.testing.assert_allclose(to_np(grad), want_g, rtol=0, atol=1e-4 * np.abs(want_g).max())
    zt = torch.as_tensor(z).reshape(-1)
    np.testing.assert_allclose(to_np(losses.dimensionality_hessian_diagonal(zt, *ops)),
                               np.diag(H_want), rtol=1e-4)
    H = to_np(losses.dimensionality_hessian(zt, *ops))
    np.testing.assert_allclose(H, H_want, rtol=0, atol=1e-4 * np.abs(H_want).max())


@pytest.fixture(scope="module")
def small_fit():
    """The JAX package's test_bf16_precision_sampling problem from a
    numpy seed: 60 x 2 cells, 20 landmarks, fitted by mellon_tpu in
    float32, and the port's estimator holding the same state in float32."""
    x = np.random.RandomState(21).randn(60, 2).astype(np.float32)
    with jax_x64_off():
        jest = mellon_tpu.DensityEstimator(n_landmarks=20)
        jest.prepare_inference(jnp.asarray(x))
        jest.run_inference()
        est = state_from_jax(jest, **CPU32)
    return jest, est


@pytest.mark.parametrize("algorithm,precondition", [("nuts", None), ("nuts", "hessian"),
                                                    ("hmc", None), ("hmc", "hessian")])
def test_bf16_precision_sampling_matches_jax(small_fit, algorithm, precondition, caplog):
    """The counterpart of tests/test_mcmc.py's test_bf16_precision_sampling:
    200 warmup and 200 draws of 2 chains, seed 5.  The port's bf16
    function means correlate > 0.99 with its float32 run (JAX's bar) and
    with JAX's bf16 run; the warning is logged."""
    jest, est = small_fit
    run = dict(num_warmup=200, num_samples=200, num_chains=2, algorithm=algorithm,
               precondition=precondition)
    with jax_x64_off():
        _, f_jax = jax_mcmc.sample_density_posterior(jest, seed=5, precision="bf16", **run)
    _, f32 = mcmc.sample_density_posterior(est, seed=5, **run)
    with caplog.at_level(logging.WARNING, logger="mellon_tpu_torch"):
        res16, f16 = mcmc.sample_density_posterior(est, seed=5, precision="bf16", **run)
    assert any("round-5 posterior-agreement" in r.getMessage() for r in caplog.records)
    assert f16.dtype == torch.float32 and bool(torch.isfinite(res16.samples).all())
    m16, m32 = to_np(f16.mean(dim=0)), to_np(f32.mean(dim=0))
    assert np.corrcoef(m16, m32)[0, 1] > 0.99
    assert np.corrcoef(m16, np.asarray(f_jax).mean(axis=0))[0, 1] > 0.99


def test_bf16_sampling_refusals_and_options(small_fit):
    """precision="fp8" raises ValueError in both packages; with bf16 the
    function samples can be left out, as with float32."""
    jest, est = small_fit
    with jax_x64_off(), pytest.raises(ValueError, match="precision"):
        jax_mcmc.sample_density_posterior(jest, precision="fp8")
    with pytest.raises(ValueError, match="precision"):
        mcmc.sample_density_posterior(est, precision="fp8")
    res, f = mcmc.sample_density_posterior(est, precision="bf16", function_samples=False,
                                           num_warmup=4, num_samples=2)
    assert f is None and res.samples.shape == (4, 2, est.L.shape[1])


def test_bf16_hmc_replays_jax_draws(small_fit):
    """resume_mcmc (HMC, 8 leapfrogs, a fixed step size and mass) on the
    bf16 zero-centred potential, 5 transitions of 4 chains on JAX's draws:
    samples within 1e-5 and acceptance within 2e-4 of JAX's, the float32
    replay's own gaps (1.9e-6 and 4.6e-5 on these draws) with room: the
    port sums the potential around z0 and in another order, so the bf16
    functions agree to float32 rounding and to one bfloat16 ulp of the
    rare gradient entry whose likelihood part lies at a rounding tie."""
    jest, est = small_fit
    rng = np.random.RandomState(22)
    k = est.L.shape[1]
    z0 = est.pre_transformation
    z = to_np(z0)[None] + 0.05 * rng.randn(4, k).astype(np.float32)
    inv_mass = np.exp(0.2 * rng.randn(k)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    run = dict(num_samples=5, algorithm="hmc", num_leapfrog_steps=8)
    vg, _ = mcmc.zero_centered_density_potential(z0, *bf16_operands(est._loss_args))
    with jax_x64_off():
        jargs = tuple(a.astype(jnp.bfloat16) if getattr(a, "ndim", 0) == 2 else a
                      for a in jest._loss_args)
        fn, jargs = jax_mcmc.zero_centered_potential(jax_density_loss, jest.pre_transformation,
                                                     jargs)
        want = jax_mcmc.resume_mcmc(fn, jnp.asarray(z), key, 0.1, jnp.asarray(inv_mass),
                                    potential_args=jargs, **run)
        # the replayed draws are JAX's float32 ones
        got = mcmc.resume_mcmc(vg, torch.as_tensor(z), JaxReplayDraws(key), 0.1,
                               torch.as_tensor(inv_mass), **run)
    np.testing.assert_allclose(to_np(got.samples), np.asarray(want.samples), rtol=0, atol=1e-5)
    np.testing.assert_allclose(to_np(got.accept_prob), np.asarray(want.accept_prob), rtol=0,
                               atol=2e-4)


ESTIMATORS = ("density", "time", "dimensionality")
SAMPLERS = {
    "nuts": dict(optimizer="nuts", sampler_options=dict(num_warmup=60, num_samples=60,
                                                        num_chains=4, max_tree_depth=5)),
    "nuts hessian": dict(optimizer="nuts",
                         sampler_options=dict(num_warmup=100, num_samples=100, num_chains=4,
                                              precondition="hessian")),
    "smc": dict(optimizer="smc", sampler_options=dict(num_particles=256)),
    "smc laplace": dict(optimizer="smc", sampler_options=dict(num_particles=256,
                                                              start="laplace")),
}


def _estimator_fit(kind, precision, opts):
    x = clustered(300, 3, seed=40).astype(np.float32)
    if kind == "time":
        times = np.repeat(np.arange(3.0), 100).astype(np.float32)
        est = mellon_tpu_torch.TimeSensitiveDensityEstimator(n_landmarks=30, ls_time=1.5,
                                                             precision=precision, **opts, **CPU32)
        est.fit(x, times)
    else:
        cls = {"density": mellon_tpu_torch.DensityEstimator,
               "dimensionality": mellon_tpu_torch.DimensionalityEstimator}[kind]
        est = cls(n_landmarks=30, precision=precision, **opts, **CPU32)
        est.fit(x)
    return est


@pytest.mark.parametrize("sampler", list(SAMPLERS))
@pytest.mark.parametrize("kind", ESTIMATORS)
def test_bf16_estimator_sampling(kind, sampler, monkeypatch):
    """precision="bf16" with NUTS (plain and Hessian-preconditioned) and
    SMC (prior and Laplace starts) on the three estimators: the sampler's
    operands are bfloat16, recorded through bf16_operands (the
    dimensionality model's k-NN distances too), and the posterior means
    correlate > 0.99 with the float32 run.  The dimensionality model's
    (2, k) latents refuse SMC in both packages."""
    opts = SAMPLERS[sampler]
    if kind == "dimensionality" and opts["optimizer"] == "smc":
        x = clustered(100, 3, seed=41).astype(np.float32)
        # the JAX estimator's constructor has no precision= (its
        # run_inference reads the attribute)
        jest = mellon_tpu.DimensionalityEstimator(n_landmarks=20, **opts)
        jest.precision = "bf16"
        with jax_x64_off(), pytest.raises(ValueError, match="1-d latent"):
            jest.fit(jnp.asarray(x))
        est = mellon_tpu_torch.DimensionalityEstimator(n_landmarks=20, precision="bf16", **opts,
                                                       **CPU32)
        with pytest.raises(ValueError, match="1-d latent"):
            est.fit(x)
        return
    cast = []

    def recording(loss_args):
        cast.append(bf16_operands(loss_args))
        return cast[-1]

    monkeypatch.setattr(base, "bf16_operands", recording)
    est = _estimator_fit(kind, "bf16", opts)
    assert len(cast) == 1
    matrices = [a for a in cast[0] if isinstance(a, torch.Tensor) and a.ndim == 2]
    assert matrices and all(a.dtype == torch.bfloat16 for a in matrices)
    assert len(matrices) == (2 if kind == "dimensionality" else 1)
    ref = _estimator_fit(kind, None, opts)
    assert len(cast) == 1
    got, want = to_np(est.pre_transformation).ravel(), to_np(ref.pre_transformation).ravel()
    assert np.all(np.isfinite(got)) and np.all(np.isfinite(to_np(est.pre_transformation_std)))
    assert np.corrcoef(got, want)[0, 1] > 0.99
