"""The samplers' building blocks and single transitions of mellon_tpu_torch
against mellon_tpu: the leapfrog, the U-turn checkpoints, dual averaging,
Welford, the batched density potential, one HMC and one NUTS transition
replayed on JAX's own draws, the NUTS step count (a deliberate divergence),
and the diagnostics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxReplayDraws, t64, to_np
from mellon_tpu.inference import diagnostics as jax_diagnostics
from mellon_tpu.inference import samplers as js
from mellon_tpu.inference.losses import density_loss as jax_density_loss
from mellon_tpu_torch.inference import diagnostics, samplers
from mellon_tpu_torch.inference.losses import (
    make_density_value_and_grad,
    make_density_value_and_grad_batch,
)
from mellon_tpu_torch.inference.mcmc import run_mcmc
from mellon_tpu_torch.inference.samplers import batched_value_and_grad

N, K, D, MU = 200, 30, 2.0, -1.0


@pytest.fixture(scope="module")
def density():
    """A density potential (n = 200 cells, 30 latents) for both packages,
    four chain starts and a diagonal inverse mass."""
    rng = np.random.RandomState(0)
    L, nn = rng.randn(N, K) * 0.3, np.exp(rng.randn(N) * 0.3 - 1)
    Z0, inv_mass = rng.randn(4, K) * 0.3, np.exp(rng.randn(K) * 0.2) * 0.5
    jargs = (jnp.asarray(L), jnp.asarray(nn), D, MU)
    return dict(
        jpot=lambda z: jax_density_loss(z, *jargs),
        vg=make_density_value_and_grad_batch(t64(L), t64(nn), D, MU),
        L=L, nn=nn, Z0=Z0, inv_mass=inv_mass,
    )


def jax_count(monkeypatch):
    """Make the port count a doubling's leapfrogs as the JAX package does."""
    monkeypatch.setattr(samplers, "_subtree_steps", lambda leaves, depth: torch.full_like(leaves, 2**depth))


def test_leapfrog_and_kinetic_match_jax(density):
    """Three leapfrog steps of four chains and their kinetic energies:
    1e-12 relative."""
    jleap = jax.vmap(lambda s: js._leapfrog(density["jpot"], jnp.asarray(density["inv_mass"]), 0.3, s))
    Z0 = density["Z0"]
    r0 = np.random.RandomState(71).randn(*Z0.shape)
    v, g = jax.vmap(jax.value_and_grad(density["jpot"]))(jnp.asarray(Z0))
    jstate = js.IntegratorState(jnp.asarray(Z0), jnp.asarray(r0), v, g)
    pv, pg = density["vg"](t64(Z0))
    pstate = samplers.IntegratorState(t64(Z0), t64(r0), pv, pg)
    step, inv_mass = torch.tensor(0.3, dtype=torch.float64), t64(density["inv_mass"])
    for _ in range(3):
        jstate = jleap(jstate)
        pstate = samplers._leapfrog(density["vg"], inv_mass, step, pstate)
    for got, want in zip(pstate, jstate):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-12, atol=1e-12)
    want = jax.vmap(lambda r: js._kinetic(jnp.asarray(density["inv_mass"]), r))(jstate.r)
    np.testing.assert_allclose(to_np(samplers._kinetic(inv_mass, pstate.r)), np.asarray(want), rtol=1e-12)


def test_checkpoint_ranges_match_jax():
    """The host arithmetic of the U-turn checkpoints equals JAX's device
    loops for every leaf index below 1,024."""
    want = jax.jit(jax.vmap(js._leaf_checkpoint_idxs))(jnp.arange(1024))
    got = np.array([samplers._leaf_checkpoint_idxs(n) for n in range(1024)])
    np.testing.assert_array_equal(got[:, 0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[:, 1], np.asarray(want[1]))


def test_dual_averaging_matches_jax():
    """50 dual-averaging steps on the same acceptance sequence: 1e-12."""
    accepts = np.random.RandomState(72).uniform(0.2, 1.0, 50)
    jda, pda = js.da_init(jnp.asarray(0.1)), samplers.da_init(torch.tensor(0.1, dtype=torch.float64))
    for a in accepts:
        jda = js.da_update(jda, jnp.asarray(a), target=0.8)
        pda = samplers.da_update(pda, torch.tensor(a, dtype=torch.float64), target=0.8)
    for got, want in zip(pda, jda):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-12)


def test_welford_matches_jax():
    """Welford over 4 chains x 30 states and its regularized variance: 1e-12."""
    states = np.random.RandomState(73).randn(30, 4, 5) * np.array([0.01, 0.1, 1, 10, 100])
    jwf, pwf = js.welford_init(5), samplers.welford_init(5, torch.float64)
    for chains in states:
        for x in chains:
            jwf, pwf = js.welford_update(jwf, jnp.asarray(x)), samplers.welford_update(pwf, t64(x))
    for got, want in zip(pwf, jwf):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-12)
    for reg in (True, False):
        np.testing.assert_allclose(
            to_np(samplers.welford_variance(pwf, reg)), np.asarray(js.welford_variance(jwf, reg)), rtol=1e-12
        )


def test_batched_density_potential_matches_jax(density):
    """The chains' potential and gradient in one call against
    jax.value_and_grad(density_loss) one chain at a time, and the offset
    identity loss(z, c) = loss(z) - n c with an unchanged gradient: 1e-12."""
    Z = density["Z0"]
    v, g = density["vg"](t64(Z))
    for i in range(Z.shape[0]):
        jv, jg = jax.value_and_grad(density["jpot"])(jnp.asarray(Z[i]))
        np.testing.assert_allclose(float(v[i]), float(jv), rtol=1e-12)
        np.testing.assert_allclose(to_np(g[i]), np.asarray(jg), rtol=1e-12, atol=1e-12)
    c = 3.7
    vc, gc = make_density_value_and_grad_batch(t64(density["L"]), t64(density["nn"]), D, MU, c)(t64(Z))
    np.testing.assert_allclose(to_np(vc), to_np(v) - N * c, rtol=1e-12)
    np.testing.assert_allclose(to_np(gc), to_np(g), rtol=1e-12)
    single = make_density_value_and_grad(t64(density["L"]), t64(density["nn"]), D, MU)(t64(Z[1]))
    np.testing.assert_allclose(float(single[0]), float(v[1]), rtol=1e-12)


def _transitions(density, kind, step, seed):
    """One transition of the four chains in both packages from the same
    state, the port on the draws JAX takes from the same keys."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    inv_mass = density["inv_mass"]
    jkernel = (js.nuts_kernel(density["jpot"], max_tree_depth=6) if kind == "nuts"
               else js.hmc_kernel(density["jpot"], num_steps=8))
    jstates = jax.vmap(lambda z: js.hmc_init(density["jpot"], z))(jnp.asarray(density["Z0"]))
    jnew, jinfo = jax.jit(jax.vmap(jkernel, in_axes=(0, 0, None, None)))(
        jstates, keys, step, jnp.asarray(inv_mass))
    pkernel = (samplers.nuts_kernel(density["vg"], max_tree_depth=6) if kind == "nuts"
               else samplers.hmc_kernel(density["vg"], num_steps=8))
    draws = JaxReplayDraws()
    draws.set_keys(keys[None])
    pnew, pinfo = pkernel(samplers.hmc_init(density["vg"], t64(density["Z0"])), draws,
                          torch.tensor(step, dtype=torch.float64), t64(inv_mass))
    return (jnew, jinfo), (pnew, pinfo)


@pytest.mark.parametrize(
    "kind,step,seed,case",
    [
        ("hmc", 0.2, 0, "plain"),
        ("nuts", 0.2, 0, "plain"),
        # chain 3's last doubling stops on a U-turn after 4 of its 8 leaves
        ("nuts", 0.5, 1, "early U-turn"),
        # chain 0 diverges at the first leaf of its third doubling
        ("nuts", 0.6, 1, "divergence"),
    ],
)
def test_transition_replayed_matches_jax(density, monkeypatch, kind, step, seed, case):
    """One transition of 4 chains (NUTS depth 6, HMC 8 steps) on JAX's
    draws, with the port counting steps as JAX does: z, potential, grad
    and accept_prob to 1e-10 relative, diverging and num_steps exactly."""
    jax_count(monkeypatch)
    (jnew, jinfo), (pnew, pinfo) = _transitions(density, kind, step, seed)
    for got, want in [*zip(pnew, jnew), (pinfo.accept_prob, jinfo.accept_prob)]:
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(to_np(pinfo.diverging), np.asarray(jinfo.diverging))
    np.testing.assert_array_equal(to_np(pinfo.num_steps), np.asarray(jinfo.num_steps))
    if case == "divergence":
        assert bool(pinfo.diverging[0])


def test_nuts_counts_the_leapfrogs_it_takes(density):
    """The deliberate divergence, unpatched.  JAX's nuts_kernel adds 2**depth
    for a doubling that stopped early on a U-turn (samplers.py:208, :400)
    and divides the summed acceptance by that count (:412).  One chain on
    the early-U-turn transition above: the port's num_steps equals the
    potential evaluations it made (11), JAX reports 15, and the port's
    accept_prob equals JAX's x (15 / 11): same sum, true count."""
    vg, calls = density["vg"], []

    def counted(Z):
        calls.append(Z.shape[0])
        return vg(Z)

    keys = jax.random.split(jax.random.PRNGKey(1), 4)[3:]
    z0 = density["Z0"][3:]
    inv_mass = jnp.asarray(density["inv_mass"])
    jstate = jax.vmap(lambda z: js.hmc_init(density["jpot"], z))(jnp.asarray(z0))
    _, jinfo = jax.vmap(js.nuts_kernel(density["jpot"], max_tree_depth=6), in_axes=(0, 0, None, None))(
        jstate, keys, 0.5, inv_mass)
    draws = JaxReplayDraws()
    draws.set_keys(keys[None])
    kernel = samplers.nuts_kernel(counted, max_tree_depth=6)
    _, info = kernel(samplers.hmc_init(counted, t64(z0)), draws, torch.tensor(0.5, dtype=torch.float64),
                     t64(density["inv_mass"]))
    port_steps, jax_steps = int(info.num_steps[0]), int(jinfo.num_steps[0])
    assert port_steps == sum(calls) - 1 == 11
    assert jax_steps == 15
    np.testing.assert_allclose(
        float(info.accept_prob[0]), float(jinfo.accept_prob[0]) * jax_steps / port_steps, rtol=1e-10
    )


def test_nuts_returns_the_gradient_at_the_proposal():
    """The transition hands the tree's proposal gradient to the next state
    without a new potential call; it must be the gradient there."""
    weights = torch.arange(1.0, 4.0, dtype=torch.float64)

    def potential(Z):
        return 0.5 * torch.sum(Z * Z * weights, dim=1)

    vg = batched_value_and_grad(potential)
    step = samplers.nuts_kernel(vg, max_tree_depth=6)
    state = samplers.hmc_init(vg, torch.tensor([[0.5, -1.0, 2.0], [1.0, 0.0, -1.0]], dtype=torch.float64))
    draws = samplers.Draws(torch.Generator().manual_seed(3))
    for _ in range(5):
        state, _ = step(state, draws, torch.tensor(0.2, dtype=torch.float64), torch.ones(3, dtype=torch.float64))
        np.testing.assert_allclose(to_np(state.grad), to_np(state.z * weights), rtol=1e-12)
        np.testing.assert_allclose(to_np(state.potential), to_np(potential(state.z)), rtol=1e-12)


@pytest.mark.parametrize("case", ["iid", "ar1", "stuck"])
def test_diagnostics_match_jax(case):
    """split_rhat, effective_sample_size with its truncation lags and
    summarize against the JAX package's on fixed arrays: 1e-12 (the
    cases of tests/test_mcmc.py:200-236)."""
    rng = np.random.RandomState(74)
    if case == "iid":
        samples = rng.randn(4, 500, 3)
    elif case == "ar1":
        x = np.zeros((8, 1000))
        innov = rng.randn(8, 1000) * np.sqrt(1 - 0.7**2)
        for t in range(1, 1000):
            x[:, t] = 0.7 * x[:, t - 1] + innov[:, t]
        samples = x[:, :, None]
    else:
        samples = np.stack([rng.randn(4, 500), np.zeros((4, 500)) + rng.randn(4, 1)], axis=-1)
    np.testing.assert_allclose(diagnostics.split_rhat(t64(samples)), jax_diagnostics.split_rhat(samples),
                               rtol=1e-12)
    ess, lag = diagnostics.effective_sample_size(t64(samples), return_truncation=True)
    jess, jlag = jax_diagnostics.effective_sample_size(samples, return_truncation=True)
    np.testing.assert_allclose(ess, jess, rtol=1e-12)
    np.testing.assert_array_equal(lag, jlag)
    got, want = diagnostics.summarize(samples), jax_diagnostics.summarize(samples)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)


def _correlated_gaussian():
    cov = torch.tensor([[2.0, 0.9], [0.9, 1.0]], dtype=torch.float64)
    prec, mean = torch.linalg.inv(cov), torch.tensor([1.0, -1.0], dtype=torch.float64)
    vg = batched_value_and_grad(lambda Z: 0.5 * torch.sum(((Z - mean) @ prec) * (Z - mean), dim=1))
    return vg, mean.numpy(), cov.numpy()


def test_nuts_recovers_gaussian():
    """NUTS with a torch.Generator on the correlated Gaussian, with the bars
    of tests/test_mcmc.py:37-52: mean 0.1, std 10%, R-hat < 1.05, ESS >
    200, no divergence."""
    vg, mean, cov = _correlated_gaussian()
    res = run_mcmc(vg, torch.zeros(2, dtype=torch.float64), torch.Generator().manual_seed(0),
                   num_warmup=500, num_samples=1000, num_chains=4)
    s = diagnostics.summarize(res.samples)
    np.testing.assert_allclose(s["mean"], mean, atol=0.1)
    np.testing.assert_allclose(s["std"], np.sqrt(np.diag(cov)), rtol=0.1)
    assert np.all(s["rhat"] < 1.05) and np.all(s["ess"] > 200)
    assert int(res.diverging.sum()) == 0
    assert res.host_reads > 0 and res.num_evaluations >= int(res.num_leapfrog.sum())


def test_mass_adaptation_absorbs_scales():
    """A Gaussian with scales 0.01, 1 and 100 (tests/test_mcmc.py:72-92):
    the adapted diagonal mass spans more than 1e4 and the stds come back
    within 25%.  100 warmup transitions instead of 800: each of the
    identity-mass ones runs to the depth cap, and 100 already settle it."""
    scales = torch.tensor([0.01, 1.0, 100.0], dtype=torch.float64)

    def value_and_grad(Z):
        return 0.5 * torch.sum((Z / scales) ** 2, dim=1), Z / scales**2

    res = run_mcmc(value_and_grad, torch.zeros(3, dtype=torch.float64),
                        torch.Generator().manual_seed(2), num_warmup=100, num_samples=1000)
    np.testing.assert_allclose(diagnostics.summarize(res.samples)["std"], to_np(scales), rtol=0.25)
    assert float(res.inv_mass_diag[2] / res.inv_mass_diag[0]) > 1e4


def test_hmc_recovers_gaussian():
    """HMC (16 leapfrogs) on the correlated Gaussian with the bars of
    tests/test_mcmc.py:55-69: mean 0.15, std 15%."""
    cov = torch.tensor([[2.0, 0.9], [0.9, 1.0]], dtype=torch.float64)
    prec, mean = torch.linalg.inv(cov), torch.tensor([1.0, -1.0], dtype=torch.float64)

    def value_and_grad(Z):
        d = Z - mean
        return 0.5 * torch.sum((d @ prec) * d, dim=1), d @ prec

    res = run_mcmc(value_and_grad, torch.zeros(2, dtype=torch.float64), torch.Generator().manual_seed(1),
                        num_warmup=500, num_samples=1000, algorithm="hmc", num_leapfrog_steps=16)
    s = diagnostics.summarize(res.samples)
    np.testing.assert_allclose(s["mean"], to_np(mean), atol=0.15)
    np.testing.assert_allclose(s["std"], np.sqrt(np.diag(to_np(cov))), rtol=0.15)
