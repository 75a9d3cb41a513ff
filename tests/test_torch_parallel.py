"""mellon_tpu_torch.parallel against mellon_tpu.parallel: the mesh, the
cell-sharded density potential and its curvature (the Hessian, its
diagonal, the Newton polish, the Laplace stds), shard_predict, chain-sharded
NUTS and HMC, Hessian-preconditioned NUTS on the sharded potential,
particle-sharded SMC and distributed checkpoints.

The port's ranks are gloo processes on the CPU in float64
(``_torch_distributed_worker.py``), two and four of them, started once for
the module with every scenario batched; the JAX side and the port's
unsharded runs are computed here, on the conftest's 8-device virtual mesh,
while the ranks run.  A rank that fails or hangs fails the tests.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_parity import CPU64, clustered, t64, to_np
import mellon_tpu
import mellon_tpu_torch
from mellon_tpu.inference import laplace as jax_laplace
from mellon_tpu.inference import mcmc as jax_mcmc
from mellon_tpu.inference.losses import density_loss as jax_density_loss
from mellon_tpu.parallel import mesh as jax_mesh
from mellon_tpu.parallel import shard_predict as jax_shard_predict
from mellon_tpu.parallel import sharded_loss_from_estimator as jax_sharded_loss
from mellon_tpu_torch import state_from_jax
from mellon_tpu_torch.inference import mcmc, smc
from mellon_tpu_torch.inference.diagnostics import summarize
from mellon_tpu_torch.inference.laplace import compute_laplace_std
from mellon_tpu_torch.inference.losses import (
    SHARDED_DERIVATIVES,
    density_hessian,
    density_hessian_diagonal,
    density_value_and_grad,
)
from mellon_tpu_torch.parallel.mesh import mesh_shape

import _torch_distributed_worker as worker

WORLDS = (2, 4)
SCENARIOS = ("mesh,loss,curvature,predict,hmc,smc,checkpoint,moments,precond_moments,replay,"
             "precond_replay")
RANK_TIMEOUT_S = 300
N_ODD = 299


@pytest.fixture(scope="module")
def fitted():
    """mellon_tpu's L-BFGS fit of tests/test_torch_mcmc.py (n = 300, d = 3,
    40 landmarks) and the port's estimator holding the same state."""
    x = clustered(300, 3, seed=80)
    jest = mellon_tpu.DensityEstimator(n_landmarks=40)
    jest.fit(jnp.asarray(x))
    return jest, state_from_jax(jest, **CPU64)


def _spawn(tmp, world, inputs):
    """Start the ranks of one gloo group; returns the processes."""
    out = tmp / f"out{world}"
    out.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    tests = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join([os.path.dirname(tests), tests, env.get("PYTHONPATH", "")])
    cmd = [sys.executable, os.path.join(tests, "_torch_distributed_worker.py"),
           str(tmp / f"store{world}"), str(world)]
    return [subprocess.Popen(cmd + [str(r), str(inputs), str(out), SCENARIOS], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _wait(procs):
    """Every rank's output; a rank that fails or outlasts the timeout (the
    others are then killed) fails the caller."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a rank hung; outputs so far: {logs}")
    for rank, p in enumerate(procs):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{logs[rank][-4000:]}"


def _jax_sharded(args, n_chains, n_cells):
    """The JAX package's zero-centred potential operands with L and the
    nearest-neighbour distances sharded over the cells of an n_chains x
    n_cells virtual mesh: (mesh, operands)."""
    mesh = jax_mesh.create_mesh(n_chains, n_cells, devices=jax.devices()[:n_chains * n_cells])
    L, nn, d, mu, offset = args
    return mesh, (jax.device_put(L, NamedSharding(mesh, P(jax_mesh.CELL_AXIS, None))),
                  jax.device_put(nn, NamedSharding(mesh, P(jax_mesh.CELL_AXIS))), d, mu, offset)


def _jax_replay(jest, args):
    """mellon_tpu's run_mcmc with the chains and the cells sharded on the
    2 x 4 virtual mesh, key 5."""
    mesh, sharded = _jax_sharded(args, 2, 4)
    return jax_mcmc.run_mcmc(jax_density_loss, jest.pre_transformation, jax.random.PRNGKey(5),
                             potential_args=sharded,
                             chain_sharding=NamedSharding(mesh, P(jax_mesh.CHAIN_AXIS, None)),
                             **worker.REPLAY_RUN)


def _jax_precond_replay(jest, args, world):
    """mellon_tpu's sample_density_posterior(precondition="hessian") flow on
    the potential with its cells sharded over the 1 x world virtual mesh:
    the Newton polish from the MAP, hessian_cholesky, T = R⁻ᵀ, run_mcmc in
    w from 0 on key 0, the draws unwhitened."""
    _, sharded = _jax_sharded(args, 1, world)
    z, _, _ = jax_mcmc.newton_polish(jax_density_loss, jest.pre_transformation, sharded)
    T = jax_mcmc.precondition_transform(
        jax_mcmc.hessian_cholesky(jax_density_loss, z, jnp.asarray(1e-6, z.dtype), *sharded))
    res = jax_mcmc.run_mcmc(jax_mcmc.preconditioned_potential(jax_density_loss), jnp.zeros_like(z),
                            jax.random.PRNGKey(0), potential_args=(T, z) + sharded,
                            **worker.REPLAY_RUN)
    return res._replace(samples=jax_mcmc.unwhiten_samples(res.samples, T, z))


def _precond_moments_reference(est):
    """The unsharded preconditioned run of the worker's precond_moments
    scenario: the whitening at the MAP, 16 chains from w = 0, seed 7."""
    z0 = est.pre_transformation
    vg, _ = mcmc.zero_centered_potential(z0, *est._loss_args)
    z_map, T, _ = mcmc.hessian_preconditioner(vg, lambda z: density_hessian(z, *est._loss_args), z0)
    run = worker.PRECOND_MOMENTS_RUN
    w0 = torch.zeros(run["num_chains"], z_map.shape[0], dtype=z_map.dtype)
    res = mcmc.run_mcmc(mcmc.preconditioned_potential(vg, T, z_map), w0,
                        torch.Generator().manual_seed(7), **run)
    return mcmc.unwhiten_samples(res.samples, T, z_map)


@pytest.fixture(scope="module")
def runs(fitted, tmp_path_factory):
    """The ranks' outputs at two and four ranks, with the references:
    ``{"ranks": {world: {scenario: [per rank]}}, "ref": {...}}``."""
    jest, est = fitted
    tmp = tmp_path_factory.mktemp("parallel")
    L, nn, d, mu = est._loss_args
    _, jax_args = jax_mcmc.zero_centered_potential(jax_density_loss, jest.pre_transformation,
                                                   jest._loss_args)
    rng = np.random.RandomState(90)
    data = dict(L=to_np(L), nn=to_np(nn), d=float(d), mu=float(mu),
                z_map=np.asarray(jest.pre_transformation),
                Z=np.asarray(jest.pre_transformation) + 0.3 * rng.randn(3, 40), n_odd=N_ODD,
                z_init=np.asarray(jest.initial_value),
                curvature_points=np.asarray(jest.pre_transformation) + [[0.0], [0.3]] * rng.randn(2, 40),
                Xq=clustered(63, 3, seed=91), smc_m=np.asarray([1.0, -0.5]), smc_s2=0.5)
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **data)
    est.predict.to_json(str(tmp / "predictor.json"))
    procs = {world: _spawn(tmp, world, inputs) for world in WORLDS}

    # the references, while the ranks run
    vg, _ = mcmc.zero_centered_potential(est.pre_transformation, *est._loss_args)
    ref = {
        "replay": _jax_replay(jest, jax_args),
        "precond_replay": {world: _jax_precond_replay(jest, jax_args, world) for world in WORLDS},
        "precond_moments": _precond_moments_reference(est),
        "hmc": mcmc.run_mcmc(vg, est.pre_transformation, torch.Generator().manual_seed(8),
                             **worker.HMC_RUN),
        "smc": smc.run_smc(worker.gaussian_loglik(data["smc_m"], data["smc_s2"]), 2,
                           torch.Generator().manual_seed(4), **worker.SMC_RUN),
        "moments": mcmc.run_mcmc(
            vg,
            est.pre_transformation.repeat(worker.MOMENTS_RUN["num_chains"], 1),
            torch.Generator().manual_seed(7), **worker.MOMENTS_RUN),
    }
    ranks = {}
    for world in WORLDS:
        _wait(procs[world])
        out = tmp / f"out{world}"
        ranks[world] = {name: [dict(np.load(out / f"{name}_rank{r}.npz")) for r in range(world)]
                        for name in SCENARIOS.split(",")}
    return {"ranks": ranks, "ref": ref, "data": data, "tmp": tmp, "jax_args": jax_args}


# a rank's own counts of its block's leaf loop
PER_RANK = ("host_reads", "num_evaluations")


def _same_on_every_rank(outputs):
    """Every rank returned the global result: the same arrays bit for bit."""
    for out in outputs[1:]:
        for key, value in outputs[0].items():
            if key not in PER_RANK:
                np.testing.assert_array_equal(out[key], value, err_msg=key)
    return outputs[0]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shapes_match_jax(n):
    """create_mesh's defaulting and its ValueError, for n devices, as the
    JAX package's over n of its virtual devices."""
    devices = jax.devices()[:n]
    for args in ((None, None), (None, 1), (1, None), (n, 1), (1, n), (2, None), (None, 2)):
        try:
            want = tuple(jax_mesh.create_mesh(*args, devices=devices).devices.shape)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                mesh_shape(*args, n)
            continue
        assert mesh_shape(*args, n) == want
    with pytest.raises(ValueError, match=f"Mesh {n + 1}x1 does not match {n} devices."):
        mesh_shape(n + 1, 1, n)


def test_one_rank_mesh_without_a_process_group():
    """Without a process group the mesh is one rank on the device asked
    for, and every sharding keeps the whole tensor."""
    m = mellon_tpu_torch.parallel.create_mesh(devices=["cpu"])
    assert m.shape == {"chains": 1, "cells": 1} and m.device == torch.device("cpu")
    t = torch.arange(6.0).reshape(3, 2)
    for sharding in (mellon_tpu_torch.parallel.chain_sharding(m),
                     mellon_tpu_torch.parallel.cell_sharding(m, ndim=2),
                     mellon_tpu_torch.parallel.replicated(m)):
        assert torch.equal(sharding.gather(sharding.shard(t)), t)
    with pytest.raises(ValueError, match="Mesh 2x1 does not match 1 devices."):
        mellon_tpu_torch.parallel.create_mesh(n_chains=2, n_cells=1, devices=["cpu"])


def test_estimator_samplers_forward_the_sharding(fitted):
    """sample_density_posterior forwards chain_sharding and
    smc_density_posterior forwards mesh to their samplers, as the JAX
    package's **kwargs do: on a one-rank mesh the runs equal the unsharded
    ones; anything else than a sharding is a TypeError."""
    _, est = fitted
    mesh = mellon_tpu_torch.parallel.create_mesh(devices=["cpu"])
    runs = [mcmc.sample_density_posterior(est, num_warmup=10, num_samples=5, seed=2,
                                          function_samples=False, **kw)[0]
            for kw in ({}, {"chain_sharding": mellon_tpu_torch.parallel.chain_sharding(mesh)})]
    assert torch.equal(runs[0].samples, runs[1].samples)
    sweeps = [smc.smc_density_posterior(est, num_particles=64, seed=2, **kw)[0]
              for kw in ({}, {"mesh": mesh})]
    assert torch.equal(sweeps[0].particles, sweeps[1].particles)
    with pytest.raises(TypeError, match="chain_sharding must be a sharding"):
        mcmc.sample_density_posterior(est, num_warmup=10, num_samples=5, chain_sharding=mesh)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_build_the_mesh_as_jax(runs, world):
    """On the ranks: the default mesh puts every rank on the chains axis,
    n_cells fills the other, the product is checked, and rank r sits at
    (r // n_cells, r % n_cells)."""
    outs = runs["ranks"][world]["mesh"]
    for rank, out in enumerate(outs):
        assert out["shapes"].tolist() == [[world, 1], [1, world]]
        assert out["default"].tolist() == [world, 1] and out["by_cells"].tolist() == [1, world]
        assert str(out["error"]) == f"Mesh {world + 1}x1 does not match {world} devices."
        n_cells = world // (2 if world > 2 else 1)
        assert out["coords"].tolist() == [rank // n_cells, rank % n_cells]


@pytest.mark.parametrize("world", WORLDS)
def test_cell_sharded_loss_matches_jax_and_local(runs, fitted, world):
    """The cell-sharded loss and gradient on the 1 x world mesh against
    mellon_tpu's sharded_loss_from_estimator on 1 x world virtual devices
    and against the port's local loss (1e-10 relative, tests/test_mcmc.py's
    bar); the potential zero-centred at the MAP, sharded (center=, the
    offset taken from the global operands), is the local zero-centred one
    there; uneven cell
    blocks (299 cells) agree with the local loss too."""
    jest, est = fitted
    out = _same_on_every_rank(runs["ranks"][world]["loss"])
    Z = runs["data"]["Z"]
    jloss = jax_sharded_loss(jest, jax_mesh.create_mesh(1, world, devices=jax.devices()[:world]))
    L, nn, d, mu = est._loss_args
    for i, z in enumerate(Z):
        want_jax = float(jax.jit(jloss)(jnp.asarray(z)))
        g_jax = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(z)))
        v_loc, g_loc = density_value_and_grad(t64(z), L, nn, d, mu)
        for got in (out["values"][i], out["batch_values"][i]):
            np.testing.assert_allclose(got, want_jax, rtol=1e-10)
            np.testing.assert_allclose(got, float(v_loc), rtol=1e-10)
        np.testing.assert_allclose(out["grads"][i], g_jax, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(out["grads"][i], to_np(g_loc), rtol=1e-10, atol=1e-10)
        v_odd, g_odd = density_value_and_grad(t64(z), L[:N_ODD], nn[:N_ODD], d, mu)
        np.testing.assert_allclose(out["odd_values"][i], float(v_odd), rtol=1e-10)
        np.testing.assert_allclose(out["odd_grads"][i], to_np(g_odd), rtol=1e-10, atol=1e-10)
    vg, _ = mcmc.zero_centered_potential(est.pre_transformation, *est._loss_args)
    v_map, g_map = vg(est.pre_transformation[None])
    v0 = float(density_value_and_grad(est.pre_transformation, L, nn, d, mu)[0])
    # the centred value is the small residue of an O(n) loss: held to 1e-10 of loss(z0)
    np.testing.assert_allclose(out["centred_at_map"], to_np(v_map), rtol=0, atol=1e-10 * abs(v0))
    np.testing.assert_allclose(out["centred_grad"], to_np(g_map), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_curvature_matches_jax_and_local(runs, fitted, world):
    """loss_func.hessian and loss_func.hessian_diagonal on 1 x 2 and 2 x 2
    (each cells group's all_reduce) at the MAP and at a point away from
    it: the JAX package's hessian_cholesky on the cells sharded over the
    same virtual mesh (R Rᵀ − jitter·I) and its laplace.hessian_diagonal
    there, and the port's whole-L density_hessian and
    density_hessian_diagonal, all within 1e-10."""
    _, est = fitted
    out = _same_on_every_rank(runs["ranks"][world]["curvature"])
    _, sharded = _jax_sharded(runs["jax_args"], world // 2, 2)
    jitter = 1e-6
    for i, z in enumerate(runs["data"]["curvature_points"]):
        R = np.asarray(jax_mcmc.hessian_cholesky(jax_density_loss, jnp.asarray(z),
                                                 jnp.asarray(jitter), *sharded))
        H_jax = R @ R.T - jitter * np.eye(len(z))
        diag_jax = np.asarray(jax_laplace.hessian_diagonal(jax_density_loss, jnp.asarray(z),
                                                           loss_args=sharded))
        H_local = to_np(density_hessian(t64(z), *est._loss_args))
        diag_local = to_np(density_hessian_diagonal(t64(z), *est._loss_args))
        for want in (H_jax, H_local):
            np.testing.assert_allclose(out["hessian"][i], want, rtol=1e-10, atol=1e-10)
        for want in (diag_jax, diag_local):
            np.testing.assert_allclose(out["diagonal"][i], want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_newton_polish_and_preconditioner(runs, fitted, world):
    """newton_polish of the zero-centred sharded potential with the sharded
    Hessian (1 x 2, 2 x 2) from the warm start: the JAX package's
    newton_polish on the sharded operands within 1e-8 (z, ‖g‖ before and
    after).  hessian_preconditioner from the MAP with the chains split:
    z* and T equal on every rank and within 1e-8 of the whole-L ones."""
    jest, est = fitted
    out = _same_on_every_rank(runs["ranks"][world]["curvature"])
    _, sharded = _jax_sharded(runs["jax_args"], world // 2, 2)
    z_j, gn0_j, gn1_j = jax_mcmc.newton_polish(jax_density_loss, jest.initial_value, sharded)
    np.testing.assert_allclose(out["z_polish"], np.asarray(z_j), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(out["grad_norms"], [gn0_j, gn1_j], rtol=1e-8, atol=1e-8)
    assert out["grad_norms"][1] < 1e-6 * out["grad_norms"][0]
    vg, _ = mcmc.zero_centered_potential(est.pre_transformation, *est._loss_args)
    z_star, T, _ = mcmc.hessian_preconditioner(
        vg, lambda z: density_hessian(z, *est._loss_args), est.pre_transformation)
    np.testing.assert_allclose(out["z_star"], to_np(z_star), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(out["T"], to_np(T), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_laplace_hessian_diagonal_refuses_a_sharded_loss(runs, fitted, world):
    """laplace.hessian_diagonal (torch.func) of a cell-sharded loss raises
    losses.SHARDED_DERIVATIVES instead of returning the rank's part of the
    diagonal; the sharded closed form gives the Laplace stds of the whole
    model (the port's and the JAX package's compute_laplace_std on the
    sharded operands, 1e-10)."""
    jest, est = fitted
    out = _same_on_every_rank(runs["ranks"][world]["curvature"])
    assert str(out["error"]) == SHARDED_DERIVATIVES
    want = compute_laplace_std(density_hessian_diagonal(est.pre_transformation, *est._loss_args))
    np.testing.assert_allclose(out["laplace_std"], to_np(want), rtol=1e-10)
    _, sharded = _jax_sharded(runs["jax_args"], world // 2, 2)
    want_jax = jax_laplace.compute_laplace_std(jax_density_loss, jest.pre_transformation,
                                               loss_args=sharded)
    np.testing.assert_allclose(out["laplace_std"], np.asarray(want_jax), rtol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_shard_predict_ragged_matches_jax_and_local(runs, fitted, world):
    """shard_predict on 1 x world at 63 query rows (a padded tail block)
    against the port's predictor on all rows and mellon_tpu's shard_predict
    on the rows that divide over its mesh, normalize too: 1e-10."""
    jest, est = fitted
    out = _same_on_every_rank(runs["ranks"][world]["predict"])
    Xq = runs["data"]["Xq"]
    assert out["mean"].shape == (63,)
    np.testing.assert_allclose(out["mean"], to_np(est.predict(Xq)), rtol=0, atol=1e-10)
    np.testing.assert_allclose(out["normalized"], to_np(est.predict(Xq, normalize=True)),
                               rtol=0, atol=1e-10)
    rows = 63 // world * world
    jpredict = jax_shard_predict(jest.predict,
                                 jax_mesh.create_mesh(1, world, devices=jax.devices()[:world]))
    np.testing.assert_allclose(out["mean"][:rows], np.asarray(jpredict(jnp.asarray(Xq[:rows]))),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(out["normalized"][:rows],
                               np.asarray(jpredict(jnp.asarray(Xq[:rows]), normalize=True)),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_chain_sharded_nuts_replays_jax(runs, world):
    """Chain-sharded NUTS on 2 x 1 and 2 x 2, cells sharded on the latter,
    each rank replaying its chains' keys: mellon_tpu's run_mcmc with
    chain_sharding on the 2 x 4 virtual mesh, to 1e-8 (samples,
    potentials, acceptance, step size, mass); steps and divergences
    exactly."""
    out = _same_on_every_rank(runs["ranks"][world]["replay"])
    want = runs["ref"]["replay"]
    for name in ("samples", "potential", "accept_prob", "step_size", "inv_mass_diag"):
        np.testing.assert_allclose(out[name], np.asarray(getattr(want, name)), rtol=1e-8,
                                   atol=1e-8, err_msg=name)
    np.testing.assert_array_equal(out["num_leapfrog"], np.asarray(want.num_leapfrog))
    np.testing.assert_array_equal(out["diverging"], np.asarray(want.diverging))


@pytest.mark.parametrize("world", WORLDS)
def test_chain_sharded_nuts_moments_and_distinct_streams(runs, world):
    """Chain-sharded NUTS from torch's generator (16 chains, 300 + 400,
    all starting at the MAP): split-R-hat < 1.05 and the moment bars of
    tests/test_multidevice_e2e.py against the unsharded run of the same
    seed (means within 0.08, std ratio in (0.85, 1.18)); the two ranks'
    blocks of chains differ (a rank draws its own rows of the global
    stream, never another rank's)."""
    out = _same_on_every_rank(runs["ranks"][world]["moments"])
    samples = out["samples"]
    local = summarize(runs["ref"]["moments"].samples)
    sharded = summarize(torch.as_tensor(samples))
    assert np.all(to_np(sharded["rhat"]) < 1.05) and np.all(to_np(local["rhat"]) < 1.05)
    np.testing.assert_allclose(to_np(sharded["mean"]), to_np(local["mean"]), atol=0.08)
    ratio = to_np(sharded["std"]) / to_np(local["std"])
    assert ratio.min() > 0.85 and ratio.max() < 1.18
    half = samples.shape[0] // 2
    assert not np.any(np.all(samples[:half, :5] == samples[half:, :5], axis=(1, 2)))
    assert np.all(np.abs(samples[:half, 0] - samples[half:, 0]).max(axis=1) > 0)


@pytest.mark.parametrize("world", WORLDS)
def test_cell_sharded_preconditioned_nuts_replays_jax(runs, world):
    """Hessian-preconditioned NUTS on 1 x 2 and 1 x 4 (the cells sharded,
    the chains whole), the whitening built by hessian_preconditioner from
    the sharded potential and Hessian, on the JAX package's draws: its
    sample_density_posterior(precondition="hessian") flow on the cells
    sharded over the same virtual mesh, to 1e-8 (unwhitened samples,
    potentials, acceptance, step size, mass); steps and divergences
    exactly."""
    out = _same_on_every_rank(runs["ranks"][world]["precond_replay"])
    want = runs["ref"]["precond_replay"][world]
    for name in ("samples", "potential", "accept_prob", "step_size", "inv_mass_diag"):
        np.testing.assert_allclose(out[name], np.asarray(getattr(want, name)), rtol=1e-8,
                                   atol=1e-8, err_msg=name)
    np.testing.assert_array_equal(out["num_leapfrog"], np.asarray(want.num_leapfrog))
    np.testing.assert_array_equal(out["diverging"], np.asarray(want.diverging))


@pytest.mark.parametrize("world", WORLDS)
def test_chain_sharded_preconditioned_nuts_moments(runs, world):
    """Chain-sharded preconditioned NUTS on 2 x 1 and 2 x 2 (16 chains from
    w = 0, seed 7, z* and T broadcast from rank 0) against the unsharded
    preconditioned run of the same seed, with the bars of
    test_chain_sharded_nuts_moments_and_distinct_streams: split-R-hat <
    1.05, means within 0.08, std ratio in (0.85, 1.18); the two chain
    blocks differ."""
    samples = _same_on_every_rank(runs["ranks"][world]["precond_moments"])["samples"]
    local = summarize(runs["ref"]["precond_moments"])
    sharded = summarize(torch.as_tensor(samples))
    assert np.all(to_np(sharded["rhat"]) < 1.05) and np.all(to_np(local["rhat"]) < 1.05)
    np.testing.assert_allclose(to_np(sharded["mean"]), to_np(local["mean"]), atol=0.08)
    ratio = to_np(sharded["std"]) / to_np(local["std"])
    assert ratio.min() > 0.85 and ratio.max() < 1.18
    half = samples.shape[0] // 2
    assert np.all(np.abs(samples[:half, 0] - samples[half:, 0]).max(axis=1) > 0)


@pytest.mark.parametrize("world", WORLDS)
def test_hmc_sharded_equals_unsharded(runs, world):
    """Fixed-step HMC with its chains over 2 and 4 ranks is the unsharded
    run of the same seed (the global mean and Welford's merge sum in
    another order: 1e-10)."""
    out = _same_on_every_rank(runs["ranks"][world]["hmc"])
    want = runs["ref"]["hmc"]
    for name in ("samples", "potential", "accept_prob", "step_size", "inv_mass_diag"):
        np.testing.assert_allclose(out[name], to_np(getattr(want, name)), rtol=1e-10,
                                   atol=1e-10, err_msg=name)
    np.testing.assert_array_equal(out["diverging"], to_np(want.diverging))


@pytest.mark.parametrize("world", WORLDS)
def test_smc_sharded_equals_unsharded(runs, world):
    """SMC with its 2,048 particles over 2 and 4 ranks is the unsharded
    sweep of the same seed (1e-10), and meets tests/test_smc.py's bars:
    the analytic posterior's mean (0.08) and std (15%), β = 1."""
    out = _same_on_every_rank(runs["ranks"][world]["smc"])
    want = runs["ref"]["smc"]
    np.testing.assert_allclose(out["particles"], to_np(want.particles), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(out["betas"], want.betas, rtol=1e-10)
    np.testing.assert_allclose(out["ess"], want.ess_history, rtol=1e-10)
    np.testing.assert_allclose(out["accept"], want.acceptance_history, rtol=1e-10)
    np.testing.assert_allclose(out["log_evidence"], want.log_evidence, rtol=1e-10)
    np.testing.assert_allclose(out["final_log_w"], to_np(want.final_stage_log_weights),
                               rtol=1e-10, atol=1e-10)
    m, s2 = runs["data"]["smc_m"], runs["data"]["smc_s2"]
    post_prec = 1 + 1 / s2
    np.testing.assert_allclose(out["particles"].mean(axis=0), (m / s2) / post_prec, atol=0.08)
    np.testing.assert_allclose(out["particles"].std(axis=0), 1 / np.sqrt(post_prec), rtol=0.15)
    assert float(out["betas"][-1]) == 1.0


@pytest.mark.parametrize("world", WORLDS)
def test_checkpoint_saved_by_rank_zero_resumes_on_another_mesh(runs, world):
    """tests/test_checkpoint_reshard.py's check for the port: each rank
    saves its block of the chains, rank 0 writes the gathered checkpoint,
    and every rank resumes it on another mesh (1 x 2 after 2 x 1; 2 x 2
    after 4 x 1, the cells sharded) without warmup: the loaded chains are
    the run's, the step size survives, and the resumed potentials sit in
    the stationary band of the first run's draws from the first draw on."""
    out = _same_on_every_rank(runs["ranks"][world]["checkpoint"])
    assert out["mesh_b"].tolist() == ([1, 2] if world == 2 else [2, 2])
    np.testing.assert_array_equal(out["loaded_samples"], out["samples"])
    np.testing.assert_array_equal(out["loaded_state"], out["samples"][:, -1])
    assert float(out["loaded_step_size"]) == float(out["step_size"]) == float(out["resumed_step_size"])
    assert out["resumed_samples"].shape == (8, 40, 40)
    assert np.all(np.isfinite(out["resumed_samples"]))
    pots_a, pots_b = out["potential"], out["resumed_potential"]
    assert abs(pots_b[:, :10].mean() - pots_a.mean()) < 4 * pots_a.std()
    scale = max(float(out["samples"].std()), 1e-3)
    np.testing.assert_allclose(out["samples"].mean(axis=(0, 1)),
                               out["resumed_samples"].mean(axis=(0, 1)), atol=0.75 * scale)
    written = runs["tmp"] / f"out{world}"
    assert (written / "ckpt.npz").exists() and (written / "ckpt.json").exists()
