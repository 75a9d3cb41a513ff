"""One rank of the gloo process group that tests/test_torch_parallel.py
starts on the CPU (float64).

    python _torch_distributed_worker.py STORE WORLD RANK INPUTS OUT_DIR SCENARIOS

STORE is the path of the group's FileStore, INPUTS an .npz of the test's
numpy operands (and ``predictor.json`` beside it), SCENARIOS a comma-
separated list of the functions below; each writes its outputs to
``OUT_DIR/<scenario>_rank<RANK>.npz``.  Only the replay scenario imports
JAX, to rebuild mellon_tpu's draws.
"""

import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

import mellon_tpu_torch as mt
from mellon_tpu_torch.inference import laplace, mcmc, samplers, smc
from mellon_tpu_torch.parallel import (
    chain_sharding,
    create_mesh,
    distributed_initialize,
    load_sampler_state,
    save_sampler_state,
    shard_density_model,
    shard_predict,
    sharded_loss_from_estimator,
)

# the settings of tests/test_torch_mcmc.py's replayed runs
REPLAY_RUN = dict(num_warmup=20, num_samples=10, num_chains=4, max_tree_depth=5)
MOMENTS_RUN = dict(num_warmup=300, num_samples=400, num_chains=16, max_tree_depth=6)
HMC_RUN = dict(algorithm="hmc", num_warmup=30, num_samples=20, num_chains=8,
               num_leapfrog_steps=8, target_accept=0.95)
PRECOND_MOMENTS_RUN = dict(num_warmup=200, num_samples=400, num_chains=16, max_tree_depth=6)
SMC_RUN = dict(num_particles=2048, num_mutation_steps=5, dtype=torch.float64)
CHECKPOINT_RUN = dict(num_warmup=40, num_samples=40, num_chains=8, max_tree_depth=5)


def t64(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def np_out(**arrays):
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in arrays.items()}


def operands(data):
    return t64(data["L"]), t64(data["nn"]), float(data["d"]), float(data["mu"])


def mesh_of(world, n_chains):
    return create_mesh(n_chains=n_chains, n_cells=world // n_chains, devices=["cpu"] * world)


def gaussian_loglik(m, s2):
    m = t64(m)

    def loglik(Z):
        d = Z - m
        return -0.5 * torch.sum(d * d, dim=1) / s2 - 0.5 * Z.shape[1] * np.log(2 * np.pi * s2), -d / s2

    return loglik


def scenario_mesh(data, world):
    """create_mesh's defaults, coordinates and refusal over the world."""
    shapes = [list(mesh_of(world, n).shape.values()) for n in (world, 1)]
    default = create_mesh(devices=["cpu"] * world)
    by_cells = create_mesh(n_cells=world, devices=["cpu"] * world)
    try:
        create_mesh(n_chains=world + 1, n_cells=1, devices=["cpu"] * world)
        error = ""
    except ValueError as e:
        error = str(e)
    return np_out(shapes=shapes, default=list(default.shape.values()),
                  by_cells=list(by_cells.shape.values()),
                  coords=list(mesh_of(world, 2 if world > 2 else 1).coords.values()),
                  error=error)


def scenario_loss(data, world):
    """The cell-sharded loss at each z of ``Z`` and its batched value and
    gradient on the 1 x world mesh; the potential zero-centred at the MAP
    (center=, its offset from the global operands) there; the loss on the first
    ``n_odd`` cells (uneven blocks)."""
    L, nn, d, mu = operands(data)
    Z = t64(data["Z"])
    mesh = mesh_of(world, 1)
    est = type("Prepared", (), dict(L=L, nn_distances=nn, d=d, mu=mu))()
    loss = sharded_loss_from_estimator(est, mesh)
    values = torch.stack([loss(z) for z in Z])
    batch_values, grads = loss.value_and_grad(Z)
    z_map = t64(data["z_map"])
    centred, _ = shard_density_model(nn, d, mu, L, mesh, center=z_map)
    centred_at_map, centred_grad = centred.value_and_grad(z_map[None])
    n_odd = int(data["n_odd"])
    odd_loss, _ = shard_density_model(nn[:n_odd], d, mu, L[:n_odd], mesh)
    odd_values, odd_grads = odd_loss.value_and_grad(Z)
    return np_out(values=values, batch_values=batch_values, grads=grads,
                  centred_at_map=centred_at_map, centred_grad=centred_grad,
                  odd_values=odd_values, odd_grads=odd_grads)


def scenario_predict(data, world):
    """shard_predict on the 1 x world mesh at a ragged number of rows."""
    pred = mt.Predictor.from_json(data["predictor_json"].item(), device="cpu",
                                  dtype=torch.float64)
    predict = shard_predict(pred, create_mesh(1, world, devices=["cpu"] * world))
    Xq = t64(data["Xq"])
    return np_out(mean=predict(Xq), normalized=predict(Xq, normalize=True))


def _cell_sharded_potential(data, mesh):
    L, nn, d, mu = operands(data)
    loss, _ = shard_density_model(nn, d, mu, L, mesh, center=t64(data["z_map"]))
    return loss.value_and_grad


def _replaying_jax_steps(fn):
    """``fn()`` with NUTS counting a doubling's leapfrogs as JAX does."""
    own_count = samplers._subtree_steps
    samplers._subtree_steps = lambda leaves, depth: torch.full_like(leaves, 2**depth)
    try:
        return fn()
    finally:
        samplers._subtree_steps = own_count


def scenario_replay(data, world):
    """Chain-sharded NUTS on the 2 x (world / 2) mesh, cells sharded too,
    on mellon_tpu's draws of key 5 (each rank replays its block of the
    chains' keys), counting steps as the JAX package does."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from _torch_parity import JaxReplayDraws

    class BlockReplay(JaxReplayDraws):
        """The replay of a block of the chains: the transitions' keys are
        split for every chain, and this rank keeps its block's."""

        def momentum(self, shape, like):
            if self.block is not None and self._keys is None:
                start, stop, total = self.block
                base, n = self._pending
                self._keys = jax.random.split(base, (n, total))[:, start:stop]
            return super().momentum(shape, like)

    mesh = mesh_of(world, 2)
    res = _replaying_jax_steps(lambda: mcmc.run_mcmc(
        _cell_sharded_potential(data, mesh), t64(data["z_map"]), BlockReplay(jax.random.PRNGKey(5)),
        chain_sharding=chain_sharding(mesh), **REPLAY_RUN))
    return np_out(**res._asdict())


def scenario_curvature(data, world):
    """The cell-sharded Hessian and its diagonal at each row of
    ``curvature_points`` on the (world / 2) x 2 mesh (1 x 2, 2 x 2); the
    Laplace stds from the sharded diagonal at the MAP and the refusal of
    laplace.hessian_diagonal; the Newton polish of the sharded potential,
    zero-centred at the MAP, from the warm start; the preconditioner from
    the MAP with the chains split (z* and T: rank 0's, broadcast)."""
    L, nn, d, mu = operands(data)
    mesh = mesh_of(world, world // 2)
    z_map = t64(data["z_map"])
    loss, _ = shard_density_model(nn, d, mu, L, mesh, center=z_map)
    points = t64(data["curvature_points"])
    try:
        laplace.hessian_diagonal(loss, z_map)
        error = ""
    except RuntimeError as e:
        error = str(e)
    z_polish, gn0, gn1 = mcmc.newton_polish(loss.value_and_grad, loss.hessian, t64(data["z_init"]))
    z_star, T, _ = mcmc.hessian_preconditioner(loss.value_and_grad, loss.hessian, z_map,
                                               chain_sharding=chain_sharding(mesh))
    return np_out(hessian=torch.stack([loss.hessian(z) for z in points]),
                  diagonal=torch.stack([loss.hessian_diagonal(z) for z in points]),
                  laplace_std=laplace.compute_laplace_std(loss.hessian_diagonal(z_map)),
                  error=error, z_polish=z_polish, grad_norms=[gn0, gn1], z_star=z_star, T=T)


def _preconditioned_run(data, mesh, draws, sharding, rows, **run):
    """Hessian-preconditioned NUTS on the cell-sharded potential of
    ``mesh``, centred at the MAP as zero_centered_potential centres it, from
    w = 0 (one row, jittered per chain, or ``rows`` rows),
    the whitening taken at the MAP: the draws unwhitened to z."""
    L, nn, d, mu = operands(data)
    z0 = t64(data["z_map"])
    loss, _ = shard_density_model(nn, d, mu, L, mesh, center=z0)
    z_map, T, _ = mcmc.hessian_preconditioner(loss.value_and_grad, loss.hessian, z0,
                                              chain_sharding=sharding)
    w0 = torch.zeros_like(z_map)
    res = mcmc.run_mcmc(mcmc.preconditioned_potential(loss.value_and_grad, T, z_map),
                        w0.repeat(rows, 1) if rows else w0, draws, chain_sharding=sharding, **run)
    return res._replace(samples=mcmc.unwhiten_samples(res.samples, T, z_map))


def scenario_precond_replay(data, world):
    """Hessian-preconditioned NUTS on the 1 x world mesh (the cells sharded,
    the chains not) on mellon_tpu's draws of key 0, counting steps as the
    JAX package does: its sample_density_posterior(precondition="hessian")
    flow on the sharded potential."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from _torch_parity import JaxReplayDraws

    res = _replaying_jax_steps(lambda: _preconditioned_run(
        data, mesh_of(world, 1), JaxReplayDraws(jax.random.PRNGKey(0)), None, 0, **REPLAY_RUN))
    return np_out(**res._asdict())


def scenario_precond_moments(data, world):
    """Chain-sharded preconditioned NUTS on the 2 x (world / 2) mesh from
    torch's generator (seed 7), every chain starting at w = 0."""
    mesh = mesh_of(world, 2)
    res = _preconditioned_run(data, mesh, torch.Generator().manual_seed(7), chain_sharding(mesh),
                              PRECOND_MOMENTS_RUN["num_chains"], **PRECOND_MOMENTS_RUN)
    return np_out(samples=res.samples)


def scenario_moments(data, world):
    """Chain-sharded NUTS on the 2 x (world / 2) mesh from torch's
    generator (seed 7), every chain starting at the MAP."""
    mesh = mesh_of(world, 2)
    z0 = t64(data["z_map"]).repeat(MOMENTS_RUN["num_chains"], 1)
    res = mcmc.run_mcmc(_cell_sharded_potential(data, mesh), z0,
                        torch.Generator().manual_seed(7), chain_sharding=chain_sharding(mesh),
                        **MOMENTS_RUN)
    return np_out(samples=res.samples, step_size=res.step_size)


def scenario_hmc(data, world):
    """Fixed-step HMC with the chains over every rank (world x 1), seed 8."""
    L, nn, d, mu = operands(data)
    vg, _ = mcmc.zero_centered_potential(t64(data["z_map"]), L, nn, d, mu)
    res = mcmc.run_mcmc(vg, t64(data["z_map"]), torch.Generator().manual_seed(8),
                        chain_sharding=chain_sharding(mesh_of(world, world)), **HMC_RUN)
    return np_out(**res._asdict())


def scenario_smc(data, world):
    """SMC with the particles over every rank (world x 1), seed 4, on the
    Gaussian likelihood of tests/test_smc.py."""
    res = smc.run_smc(gaussian_loglik(data["smc_m"], float(data["smc_s2"])), 2,
                      torch.Generator().manual_seed(4), mesh=mesh_of(world, world), **SMC_RUN)
    return np_out(particles=res.particles, betas=res.betas, ess=res.ess_history,
                  accept=res.acceptance_history, log_evidence=res.log_evidence,
                  final_log_w=res.final_stage_log_weights)


def scenario_checkpoint(data, world):
    """NUTS with the chains over every rank (world x 1), seed 9; each rank
    saves its block of the chains (gathered, rank 0 writes); every rank
    loads the checkpoint and resumes on another mesh, the cells sharded
    (1 x 2 at two ranks, 2 x 2 at four), seed 10."""
    mesh_a = mesh_of(world, world)
    vg = _cell_sharded_potential(data, mesh_a)
    res = mcmc.run_mcmc(vg, t64(data["z_map"]), torch.Generator().manual_seed(9),
                        chain_sharding=chain_sharding(mesh_a), **CHECKPOINT_RUN)
    block = chain_sharding(mesh_a)
    path = os.path.join(str(data["out_dir"]), "ckpt")
    save_sampler_state(path, samples=block.shard(res.samples), state=block.shard(res.samples[:, -1]),
                       step_size=res.step_size, inv_mass_diag=res.inv_mass_diag,
                       rng_key=torch.Generator().manual_seed(11), metadata={"algorithm": "nuts"},
                       chain_sharding=block)
    loaded = load_sampler_state(path)
    mesh_b = mesh_of(world, 1 if world == 2 else 2)
    resumed = mcmc.resume_mcmc(_cell_sharded_potential(data, mesh_b), loaded["state"][0],
                               torch.Generator().manual_seed(10), loaded["step_size"],
                               loaded["inv_mass_diag"], num_samples=40, max_tree_depth=5,
                               chain_sharding=chain_sharding(mesh_b))
    return np_out(samples=res.samples, potential=res.potential, step_size=res.step_size,
                  inv_mass_diag=res.inv_mass_diag, loaded_samples=loaded["samples"],
                  loaded_state=loaded["state"][0], loaded_step_size=loaded["step_size"],
                  mesh_b=list(mesh_b.shape.values()), resumed_samples=resumed.samples,
                  resumed_potential=resumed.potential, resumed_step_size=resumed.step_size)


SCENARIOS = {name[len("scenario_"):]: fn for name, fn in globals().items()
             if name.startswith("scenario_")}


def main():
    store, world, rank, inputs, out_dir, scenarios = sys.argv[1:7]
    world, rank = int(world), int(rank)
    torch.set_num_threads(1)
    init = dict(store=dist.FileStore(store, world), rank=rank, world_size=world,
                timeout=datetime.timedelta(seconds=60))
    distributed_initialize(backend="gloo", device="cpu", **init)
    distributed_initialize(backend="gloo", device="cpu", **init)  # a second call returns
    data = dict(np.load(inputs))
    data["predictor_json"] = np.asarray(os.path.join(os.path.dirname(inputs), "predictor.json"))
    data["out_dir"] = np.asarray(out_dir)
    for name in scenarios.split(","):
        out = SCENARIOS[name](data, world)
        np.savez(os.path.join(out_dir, f"{name}_rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
