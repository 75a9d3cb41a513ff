"""Hessian-preconditioned NUTS on a (chains × cells) mesh of ranks, one
process per device: the sampler of ``drivers/nuts.py`` with the rows of L
split over the mesh's cells axis and the chains over its chains axis, as
a user who samples an atlas on several GPUs runs it, through
``parallel.create_mesh``, ``parallel.shard_density_model(..., center=)``,
``mcmc.hessian_preconditioner(..., chain_sharding=)``, ``run_mcmc`` for
the warm-up and ``resume_mcmc`` in the window, both with
``chain_sharding``.

Every rank makes the same cells from the seed and fits them (the ranks'
fits are checked to be the same), keeps its block of L's rows and frees
the global L.  Each leaf's potential sums its cells with one
``all_reduce`` over the cells axis; each ``resume_mcmc`` call ends by
gathering the chains to every rank.  The window stops by rank 0's clock,
broadcast after every block, so that every rank runs the same blocks.

Traffic parameters: ``mesh`` ([chains axis, cells axis], whose product is
the cell's chips), ``chains`` (all of them, split evenly over the chains
axis), ``warmup``, ``block_transitions``.

``ess_per_s`` and the traced run's ``nuts.ess_per_draw`` are those of
``drivers/nuts.py`` over every chain, on rank 0.  The traced run's
``shapes`` are a rank's share (its cells and its chains), which the
leaf's roofline takes.

The comparison is ``drivers/nuts.py``'s, on rank 0, of rank 0's draws:
every rank gets them, each rank of rank 0's cells group works out
f = L z + μ on its block, and rank 0 gathers f at every cell.  Two exact
numbers read the chains axis's exchange, which the pooled draws cannot:
each chain's draws on rank 0 against the rank that sampled them, and the
chains that never move."""

import hashlib
import math
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from benchmark import fitcheck
from benchmark.data import mixture_cells
from benchmark.drivers import nuts
from benchmark.drivers.nuts import DRAW_BLOCK, control  # noqa: F401
from benchmark.ess import ess_by_blocks, ess_from_lag0


def setup(ctx):
    import mellon_tpu_torch as mt
    from mellon_tpu_torch import parallel
    from mellon_tpu_torch.inference import mcmc

    cfg, tr = ctx.config, ctx.traffic
    x = mixture_cells(cfg["cells"], cfg["dims"], ctx.seed)
    est = mt.DensityEstimator(device=ctx.device, **cfg.get("estimator", {}))
    est.fit(x, build_predict=False)
    mesh = parallel.create_mesh(*tr["mesh"], devices=ctx.devices)
    _same_fit_on_every_rank(est, ctx.world)
    z0 = est.pre_transformation.reshape(-1)
    loss, (_, L_block) = parallel.shard_density_model(
        est.nn_distances, est.d, est.mu, est.L, mesh, center=z0)
    fit = fitcheck.fit_outputs(est, ctx.seed, cfg) if ctx.rank == 0 else None
    mu, n = est.mu, est.L.shape[0]
    held = torch.cuda.memory_allocated() if ctx.device != "cpu" else 0
    del est
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
        print(f"rank {ctx.rank}: the global fit freed, {held - torch.cuda.memory_allocated()} "
              f"bytes; L's block {L_block.numel() * L_block.element_size()} bytes",
              file=sys.stderr)
    sharding = parallel.chain_sharding(mesh)
    z_map, T, _ = mcmc.hessian_preconditioner(loss.value_and_grad, loss.hessian, z0,
                                              chain_sharding=sharding)
    potential = mcmc.precondition_value_and_grad(loss.value_and_grad, T, z_map)
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    warm = mcmc.run_mcmc(potential, torch.zeros_like(z_map), gen, num_warmup=tr["warmup"],
                         num_samples=1, num_chains=tr["chains"], chain_sharding=sharding)
    ctx.state.update(x=x if ctx.rank == 0 else None, fit=fit, n=n, mesh=mesh,
                     sharding=sharding, L_block=L_block, mu=mu, z_map=z_map, T=T,
                     potential=potential, gen=gen, step=warm.step_size,
                     mass=warm.inv_mass_diag, w=warm.samples[:, -1])
    _block(ctx, tr["block_transitions"])  # the window's call, once


def _same_fit_on_every_rank(est, world):
    """RuntimeError unless every rank's fit has the same landmarks, MAP
    and every 1,000th row of L, bit for bit."""
    digest = hashlib.sha256()
    for t in (est.landmarks, est.pre_transformation, est.L[::1000]):
        digest.update(t.detach().contiguous().cpu().numpy().tobytes())
    digests = [None] * world
    dist.all_gather_object(digests, digest.hexdigest())
    if len(set(digests)) != 1:
        raise RuntimeError(f"the ranks' fits of the same cells differ: {digests}")


def _block(ctx, transitions):
    from mellon_tpu_torch.inference import mcmc

    s = ctx.state
    res = mcmc.resume_mcmc(s["potential"], s["w"], s["gen"], s["step"], s["mass"],
                           num_samples=transitions, chain_sharding=s["sharding"])
    s["w"] = res.samples[:, -1]
    return res


def _first_rank_says(ctx, flag):
    """Rank 0's ``flag`` on every rank."""
    t = torch.tensor([1.0 if flag else 0.0], device=ctx.device)
    dist.broadcast(t, src=0)
    return bool(t.item())


def window(ctx):
    from mellon_tpu_torch.inference import mcmc

    s = ctx.state
    chains = ctx.traffic["chains"]
    block_chains = chains // s["sharding"].size
    blocks = []
    t0 = time.perf_counter()
    while True:
        with ctx.span("nuts.block"):
            res = _block(ctx, ctx.traffic["block_transitions"])
        ctx.count("leaves", res.num_evaluations // block_chains)
        ctx.count("host_reads", res.host_reads)
        blocks.append(res)
        if _first_rank_says(ctx, time.perf_counter() - t0 >= ctx.seconds):
            break
    elapsed = time.perf_counter() - t0
    W = torch.cat([b.samples for b in blocks], dim=1)
    Z = mcmc.unwhiten_samples(W, s["T"], s["z_map"])
    s.update(W=W, Z=Z, potentials=torch.cat([b.potential for b in blocks], dim=1))
    ctx.record["shapes"] = {"cells": s["L_block"].shape[0], "latents": Z.shape[2],
                            "chains": block_chains}
    if ctx.rank != 0:
        return {}
    draws = Z.double().cpu().numpy()
    ess = ess_by_blocks(draws)
    lag0 = ess_by_blocks(draws, estimator=ess_from_lag0)
    leaves = sum(b.num_evaluations for b in blocks) // block_chains
    ctx.record["ess_per_draw"] = float(np.median(lag0)) / (chains * W.shape[1])
    print(f"nuts mesh {list(s['mesh'].shape.values())}: {W.shape[1]} transitions x {chains} "
          f"chains in {elapsed:.3f} s, {leaves} lockstep leaves on rank 0 "
          f"({1e3 * elapsed / leaves:.3f} ms per leaf), step {float(s['step']):.4g}, "
          f"ESS min {ess.min():.1f} median {np.median(ess):.1f} (from lag 0, uncapped: "
          f"min {lag0.min():.1f} median {np.median(lag0):.1f})", file=sys.stderr)
    ctx.state["attempted"] = int(W.shape[0] * W.shape[1])
    ctx.state["failed"] = int((~torch.isfinite(Z).all(dim=2)).sum())
    return {"ess_per_s": float(np.median(ess)) / elapsed}


def profile(ctx):
    with ctx.profiled(), ctx.span("nuts.block"):
        _block(ctx, max(1, ctx.traffic["block_transitions"] // 5))


def collect(ctx):
    """On every rank (collectives): the chains exchange's numbers
    (:func:`_chains_exchange`); rank 0's draws sent to every rank;
    on the ranks of rank 0's cells group f = L z + μ at their cells for
    every draw, gathered to rank 0 (float32, on the device); then the
    program's state freed.  Rank 0 returns ``drivers/nuts.py``'s outputs
    (the fit's, and of every draw the sampler's potential, ½|z|², f at
    every cell and z), the other ranks None."""
    from mellon_tpu_torch import parallel

    s = ctx.state
    mesh = s["mesh"]
    k = s["Z"].shape[2]
    flat = s["Z"].reshape(-1, k).contiguous()
    dist.broadcast(flat, src=0)
    F = None
    if mesh.coords[parallel.CHAIN_AXIS] == 0:
        cells = parallel.cell_sharding(mesh)
        if ctx.rank == 0:
            F = torch.empty((flat.shape[0], s["n"]), dtype=torch.float32, device=flat.device)
        for i in range(0, flat.shape[0], DRAW_BLOCK):
            part = s["L_block"] @ flat[i : i + DRAW_BLOCK].T + s["mu"]
            whole = cells.gather(part.contiguous())
            if ctx.rank == 0:
                F[i : i + DRAW_BLOCK] = whole.T
    chains = _chains_exchange(ctx)
    outputs = None
    if ctx.rank == 0:
        zz = flat.double()
        outputs = {"fit": s["fit"], "potential": s["potentials"].reshape(-1).double().cpu(),
                   "half_z2": (0.5 * (zz * zz).sum(1)).cpu(), "f_draws": F,
                   "z_draws": flat.cpu(), "chains": chains}
    for key in ("W", "Z", "potentials", "potential", "L_block", "T", "z_map", "w", "fit"):
        s.pop(key, None)
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    return outputs


def _chain_digests(W):
    """The sha256 of each chain's draws ``W[c]``, as this rank holds them."""
    return [hashlib.sha256(w.contiguous().cpu().numpy().tobytes()).hexdigest() for w in W]


def _chains_exchange(ctx):
    """On every rank (a collective): each rank's own chain group's draws,
    as it holds them after the sampler's gathers over the chains axis,
    against rank 0's copy of them.  Rank 0 receives a chain group's
    block from the rank of that group on its own cells coordinate, so
    each chain is held to that rank's.  Rank 0 returns
    ``{"chains_mismatch": chains of which rank 0 holds other draws than
    the rank that sampled them (or that no rank sent), "frozen_chains":
    chains whose draws never move in the window}``, the others None."""
    from mellon_tpu_torch import parallel

    s = ctx.state
    W, mesh = s["W"], s["mesh"]
    lo, hi = s["sharding"].block(W.shape[0])
    digests = _chain_digests(W)
    sent = [None] * ctx.world
    dist.all_gather_object(sent, (mesh.coords[parallel.CELL_AXIS],
                                  {c: digests[c] for c in range(lo, hi)}))
    if ctx.rank != 0:
        return None
    own = {}
    for cells, blocks in sent:
        if cells == mesh.coords[parallel.CELL_AXIS]:
            own.update(blocks)
    mismatch = sum(own.get(c) != d for c, d in enumerate(digests))
    frozen = int((W == W[:, :1]).all(dim=2).all(dim=1).sum())
    return {"chains_mismatch": float(mismatch), "frozen_chains": float(frozen)}


def check(ctx, outputs):
    """``drivers/nuts.py``'s comparison, then the chains exchange's two
    numbers (:func:`_chains_exchange`; exact, with the limit 0): a gather
    over the chains axis that leaves a chain group out, or a chain group
    that never moves, passes the comparison of the pooled draws."""
    chains = outputs.get("chains") or {"chains_mismatch": math.inf, "frozen_chains": math.inf}
    return nuts.check(ctx, outputs) + list(chains.items())
