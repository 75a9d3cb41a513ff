#!/usr/bin/env python3
"""One rank of ``chip_smoke.py``'s ``[parallel]`` path (torch.distributed
on NVIDIA GPUs; it imports no JAX).

    python3 scripts/chip_smoke_parallel.py PHASE BACKEND WORLD RANK DEVICE STORE OUT

PHASE "ranks" (two ranks: NCCL with one card each, or gloo with both on
one card) prepares the benchmark fit on every rank and holds the sharded
entry points to the local ones and to [nuts]'s and [smc]'s bars:

* the cell-sharded value and gradient on the 1 x 2 mesh against the local
  potential, float32 (CELL_F32_REL) and float64 (CELL_F64_REL);
* shard_predict at PREDICT_POINTS query points against the unsharded
  predictor (PREDICT_REL of the spread), the kernel's launches counted on
  every rank and its output held to its plain version on this rank's card;
* chain-sharded NUTS on the 2 x 1 mesh at [nuts]'s budget and bars (and a
  posterior-mean log density that correlates with [nuts]'s, read from
  OUT/nuts_reference.npz), on [nuts]'s potential, its milliseconds per
  lockstep leaf;
* particle-sharded SMC on the 2 x 1 mesh at [smc]'s settings and bars;
* a checkpoint of the NUTS chains, each rank's block gathered, written by
  rank 0 to OUT/checkpoint.

PHASE "one" (one rank, NCCL on cuda:0) runs every sharded entry point on
the 1 x 1 mesh through real collectives and requires each to equal the
unsharded run exactly; resumes the checkpoint on that mesh (finite,
split-R-hat <= [nuts]'s bar); and times the cell-sharded log-prob+grad at
RATE_SHAPE (scripts/scaling_bench.py's shape, from a numpy seed).  With
two ranks on two cards, PHASE "ranks" times it too.

PHASE "atlas" (four ranks on the 2 x 2 chains x cells mesh: NCCL with one
card each at chip_smoke's 1M x 50 atlas, or gloo with all four on one card
at ATLAS_GLOO_CELLS x 50) runs configuration 5's sampler with the cells
and the chains sharded: every rank fits the same atlas (checksums equal);
the sharded Hessian and its diagonal within CURVATURE_REL of the whole-L
ones; the global L freed; hessian_preconditioner on the sharded potential
and Hessian, z* and T one digest on every rank; chain-sharded NUTS in w at
chip_smoke.ATLAS_NUTS (split-R-hat over chip_smoke's latent subset, the
posterior-mean log density against the rank's MAP and, at 1M, against
[atlas nuts]'s from chip_smoke.ATLAS_POSTERIOR), the milliseconds per
lockstep leaf and, on NCCL, the cells all_reduce's share of one; the
chains saved with save_sampler_state(chain_sharding=) (rank 0 writes
OUT/atlas_checkpoint), reloaded on every rank (state, step size and
mass equal to the run's) and resumed for ATLAS_RESUME_DRAWS transitions
with resume_mcmc (finite; the resumed draws alone within [nuts]'s
split-R-hat bar);
shard_predict of the posterior-mean predictor at PREDICT_POINTS points
against the unsharded one.

Each rank writes OUT/<PHASE>_rank<RANK>.json and exits non-zero if a bar
fails.  Its ``launches`` are the kernel's in its fit and in its
shard_predict, each counted from 0 (chip_smoke.counted_path): the
curvature, the potential, the samplers and the checkpoint read the
prepared L and launch no kernel, and the kernel's checks against its plain
version are not counted.
"""

import datetime
import hashlib
import json
import math
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import mellon_tpu_torch as mt  # noqa: E402
from mellon_tpu_torch import parallel  # noqa: E402
from mellon_tpu_torch.inference import mcmc, smc  # noqa: E402
from mellon_tpu_torch.inference.diagnostics import effective_sample_size, split_rhat  # noqa: E402
from mellon_tpu_torch.inference.factories import compute_conditional  # noqa: E402
from mellon_tpu_torch.inference.laplace import laplace_std_from_diagonal  # noqa: E402
from mellon_tpu_torch.inference.losses import (  # noqa: E402
    density_hessian,
    density_hessian_diagonal,
    make_density_value_and_grad_batch,
)
from mellon_tpu_torch.ops import hopper_kernels as hk  # noqa: E402

PREDICT_POINTS = chip_smoke.PREDICT_BATCH
CELL_F32_REL = 1e-5
CELL_F64_REL = 1e-10
PREDICT_REL = 1e-5
RATE_SHAPE = (100_000, 5_000)
RATE_SEED = 0
RATE_CALLS = 200
EXACT_RUN = dict(num_chains=4, num_warmup=10, num_samples=5)
EXACT_SMC = dict(num_particles=256, start="laplace", num_sweeps=1, seed=3)
RESUME_DRAWS = 50
CHECKS_POINTS = 3
TIMEOUT = datetime.timedelta(seconds=60)
# the atlas phase: four NCCL ranks on four cards at configuration 5's full
# size, or four gloo ranks on one card at scripts/scaling_bench.py's n (the
# collectives and the control flow, not the scale); a rank's prepare takes
# ~30 s at 1M cells, so the group waits longer
ATLAS_GLOO_CELLS = 100_000
ATLAS_TIMEOUT = datetime.timedelta(seconds=240)
CURVATURE_REL = 1e-5
# the atlas checkpoint's resumed transitions, as many as the saved run
# drew, so that their own split-R-hat reads the resumed chains (over 10
# draws, 16 halves of 5, it read 1.141-1.150 on the H100: noise; PERF.md)
ATLAS_RESUME_DRAWS = chip_smoke.ATLAS_NUTS["num_samples"]
ATLAS_RESUME_SEED = 6
REDUCE_CALLS = 50


class Bars:
    """The rank's results and the names of the bars it failed."""

    def __init__(self):
        self.stats, self.failed = {}, []

    def check(self, name, ok, **values):
        self.stats[name] = dict(values, ok=bool(ok))
        chip_smoke.log(f"[parallel] rank {dist.get_rank()} {name}: {json.dumps(self.stats[name])}")
        if not ok:
            self.failed.append(name)


def counted(label, fn):
    """chip_smoke.counted_path (the kernel's launch count set to 0 just
    before ``fn``, read just after, and > 0) with the (n, m, d, dtype, ls)
    of each call the covariance module made, eagerly or replayed by a CUDA
    graph (chip_smoke.record_operands): (fn's result, launches, calls)."""
    recorded, stop = chip_smoke.record_operands()
    try:
        result, launches = chip_smoke.counted_path(hk, f"parallel rank {dist.get_rank()} {label}", fn)
    finally:
        stop()
    calls = [(x.shape[0], y.shape[0], x.shape[1], chip_smoke.dtype_name(x.dtype), float(ls), x, y)
             for x, y, ls in recorded]
    return result, launches, calls


def rel(got, want):
    """max |got − want| over max |want|, in float64."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def fit(device):
    """The benchmark fit (DensityEstimator() on the 8,627 x 20 cells)."""
    ref = np.load(chip_smoke.DATA)
    x = np.asarray(ref["x"], dtype=np.float32)
    est = mt.DensityEstimator(device=device)
    est.fit(x)
    return est, x


def query_points(x, device):
    """PREDICT_POINTS points near the cells, from chip_smoke's seed."""
    xt = torch.as_tensor(x, device=device)
    g = torch.Generator(device=device).manual_seed(2)
    idx = torch.randint(0, xt.shape[0], (PREDICT_POINTS,), device=device, generator=g)
    return (xt[idx] + 0.05 * xt.std(dim=0) * torch.randn(
        PREDICT_POINTS, xt.shape[1], device=device, generator=g)).contiguous()


def latents(est):
    """CHECKS_POINTS latent vectors around the MAP."""
    g = torch.Generator(device=est.device).manual_seed(5)
    z = est.pre_transformation
    return z + 0.1 * torch.randn(CHECKS_POINTS, z.shape[0], device=z.device, dtype=z.dtype,
                                 generator=g)


def cell_sharded_checks(bars, est, mesh, exact):
    """The cell-sharded batched potential against the local one in float32
    and float64 (equal where ``exact``)."""
    for dtype, bar in ((torch.float32, CELL_F32_REL), (torch.float64, CELL_F64_REL)):
        L, nn = est.L.to(dtype), est.nn_distances.to(dtype)
        Z = latents(est).to(dtype)
        loss, _ = parallel.shard_density_model(nn, est.d, est.mu, L, mesh)
        v, g = loss.value_and_grad(Z)
        v0, g0 = make_density_value_and_grad_batch(L, nn, est.d, est.mu)(Z)
        scalar = torch.stack([loss(z) for z in Z])
        errs = {"value_rel": rel(v, v0), "grad_rel": rel(g, g0), "scalar_rel": rel(scalar, v0)}
        ok = (torch.equal(v, v0) and torch.equal(g, g0)) if exact else max(errs.values()) <= bar
        bars.check(f"cell-sharded potential {chip_smoke.dtype_name(dtype)}", ok, bar=bar,
                   exact=exact, **errs)


def kernel_vs_plain(bars, calls):
    """Each distinct shape the sharded predictor launched, again through
    the kernel, against its plain version on this card (chip_smoke's bars,
    on 2,000 rows at each end)."""
    from mellon_tpu_torch.ops.hopper_kernels import matern52_gram_reference

    seen = set()
    for n, m, d, name, ls, x, y in calls:
        if (n, m, d, name) in seen:
            continue
        seen.add((n, m, d, name))
        out = hk.matern52_gram(x, y, ls)
        worst = 0.0
        for s in (slice(0, 2000), slice(max(n - 2000, 0), n)):
            plain = matern52_gram_reference(x[s], y, ls)
            err, k64, p64, bar, ok = chip_smoke.kernel_errors(out[s], plain, x[s], y, ls, name)
            worst = max(worst, err)
            if not ok:
                break
        bars.check(f"kernel {n}x{m}x{d} {name} on {x.device}", ok, max_abs_err=worst,
                   kernel_vs_f64=k64, plain_vs_f64=p64, bar=bar)


def predict_checks(bars, est, x, mesh, exact):
    """shard_predict at PREDICT_POINTS points: the launches, the kernel
    against its plain version, the result against the unsharded predictor."""
    xq = query_points(x, est.device)
    predict = parallel.shard_predict(est.predict, mesh)
    (got, seconds), launches, calls = counted(
        "shard_predict", lambda: chip_smoke.synced_seconds(lambda: predict(xq)))
    want = est.predict(xq)
    spread = float(want.max() - want.min())
    err = float((got - want).abs().max()) / spread
    ok = launches > 0 and (torch.equal(got, want) if exact else err <= PREDICT_REL)
    bars.check("shard_predict", ok, points=PREDICT_POINTS, launches=launches, seconds=seconds,
               err_over_spread=err, bar=PREDICT_REL, exact=exact,
               shapes=[c[:5] for c in calls])
    kernel_vs_plain(bars, calls)
    return launches, calls


def log_density_corr(a, b):
    return float(np.corrcoef(a.double().cpu().numpy(), b.double().cpu().numpy())[0, 1])


def nuts_checks(bars, est, mesh, reference):
    """Chain-sharded NUTS at [nuts]'s budget and bars, on the potential
    [nuts] samples (the mesh's cells axis has one rank, and a one-rank
    gloo all_reduce of CUDA tensors would add a round trip through the
    host to every leaf); returns the result."""
    potential = chip_smoke.counted_calls(mcmc.zero_centered_density_potential(
        est.pre_transformation, *est._loss_args)[0])
    opts = dict(chip_smoke.NUTS_OPTIONS, max_tree_depth=10, initial_step_size=0.1)
    gen = torch.Generator(device=est.device).manual_seed(0)
    res, seconds = chip_smoke.synced_seconds(lambda: mcmc.run_mcmc(
        potential, est.pre_transformation, gen, chain_sharding=parallel.chain_sharding(mesh),
        **opts))
    flat = res.samples.reshape(-1, res.samples.shape[-1])
    ld = est.transform(flat.mean(dim=0))
    rhat = float(np.max(split_rhat(res.samples)))
    ess = effective_sample_size(res.samples)
    laplace = laplace_std_from_diagonal(est._hessian_diagonal(est.pre_transformation))
    ratio = float(flat.std(dim=0, correction=0).mean() / laplace.mean())
    corr_map = log_density_corr(ld, est.log_density_x)
    corr_nuts = log_density_corr(ld, torch.as_tensor(reference["log_density"]))
    ok = (chip_smoke.finite(res.samples, ld) and rhat <= chip_smoke.NUTS_MAX_RHAT
          and float(ess.min()) >= chip_smoke.NUTS_MIN_ESS
          and chip_smoke.STD_RATIO[0] <= ratio <= chip_smoke.STD_RATIO[1]
          and corr_map >= chip_smoke.POSTERIOR_MIN_CORR
          and corr_nuts >= chip_smoke.POSTERIOR_MIN_CORR)
    bars.check("chain-sharded nuts", ok, mesh=list(mesh.shape.values()), seconds=seconds,
               leaf_ms=1e3 * seconds / potential.calls, leaves=potential.calls,
               step_size=float(res.step_size), max_rhat=rhat, ess_min=float(ess.min()),
               std_ratio_to_laplace=ratio, corr_with_map=corr_map,
               corr_with_nuts_path=corr_nuts, **{"settings": opts})
    return res


def smc_checks(bars, est, mesh):
    """Particle-sharded SMC at [smc]'s settings and bars."""
    (res, f), seconds = chip_smoke.synced_seconds(
        lambda: smc.smc_density_posterior(est, mesh=mesh, **chip_smoke.SMC))
    corr = log_density_corr(f.mean(dim=0), est.log_density_x)
    ok = (res.betas[-1] == 1.0 and math.isfinite(res.log_evidence) and chip_smoke.finite(f)
          and corr >= chip_smoke.POSTERIOR_MIN_CORR)
    bars.check("particle-sharded smc", ok, mesh=list(mesh.shape.values()), seconds=seconds,
               stages=len(res.betas), final_beta=res.betas[-1], log_evidence=res.log_evidence,
               log_evidence_std=res.log_evidence_std, corr_with_map=corr)


def rate(bars, mesh, device, label):
    """Log-prob+grad evaluations per second of the cell-sharded potential at
    RATE_SHAPE, float32, one latent vector per call."""
    n, m = RATE_SHAPE
    rng = np.random.default_rng(RATE_SEED)
    L = torch.as_tensor(rng.standard_normal((n, m), dtype=np.float32) / np.float32(math.sqrt(m)))
    nn = torch.as_tensor((0.05 + 0.3 * rng.random(n)).astype(np.float32))
    loss, _ = parallel.shard_density_model(nn.to(device), 20.0, -10.0, L.to(device), mesh)
    del L
    z = torch.zeros(1, m, device=device)
    for _ in range(5):
        v, g = loss.value_and_grad(z)
    _, seconds = chip_smoke.synced_seconds(
        lambda: [loss.value_and_grad(z - 1e-6 * g) for _ in range(RATE_CALLS)])
    bars.check(f"rate {label}", bool(torch.isfinite(v).all()), shape=list(RATE_SHAPE),
               mesh=list(mesh.shape.values()), evals_per_second=RATE_CALLS / seconds,
               ms_per_eval=1e3 * seconds / RATE_CALLS)


def same_fit_on_every_rank(bars, est):
    """The ranks' fits are bit-identical (same seed, F1): their checksums."""
    sums = torch.stack([t.double().sum() for t in (est.L, est.pre_transformation, est.landmarks)])
    parts = [torch.empty_like(sums) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, sums)
    bars.check("same fit on every rank", all(torch.equal(p, parts[0]) for p in parts),
               checksums=[p.tolist() for p in parts])


def phase_ranks(bars, est, x, out, world, two_cards):
    cells = parallel.create_mesh(1, world, devices=DEVICES)
    chains = parallel.create_mesh(world, 1, devices=DEVICES)
    same_fit_on_every_rank(bars, est)
    cell_sharded_checks(bars, est, cells, exact=False)
    launches, calls = predict_checks(bars, est, x, cells, exact=False)
    reference = np.load(os.path.join(out, "nuts_reference.npz"))
    res = nuts_checks(bars, est, chains, reference)
    smc_checks(bars, est, chains)
    block = parallel.chain_sharding(chains)
    parallel.save_sampler_state(
        os.path.join(out, "checkpoint"), samples=block.shard(res.samples),
        state=block.shard(res.samples[:, -1]), step_size=res.step_size,
        inv_mass_diag=res.inv_mass_diag, rng_key=torch.Generator(device=est.device).manual_seed(1),
        metadata={"algorithm": "nuts", "mesh": list(chains.shape.values())}, chain_sharding=block)
    if two_cards:
        rate(bars, cells, est.device, "1x2")
    return launches, calls


def phase_one(bars, est, x, out):
    """World size 1 on NCCL: every sharded entry point equals the local run."""
    mesh = parallel.create_mesh(1, 1, devices=DEVICES)
    cell_sharded_checks(bars, est, mesh, exact=True)
    launches, calls = predict_checks(bars, est, x, mesh, exact=True)
    args = est._loss_args
    local, _ = mcmc.zero_centered_density_potential(est.pre_transformation, *args)
    L, nn, d, mu = args
    sharded = parallel.shard_density_model(nn, d, mu, L, mesh,
                                           center=est.pre_transformation)[0].value_and_grad
    runs = [mcmc.run_mcmc(vg, est.pre_transformation,
                          torch.Generator(device=est.device).manual_seed(4), **kw, **EXACT_RUN)
            for vg, kw in ((local, {}), (sharded, {"chain_sharding": parallel.chain_sharding(mesh)}))]
    bars.check("chain-sharded nuts equals local", all(
        torch.equal(getattr(runs[0], f), getattr(runs[1], f))
        for f in ("samples", "potential", "step_size", "inv_mass_diag")), settings=EXACT_RUN)
    sweeps = [smc.smc_density_posterior(est, **kw, **EXACT_SMC)[0] for kw in ({}, {"mesh": mesh})]
    bars.check("particle-sharded smc equals local",
               torch.equal(sweeps[0].particles, sweeps[1].particles)
               and sweeps[0].betas == sweeps[1].betas, settings=EXACT_SMC)
    loaded = parallel.load_sampler_state(os.path.join(out, "checkpoint"))
    resumed = mcmc.resume_mcmc(sharded, loaded["state"][0],
                               torch.Generator(device=est.device).manual_seed(6),
                               loaded["step_size"], loaded["inv_mass_diag"],
                               num_samples=RESUME_DRAWS, max_tree_depth=10,
                               chain_sharding=parallel.chain_sharding(mesh))
    rhat = float(np.max(split_rhat(resumed.samples)))
    bars.check("checkpoint resumed on 1x1", chip_smoke.finite(resumed.samples)
               and rhat <= chip_smoke.NUTS_MAX_RHAT and loaded["samples"].device == est.device,
               saved_on=loaded["metadata"]["mesh"], chains=int(loaded["state"][0].shape[0]),
               draws=RESUME_DRAWS, max_rhat=rhat)
    rate(bars, mesh, est.device, "1x1")
    return launches, calls


def digest(*tensors):
    """A hash of the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def phase_atlas(bars, device, world, backend, out):
    """Configuration 5's sampler on the 2 x 2 (chains x cells) mesh: the
    sharded curvature against the whole-L one, the global L freed, the
    preconditioner from the sharded potential and Hessian (z* and T the
    same bits on every rank), chain-sharded preconditioned NUTS in w, the
    posterior mean against the MAP's (and against [atlas nuts]'s on the
    same 1M cells), shard_predict of the posterior mean, the cells
    all_reduce's share of a leaf.  Every rank prepares the same cells (the
    full 1M x 50 with NCCL, ATLAS_GLOO_CELLS x 50 with gloo).  Returns the
    (launches, calls) of the fit and of shard_predict."""
    cells = chip_smoke.ATLAS_CELLS if backend == "nccl" else ATLAS_GLOO_CELLS
    (est, x), fit_launches, fit_calls = counted("atlas fit", lambda: atlas_fit(device, cells))
    mesh = parallel.create_mesh(2, world // 2, devices=DEVICES)
    same_fit_on_every_rank(bars, est)
    args = est._loss_args
    L, nn, d, mu = args
    z0, ld_map = est.pre_transformation, est.log_density_x
    loss, (nn_block, L_block) = parallel.shard_density_model(nn, d, mu, L, mesh, center=z0)
    (H, diag), sharded_s = chip_smoke.synced_seconds(
        lambda: (loss.hessian(z0), loss.hessian_diagonal(z0)))
    (H0, diag0), whole_s = chip_smoke.synced_seconds(
        lambda: (density_hessian(z0, *args), density_hessian_diagonal(z0, *args)))
    errs = {"hessian_rel": rel(H, H0), "diagonal_rel": rel(diag, diag0)}
    bars.check("atlas sharded curvature", max(errs.values()) <= CURVATURE_REL, bar=CURVATURE_REL,
               cells=list(x.shape), latents=int(z0.shape[0]), sharded_seconds=sharded_s,
               whole_seconds=whole_s, reduce_bytes=H.numel() * H.element_size(), **errs)
    del H, H0, diag, diag0
    keep = dict(landmarks=est.landmarks, Lp=est.Lp, cov_func=est.cov_func, jitter=est.jitter)
    allocated = torch.cuda.memory_allocated(est.device)
    del est, args, L, nn
    torch.cuda.empty_cache()
    freed = allocated - torch.cuda.memory_allocated(z0.device)

    sharding = parallel.chain_sharding(mesh)
    (z_star, T, norms), precond_s = chip_smoke.synced_seconds(lambda: mcmc.hessian_preconditioner(
        loss.value_and_grad, loss.hessian, z0, chain_sharding=sharding))
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, digest(z_star, T))
    bars.check("atlas z* and T identical on every rank", len(set(digests)) == 1,
               newton_grad_norm=list(norms), seconds=precond_s, digests=digests,
               global_L_bytes_freed=freed)

    potential = chip_smoke.counted_calls(mcmc.precondition_value_and_grad(loss.value_and_grad, T, z_star))
    opts = {k: v for k, v in chip_smoke.ATLAS_NUTS.items() if k != "num_chains"}
    w0 = z_star.new_zeros((chip_smoke.ATLAS_NUTS["num_chains"], z_star.shape[0]))
    gen = torch.Generator(device=z0.device).manual_seed(chip_smoke.ATLAS_NUTS_SEED)
    res, seconds = chip_smoke.synced_seconds(lambda: mcmc.run_mcmc(
        potential, w0, gen, chain_sharding=sharding, **opts))
    samples = mcmc.unwhiten_samples(res.samples, T, z_star)
    chains, draws, k = samples.shape
    sub = torch.as_tensor(chip_smoke.latent_subset(k), device=samples.device)
    rhat = float(np.max(split_rhat(samples[:, :, sub])))
    ess = effective_sample_size(samples[:, :, sub])
    z_mean = samples.reshape(-1, k).mean(dim=0)
    ld_post = parallel.cell_sharding(mesh).gather(L_block @ z_mean + mu)
    corr_map = log_density_corr(ld_post, ld_map)
    corr_one_card = None
    if ld_post.shape[0] == chip_smoke.ATLAS_CELLS:
        corr_one_card = log_density_corr(
            ld_post, torch.as_tensor(np.load(chip_smoke.ATLAS_POSTERIOR)["log_density"]))
    # the cells all_reduce's share of a leaf: the sharded potential against
    # this rank's block alone, on its block of the chains
    local = make_density_value_and_grad_batch(L_block, nn_block, d, mu, center=z0)
    Zb = parallel.chain_sharding(mesh).shard(z_star + w0 @ T.T)
    timed = {name: chip_smoke.synced_seconds(lambda f=f: [f(Zb) for _ in range(REDUCE_CALLS)])[1]
             for name, f in (("sharded", loss.value_and_grad), ("block", local))}
    # unreadable where the four ranks share one card and contend for it
    reduce_ms = (1e3 * (timed["sharded"] - timed["block"]) / REDUCE_CALLS
                 if backend == "nccl" else None)
    ok = (chip_smoke.finite(samples, ld_post) and rhat <= chip_smoke.NUTS_MAX_RHAT
          and corr_map >= chip_smoke.POSTERIOR_MIN_CORR
          and (corr_one_card is None or corr_one_card >= chip_smoke.POSTERIOR_MIN_CORR))
    bars.check("atlas nuts", ok, mesh=list(mesh.shape.values()), settings=chip_smoke.ATLAS_NUTS,
               seconds=seconds, leaves=potential.calls, leaf_ms=1e3 * seconds / potential.calls,
               step_size=float(res.step_size), mean_accept=float(res.accept_prob.mean()),
               leapfrogs_per_draw=float(res.num_leapfrog.double().mean()),
               draws_per_second=chains * draws / seconds, max_rhat=rhat, ess_min=float(ess.min()),
               corr_with_map=corr_map, corr_with_atlas_nuts=corr_one_card,
               ms_per_call={n: 1e3 * t / REDUCE_CALLS for n, t in timed.items()},
               all_reduce_ms_per_leaf=reduce_ms, backend=backend)

    path = os.path.join(out, "atlas_checkpoint")
    parallel.save_sampler_state(
        path, samples=sharding.shard(res.samples), state=sharding.shard(res.samples[:, -1]),
        step_size=res.step_size, inv_mass_diag=res.inv_mass_diag,
        metadata={"algorithm": "nuts", "space": "whitened", "mesh": list(mesh.shape.values())},
        chain_sharding=sharding)
    loaded = parallel.load_sampler_state(path)
    resumed = mcmc.resume_mcmc(
        potential, loaded["state"][0], torch.Generator(device=z0.device).manual_seed(ATLAS_RESUME_SEED),
        loaded["step_size"], loaded["inv_mass_diag"], num_samples=ATLAS_RESUME_DRAWS,
        max_tree_depth=chip_smoke.ATLAS_NUTS["max_tree_depth"], chain_sharding=sharding)
    more = mcmc.unwhiten_samples(resumed.samples, T, z_star)
    resumed_rhat = float(np.max(split_rhat(more[:, :, sub])))
    as_saved = (torch.equal(loaded["state"][0], res.samples[:, -1])
                and torch.equal(torch.as_tensor(loaded["step_size"]).cpu(),
                                torch.as_tensor(res.step_size).cpu())
                and torch.equal(loaded["inv_mass_diag"].cpu(), res.inv_mass_diag.cpu()))
    bars.check("atlas checkpoint resumed",
               chip_smoke.finite(more) and resumed_rhat <= chip_smoke.NUTS_MAX_RHAT and as_saved
               and loaded["samples"].device == z0.device,
               saved_on=loaded["metadata"]["mesh"], chains=int(loaded["state"][0].shape[0]),
               draws=ATLAS_RESUME_DRAWS, as_saved=as_saved, max_rhat=resumed_rhat,
               step_size=float(resumed.step_size), mean_accept=float(resumed.accept_prob.mean()),
               bar=chip_smoke.NUTS_MAX_RHAT)

    pred = compute_conditional(x, keep["landmarks"], z_mean, None, None, mu, keep["cov_func"],
                               None, keep["Lp"], sigma=None, jitter=keep["jitter"],
                               y_is_mean=True)
    xq = query_points(x, z0.device)
    predict = parallel.shard_predict(pred, mesh)
    (got, predict_s), launches, calls = counted(
        "atlas shard_predict", lambda: chip_smoke.synced_seconds(lambda: predict(xq)))
    want = pred(xq)
    err = float((got - want).abs().max()) / float(want.max() - want.min())
    bars.check("atlas shard_predict", launches > 0 and err <= PREDICT_REL, points=PREDICT_POINTS,
               launches=launches, seconds=predict_s, err_over_spread=err, bar=PREDICT_REL,
               shapes=[c[:5] for c in calls])
    kernel_vs_plain(bars, calls)
    return fit_launches + launches, fit_calls + calls


def atlas_fit(device, n):
    """Configuration 5's float32 MAP on n cells of chip_smoke's atlas seed."""
    x = chip_smoke.atlas_cells(n, chip_smoke.ATLAS_DIMS, chip_smoke.ATLAS_SEED)
    est = mt.DensityEstimator(n_landmarks=chip_smoke.ATLAS_LANDMARKS, device=device)
    est.fit(x, build_predict=False)
    return est, est.x


DEVICES = None


def main():
    global DEVICES
    phase, backend, world, rank, device, store, out = sys.argv[1:8]
    world, rank = int(world), int(rank)
    device = torch.device(device)
    torch.cuda.set_device(device)
    DEVICES = [device] * world if backend == "gloo" else [torch.device("cuda", r) for r in range(world)]
    parallel.distributed_initialize(backend=backend, device=device, rank=rank, world_size=world,
                                    store=dist.FileStore(store, world),
                                    timeout=ATLAS_TIMEOUT if phase == "atlas" else TIMEOUT)
    bars = Bars()
    if phase == "atlas":
        launches, calls = phase_atlas(bars, device, world, backend, out)
    else:
        (est, x), fit_launches, fit_calls = counted("fit", lambda: fit(device))
        if phase == "ranks":
            launches, calls = phase_ranks(bars, est, x, out, world,
                                          two_cards=backend == "nccl" and world > 1)
        else:
            launches, calls = phase_one(bars, est, x, out)
        launches, calls = fit_launches + launches, fit_calls + calls
    result = {
        "phase": phase, "rank": rank, "world": world, "backend": backend, "device": str(device),
        "card": torch.cuda.get_device_name(device), "failed": bars.failed, "stats": bars.stats,
        "launches": launches,
        "calls": [c[:5] for c in calls],
    }
    with open(os.path.join(out, f"{phase}_rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()
    return 1 if bars.failed else 0


if __name__ == "__main__":
    sys.exit(main())
