"""Hessian-preconditioned NUTS continuing after set-up, as
``sample_density_posterior(est, precondition="hessian")`` runs it, through
the functional API's names: the MAP fit, ``zero_centered_potential``,
``newton_polish``, ``hessian_cholesky`` and ``precondition_transform``
(T = R⁻ᵀ), ``preconditioned_potential``, ``run_mcmc`` for the warm-up;
the window then calls ``resume_mcmc`` with the adapted step size and mass
in blocks of ``block_transitions`` transitions until ``seconds`` have
passed.

Traffic parameters: ``chains``, ``warmup`` (run_mcmc's warm-up
transitions), ``block_transitions``.

``ess_per_s``: for each latent the multi-chain ESS over all of the
window's draws, unwhitened to z (``ess.effective_sample_size``, the
program's definition, which caps at chains × draws); the median over the
latents over the window's length.  The traced run's ``nuts.ess_per_draw``
is the median ESS by ``ess.ess_from_lag0``, which does not cap, over
chains × draws.

The comparison is taken in function space, f = L z + μ at the cells:
float32 leaves L's columns ~1e-3 off float64's in directions of tiny
prior variance, which moves the latents' posterior by many of its
standard deviations in the stiffest directions (the MAP, T and the
gradient in z cannot be compared), but f barely."""

import sys
import time

import numpy as np
import torch

from benchmark import fitcheck
from benchmark.data import mixture_cells
from benchmark.ess import ess_by_blocks, ess_from_lag0
from benchmark.reference import density as ref

DRAW_BLOCK = 64


def setup(ctx):
    import mellon_tpu_torch as mt
    from mellon_tpu_torch.inference import losses, mcmc

    cfg, tr = ctx.config, ctx.traffic
    x = mixture_cells(cfg["cells"], cfg["dims"], ctx.seed)
    est = mt.DensityEstimator(device=ctx.device, **cfg.get("estimator", {}))
    est.fit(x, build_predict=False)
    z0 = est.pre_transformation.reshape(-1)
    fn, args = mcmc.zero_centered_potential(
        losses.density_loss, z0, (est.L, est.nn_distances, est.d, est.mu))
    z_map, _, _ = mcmc.newton_polish(fn, z0, args)
    T = mcmc.precondition_transform(mcmc.hessian_cholesky(fn, z_map, mcmc.NEWTON_JITTER, *args))
    potential = mcmc.preconditioned_potential(fn)
    pargs = (T, z_map, *args)
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    warm = mcmc.run_mcmc(potential, torch.zeros_like(z_map), gen, num_warmup=tr["warmup"],
                         num_samples=1, num_chains=tr["chains"], potential_args=pargs)
    ctx.state.update(x=x, est=est, z_map=z_map, T=T, potential=potential, pargs=pargs,
                     gen=gen, step=warm.step_size, mass=warm.inv_mass_diag,
                     w=warm.samples[:, -1])
    _block(ctx, tr["block_transitions"])  # the window's call, once


def _block(ctx, transitions):
    from mellon_tpu_torch.inference import mcmc

    s = ctx.state
    res = mcmc.resume_mcmc(s["potential"], s["w"], s["gen"], s["step"], s["mass"],
                           num_samples=transitions, potential_args=s["pargs"])
    s["w"] = res.samples[:, -1]
    return res


def window(ctx):
    from mellon_tpu_torch.inference import mcmc

    s = ctx.state
    chains = ctx.traffic["chains"]
    blocks = []
    t0 = time.perf_counter()
    while True:
        with ctx.span("nuts.block"):
            res = _block(ctx, ctx.traffic["block_transitions"])
        ctx.count("leaves", res.num_evaluations // chains)
        ctx.count("host_reads", res.host_reads)
        blocks.append(res)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    elapsed = time.perf_counter() - t0
    W = torch.cat([b.samples for b in blocks], dim=1)
    Z = mcmc.unwhiten_samples(W, s["T"], s["z_map"])
    draws = Z.double().cpu().numpy()
    ess = ess_by_blocks(draws)
    lag0 = ess_by_blocks(draws, estimator=ess_from_lag0)
    leaves = sum(b.num_evaluations for b in blocks) // chains
    n, k = s["est"].L.shape
    ctx.record["shapes"] = {"cells": n, "latents": k, "chains": chains}
    ctx.record["ess_per_draw"] = float(np.median(lag0)) / (chains * W.shape[1])
    print(f"nuts: {W.shape[1]} transitions x {chains} chains in {elapsed:.3f} s, "
          f"{leaves} lockstep leaves ({1e3 * elapsed / leaves:.3f} ms per leaf), "
          f"step {float(s['step']):.4g}, ESS min {ess.min():.1f} median {np.median(ess):.1f} "
          f"(from lag 0, uncapped: min {lag0.min():.1f} median {np.median(lag0):.1f})",
          file=sys.stderr)
    s.update(Z=Z, potentials=torch.cat([b.potential for b in blocks], dim=1))
    ctx.state["attempted"] = int(W.shape[0] * W.shape[1])
    ctx.state["failed"] = int((~torch.isfinite(Z).all(dim=2)).sum())
    return {"ess_per_s": float(np.median(ess)) / elapsed}


def profile(ctx):
    with ctx.profiled(), ctx.span("nuts.block"):
        _block(ctx, max(1, ctx.traffic["block_transitions"] // 5))


def collect(ctx):
    """The fit's outputs, and of every draw of the window the sampler's
    potential, ½|z|² and the function sample f = est.transform(z) at every
    cell (float32, kept on the device: the program's state is freed
    before the reference runs)."""
    s = ctx.state
    est, Z = s["est"], s["Z"]
    k = Z.shape[2]
    fit = fitcheck.fit_outputs(est, ctx.seed, ctx.config)
    rows = fit["rows"].to(Z.device)
    flat = Z.reshape(-1, k)
    F = torch.empty((flat.shape[0], est.L.shape[0]), dtype=torch.float32, device=Z.device)
    for i in range(0, flat.shape[0], DRAW_BLOCK):
        F[i : i + DRAW_BLOCK] = est.transform(flat[i : i + DRAW_BLOCK].T).T
    zz = flat.double()
    outputs = {
        "fit": fit, "potential": s["potentials"].reshape(-1).double().cpu(),
        "half_z2": (0.5 * (zz * zz).sum(1)).cpu(), "f_draws": F, "z_draws": flat.cpu(),
    }
    for key in ("est", "Z", "potentials", "potential", "pargs", "T", "z_map", "w"):
        s.pop(key, None)
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    return outputs


def control(ctx, outputs):
    """The control's outputs in place of the program's: its fit from the
    same cells and landmarks, its potential at the program's draws (the
    control draws none: its function values there, f = L z + μ in its own
    L, and ½|z|² − Σℓ(f) in its precision), and for the draws' moments its
    Laplace approximation at its MAP (``moments``)."""
    fit = outputs["fit"]
    cfit, model = fitcheck.control_fit(ctx.state["x"], fit, ctx.device, fit["z"].float())
    values, f_draws = [], []
    for i in range(0, outputs["z_draws"].shape[0], DRAW_BLOCK):
        zs = outputs["z_draws"][i : i + DRAW_BLOCK].to(model.L.device, model.ar.dtype)
        values.append(model.loss_grad(zs)[0].double().cpu())
        f_draws.append(torch.cat([model.ar.mm(zs, model.L[j : j + ref.BLOCK].T) + model.mu
                                  for j in range(0, model.L.shape[0], ref.BLOCK)], dim=1).cpu())
    mean, sd = laplace_f(model, cfit["z"].to(model.L.device), fit["rows"])
    return dict(outputs, fit=cfit, potential=torch.cat(values), f_draws=torch.cat(f_draws),
                moments=(mean.double().cpu(), sd.double().cpu()))


def laplace_f(model, z, rows):
    """The Laplace approximation's mean and standard deviation of f at the
    cells ``rows``: L z + μ and sqrt(lᵢᵀ H⁻¹ lᵢ), H the Hessian at z."""
    R, _ = ref.cholesky(model.hessian(z), jitter=0.0)
    Lr = model.L[rows.to(model.L.device)]
    V = torch.linalg.solve_triangular(R, Lr.T, upper=False)
    return model.ar.mm(Lr, z[:, None])[:, 0] + model.mu, torch.sqrt((V * V).sum(0))


def check(ctx, outputs):
    """The fit's numbers (:func:`..fitcheck.fit_numbers` but ``ld_gap``), then: the
    potential at every draw up to a constant (the sampler's potential less
    ½|z|², against the reference's −Σℓ at the program's f, each less its
    mean; nats), and the draws' mean of f at the sampled cells against the
    reference's Laplace mean (the median gap in its standard deviations)
    and their standard deviation against its (the median ratio's gap from
    1)."""
    dev = ctx.device
    fit = outputs["fit"]
    model = fitcheck.reference_model(ctx.state["x"], fit["landmarks"], dev)
    z_ref = model.newton_map(fit["z"])
    numbers = fitcheck.fit_numbers(fit, model, z_ref)
    # ld_gap judges the L-BFGS start, which the polish and the sampler
    # replace; at the atlas L-BFGS stops at its step cap, 3-6% of the
    # spread from the MAP, where the control reads 11-15%: not compared
    del numbers["ld_gap"]
    mean, sd = laplace_f(model, z_ref, fit["rows"])
    rows = fit["rows"]
    loglik, f_sum, f_sq = [], 0.0, 0.0
    for i in range(0, outputs["f_draws"].shape[0], DRAW_BLOCK):
        f = outputs["f_draws"][i : i + DRAW_BLOCK].to(dev, torch.float64)
        loglik.append((f + model.Vd - torch.exp(f + model.V)).sum(1))
        fr = f[:, rows.to(dev)]
        f_sum, f_sq = f_sum + fr.sum(0), f_sq + (fr * fr).sum(0)
    m = outputs["f_draws"].shape[0]
    if "moments" in outputs:
        f_mean, f_sd = (t.to(dev) for t in outputs["moments"])
    else:
        f_mean = f_sum / m
        f_sd = torch.sqrt(torch.clamp_min(f_sq / m - f_mean * f_mean, 0) * m / max(m - 1, 1))
    a = outputs["potential"].to(dev) - outputs["half_z2"].to(dev) + torch.cat(loglik)
    print(f"nuts check: f's Laplace sd at the sampled cells, median {float(sd.median()):.4g} nats; "
          f"|draws' mean - Laplace mean| median {float((f_mean - mean).abs().median()):.4g} nats",
          file=sys.stderr)
    numbers.update({
        "pot_gap": float((a - a.mean()).abs().max()),
        "fmean_gap": float(((f_mean - mean).abs() / sd).median()),
        "fsd_gap": abs(float((f_sd / sd).median()) - 1.0),
    })
    return list(numbers.items())
