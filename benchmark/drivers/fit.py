"""Warm fits back to back: ``DensityEstimator(**estimator).fit_predict(x)``
on data sets of the configuration's shape made from the seed, each fit on
the next set, its log density read to the host as a user's code reads it.

Traffic parameters: ``data_sets`` (made in set-up and cycled through),
``warmup_fits`` (on the last sets, in set-up: the first fit of a shape
captures the fused prepare's CUDA graphs), ``checked_fits`` (drawn from
the seed among the window's fits and compared with the reference).

The window ends when the first fit that finishes after ``seconds``
finishes; ``fit_s`` is its length over the number of fits."""

import sys
import time

import numpy as np
import torch

from benchmark import fitcheck
from benchmark.data import mixture_cells


def _estimator(ctx):
    import mellon_tpu_torch as mt

    return mt.DensityEstimator(device=ctx.device, **ctx.config.get("estimator", {}))


def _traced(ctx, est):
    """With ``trace``, the instance's prepare_inference and run_inference
    inside spans (fit_predict still runs, so ``fit`` sets ``_in_fit``)."""
    if not ctx.trace:
        return est
    for method, span in (("prepare_inference", "fit.prepare"), ("run_inference", "fit.optimize")):
        bound = getattr(est, method)

        def wrapped(*args, _bound=bound, _span=span, **kwargs):
            with ctx.span(_span):
                return _bound(*args, **kwargs)

        setattr(est, method, wrapped)
    return est


def fit_once(ctx, x):
    est = _traced(ctx, _estimator(ctx))
    ld = est.fit_predict(x).cpu()
    return est, ld


def setup(ctx):
    cfg, tr = ctx.config, ctx.traffic
    sets = [mixture_cells(cfg["cells"], cfg["dims"], [ctx.seed, i]) for i in range(tr["data_sets"])]
    ctx.state["sets"] = sets
    for i in range(tr["warmup_fits"]):
        fit_once(ctx, sets[-1 - i % len(sets)])


def window(ctx):
    sets = ctx.state["sets"]
    fits = []
    t0 = time.perf_counter()
    while True:
        i = len(fits) % len(sets)
        est, ld = fit_once(ctx, sets[i])
        fits.append((i, est, ld))
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    elapsed = time.perf_counter() - t0
    ctx.count("fits", len(fits))
    print(f"fit: {len(fits)} fits in {elapsed:.3f} s", file=sys.stderr)
    ctx.state["fits"] = fits
    ctx.state["attempted"] = len(fits)
    ctx.state["failed"] = sum(not bool(torch.isfinite(ld).all()) for _, _, ld in fits)
    return {"fit_s": elapsed / len(fits)}


def profile(ctx):
    with ctx.profiled():
        fit_once(ctx, ctx.state["sets"][0])


def collect(ctx):
    fits = ctx.state.pop("fits")
    rng = np.random.default_rng([ctx.seed, 7])
    picked = sorted(rng.choice(len(fits), size=min(len(fits), ctx.traffic["checked_fits"]),
                               replace=False))
    outputs = [(fits[i][0], fitcheck.fit_outputs(fits[i][1], ctx.seed, ctx.config))
               for i in picked]
    del fits
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    return outputs


def control(ctx, outputs):
    """The control's outputs in place of the program's."""
    return [(i, fitcheck.control_fit(ctx.state["sets"][i], fit, ctx.device,
                                     torch.zeros_like(fit["z"]))[0])
            for i, fit in outputs]


def check(ctx, outputs):
    rows = []
    for i, fit in outputs:
        model = fitcheck.reference_model(ctx.state["sets"][i], fit["landmarks"], ctx.device)
        rows.append(fitcheck.fit_numbers(fit, model, model.newton_map(fit["z"])))
        del model
    return list(fitcheck.worst(rows).items())
