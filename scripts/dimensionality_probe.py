#!/usr/bin/env python3
"""Where the DimensionalityEstimator's float32 fit and its float64 twin
part at the benchmark shape.

    python scripts/dimensionality_probe.py [--max-iter N] [--cpu CELLS LANDMARKS]

On the card (default) at the 8,627 x 20 benchmark cells, or on the CPU at
CELLS cells and LANDMARKS default landmarks: the default float32 fit and a
float64 fit on its landmarks and length scale, as chip_smoke.py's
[dimensionality] path makes them, each with its L-BFGS steps, whether it
met its tolerance and its loss; the float64 loss at the float32 solution
(its excess over the float64 fit's loss, relative); then up to N more
L-BFGS steps (default 2,000) on the float32 problem and on the same
problem in float64 (the float32 fit's L and distances cast), both from the
float32 solution, and on the float64 fit's own problem from its solution,
each with the correlation of its local dimensions and log densities with
the float64 fit's, and those of the continued float32 solution with the
other two. The last line is all of it as JSON.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import mellon_tpu_torch as mt  # noqa: E402
from mellon_tpu_torch.inference.losses import (  # noqa: E402
    compute_dimensionality_transform,
    make_dimensionality_value_and_grad,
)
from mellon_tpu_torch.inference.optimizers import minimize_lbfgs_value_and_grad  # noqa: E402


def lbfgs_stats(res):
    return {"steps": res.n_steps, "evals": res.n_evals, "converged": bool(res.converged),
            "loss": res.loss}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--max-iter", type=int, default=2000)
    parser.add_argument("--cpu", nargs=2, type=int, metavar=("CELLS", "LANDMARKS"))
    args = parser.parse_args()
    device = "cuda"
    x_np = np.asarray(np.load(cs.DATA)["x"], dtype=np.float32)
    if args.cpu:
        device = "cpu"
        mt.config.DEFAULT_DEVICE = "cpu"
        mt.parameters.DEFAULT_N_LANDMARKS = args.cpu[1]
        x_np = x_np[: args.cpu[0]]
    elif not torch.cuda.is_available():
        print("no CUDA device; pass --cpu CELLS LANDMARKS for a CPU run", file=sys.stderr)
        return 2

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def fit(dtype, **kwargs):
        est = mt.DimensionalityEstimator(device=device, dtype=dtype, **kwargs)
        t0 = time.perf_counter()
        est.fit(x_np, build_predict=False)
        sync()
        return est, time.perf_counter() - t0

    def corr(a, b):
        return float(np.corrcoef(a.double().cpu().numpy(), b.double().cpu().numpy())[0, 1])

    est, seconds = fit(torch.float32)
    est64, seconds64 = fit(torch.float64, landmarks=est.landmarks.double(), ls=est.ls)
    z32 = est.pre_transformation.reshape(-1)
    loss_at_f32, grad_at_f32 = est64._value_and_grad(z32.double())
    out = {
        "device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
        "cells": x_np.shape[0], "landmarks": int(est.landmarks.shape[0]),
        "f32": {**lbfgs_stats(est.opt_state), "seconds": seconds},
        "f64": {**lbfgs_stats(est64.opt_state), "seconds": seconds64},
        "tol_gradient_norm_f64": 1e-5 * abs(est64.opt_state.loss),
        "f64_loss_at_f32": float(loss_at_f32),
        "f64_gradient_norm_at_f32": float(grad_at_f32.norm()),
        "f64_loss_excess_of_f32": (float(loss_at_f32) - est64.opt_state.loss)
        / abs(est64.opt_state.loss),
        "corr_local_dim": corr(est.local_dim_x, est64.local_dim_x),
        "corr_log_density": corr(est.log_density_x, est64.log_density_x),
    }
    L, distances, mu_dim, mu_dens = est._loss_args
    problems = {
        "f32 continued": (est._value_and_grad, z32, est.transform),
        "f32 problem in f64 continued": (
            make_dimensionality_value_and_grad(L.double(), distances.double(), mu_dim, mu_dens),
            z32.double(),
            compute_dimensionality_transform(mu_dim, mu_dens, L.double()),
        ),
        "f64 continued": (est64._value_and_grad, est64.pre_transformation.reshape(-1),
                          est64.transform),
    }
    optima = {}
    for name, (fun, z0, transform) in problems.items():
        t0 = time.perf_counter()
        res = minimize_lbfgs_value_and_grad(fun, z0, max_iter=args.max_iter)
        sync()
        optima[name] = transform(res.pre_transformation.reshape(2, -1))
        dims, log_dens = optima[name]
        out[name] = {**lbfgs_stats(res), "seconds": time.perf_counter() - t0,
                     "corr_local_dim_with_capped_f64": corr(dims, est64.local_dim_x),
                     "corr_log_density_with_capped_f64": corr(log_dens, est64.log_density_x)}
        print(f"[{name}] {json.dumps(out[name])}", flush=True)
    for other in ("f32 problem in f64 continued", "f64 continued"):
        out[f"corr f32 continued vs {other}"] = {
            "local_dim": corr(optima["f32 continued"][0], optima[other][0]),
            "log_density": corr(optima["f32 continued"][1], optima[other][1]),
        }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
