#!/usr/bin/env python3
"""Time the estimator's NUTS path at the benchmark shape for given settings.

Run from the root of the repository on a machine with an NVIDIA GPU:

    python3 scripts/nuts_probe.py 4:200/200 4:100/50 16:100/50@43 ...

Each argument is chains:warmup/draws, optionally @seed (default 42).  It
prepares DensityEstimator() on
the 8,627 x 20 benchmark cells (benchdata/ld_ref_8627x20_f64.npz) in
float32, finds the L-BFGS MAP and zero-centres the potential there, as
optimizer="nuts" does, and then runs run_mcmc (depth 10) once per
argument.  It prints the card's name and power limit, the loss at the warm
start and at the MAP, and per run one JSON line: seconds, the lockstep
leaves of the whole run and of the sampling transitions, ms per leaf, step
size, acceptance, leapfrogs per draw, max split-R-hat and min/median ESS.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("nuts_probe: no CUDA device is available; nothing was run.", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import mellon_tpu_torch as mt
    from mellon_tpu_torch.inference import mcmc
    from mellon_tpu_torch.inference.diagnostics import effective_sample_size, split_rhat
    from mellon_tpu_torch.inference.optimizers import minimize_lbfgs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    x = np.asarray(np.load(os.path.join(ROOT, "benchdata", "ld_ref_8627x20_f64.npz"))["x"], dtype=np.float32)
    est = mt.DensityEstimator(device="cuda")
    est.prepare_inference(x)
    z_map = minimize_lbfgs(est._value_and_grad, est.initial_value).pre_transformation
    value_and_grad, offset = mcmc.zero_centered_potential(z_map, *est._loss_args)
    print(json.dumps({"loss_warm_start": float(est._value_and_grad(est.initial_value)[0]),
                      "loss_map": float(est._value_and_grad(z_map)[0]), "offset": offset}), flush=True)
    rows = [0]

    def counted(Z):
        rows[0] += Z.shape[0]
        return value_and_grad(Z)

    for arg in sys.argv[1:]:
        arg, _, seed = arg.partition("@")
        seed = int(seed) if seed else 42
        chains, run = arg.split(":")
        warmup, draws = (int(v) for v in run.split("/"))
        chains = int(chains)
        rows[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = mcmc.run_mcmc(counted, z_map, torch.Generator(device="cuda").manual_seed(seed),
                            num_warmup=warmup, num_samples=draws, num_chains=chains)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        ess = effective_sample_size(res.samples)
        print(json.dumps({
            "chains": chains, "warmup": warmup, "draws": draws, "seed": seed, "seconds": seconds,
            "leaves": rows[0] / chains, "sampling_leaves": res.num_evaluations / chains,
            "ms_per_leaf": 1e3 * seconds * chains / rows[0], "step_size": float(res.step_size),
            "mean_accept": float(res.accept_prob.mean()),
            "leapfrogs_per_draw": float(res.num_leapfrog.double().mean()),
            "max_rhat": float(split_rhat(res.samples).max()), "ess_min": float(ess.min()),
            "ess_median": float(np.median(ess)), "divergences": int(res.diverging.sum()),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
