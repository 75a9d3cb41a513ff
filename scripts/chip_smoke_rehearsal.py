#!/usr/bin/env python3
"""Rehearse chip_smoke.py's paths from the FunctionEstimator on (14-26,
all but [time matched]) on the CPU at a reduced size.

    python scripts/chip_smoke_rehearsal.py [outputs]

It runs the paths' own functions with the plain Matern-5/2 version in
place of the CUDA kernel (counted as launches), on the first 2,000
benchmark cells, 500 default landmarks, FULL_CELLS = 500 and ``outputs``
gene trends (default 100); [time] and [time predict] on the first 1,000
cells of each of the time course's 8 time points (their certificate
against the full course's float64 fit does not apply there and is
reported, not held), [ls_time] on a tenth of its cells per time point;
[nystroem] on the Nyström reference's 8,627 cells with 600 landmarks,
[full capacity] with 1,000 default landmarks (float32 factors 500
there), [atlas] on 20,000 cells with 500 landmarks and its subscale on
the reference's first 5,000 cells, and [nuts], [dimensionality nuts] and
[checkpoint] at 4 chains, 30 warmup and 10 draws, with the certificates
and sampler bars of these reduced runs reported, not held: the control
flow, the launch counts and the float32-vs-float64 gaps that
chip_smoke.py's bars were set from.  Its seconds are CPU seconds and say
nothing of the card.  [time matched] is not rehearsed (its inputs are the
full course's).
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import mellon_tpu_torch as mt  # noqa: E402
from mellon_tpu_torch.ops import hopper_kernels as hk  # noqa: E402


def run_paths(paths):
    failed, results = [], {}
    for label, run in paths.items():
        t0 = time.perf_counter()
        try:
            results[label], _ = cs.counted_path(hk, label, lambda: run(results))
        except AssertionError as error:
            failed.append(label)
            print(f"[{label}] bar failed: {error}", flush=True)
        print(f"[{label}] CPU seconds {time.perf_counter() - t0:.1f}", flush=True)
    return 1 if failed else 0


def main():
    torch.set_num_threads(4)
    torch.cuda.synchronize = lambda *args, **kwargs: None
    torch.cuda.empty_cache = lambda: None
    mt.config.DEFAULT_DEVICE = "cpu"
    mt.parameters.DEFAULT_N_LANDMARKS = 500
    cs.DEVICE = "cpu"
    cs.FULL_CELLS = 500
    cs.FUNCTION_OUTPUTS = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    cs.NYSTROEM = dict(cs.NYSTROEM, n_landmarks=600)
    cs.ATLAS_CELLS, cs.ATLAS_LANDMARKS, cs.ATLAS_BIG_COLUMNS = 20_000, 500, 300
    cs.DIM_NUTS_OPTIONS = cs.NUTS_OPTIONS = dict(num_chains=4, num_warmup=30, num_samples=10)
    cs.NUTS_MIN_ESS, cs.NUTS_MAX_RHAT = 0, float("inf")
    cs.CERT_MIN_CORR, cs.CERT_MAX_RMSE = -1.0, float("inf")
    cs.NYSTROEM_CERT_MIN_CORR, cs.NYSTROEM_CERT_MAX_RMSE = -1.0, float("inf")
    cs.TIME_CERT_MIN_CORR, cs.TIME_CERT_MAX_RMSE = -1.0, float("inf")
    cs.LS_TIME_GROUPS = tuple(s // 10 for s in cs.LS_TIME_GROUPS)
    sub = np.load(cs.ATLAS_SUB)
    cs.ATLAS_SUB = os.path.join(ROOT, "build", "rehearsal_atlas_sub.npz")
    os.makedirs(os.path.dirname(cs.ATLAS_SUB), exist_ok=True)
    np.savez(cs.ATLAS_SUB, x=sub["x"][:5000], log_density=sub["log_density"][:5000])
    plain = hk._matern52_gram

    def counting(x, y, ls):
        hk.matern52_gram.launches += 1
        return plain(x, y, ls)

    hk._matern52_gram = counting
    ref = np.load(cs.DATA)
    x_np = np.asarray(ref["x"][:2000], dtype=np.float32)
    ld_ref = np.asarray(ref["log_density"][:2000], dtype=np.float64)
    x = torch.as_tensor(x_np)
    noise = torch.randn(300, x.shape[1], generator=torch.Generator().manual_seed(1))
    x_new = x[:300] + 0.01 * x.std(dim=0) * noise
    Y = cs.gene_trends(x_np, cs.FUNCTION_OUTPUTS)
    tx, times, tld = cs.load_time_course()
    keep = np.concatenate([np.flatnonzero(times == t)[:1000] for t in np.unique(times)])

    def full_capacity(r):
        # float32 factors 500 landmarks of these cells but not 1,000
        mt.parameters.DEFAULT_N_LANDMARKS = 1000
        try:
            return cs.full_capacity_path(mt, x_np, ld_ref, {})
        finally:
            mt.parameters.DEFAULT_N_LANDMARKS = 500

    paths = {
        "function": lambda r: cs.function_path(mt, x_np, x_new, Y),
        "function full": lambda r: cs.function_full_path(mt, x_np, x_new, Y),
        "dimensionality": lambda r: cs.dimensionality_path(mt, x_np, x_new),
        "density full": lambda r: cs.density_full_path(mt, x_np, x_new),
        "time": lambda r: cs.time_path(mt, tx[keep], times[keep], tld[keep]),
        "time predict": lambda r: cs.time_predict_path(mt, r["time"]),
        "ls_time": lambda r: cs.ls_time_path(mt),
        "nystroem": lambda r: cs.nystroem_path(mt),
        "full capacity": full_capacity,
        "atlas": lambda r: cs.atlas_path(mt),
        "nuts": lambda r: cs.nuts_path(mt, x_np, x_new, mt.DensityEstimator().fit(x_np)),
        "dimensionality nuts": lambda r: cs.dimensionality_nuts_path(mt, x_np, r["dimensionality"][1]),
        "checkpoint": lambda r: cs.checkpoint_path(mt, r["nuts"][1], x_new),
    }
    return run_paths(paths)


if __name__ == "__main__":
    sys.exit(main())
