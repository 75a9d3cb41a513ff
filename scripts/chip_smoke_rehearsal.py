#!/usr/bin/env python3
"""Rehearse chip_smoke.py's FunctionEstimator, DimensionalityEstimator,
full-GP and time paths (14-19, 21) on the CPU at a reduced size.

    python scripts/chip_smoke_rehearsal.py [outputs]

It runs the paths' own functions with the plain Matern-5/2 version in
place of the CUDA kernel (counted as launches), on the first 2,000
benchmark cells, 500 default landmarks, FULL_CELLS = 500 and ``outputs``
gene trends (default 100); [time] and [time predict] on the first 1,000
cells of each of the time course's 8 time points (their certificate
against the full course's float64 fit does not apply there and is
reported, not held), [ls_time] on a tenth of its cells per time point:
the control flow, the launch counts and the float32-vs-float64 gaps that
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


def main():
    torch.set_num_threads(4)
    torch.cuda.synchronize = lambda *args, **kwargs: None
    mt.config.DEFAULT_DEVICE = "cpu"
    mt.parameters.DEFAULT_N_LANDMARKS = 500
    cs.DEVICE = "cpu"
    cs.FULL_CELLS = 500
    cs.FUNCTION_OUTPUTS = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    plain = hk._matern52_gram

    def counting(x, y, ls):
        hk.matern52_gram.launches += 1
        return plain(x, y, ls)

    hk._matern52_gram = counting
    x_np = np.asarray(np.load(cs.DATA)["x"][:2000], dtype=np.float32)
    x = torch.as_tensor(x_np)
    noise = torch.randn(300, x.shape[1], generator=torch.Generator().manual_seed(1))
    x_new = x[:300] + 0.01 * x.std(dim=0) * noise
    Y = cs.gene_trends(x_np, cs.FUNCTION_OUTPUTS)
    cs.LS_TIME_GROUPS = tuple(s // 10 for s in cs.LS_TIME_GROUPS)
    tx, times, tld = cs.load_time_course()
    keep = np.concatenate([np.flatnonzero(times == t)[:1000] for t in np.unique(times)])
    cs.TIME_CERT_MIN_CORR, cs.TIME_CERT_MAX_RMSE = -1.0, float("inf")
    time_est = {}

    def time_paths():
        time_est["est"] = cs.time_path(mt, tx[keep], times[keep], tld[keep])

    paths = {
        "function": lambda: cs.function_path(mt, x_np, x_new, Y),
        "function full": lambda: cs.function_full_path(mt, x_np, x_new, Y),
        "dimensionality": lambda: cs.dimensionality_path(mt, x_np, x_new),
        "density full": lambda: cs.density_full_path(mt, x_np, x_new),
        "time": time_paths,
        "time predict": lambda: cs.time_predict_path(mt, time_est["est"]),
        "ls_time": lambda: cs.ls_time_path(mt),
    }
    failed = []
    for label, run in paths.items():
        t0 = time.perf_counter()
        try:
            cs.counted_path(hk, label, run)
        except AssertionError as error:
            failed.append(label)
            print(f"[{label}] bar failed: {error}", flush=True)
        print(f"[{label}] CPU seconds {time.perf_counter() - t0:.1f}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
