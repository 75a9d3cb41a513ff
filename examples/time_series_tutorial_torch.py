"""Time-resolved density over a developmental time course, on
mellon_tpu_torch.

The flow of ``time_series_tutorial.py`` through the PyTorch package, on
the GPU by default (time-sensitive density fit → per-time evaluation →
time derivative → trajectory × time-grid densities via multi_time →
serialization), with a synthetic time course standing in for the mouse
gastrulation atlas.

Usage: python examples/time_series_tutorial_torch.py
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mellon_tpu_torch as mellon

# --- synthetic time course: a population drifting and growing over time -----
rs = np.random.RandomState(0)
stages = []
stage_times = [0.0, 1.0, 2.0, 3.0]
for t in stage_times:
    n_t = int(2000 + 1000 * t)            # the population grows over time
    stages.append((rs.randn(n_t, 2) * 0.5 + t * 0.8, np.full(n_t, t)))
X = np.concatenate([s[0] for s in stages]).astype(np.float32)
X_times = np.concatenate([s[1] for s in stages]).astype(np.float32)

# --- fit (ls_time given, as in the tutorial; omit it to auto-select) --------
t_est = mellon.TimeSensitiveDensityEstimator(d=2, ls_time=1.5)
t_est.fit(X, X_times)
density_predictor = t_est.predict

# density and its rate of change at each developmental stage
for time in stage_times:
    ld = density_predictor(X, time)
    dld_dt = density_predictor.time_derivative(X, time)
    print(f"E{time:.0f}: mean log-density {float(ld.mean()):7.3f}, "
          f"mean d(log-density)/dt {float(dld_dt.mean()):7.3f}")

# --- gene-trend style smoothing of a trajectory (FunctionEstimator) ---------
# a pseudo-trajectory through state space, smoothed onto a fine grid
traj_support = np.linspace(0.0, 2.4, 30)[:, None] * np.ones((1, 2))
traj_noisy = (traj_support + 0.05 * rs.randn(30, 2)).astype(np.float32)
traj_support = traj_support.astype(np.float32)
grid = (np.linspace(0.0, 2.4, 200)[:, None] * np.ones((1, 2))).astype(np.float32)

diffcomp_est = mellon.FunctionEstimator(ls=1, sigma=0.1, n_landmarks=100)
trajectory = diffcomp_est.fit_predict(traj_support, traj_noisy, grid)
print(f"smoothed trajectory: {tuple(trajectory.shape)}")

# density along the trajectory across the whole time grid in one call
time_grid = np.linspace(0.0, 3.0, 200).astype(np.float32)
densities = density_predictor(trajectory, multi_time=time_grid)
print(f"trajectory x time densities: {tuple(densities.shape)} "
      f"(200 states x {len(time_grid)} times)")

# --- serialization round trip ------------------------------------------------
state = density_predictor.to_dict()
restored = mellon.Predictor.from_dict(state)
check = restored(X[:100], stage_times[1])
assert torch.allclose(check, density_predictor(X[:100], stage_times[1]), atol=1e-6)
print("time predictor to_dict/from_dict roundtrip: identical")
print("time-series tutorial flow complete")
