"""Gene-expression trends along a pseudotime trajectory, on
mellon_tpu_torch.

The flow of ``trajectory_trends_tutorial.py`` through the PyTorch package,
on the GPU by default: FunctionEstimator smooths per-cell gene expression
onto a pseudotime grid — many genes at once via multi-output y — with
per-gene noise levels and leverage/observation-variance diagnostics.

Usage: python examples/trajectory_trends_tutorial_torch.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mellon_tpu_torch as mellon

# --- synthetic lineage: pseudotime + noisy expression of 50 genes -----------
rs = np.random.RandomState(0)
n_cells, n_genes = 3000, 50
pseudotime = (np.sort(rs.rand(n_cells)) * 10).astype(np.float32)

# each gene follows its own smooth trend with gene-specific noise
onsets = rs.rand(n_genes) * 8
noise = 0.05 + 0.3 * rs.rand(n_genes)
trends_true = 1 / (1 + np.exp(-(pseudotime[:, None] - onsets) * 2))
expressions = (trends_true + rs.randn(n_cells, n_genes) * noise).astype(np.float32)

pseudotime_grid = np.linspace(0, 10, 200, dtype=np.float32)

# --- smooth all genes in one fit (per-gene sigma) ----------------------------
model = mellon.FunctionEstimator(ls=5, sigma=noise.astype(np.float32), n_landmarks=100)
trends = model.fit_predict(pseudotime, expressions, pseudotime_grid)
print(f"smoothed {n_genes} gene trends onto {len(pseudotime_grid)} grid "
      f"points: {tuple(trends.shape)}")

# recovered trends should match the noise-free truth closely
truth_on_grid = 1 / (1 + np.exp(-(pseudotime_grid[:, None] - onsets) * 2))
rmse = float(np.sqrt(np.mean((trends.double().cpu().numpy() - truth_on_grid) ** 2)))
print(f"rmse vs noise-free truth: {rmse:.4f} (gene noise levels 0.05-0.35)")
assert rmse < 0.1

# --- diagnostics: leverage and smoothed observation variance -----------------
single = mellon.FunctionEstimator(
    ls=5, sigma=float(noise[0]), n_landmarks=100, obs_variance=True
)
single.fit(pseudotime, expressions[:, 0])
h = single.leverage(pseudotime[:500])
ov = single.get_obs_variance(pseudotime_grid)
print(f"leverage range [{float(h.min()):.4f}, {float(h.max()):.4f}]; "
      f"mean smoothed obs-variance {float(ov.mean()):.4f} "
      f"(true noise var {float(noise[0])**2:.4f})")
print("trajectory-trends tutorial flow complete")
