"""Local gene-change analysis with fractal-dimension density, on
mellon_tpu_torch.

The flow of ``gene_change_analysis_tutorial.py`` through the PyTorch
package, on the GPU by default: a density fit with ``d_method="fractal"``
(effective intrinsic dimensionality for density normalization), the
DimensionalityEstimator for per-cell local dimension, and
density-gradient-aligned local gene change scores.

Usage: python examples/gene_change_analysis_tutorial_torch.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mellon_tpu_torch as mellon

# --- synthetic embedding: a curved 2-d manifold inside 10 dims --------------
rs = np.random.RandomState(0)
n = 4000
u = rs.rand(n, 2) * 4
manifold = np.stack(
    [u[:, 0], u[:, 1], np.sin(u[:, 0]), np.cos(u[:, 1])] + [u[:, 0] * 0] * 6,
    axis=1,
)
X = (manifold + rs.randn(n, 10) * 0.02).astype(np.float32)

# --- density with fractal intrinsic dimension --------------------------------
model = mellon.DensityEstimator(d_method="fractal")
log_density = model.fit_predict(X)
print(f"fractal-d density fit: d={float(model.d):.2f} "
      f"(embedding dim 10, intrinsic dim 2)")

# --- per-cell local dimensionality (joint dim+density GP) --------------------
dim_est = mellon.DimensionalityEstimator(n_landmarks=500)
local_dim = dim_est.fit_predict(X)
print(f"local dimensionality: mean {float(local_dim.mean()):.2f}, "
      f"range [{float(local_dim.min()):.2f}, {float(local_dim.max()):.2f}]")
log_density_lowd = dim_est.predict_density(X)
print(f"dimensionality-corrected density range "
      f"[{float(log_density_lowd.min()):.2f}, {float(log_density_lowd.max()):.2f}]")

# --- local gene-change score: expression gradient along density gradient -----
# (the tutorial scores genes by their change along the density landscape)
gene_expr = (np.sin(X[:, 0] * 2.0) + 0.1 * rs.randn(n)).astype(np.float32)
gene_model = mellon.FunctionEstimator(sigma=0.1, n_landmarks=500)
gene_model.fit(X, gene_expr)
gene_grad = gene_model.predict.gradient(X[:500])
dens_grad = model.predict.gradient(X[:500])
alignment = (gene_grad * dens_grad).sum(dim=1)
print(f"density-aligned gene change score: mean |score| "
      f"{float(alignment.abs().mean()):.4f}")
print("gene-change-analysis tutorial flow complete")
