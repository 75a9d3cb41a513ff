"""Cell-state density estimation, start to finish, on mellon_tpu_torch.

The flow of ``basic_tutorial.py`` (density fit on a cell-state embedding →
predictor → serialization → out-of-sample evaluation) through the PyTorch
package, on the GPU by default (``mellon_tpu_torch.config.DEFAULT_DEVICE``).
The synthetic embedding stands in for the reference tutorial's
T-cell-depleted bone-marrow diffusion-map eigenvectors, so it runs
anywhere without downloads.

Usage: python examples/basic_tutorial_torch.py
"""

import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mellon_tpu_torch as mellon

# --- synthetic stand-in for ad.obsm["DM_EigenVectors"] ----------------------
# three cell populations with different densities in a 10-dim state space
rs = np.random.RandomState(0)
populations = [
    rs.randn(4000, 10) * 0.3,                       # dense population
    rs.randn(1500, 10) * 0.6 + 2.0,                 # looser population
    rs.randn(500, 10) * 1.0 - 2.0,                  # rare population
]
X = np.concatenate(populations).astype(np.float32)

# --- fit the density model (all defaults, like the tutorial) ----------------
model = mellon.DensityEstimator()
log_density = model.fit_predict(X)
print(f"fit {X.shape[0]:,} cells on {log_density.device}; log-density range "
      f"[{float(log_density.min()):.2f}, {float(log_density.max()):.2f}]")

# denser populations should score higher
d_dense = float(log_density[:4000].mean())
d_rare = float(log_density[-500:].mean())
print(f"mean log-density: dense pop {d_dense:.2f} > rare pop {d_rare:.2f}")
assert d_dense > d_rare

# --- the predictor is the deployable artifact --------------------------------
predictor = model.predict

# embed in an AnnData-style dict (ad.uns["log_density_function"] in the
# tutorial) and reconstitute
state = predictor.to_dict()
restored = mellon.Predictor.from_dict(state)
assert torch.allclose(restored(X), predictor(X), atol=1e-6)
# the predictor's conditional mean matches the training log-densities to
# f32 conditioning accuracy
assert torch.allclose(restored(X), log_density, atol=1e-2)
print("to_dict/from_dict roundtrip: identical predictions")

# JSON file serialization (+gzip), evaluable on out-of-sample states
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "density_predictor.json.gz")
    predictor.to_json(path, compress="gzip")
    loaded = mellon.Predictor.from_json(path)
X_new = (rs.randn(100, 10) * 0.3).astype(np.float32)
print(f"out-of-sample mean log-density: {float(loaded(X_new).mean()):.2f}")

# gradients of the density field (e.g. for density-directed trajectories)
grads = predictor.gradient(X_new)
print(f"density gradient shape: {tuple(grads.shape)}")

# --- uncertainty-aware variant (ADVI + predictor_with_uncertainty) -----------
model_u = mellon.DensityEstimator(
    optimizer="advi", predictor_with_uncertainty=True, n_landmarks=500
)
model_u.fit(X)
unc = model_u.predict.uncertainty(X_new)
print(f"posterior uncertainty at new states: mean {float(unc.mean()):.4f}")
print("basic tutorial flow complete")
