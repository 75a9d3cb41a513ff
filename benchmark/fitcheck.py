"""What a density fit produced, and its comparison with the plain
reference, shared by the drivers whose window or set-up fits.

The reference follows the program from one thing it computed: the kept
landmarks (a seeded k-means++ draw from the program's generator, then,
where the landmark kernel is singular in float32, the pivoted-Cholesky
selection).  The draw's stream an independent reference cannot repeat,
and the dropped candidates are not kept; the selection's order it
checks (``pivot_gap``: the greedy rule redone on the kept landmarks in
float64).  Everything else is worked out again from the cells."""

import math

import numpy as np
import torch

from benchmark.reference import density as ref


PRIOR_ROWS = 2048
# Mellon's documented default landmark count (at most the cells)
DEFAULT_LANDMARKS = 5000


def sample_rows(n, rows, seed):
    """``rows`` sorted cell indices of n drawn from ``seed`` (all where
    n ≤ rows)."""
    if n <= rows:
        return torch.arange(n)
    return torch.as_tensor(np.sort(np.random.default_rng([seed, 13]).choice(n, rows, replace=False)))


def fit_outputs(est, seed, config):
    """The fit's answers and state, as CPU tensors: the 1-NN distances, d,
    μ, ls, the kept landmarks, PRIOR_ROWS rows of L drawn from ``seed``
    (and their indices), the optimum z and the log density at the
    cells, and whether the landmarks were pruned (fewer kept than the
    k-means candidates that the configuration ``config`` asks for)."""
    cpu = lambda t: t.detach().to("cpu")  # noqa: E731
    out = {
        "nn": cpu(est.nn_distances), "d": float(est.d), "mu": float(est.mu),
        "ls": float(est.ls), "landmarks": cpu(est.landmarks),
        "pruned": est.landmarks.shape[0] < min(
            config.get("estimator", {}).get("n_landmarks", DEFAULT_LANDMARKS), config["cells"]),
        "z": cpu(est.pre_transformation).reshape(-1), "ld": cpu(est.log_density_x),
    }
    out["rows"] = sample_rows(est.L.shape[0], PRIOR_ROWS, seed)
    out["L"] = cpu(est.L[out["rows"].to(est.L.device)])
    return out


def control_fit(x, fit, device, z_start):
    """The reference in the program's place at the control's precision:
    the same outputs as :func:`fit_outputs` from the cells and the
    program's landmarks, its MAP by Newton's method from ``z_start``."""
    landmarks, rows = fit["landmarks"], fit["rows"]
    model = ref.Model(torch.as_tensor(x).to(device), landmarks.to(device), ref.CONTROL)
    z = model.newton_map(z_start)
    out = {"nn": model.nn.cpu(), "d": float(model.d), "mu": model.mu, "ls": model.ls,
           "landmarks": landmarks, "pruned": fit["pruned"], "z": z.cpu(),
           "rows": rows, "L": model.L[rows.to(model.L.device)].cpu(),
           "ld": model.log_density(z).cpu()}
    return out, model


def reference_model(x, landmarks, device):
    return ref.Model(torch.as_tensor(x).to(device), landmarks.to(device), ref.F64)


def fit_numbers(fit, model, z_map):
    """The numbers compared for one fit against the float64 reference
    ``model`` and its MAP ``z_map``: the largest relative gap of the 1-NN
    distances, the gap of μ (nats), the relative gap of ls, the largest
    gap of the prior covariance L Lᵀ between the sampled cells (free of
    L's basis: float32 leaves L's columns off by ~1e-3 in directions of
    tiny prior variance, which L Lᵀ barely sees), the largest gap of the
    log density at a cell over the reference's spread there, and where the
    landmarks were pruned :func:`..reference.density.pivot_gap` of their
    kernel in float64."""
    dev = model.L.device
    nn = fit["nn"].to(dev, torch.float64)
    ld_ref = model.log_density(z_map)
    Lp = fit["L"].to(dev, torch.float64)
    Lr = model.L[fit["rows"].to(dev)]
    spread = float(ld_ref.max() - ld_ref.min())
    return {
        "nn_rel": float(((nn - model.nn).abs() / model.nn).max()),
        "mu_gap": abs(fit["mu"] - model.mu),
        "ls_rel": abs(fit["ls"] - model.ls) / model.ls,
        "prior_gap": float((Lp @ Lp.T - Lr @ Lr.T).abs().max()),
        "ld_gap": float((fit["ld"].to(dev, torch.float64) - ld_ref).abs().max()) / spread,
        "pivot_gap": (ref.pivot_gap(ref.matern52(model.xu, model.xu, model.ls, ref.F64))
                      if fit["pruned"] else 0.0),
    }


def worst(rows):
    """The largest reading of each number over ``rows`` (NaN wins)."""
    out = {}
    for row in rows:
        for name, value in row.items():
            prev = out.get(name, -math.inf)
            out[name] = value if (math.isnan(value) or value > prev or math.isnan(prev)) else prev
    return out
