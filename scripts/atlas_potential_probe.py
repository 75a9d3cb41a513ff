#!/usr/bin/env python3
"""How much float32 rounding the samplers' density potential carries at
configuration 5's atlas (1M x 50 cells, 5,000 landmarks), on one NVIDIA GPU.

    python3 scripts/atlas_potential_probe.py [cells]

It fits chip_smoke.py's atlas in float32 (L-BFGS MAP), Newton-polishes the
MAP and whitens with T = R^-T of the Hessian there, as [atlas nuts] does,
then evaluates three forms of the batched potential, each zero-centred at
the L-BFGS MAP z0 by the per-cell offset, at 41 points on a line through
the polished MAP (spacings 1e-4, 1e-2 and 1 along a whitened direction),
against the same potential with L in float64 at the same points:

* offset: F = L z in float32, the cells summed in float32 (the JAX
  package's form);
* offset, float64 sum: the same terms summed in float64;
* centred: F = F(z0) + L (z - z0), the likelihood's change summed around
  z0 (losses.make_density_value_and_grad_batch(center=z0), what
  zero_centered_potential returns).

Printed per form and spacing: the error's mean, std and largest value, and
the float64 potential's range on the line; the terms' spread at the MAP;
how well T whitens the float64 Hessian (the eigenvalues of T^T H T); the
gradient's error in z and in w.  Then NUTS in w (8 chains, 30 + 20
transitions, depth cap 6, step 0.5 to start) on the offset form and on the
centred form: step size, acceptance, leapfrogs per draw, split-R-hat.
"""

import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import mellon_tpu_torch as mt  # noqa: E402
from mellon_tpu_torch.inference import mcmc  # noqa: E402
from mellon_tpu_torch.inference.diagnostics import split_rhat  # noqa: E402
from mellon_tpu_torch.inference.likelihoods import nearest_neighbors_terms  # noqa: E402
from mellon_tpu_torch.inference.losses import (  # noqa: E402
    density_hessian,
    make_density_value_and_grad_batch,
)

NUTS = dict(num_warmup=30, num_samples=20, max_tree_depth=6, initial_step_size=0.5)


def float64_sum_potential(L, nn, d, mu, offset):
    """The offset form with the cells' terms summed in float64."""
    V, Vdr = nearest_neighbors_terms(nn, d)
    V, Vdr = V[:, None], Vdr[:, None]

    def value_and_grad(Z):
        k = Z.shape[1]
        F = L @ Z.T + mu
        E = torch.exp(F + V)
        prior = -(1 / 2) * torch.sum(Z * Z, dim=1) - (k / 2) * math.log(2 * math.pi)
        likelihood = torch.sum((F + Vdr) - E + offset, dim=0, dtype=torch.float64)
        return (-(prior.double() + likelihood)).to(Z.dtype), Z - (L.T @ (1 - E)).T

    return value_and_grad


def main():
    if not torch.cuda.is_available():
        print("atlas_potential_probe: no CUDA device is available.", file=sys.stderr)
        return 2
    cells = int(sys.argv[1]) if len(sys.argv) > 1 else cs.ATLAS_CELLS
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cs.log(f"[probe] {smi}; torch {torch.__version__}")
    t0 = time.perf_counter()
    x = cs.atlas_cells(cells, cs.ATLAS_DIMS, cs.ATLAS_SEED)
    est = mt.DensityEstimator(n_landmarks=cs.ATLAS_LANDMARKS, device=cs.DEVICE).fit(
        x, build_predict=False)
    L, nn, d, mu = est._loss_args
    z0 = est.pre_transformation
    cs.log(f"[probe] fit {time.perf_counter() - t0:.1f} s; L {tuple(L.shape)}; "
           f"L-BFGS {est.opt_state.n_steps} steps")
    centred, offset = mcmc.zero_centered_potential(z0, L, nn, d, mu)
    forms = {"offset": make_density_value_and_grad_batch(L, nn, d, mu, offset),
             "offset, float64 sum": float64_sum_potential(L, nn, d, mu, offset),
             "centred": centred}
    hessian = lambda z: density_hessian(z, L, nn, d, mu)  # noqa: E731
    z_map, gn0, gn1 = mcmc.newton_polish(centred, hessian, z0)
    H = hessian(z_map)
    T = mcmc.precondition_transform(mcmc.hessian_cholesky(H))
    cs.log(f"[probe] Newton polish |g| {gn0!r} -> {gn1!r}")
    V, Vdr = nearest_neighbors_terms(nn, d)
    F = L @ z_map + mu
    terms = (F + Vdr) - torch.exp(F + V) + offset
    cs.log(f"[probe] terms at the MAP: mean {float(terms.mean())!r}, std {float(terms.std())!r}, "
           f"max |.| {float(terms.abs().max())!r}; F in [{float(F.min())!r}, {float(F.max())!r}], "
           f"e^(F+V) max {float(torch.exp(F + V).max())!r}")
    L64, nn64 = L.double(), nn.double()
    truth = make_density_value_and_grad_batch(L64, nn64, d, mu, offset)
    gen = torch.Generator(device=cs.DEVICE).manual_seed(3)
    v = T @ torch.randn(T.shape[0], device=cs.DEVICE, dtype=T.dtype, generator=gen)
    for spacing in (1e-4, 1e-2, 1.0):
        Z = z_map + torch.linspace(-spacing, spacing, 41, device=cs.DEVICE, dtype=T.dtype)[:, None] * v
        want, g64 = truth(Z.double())
        for name, form in forms.items():
            got, g = form(Z)
            err = got.double() - want
            cs.log(f"[probe] spacing {spacing}: {name}: error mean {float(err.mean())!r}, std "
                   f"{float(err.std())!r}, max {float(err.abs().max())!r}; float64 range "
                   f"{float(want.max() - want.min())!r}; gradient error in z "
                   f"{float((g[:1].double() - g64[:1]).norm())!r}, in w "
                   f"{float(((g[:1].double() - g64[:1]) @ T.double()).norm())!r}")
    H64 = density_hessian(z_map.double(), L64, nn64, d, mu)
    whitened = torch.linalg.eigvalsh(T.double().T @ H64 @ T.double())
    eig = torch.linalg.eigvalsh(H64)
    cs.log(f"[probe] H64 eigenvalues [{float(eig.min())!r}, {float(eig.max())!r}]; T^T H64 T "
           f"[{float(whitened.min())!r}, {float(whitened.max())!r}]; float32 H vs float64 "
           f"{float((H.double() - H64).abs().max() / H64.abs().max())!r}")
    del L64, nn64, truth, H64
    torch.cuda.empty_cache()
    sub = torch.as_tensor(cs.latent_subset(T.shape[0]), device=cs.DEVICE)
    for name in ("offset", "centred"):
        potential = cs.CountedCalls(mcmc.preconditioned_potential(forms[name], T, z_map))
        w0 = z_map.new_zeros((8, T.shape[0]))
        gen = torch.Generator(device=cs.DEVICE).manual_seed(1)
        res, seconds = cs.synced_seconds(lambda: mcmc.run_mcmc(potential, w0, gen, **NUTS))
        z = mcmc.unwhiten_samples(res.samples, T, z_map)
        cs.log(f"[probe] NUTS {NUTS} on the {name} form: {seconds!r} s, {potential.calls} leaves "
               f"({1e3 * seconds / potential.calls!r} ms each), step {float(res.step_size)!r}, "
               f"acceptance {float(res.accept_prob.mean())!r}, leapfrogs per draw "
               f"{float(res.num_leapfrog.double().mean())!r}, split-R-hat over "
               f"{len(sub)} latents {float(np.max(split_rhat(z[:, :, sub])))!r}")
    cs.log(f"[probe] seconds {time.perf_counter() - t0!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
