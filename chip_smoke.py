#!/usr/bin/env python3
"""Drive mellon_tpu_torch's estimators once on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each printed as it runs (any failure raises and exits non-zero).
Each path (3, 5-8 and 11-26) runs with the kernel's launch count set to 0
just before it and read just after, and fails if the kernel was not
launched; the operands of every kernel call the covariance module makes on
these paths are kept for phase 4.  Path 27's ranks are processes of their
own: each counts its launches from 0 over its fit and its sharded
predictor and reports them with its calls' shapes, and the path fails if
any rank launched the kernel no time.

1. device: the card's name and power limit (from nvidia-smi);
2. build: nvcc builds the Matern-5/2 kernel from csrc/ into build/;
3. fit (the main path): DensityEstimator().fit_predict on the 8,627 x 20
   benchmark cells, certified against the host-float64 full-landmark fit
   stored in benchdata/ld_ref_8627x20_f64.npz (corr >= 0.999, RMSE <= 0.01
   of the spread), then .predict at the training points (equal to
   f = Lz + mu within 1e-3 of the spread) and at 1,000 perturbed points
   (finite);
4. kernel: the CUDA tile against its plain PyTorch version on the card, on
   the operands the paths gave it (K_uu, C, the predictor's mean,
   covariance and derivative calls) and at synthetic shapes (ragged and
   unaligned, d from 1 to 130, one output element, more rows or columns
   than 65535 tiles of 64): in float32 the kernel's max abs error against
   the same function in float64 <= 1e-5, or KERNEL_VS_PLAIN_F64 times the
   plain version's where that is larger (kernel_errors); in float64 the
   kernel within 1e-12 of its plain version.  At every path shape, in both
   types, the kernel's device time (median of N_RUNS runs of CUDA events
   around N_LAUNCHES
   back-to-back launches of its C entry point into one output, divided by
   N_LAUNCHES) beside the plain version's, timed the same way, and the
   bound: the larger of the bytes over the memory rate and the flops over
   the peak rate;
   predict batch: the same in float32 at the PREDICT_BATCH-point shapes
   (200,000 query points against the kept landmarks, both orientations),
   checked on 2,000 rows or columns at each end, the plain version timed
   over fewer launches (its temporaries are several times the 1.64 GB
   output);
5. uncertainty: DensityEstimator(predictor_with_uncertainty=True) on the
   same cells (L-BFGS, then the diagonal Laplace approximation), certified
   as in 3; covariance, mean_covariance and uncertainty at 1,000 perturbed
   points and at the PREDICT_BATCH batch (finite, mean_covariance >= 0),
   and at the 1,000 points against the same predictor state in float64
   on the card (max |f32 - f64| <= UNCERTAINTY_F64_REL of the largest
   float64 value);
6. advi: DensityEstimator(optimizer="advi", predictor_with_uncertainty=True)
   (100 steps, 40 draws each, a CUDA generator): its time, the ELBO of the
   first and last 10 steps (the last must be higher), and its agreement
   with the float64 reference (printed, no bar: the JAX package is held to
   none for ADVI);
7. derivatives: gradient, hessian and hessian_log_determinant of the main
   path's predictor at the 1,000 points, one of them moved onto a
   landmark, against autograd through the plain version on the card
   (DERIV_REL of the largest value; at the landmark the gradient, and a
   finite Hessian); the backward's device time at 1000 x 2048;
8. json: the main path's predictor through gzip JSON and back on the card
   (JSON_REL of the spread), and the reference Mellon's predictor
   (tests/fixtures) in float64 against its own predictions (FIXTURE_ATOL);
9. wrapper: the host time of one ``matern52_gram`` call, over 1,000 calls
   without a synchronise, in turns with the call below its autograd
   routing;
10. timing: the warm fit time (median of 3) and a per-stage breakdown;
11. nuts: DensityEstimator(optimizer="nuts", predictor_with_uncertainty=True)
   with the estimator's default sampler settings (depth 10, step 0.1) but
   16 chains, 100 warmup transitions and 50 draws (NUTS_OPTIONS; the
   default 200 and 200 do not fit the time budget): its sampling time, step
   size, acceptance, divergences,
   leapfrogs per draw (reported, and the potential's evaluations counted),
   host reads per transition, ESS and ESS/s, held to max split-R-hat <=
   NUTS_MAX_RHAT, min-ESS >= NUTS_MIN_ESS, mean NUTS std / mean Laplace
   std in STD_RATIO and
   corr(posterior-mean log density, the main path's) >= POSTERIOR_MIN_CORR;
   its uncertainty at the 1,000 points (finite);
12. nuts precond: sample_density_posterior(precondition="hessian") on the
   main path's fit (PRECOND settings) after the Newton polish, Hessian
   build and factor run and timed on their own: draws/s, ESS/s, the
   Geyer-truncated dimensions, held to max split-R-hat <= PRECOND_MAX_RHAT;
   TRACE_TRANSITIONS more transitions from its last draws under
   torch.profiler (busy and idle share, host reads per transition); the
   draws' mean-and-std predictor at the 1,000 points (finite);
13. smc: smc_density_posterior on the main path's fit (SMC settings): its
   stages, β, the log evidence ± its across-sweep std, the acceptance
   range, held to β = 1, a finite evidence and corr(particle-mean log
   density, the main path's) >= POSTERIOR_MIN_CORR; the particles'
   predictor at the 1,000 points (finite);
14. function: FunctionEstimator(sigma=0.1, obs_variance=True) on the
   benchmark cells and FUNCTION_OUTPUTS gene trends (smooth functions of
   the cells plus N(0, 0.1²) noise, from GENE_SEED), the sparse type on
   5,000 k-means landmarks pruned at float32: the prediction at the 1,000
   points, the leverage at every cell and the observation variance at the
   1,000 points, then the same with a per-feature σ on the first
   PER_FEATURE_OUTPUTS outputs (one σ per output, on the first fit's
   landmarks and factor); each within FUNCTION_F64_REL of a float64 fit
   on the card on the same landmarks and length scale, the leverage
   within [0, 1], with the count of leverages float32 left to the float64
   recomputation;
15. function full: FunctionEstimator(sigma=1.0, n_landmarks=0,
   obs_variance=True) on the first FULL_CELLS cells and the same outputs
   (the full GP type), held to float64 in the same way;
16. dimensionality: DimensionalityEstimator(predictor_with_uncertainty=True)
   on the benchmark cells: the local dimensions and log densities at the
   cells, predict and predict_density (and their uncertainty) at the 1,000
   points, the local dimensions finite and in (0, 2d]; a float64 fit on
   the same landmarks, each fit's L-BFGS steps, whether it met its
   tolerance and the two fits' correlation; then each fit's L-BFGS
   continued from its solution (at most DIMENSIONALITY_CONTINUE steps),
   both to tolerance, their optima within DIMENSIONALITY_OPTIMUM_MIN_CORR
   of each other;
17. density full: DensityEstimator(predictor_with_uncertainty=True) on the
   first FULL_CELLS cells (the full GP type: an L-BFGS MAP over as many
   latents), d_method="fractal" on the same cells, and the README's first
   example (100 x 10 normal cells); each within DENSITY_FULL_MIN_CORR of
   its float64 fit on the card;
18. time: TimeSensitiveDensityEstimator(ls_time=TIME_LS) on the 98,192 x 2
   time course over 8 time points (benchdata/ref_time_98192x2_f64.npz),
   float32, stage-synchronized, certified against the host-float64 fit
   there (corr >= TIME_CERT_MIN_CORR, RMSE <= TIME_CERT_MAX_RMSE of the
   spread), and a warm fit with the same seed that must equal it bit for
   bit (landmarks, latents, loss);
19. time predict: that fit's predictor over TIME_GRID times at 1,000
   cells (one call of 200,000 rows), and its time derivative, gradient and
   Hessian log-determinant at one time, against the same state in float64
   (TIME_PREDICT_F64_REL) and against autograd through the plain version
   (DERIV_REL), the log-determinant against both (TIME_LOGDET_ABS,
   TIME_LOGDET_SIGN_FLIPS); a gzip JSON round trip (JSON_REL);
20. time matched: the port's fit on the JAX package's float64 prepare of
   the same cells (benchdata/f64_prepare_time98k_seed43.npz) in float64,
   corr >= TIME_MATCHED_MIN_CORR with that fit's log density, then the
   same in float32 (printed);
21. ls_time: automatic ls_time on 20,000 cells at d = 2 over ten ragged
   time points: the batched fits in float32 and float64 and the per-time
   loop in float64, batched within LS_TIME_LOOP_REL of the loop, float32
   within LS_TIME_F32_REL of float64;
22. nystroem: DensityEstimator(gp_type="sparse_nystroem", rank=0.999,
   n_landmarks=2000) on the cells of benchdata/ref_nystroem_8627x20_f64.npz,
   certified against its float64 fit (NYSTROEM_CERT_MIN_CORR,
   NYSTROEM_CERT_MAX_RMSE): the kept landmarks, the rank, the eigensolver
   (direct or sketch), the warm fit time (median of 3), the gap to a
   float64 fit on the card, and the predictor at the training points
   against the float64 fit's (its distance from f printed: the Nyström
   predictor smooths); then gp_type="full_nystroem" on FULL_CELLS cells,
   float32 against float64 (DENSITY_FULL_MIN_CORR);
23. full capacity: config.PRUNE_SINGULAR_LANDMARKS = False at the bench
   shape (restored after): all 5,000 landmarks kept, L within
   CAPACITY_L_REL (relative RMS) of a float64 construction from the plain
   kernel, certified with the main path's bars beside the pruned
   default's figures; then EXTENDED_PRECISION_WHITEN = False, printed;
24. atlas: 1M x 50 cells from ATLAS_SEED by bench.make_data's recipe,
   DensityEstimator(n_landmarks=5000) stage-synchronised (the kNN stage on
   its own, the kept rank, L's bytes), then precision="bf16" on the same
   prepared model (both phases' steps), held to the float32 fit (BF16_MIN_CORR,
   BF16_MAX_RMSE); the 50,000 x 50 subscale float32 fit certified against
   benchdata/ref_atlas_sub_50000x50_f64.npz with the main path's bars;
   then atlas nuts, counted on its own: configuration 5's sampler
   (scripts/atlas_nuts_bench.py's flow with precond) from the float32 MAP:
   the zero-centred potential, the Newton polish, the MAP-Hessian Cholesky
   and T = R^-T (each timed), NUTS in w (ATLAS_NUTS), the draws unwhitened;
   over ATLAS_SUBSET latents split-R-hat <= NUTS_MAX_RHAT, min-ESS >=
   NUTS_MIN_ESS and each posterior std within STD_RATIO of
   sqrt(diag(T T^T)); the posterior-mean log density at the cells within
   POSTERIOR_MIN_CORR of the MAP's, and its predictor at 1,000 cells
   (ATLAS_PREDICT_REL); the posterior mean saved to ATLAS_POSTERIOR;
25. dimensionality nuts: DimensionalityEstimator(optimizer="nuts") with
   DIM_NUTS_OPTIONS: split-R-hat <= NUTS_MAX_RHAT, draws (chains, draws,
   2, k), finite positive local dimensions, their correlation with the
   L-BFGS fit of 16 (printed); optimizer="smc" raises ValueError;
26. checkpoint: the chains of 11 saved and loaded (save_sampler_state,
   load_sampler_state with the generator's state): CHECKPOINT_DRAWS draws
   resumed from the loaded checkpoint bit-identical to those resumed from
   memory, and their predictors at the 1,000 points equal;
27. parallel: torch.distributed ranks started as processes of
   scripts/chip_smoke_parallel.py (a FileStore under build/parallel, a
   60 s group timeout; a rank that fails or outlasts PARALLEL_TIMEOUT
   fails the script), each preparing the benchmark fit itself.  Two ranks
   first: NCCL with one card each where the machine has two, else gloo with
   both on cuda:0 (NCCL takes one rank per card): the cell-sharded value
   and gradient against the local ones, shard_predict at PREDICT_BATCH
   points (its kernel launches counted on every rank, its output held to
   the plain version on that rank's card), chain-sharded NUTS at [nuts]'s
   budget and bars (its posterior-mean log density against 11's), particle-
   sharded SMC at [smc]'s, and a checkpoint of the chains.  Then one rank
   on NCCL: every sharded entry point equal to the unsharded run, the
   checkpoint resumed on the 1 x 1 mesh, and the cell-sharded
   log-prob+grad evaluations per second at 100,000 x 5,000 (also at two
   ranks with two cards).  Then the atlas on the 2 x 2 (chains x cells)
   mesh: four NCCL ranks, one card each, at 1M x 50 where the machine has
   four cards, else four gloo ranks on cuda:0 at 100,000 x 50 (the
   collectives and the control flow, not the scale): every rank's fit
   bit-identical, the sharded Hessian and its diagonal against the whole-L
   ones, the global L freed, z* and T identical on every rank,
   chain-sharded preconditioned NUTS at ATLAS_NUTS (split-R-hat, the
   posterior-mean log density against the MAP's and, at 1M, against
   24's), shard_predict of the posterior mean at PREDICT_BATCH points.
   The ranks' kernel calls join phase 4's.

Phase 4 also checks the kernel at an atlas-shaped call past 2**31 output
elements (the atlas cells against ATLAS_BIG_COLUMNS of their landmarks),
on 2,000 rows at each end, the plain version timed in row blocks.
The script prints its total seconds before the result lines.

The line before the last is the JSON kernel report (``launches``: over
all paths; ``ms``, ``plain_ms`` and ``bound_ms``: the kernel's, the plain
version's and the bound's time summed over those launches; ``shapes``:
each shape and type with its launches, its own times and share of the
bound); the last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script exits with status 2 and prints no result.
"""

import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "benchdata", "ld_ref_8627x20_f64.npz")
# edge cases the main path does not reach: ragged tiles with m not a
# multiple of the vector width; one and several feature chunks; a single
# element; more row or column tiles than a grid axis of 65535 would hold
SYNTHETIC_SHAPES = (
    (1000, 333, 7), (777, 1000, 1), (1000, 512, 50), (300, 260, 130), (1, 1, 20),
    (65535 * 64 + 5, 3, 2), (3, 65535 * 64 + 5, 2),
)
TOLERANCE = {"float32": 1e-5, "float64": 1e-12}
# near coincident points the |x|² − 2x·y + |y|² form loses ~eps·|x|²/ls² to
# cancellation, in the kernel and in its plain version alike (the time
# course's states at ls 0.35: the plain version ~8e-5 from float64 in
# float32); there the float32 kernel may be as far from float64 as the
# plain version, and a quarter more
KERNEL_VS_PLAIN_F64 = 1.25
CERT_MIN_CORR = 0.999
CERT_MAX_RMSE = 0.01
N_LAUNCHES = 20
N_RUNS = 7
PREDICT_BATCH = 200_000
# outputs of at least this many elements take the predict-batch treatment
BIG_OUTPUT = 10**8
BIG_PLAIN_LAUNCHES, BIG_PLAIN_RUNS = 5, 3
DEVICE = "cuda"
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
# bars of the new paths, each with its reason in PERF.md.  The covariance
# k(x, x) - |L^-1 k(xu, x)|^2 is a difference of two terms near k(x, x) = 1
# whose float32 rounding grows with cond(L): beside its own small values
# near the data it is the loosest (CPU rehearsal, 4,000 cells and 1,024
# kept landmarks: 0.039 for the covariance, 2.4e-4 for the others)
UNCERTAINTY_F64_REL = {"covariance": 0.25, "mean_covariance": 1e-2, "uncertainty": 1e-2}
DERIV_REL = 1e-3
JSON_REL = 1e-6
FIXTURE_ATOL = 1e-5
# the sampler paths: the split-R-hat bars and the NUTS/Laplace std ratio of
# tests/test_mcmc.py:95-124; the correlation of a posterior-mean log
# density with the MAP's, set from a CPU rehearsal (PERF.md)
NUTS_MAX_RHAT = 1.1
PRECOND_MAX_RHAT = 1.05
STD_RATIO = (0.5, 2.0)
POSTERIOR_MIN_CORR = 0.99
# the estimator's NUTS defaults are 4 chains, 200 warmup, 200 draws, depth
# 10; at the bench shape they took 70 s on the H100 (host-bound leaf loop,
# PERF.md), so this path cuts the warmup and the draws to fit its share of
# the time budget, and runs 16 chains in lockstep: the leaf loop is
# host-bound, so they cost about what 4 do (31-56 s against 32 s), and
# their min-ESS read 314-453 over three seeds where 4 chains read 21
# (split-R-hat 1.022-1.043 against 1.094; PERF.md).  The ESS floor is
# ~1/3 of the lowest of those readings
NUTS_OPTIONS = dict(num_chains=16, num_warmup=100, num_samples=50)
NUTS_MIN_ESS = 100
PRECOND = dict(num_chains=64, num_warmup=100, num_samples=200)
SMC = dict(num_particles=1024, start="laplace", num_sweeps=2)
TRACE_TRANSITIONS = 10
# the FunctionEstimator, DimensionalityEstimator and full-GP paths: the
# gene-trend outputs, the cells of the full type (the most it picks by
# default: min(n, 5,000) landmarks), and their float32-vs-float64 bars, set
# from a CPU rehearsal (PERF.md): max |f32 - f64| / max |f64| per output,
# and the correlation of the fitted functions at the cells
FUNCTION_OUTPUTS = 2000
# the per-feature σ run takes one leverage factorization per output, twice
# (the HC3 step and leverage()), in float64 where float32 fails as it does
# at this shape: with its float64 twin ~14 ms per output on the H100
# (PERF.md), so it runs on the first PER_FEATURE_OUTPUTS outputs
PER_FEATURE_OUTPUTS = 200
FUNCTION_SIGMA = 0.1
GENE_SEED = 5
FULL_CELLS = 5000
# at the bench shape the sparse type's float32 M = σ² K_uu + BᵀB fails
# (σ² = 0.01 against BᵀB's ~8,600), so every sparse leverage, the HC3 step's
# too, is the float64 recomputation from the float32 operands: there the
# leverage bar holds that recomputation, not float32 (the full type's
# leverage is float32's own); the paths count the recomputations
FUNCTION_F64_REL = {"predict": 0.05, "leverage": 1e-3, "obs_variance": 0.1}
# both dimensionality fits stop at L-BFGS's 400-step cap at the bench shape,
# unconverged, at points of a flat valley that move from run to run (corr
# 0.9904-0.9975 on the local dimension over six H100 readings, PERF.md):
# their correlation is printed, not held.  Each fit is continued from its
# solution to its tolerance (1,093-1,254 more steps there), and the two
# optima are held to each other, at ~5x the gap of the two H100 readings
# (1 - corr 3.5e-5-4.1e-5 and 7.7e-6-8.0e-6)
DIMENSIONALITY_CONTINUE = 3000
DIMENSIONALITY_OPTIMUM_MIN_CORR = {"local_dim_x": 0.9998, "log_density_x": 0.99995}
DENSITY_FULL_MIN_CORR = 0.999

# the time-sensitive paths (BASELINE.json configuration 4): the 98,192 x 2
# time course over 8 time points, certified against its host-float64 fit
# (the JAX package read 0.996117 / 0.008139 on the TPU); the JAX package's
# float64 prepare on the same cells (landmarks, nn_distances, ls, mu, d)
# and its log density, held at TIME_MATCHED_MIN_CORR; the predictor over
# TIME_GRID times at 1,000 cells; automatic ls_time on 20,000 cells over
# ten ragged time points (the group sizes of
# benchdata/logs_r5/ls_time_d2_r5.log:1)
TIME_DATA = os.path.join(ROOT, "benchdata", "ref_time_98192x2_f64.npz")
TIME_PREPARE = os.path.join(ROOT, "benchdata", "f64_prepare_time98k_seed43.npz")
TIME_LS = 0.375
TIME_CERT_MIN_CORR = 0.995
TIME_CERT_MAX_RMSE = 0.01
TIME_MATCHED_MIN_CORR = 0.9999
TIME_GRID = 200
# the mean over the grid, the time derivative and the gradient at one time
# against the same state in float64, max |diff| / max |float64|: the H100
# read 8.6e-5, 3.0e-5 and 3.0e-5 (PERF.md); the Hessian's log-determinant
# at one time, where the signs agree, absolute: an error in |det| relative
# to |det|, which float32's rounding of the Hessian grows without bound as
# the Hessian nears singular.  The H100 read 0.128 against float64 and
# 0.018 against autograd through the plain version, and the signs equal at
# all 1,000 cells; the bar is ~4x the larger reading, and at most
# TIME_LOGDET_SIGN_FLIPS cells may differ in sign
TIME_PREDICT_F64_REL = 1e-3
TIME_LOGDET_ABS = 0.5
TIME_LOGDET_SIGN_FLIPS = 5
LS_TIME_GROUPS = (2384, 2259, 2329, 1892, 2463, 2407, 2059, 1709, 2423, 1977)
LS_TIME_SEED = 10
# batched vs the per-time loop in float64 (the JAX package's two agree to
# 0.02%), float32 vs float64 batched (the JAX package's float32 sits 0.37%
# from its float64 truth)
LS_TIME_LOOP_REL = 1e-3
LS_TIME_F32_REL = 1e-2

# the paths of the Nyström types, full capacity, the atlas slice, the
# dimensionality model's NUTS and the sampler checkpoint.  [nystroem] is
# the BASELINE row (scripts/baseline_matrix.py:59-96): 2,000 landmarks at
# rank 0.999 on the cells of benchdata/ref_nystroem_8627x20_f64.npz,
# certified against that file's host-float64 fit (the JAX package read
# corr 0.999061 / RMSE 0.0132 of the spread on the TPU); [atlas] is
# configuration 5's single-card slice (scripts/atlas_bench.py:21): 1M x 50
# cells from ATLAS_SEED by bench.make_data's recipe, 5,000 landmarks, the
# bf16 MAP held to the float32 one, and the 50,000 x 50 subscale float64
# reference of scripts/accuracy_cert.py:240-268 held to the main path's
# bars; the full-capacity L held to a float64 construction of its own
# (the plain kernel, an unescalated Cholesky, a TRSM), relative RMS
NYSTROEM_DATA = os.path.join(ROOT, "benchdata", "ref_nystroem_8627x20_f64.npz")
NYSTROEM = dict(gp_type="sparse_nystroem", rank=0.999, n_landmarks=2000)
NYSTROEM_CERT_MIN_CORR = 0.998
NYSTROEM_CERT_MAX_RMSE = 0.02
FULL_NYSTROEM = dict(gp_type="full_nystroem", rank=0.999)
CAPACITY_L_REL = 1e-6
ATLAS_CELLS, ATLAS_DIMS, ATLAS_LANDMARKS, ATLAS_SEED = 1_000_000, 50, 5000, 0
ATLAS_SUB = os.path.join(ROOT, "benchdata", "ref_atlas_sub_50000x50_f64.npz")
BF16_MIN_CORR = 0.999
BF16_MAX_RMSE = 0.02
# an atlas-shaped kernel call past 2**31 output elements, checked whatever
# the atlas fit keeps (1M x 2,048 is below 2**31)
ATLAS_BIG_COLUMNS = 2200
# configuration 5's sampler (scripts/atlas_nuts_bench.py:60-140 with
# precond): Hessian-preconditioned NUTS on the atlas MAP in whitened w, 8
# chains.  The JAX script's depth 10 lets an early warmup tree cost 1,023
# leaves, ~6 s at 1M cells; depth 8 caps one at 255.  Its bars hold
# ATLAS_SUBSET latents drawn as the JAX script draws them
# (np.random.RandomState(0)); the posterior std of each against the
# Gaussian at the MAP, sqrt(diag(T Tᵀ)) = sqrt(diag(H⁻¹)), within STD_RATIO
ATLAS_NUTS = dict(num_chains=8, num_warmup=80, num_samples=80, max_tree_depth=8,
                  initial_step_size=0.5)
ATLAS_NUTS_SEED = 1
ATLAS_SUBSET = 256
ATLAS_POSTERIOR = os.path.join(ROOT, "build", "atlas_nuts_posterior_mean.npz")
# the posterior-mean predictor at 1,000 atlas cells against f = L z + mu
# there, over f's spread: its float32 weights Lp^-T z and k(x, xu) take
# another rounding path than L = C Lp^-T; at the MAP the H100 read 3.7e-3
# (PERF.md), where the bench shape holds 1e-3
ATLAS_PREDICT_REL = 1e-2
# the dimensionality model's NUTS at [nuts]'s budget; the checkpoint
# resumes its chains for CHECKPOINT_DRAWS draws
DIM_NUTS_OPTIONS = NUTS_OPTIONS
CHECKPOINT_DRAWS = 10
PARALLEL_WORKER = os.path.join(ROOT, "scripts", "chip_smoke_parallel.py")
PARALLEL_TIMEOUT = 300

# H100 SXM (NVIDIA's data sheet, at the full 700 W): HBM rate and the
# peak rates outside the tensor cores
MEMORY_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
ITEMSIZE = {"float32": 4, "float64": 8}
# per output element after the cross term, counted for the bound: the
# distance's three additions, its floor, sqrt, the scale, the polynomial's
# two fmas, exp and the product
EPILOGUE_FLOPS = 10


def log(*parts):
    print(*parts, flush=True)


def matern52_work(n, m, d, dtype):
    """(bytes, flops) the Matern-5/2 tile k(x (n, d), y (m, d)) needs: x
    and y read once and the (n, m) output written once; 2d flops of cross
    term and EPILOGUE_FLOPS per output element, 2d per row norm."""
    nbytes = ITEMSIZE[dtype] * (n * d + m * d + n * m)
    flops = n * m * (2 * d + EPILOGUE_FLOPS) + 2 * d * (n + m)
    return nbytes, flops


def matern52_bound_ms(n, m, d, dtype):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and the flops over the
    peak rate of ``dtype``."""
    nbytes, flops = matern52_work(n, m, d, dtype)
    by_bytes = 1e3 * nbytes / MEMORY_BYTES_PER_S
    by_ops = 1e3 * flops / PEAK_FLOPS[dtype]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def device_ms(fn, launches=N_LAUNCHES, runs=N_RUNS):
    """Device time of one ``fn()``: the median over ``runs`` runs of CUDA
    events around ``launches`` back-to-back calls, divided by
    ``launches``, after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / launches)
    return statistics.median(times)


def bare_launcher(lib, x, y, out, ls):
    """A call of the kernel library's C entry point on contiguous (x, y)
    into ``out``, on the current stream: the kernel alone, without the
    wrapper's checks, allocation and launch count.  Its scratch buffer,
    for a library that takes one, is allocated here once."""
    import torch

    fn = lib.matern52_gram_f32 if x.dtype == torch.float32 else lib.matern52_gram_f64
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    scratch = ()
    if hasattr(lib, "matern52_scratch_elems"):
        numel = lib.matern52_scratch_elems(n, m, d, x.element_size())
        scratch = (torch.empty(numel, dtype=x.dtype, device=x.device),)
    args = (x.data_ptr(), y.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in scratch),
            n, m, d, float(ls), x.device.index, torch.cuda.current_stream().cuda_stream)

    def launch():
        code = fn(*args)
        if code != 0:
            raise RuntimeError(f"matern52 launch failed: {lib.matern52_error_string(code).decode()}")

    launch.scratch = scratch  # every launch writes it: it lives as long as the launcher
    return launch


def record_operands():
    """Keep the operands of every kernel call the covariance module makes
    until the returned ``stop()`` is called; returns ``(calls, stop)``."""
    from mellon_tpu_torch.ops import kernels

    launch = kernels.matern52_gram
    calls = []

    def recording(x, y, ls):
        calls.append((x.detach(), y.detach(), float(ls)))
        return launch(x, y, ls)

    def stop():
        kernels.matern52_gram = launch

    kernels.matern52_gram = recording
    return calls, stop


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def kernel_errors(K, plain, x, y, ls, name):
    """The kernel's output K on (x, y) held to its bar: (max |K − plain|,
    the kernel's and the plain version's max error against the same
    function in float64 on the same inputs, the bar, ok).  In float32 the
    kernel's error against float64 is held to TOLERANCE, or to
    KERNEL_VS_PLAIN_F64 times the plain version's where that is larger; in
    float64 the kernel is held to its plain version within TOLERANCE."""
    from mellon_tpu_torch.ops.hopper_kernels import matern52_gram_reference

    err = (K - plain).abs().max().item()
    if name == "float64":
        return err, err, 0.0, TOLERANCE[name], err <= TOLERANCE[name]
    ref = matern52_gram_reference(x.double(), y.double(), ls)
    kernel_f64 = (K.double() - ref).abs().max().item()
    plain_f64 = (plain.double() - ref).abs().max().item()
    bar = max(TOLERANCE[name], KERNEL_VS_PLAIN_F64 * plain_f64)
    return err, kernel_f64, plain_f64, bar, kernel_f64 <= bar


def check_kernel(x, y, ls, label):
    """Kernel against plain version on (x, y) in float32 and float64;
    returns the float32 error."""
    import torch

    from mellon_tpu_torch.ops.hopper_kernels import matern52_gram, matern52_gram_reference

    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    for dtype in (torch.float32, torch.float64):
        xa, ya = x.to(dtype), y.to(dtype)
        K = matern52_gram(xa, ya, ls)
        torch.cuda.synchronize()
        plain = matern52_gram_reference(xa, ya, ls)
        name = dtype_name(dtype)
        err, kernel_f64, plain_f64, bar, ok = kernel_errors(K, plain, xa, ya, ls, name)
        log(f"[kernel] {label} {n}x{m}x{d} {name}: max_abs_err={err!r}; against float64: "
            f"kernel {kernel_f64!r}, plain version {plain_f64!r} (bar {bar!r}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"matern52 kernel disagrees at {n}x{m}x{d} {name}: "
                                 f"{kernel_f64} against float64 (bar {bar})")
        if dtype == torch.float32:
            err32 = err
    return err32


def time_shape(lib, x, y, ls, launches):
    """The kernel's and the plain version's device time and the bound at
    the operands (x, y), in float32 and float64: one report row each;
    ``launches`` maps a dtype's name to the paths' launches in it."""
    import torch

    from mellon_tpu_torch.ops.hopper_kernels import matern52_gram_reference

    rows = []
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    for dtype in (torch.float32, torch.float64):
        name = dtype_name(dtype)
        xa, ya = x.to(dtype).contiguous(), y.to(dtype).contiguous()
        out = torch.empty((n, m), dtype=dtype, device=x.device)
        ms = device_ms(bare_launcher(lib, xa, ya, out, ls))
        plain_ms = device_ms(lambda: matern52_gram_reference(xa, ya, ls))
        bound_ms, bound_by = matern52_bound_ms(n, m, d, name)
        rows.append({"shape": f"{n}x{m}x{d}", "dtype": name,
                     "launches": launches.get(name, 0),
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "share": bound_ms / ms})
        log(f"[kernel] {n}x{m}x{d} {name}: kernel {ms!r} ms, plain {plain_ms!r} ms, "
            f"bound {bound_ms!r} ms ({bound_by}), share {bound_ms / ms!r} "
            f"(median of {N_RUNS} runs of {N_LAUNCHES} launches)")
        del out
    return rows


def kernel_phase(lib, calls):
    """Kernel against plain version on every path call's operands and at
    the synthetic shapes, and its times at each path shape; returns (max
    float32 error over the paths' operands, report rows)."""
    import torch

    worst, rows, seen = 0.0, [], {}
    for x, y, ls in calls:
        shape = (x.shape[0], y.shape[0], x.shape[1])
        entry = seen.setdefault(shape, [x, y, ls, {}])
        entry[3][dtype_name(x.dtype)] = entry[3].get(dtype_name(x.dtype), 0) + 1
    for (n, m, d), (x, y, ls, launches) in seen.items():
        if n * m >= BIG_OUTPUT:
            for label, count in sorted(launches.items()):
                err, row = predict_batch_phase(lib, x, y, ls, count, label)
                if label == "float32":
                    worst = max(worst, err)
                rows.append(row)
                torch.cuda.empty_cache()
        else:
            worst = max(worst, check_kernel(x, y, ls, "path"))
            rows += time_shape(lib, x, y, ls, launches)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    for n, m, d in SYNTHETIC_SHAPES:
        x = torch.randn(n, d, device=DEVICE, dtype=torch.float64, generator=g)
        y = torch.randn(m, d, device=DEVICE, dtype=torch.float64, generator=g)
        check_kernel(x, y, 2.5, "synthetic")
    return worst, rows


def predict_batch_phase(lib, x, y, ls, launches, dtype_label="float32"):
    """The kernel at an output of at least BIG_OUTPUT elements (a
    PREDICT_BATCH-point predictor batch, or the time course's 98,192 cells
    against its landmarks), in ``dtype_label``: device time, checked
    against the plain version on 2,000 rows (or columns) at each end, the
    plain version timed over fewer launches.  Returns (error, report row)."""
    import torch

    from mellon_tpu_torch.ops.hopper_kernels import matern52_gram_reference

    dtype = getattr(torch, dtype_label)
    x, y = x.to(dtype).contiguous(), y.to(dtype).contiguous()
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    out = torch.empty((n, m), dtype=dtype, device=DEVICE)
    ms = device_ms(bare_launcher(lib, x, y, out, ls), runs=5)
    err = kernel_f64 = plain_f64 = 0.0
    for s in (slice(0, 2000), slice(n - 2000, n)) if n >= m else (slice(0, 2000), slice(m - 2000, m)):
        xs, ys, got = (x[s], y, out[s]) if n >= m else (x, y[s], out[:, s])
        plain = matern52_gram_reference(xs, ys, ls)
        e, k64, p64, bar, ok = kernel_errors(got, plain, xs, ys, ls, dtype_label)
        err, kernel_f64, plain_f64 = max(err, e), max(kernel_f64, k64), max(plain_f64, p64)
        if not ok:
            raise AssertionError(f"matern52 kernel disagrees at {n}x{m}x{d} {dtype_label}: "
                                 f"{k64} against float64 (bar {bar})")
    del out
    if n * m <= 2**31:
        plain_ms = device_ms(lambda: matern52_gram_reference(x, y, ls),
                             launches=BIG_PLAIN_LAUNCHES, runs=BIG_PLAIN_RUNS)
    else:
        # past 2**31 elements the plain version's temporaries would not fit
        # beside the output: it computes the whole output in row blocks
        # (columns for a wide output) of at most 2**29 elements each
        if n >= m:
            step = max(1, 2**29 // m)
            blocks = [(x[i:i + step], y) for i in range(0, n, step)]
        else:
            step = max(1, 2**29 // n)
            blocks = [(x, y[i:i + step]) for i in range(0, m, step)]
        plain_ms = device_ms(lambda: [matern52_gram_reference(a, b, ls) for a, b in blocks],
                             launches=1, runs=BIG_PLAIN_RUNS)
    bound_ms, bound_by = matern52_bound_ms(n, m, d, dtype_label)
    log(f"[predict batch] {n}x{m}x{d} {dtype_label}: kernel {ms!r} ms, plain {plain_ms!r} ms, "
        f"bound {bound_ms!r} ms ({bound_by}), share {bound_ms / ms!r}; "
        f"{n * m * ITEMSIZE[dtype_label] / 1e9!r} GB written; max_abs_err on 4000 "
        f"{'rows' if n >= m else 'columns'} {err!r}; against float64: kernel {kernel_f64!r}, "
        f"plain version {plain_f64!r}")
    return err, {"shape": f"{n}x{m}x{d}", "dtype": dtype_label, "launches": launches, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                 "share": bound_ms / ms}


def counted_path(hk, label, fn):
    """``fn()`` with the kernel's launch count set to 0 just before it and
    read just after; fails if the path launched the kernel no time.
    Returns (fn's result, launches)."""
    import torch

    torch.cuda.synchronize()
    hk.matern52_gram.launches = 0
    result = fn()
    torch.cuda.synchronize()
    launches = hk.matern52_gram.launches
    log(f"[{label}] kernel launches in this path: {launches}")
    if launches <= 0:
        raise AssertionError(f"the {label} path launched the matern52 kernel no time")
    return result, launches


def certificate(ld, ld_ref):
    """(corr, RMSE / spread) of a log density against the float64 reference."""
    import numpy as np

    ld = ld.double().cpu().numpy()
    corr = float(np.corrcoef(ld, ld_ref)[0, 1])
    rmse = float(np.sqrt(np.mean((ld - ld_ref) ** 2))) / float(ld_ref.max() - ld_ref.min())
    return corr, rmse


def synced_seconds(fn):
    """(fn's result, host seconds around it, ending in a synchronise)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def relative_gap(got, want):
    """max |got - want| over max |want|."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def uncertainty_path(mt, x_np, x_new, xq, ld_ref):
    """Fit with Laplace uncertainty, certify it, and evaluate the
    predictor's covariance surface at 1,000 and PREDICT_BATCH points, the
    1,000 also in float64; returns the estimator."""
    import torch

    from mellon_tpu_torch.inference.laplace import compute_laplace_std

    est = mt.DensityEstimator(predictor_with_uncertainty=True, device=DEVICE)
    ld, fit_s = synced_seconds(lambda: est.fit_predict(x_np))
    corr, rmse = certificate(ld, ld_ref)
    std = est.pre_transformation_std
    _, laplace_s = synced_seconds(
        lambda: compute_laplace_std(est._hessian_diagonal(est.pre_transformation)))
    log(f"[uncertainty] fit with Laplace {fit_s:.3f} s; Laplace alone (again, on the same "
        f"MAP) {laplace_s!r} s; std range [{std.min().item()!r}, {std.max().item()!r}]; "
        f"certificate corr {corr!r}, RMSE/spread {rmse!r}")
    if not (corr >= CERT_MIN_CORR and rmse <= CERT_MAX_RMSE and bool(torch.isfinite(std).all())):
        raise AssertionError(f"uncertainty fit failed: corr {corr}, RMSE/spread {rmse}")
    pred = est.predict
    methods = ("covariance", "mean_covariance", "uncertainty")
    for points, label in ((x_new, "1000 points"), (xq, f"{xq.shape[0]} points")):
        times = {}
        for method in methods:
            getattr(pred, method)(points)  # first call: allocator warm-up
            out, times[method] = synced_seconds(lambda: getattr(pred, method)(points))
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{method} at {label} is not finite")
            if method == "mean_covariance" and not bool((out >= 0).all()):
                raise AssertionError(f"mean_covariance at {label} is negative")
        log(f"[uncertainty] {label}: seconds " + json.dumps(times))
    p64 = mt.LandmarksConditionalCholesky.from_state(
        pred.landmarks.double(), pred.weights.double(), pred.mu, pred.cov_func,
        n_obs=pred.n_obs, jitter=pred.jitter, sigma=pred.sigma.double(),
        L=pred.L.double(), W=pred.W.double(),
    )
    gaps, scale = {}, {}
    for m in methods:
        want = getattr(p64, m)(x_new.double())
        gaps[m] = relative_gap(getattr(pred, m)(x_new), want)
        scale[m] = want.abs().max().item()
    log(f"[uncertainty] float32 vs the same state in float64 at 1000 points, max |diff| / "
        f"max |f64|: {json.dumps(gaps)} (bars {json.dumps(UNCERTAINTY_F64_REL)}); "
        f"max |f64|: {json.dumps(scale)}")
    if not all(gaps[m] <= UNCERTAINTY_F64_REL[m] for m in methods):
        raise AssertionError(f"float32 uncertainty disagrees with float64: {gaps}")
    return est


def advi_path(mt, x_np, ld_ref):
    """ADVI with uncertainty at the bench shape."""
    import torch

    est = mt.DensityEstimator(optimizer="advi", predictor_with_uncertainty=True, device=DEVICE)
    ld, fit_s = synced_seconds(lambda: est.fit_predict(x_np))
    elbo = -est.losses
    first, last = elbo[:10].mean().item(), elbo[-10:].mean().item()
    corr, rmse = certificate(ld, ld_ref)
    log(f"[advi] fit {fit_s:.3f} s ({est.n_iter} steps, 40 draws each); mean ELBO of the "
        f"first 10 steps {first!r}, of the last 10 {last!r}; vs the float64 reference "
        f"corr {corr!r}, RMSE/spread {rmse!r}")
    finite = all(bool(torch.isfinite(t).all()) for t in (ld, elbo, est.pre_transformation_std))
    if not (finite and last > first):
        raise AssertionError(f"ADVI failed: finite {finite}, ELBO {first} -> {last}")


def derivatives_path(pred, x_new):
    """The predictor's derivatives at the 1,000 points, the first moved
    onto a landmark; returns them with the points."""
    X = x_new.clone()
    X[0] = pred.landmarks[7]
    out = {}
    for method in ("gradient", "hessian", "hessian_log_determinant"):
        getattr(pred, method)(X)  # first call: library and allocator warm-up
        out[method], seconds = synced_seconds(lambda: getattr(pred, method)(X))
        log(f"[derivatives] {method} at {X.shape[0]} points: {seconds!r} s")
    return X, out


def check_derivatives(pred, X, out):
    """The derivatives against autograd through the plain version, and the
    backward's device time at the predictor's shape."""
    import torch

    from mellon_tpu_torch.inference.derivatives import gradient, hessian
    from mellon_tpu_torch.ops.hopper_kernels import (
        matern52_gram_backward, matern52_gram_reference)

    ls = pred.cov_func.ls

    def plain_mean(z):
        return pred.mu + matern52_gram_reference(z, pred.landmarks, ls) @ pred.weights

    g_ref, H_ref = gradient(plain_mean, X), hessian(plain_mean, X)
    sign_ref, logdet_ref = torch.linalg.slogdet(H_ref[1:])
    sign, logdet = out["hessian_log_determinant"]
    same = sign[1:] == sign_ref
    gaps = {
        "gradient": relative_gap(out["gradient"], g_ref),
        "gradient at the landmark": relative_gap(out["gradient"][0], g_ref[0]),
        "hessian": relative_gap(out["hessian"][1:], H_ref[1:]),
        "logdet": float((logdet[1:][same] - logdet_ref[same]).abs().max()),
    }
    log(f"[derivatives] vs autograd through the plain version, max |diff| / max |plain|: "
        f"{json.dumps(gaps)} (bar {DERIV_REL}; logdet absolute, printed); signs of det "
        f"equal at {int(same.sum())} of {same.numel()}; Hessian at the landmark finite: "
        f"{bool(torch.isfinite(out['hessian'][0]).all())}")
    if not (max(gaps["gradient"], gaps["gradient at the landmark"], gaps["hessian"]) <= DERIV_REL
            and bool(torch.isfinite(out["hessian"][0]).all())):
        raise AssertionError(f"derivatives disagree with the plain version: {gaps}")
    grad_out = pred.weights.expand(X.shape[0], -1)
    ms = device_ms(lambda: matern52_gram_backward(grad_out, X, pred.landmarks, ls, (True, False)))
    log(f"[derivatives] backward (plain torch) at {X.shape[0]}x{pred.landmarks.shape[0]}x"
        f"{X.shape[1]} float32: {ms!r} ms (median of {N_RUNS} runs of {N_LAUNCHES} calls)")
    return gaps, ms


def json_path(mt, pred, x_new):
    """The predictor through gzip JSON and back on the card, and the
    reference Mellon's predictor in float64."""
    import numpy as np
    import torch

    path = os.path.join(ROOT, "build", "chip_smoke_predictor.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pred.to_json(path, compress="gzip")
    back = mt.Predictor.from_json(path + ".gz")
    want = pred(x_new)
    gap = float((back(x_new) - want).abs().max() / (want.max() - want.min()))
    data = np.load(os.path.join(FIXTURES, "reference_fixture_data.npz"))
    ref = mt.Predictor.from_json(os.path.join(FIXTURES, "reference_density_predictor.json.gz"),
                                 dtype=torch.float64)
    fix = max(float(np.abs(ref(data["x"]).cpu().numpy() - data["de_pred"]).max()),
              float(np.abs(ref(data["x"], normalize=True).cpu().numpy() - data["de_pred_norm"]).max()))
    log(f"[json] gzip round trip on {back.device} {back.dtype}: max |diff| / spread {gap!r} "
        f"(bar {JSON_REL}); the reference Mellon's predictor on {ref.device} float64: "
        f"max |diff| from its own predictions {fix!r} (bar {FIXTURE_ATOL})")
    if not (back.device == pred.device and gap <= JSON_REL and fix <= FIXTURE_ATOL):
        raise AssertionError(f"JSON round trip {gap}, reference predictor {fix}")


def posterior_predictor(est, z):
    """The predictor with uncertainty of the latents' posterior draws ``z``
    (draws, k): their mean and std (ddof 0) on the estimator's landmarks."""
    from mellon_tpu_torch.inference.factories import compute_conditional

    mean = z.mean(dim=0)
    return compute_conditional(
        est.x, est.landmarks, mean, z.std(dim=0, correction=0), est.transform(mean), est.mu,
        est.cov_func, est.L, est.Lp, sigma=None, jitter=est.jitter, y_is_mean=True,
        with_uncertainty=True,
    )


def log_density_corr(ld, ld_map):
    import numpy as np

    return float(np.corrcoef(ld.double().cpu().numpy(), ld_map.double().cpu().numpy())[0, 1])


def finite(*tensors):
    import torch

    return all(bool(torch.isfinite(t).all()) for t in tensors)


def nuts_path(mt, x_np, x_new, est_map):
    """DensityEstimator(optimizer="nuts", predictor_with_uncertainty=True)
    with its default sampler settings, held to the bars of
    tests/test_mcmc.py:95-124 against the main path's L-BFGS fit and its
    Laplace stds; the predictor's uncertainty at the 1,000 points."""
    import numpy as np

    from mellon_tpu_torch.inference.diagnostics import split_rhat
    from mellon_tpu_torch.inference.laplace import compute_laplace_std

    est = mt.DensityEstimator(optimizer="nuts", predictor_with_uncertainty=True,
                              sampler_options=NUTS_OPTIONS, device=DEVICE)
    ld, fit_s = synced_seconds(lambda: est.fit_predict(x_np))
    res = est.mcmc_result
    chains, draws = res.samples.shape[:2]
    rhat = float(np.max(split_rhat(res.samples)))
    laplace = compute_laplace_std(est_map._hessian_diagonal(est_map.pre_transformation))
    ratio = float(est.pre_transformation_std.mean() / laplace.mean())
    corr = log_density_corr(ld, est_map.log_density_x)
    u = est.predict.uncertainty(x_new)
    stats = {
        "settings": {"num_chains": chains, "num_warmup": NUTS_OPTIONS["num_warmup"],
                     "num_samples": draws, "max_tree_depth": 10, "initial_step_size": 0.1},
        "fit_seconds": fit_s, "sampling_seconds": est.sampling_time,
        "step_size": float(res.step_size), "mean_accept": float(res.accept_prob.mean()),
        "divergences": int(res.diverging.sum()),
        "leapfrogs_per_draw": float(res.num_leapfrog.double().mean()),
        "potential_evaluations_per_draw": res.num_evaluations / (chains * draws),
        "host_reads_per_transition": res.host_reads / draws,
        "ess_min": float(est.ess.min()), "ess_median": float(np.median(est.ess)),
        "ess_per_second": est.ess_per_second, "max_rhat": rhat,
        "nuts_over_laplace_std": ratio, "corr_with_map": corr,
    }
    log("[nuts] " + json.dumps(stats))
    log(f"[nuts] bars: max split-R-hat <= {NUTS_MAX_RHAT}, min-ESS >= {NUTS_MIN_ESS}, std ratio "
        f"in {list(STD_RATIO)}, corr >= {POSTERIOR_MIN_CORR}, all finite")
    ok = (finite(ld, res.samples, est.pre_transformation_std, u) and rhat <= NUTS_MAX_RHAT
          and float(est.ess.min()) >= NUTS_MIN_ESS
          and STD_RATIO[0] <= ratio <= STD_RATIO[1] and corr >= POSTERIOR_MIN_CORR)
    if not ok:
        raise AssertionError(f"NUTS failed its bars: {stats}")
    return stats, est


def precond_path(mt, est_map, x_new):
    """sample_density_posterior(precondition="hessian") on the main path's
    fit (PRECOND settings, no function samples); the Newton polish, the
    Hessian build and its factor are also run and timed on their own
    first.  The posterior predictor at the 1,000 points must be finite."""
    import numpy as np

    from mellon_tpu_torch.inference import mcmc
    from mellon_tpu_torch.inference.diagnostics import effective_sample_size, split_rhat
    from mellon_tpu_torch.inference.losses import density_hessian

    args = est_map._loss_args
    z0 = est_map.pre_transformation
    value_and_grad, _ = mcmc.zero_centered_potential(z0, *args)
    hessian = lambda z: density_hessian(z, *args)  # noqa: E731
    (z_map, gn0, gn1), polish_s = synced_seconds(lambda: mcmc.newton_polish(value_and_grad, hessian, z0))
    H, build_s = synced_seconds(lambda: hessian(z_map))
    _, factor_s = synced_seconds(lambda: mcmc.precondition_transform(mcmc.hessian_cholesky(H)))
    (res, _), seconds = synced_seconds(lambda: mcmc.sample_density_posterior(
        est_map, precondition="hessian", function_samples=False, **PRECOND))
    R = mcmc.hessian_cholesky(H)
    trace = trace_transitions(
        mcmc.preconditioned_potential(value_and_grad, mcmc.precondition_transform(R), z_map),
        (res.samples[:, -1] - z_map) @ R, res.step_size, res.inv_mass_diag)
    chains, draws = res.samples.shape[:2]
    ess, lags = effective_sample_size(res.samples, return_truncation=True)
    rhat = float(np.max(split_rhat(res.samples)))
    flat = res.samples.reshape(-1, res.samples.shape[-1])
    pred = posterior_predictor(est_map, flat)
    at_new, u = pred(x_new), pred.uncertainty(x_new)
    stats = {
        "settings": PRECOND, "newton_grad_norm": [gn0, gn1], "newton_seconds": polish_s,
        "hessian_build_seconds": build_s, "hessian_factor_seconds": factor_s,
        "seconds": seconds, "step_size": float(res.step_size),
        "mean_accept": float(res.accept_prob.mean()), "divergences": int(res.diverging.sum()),
        "leapfrogs_per_draw": float(res.num_leapfrog.double().mean()),
        "potential_evaluations_per_draw": res.num_evaluations / (chains * draws),
        "host_reads_per_transition": res.host_reads / draws,
        "draws_per_second": chains * draws / seconds,
        "ess_min_per_second": float(ess.min()) / seconds,
        "ess_median_per_second": float(np.median(ess)) / seconds,
        "geyer_truncated_dims": int(np.sum(lags + 2 > draws)), "max_rhat": rhat,
    }
    log("[nuts precond] " + json.dumps(stats))
    log(f"[nuts precond] seconds: the whole sample_density_posterior call (its own polish, "
        f"Hessian and factor included); bars: max split-R-hat <= {PRECOND_MAX_RHAT}, all finite")
    log("[nuts precond] trace " + json.dumps(trace))
    if not (finite(res.samples, at_new, u) and rhat <= PRECOND_MAX_RHAT):
        raise AssertionError(f"preconditioned NUTS failed its bars: {stats}")
    return stats


def union_length(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


def trace_transitions(potential, start, step_size, inv_mass, n=TRACE_TRANSITIONS):
    """``n`` sampling transitions of the whitened potential from the
    chains' last positions (resume_mcmc, the same seed each time), twice
    without and once under torch.profiler: the device's busy share (the
    union of the traced kernels' intervals over the quicker unprofiled
    run), the host reads and lockstep leaves per transition, and leaf steps
    per second.  The Chrome trace goes to build/."""
    import torch

    from mellon_tpu_torch.inference.mcmc import resume_mcmc

    def transitions():
        gen = torch.Generator(device=DEVICE).manual_seed(1)
        return resume_mcmc(potential, start, gen, step_size, inv_mass, num_samples=n)

    res, wall = min((synced_seconds(transitions) for _ in range(2)), key=lambda r: r[1])
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        synced_seconds(transitions)
    prof.export_chrome_trace(os.path.join(ROOT, "build", "chip_smoke_sampler_trace.json"))
    device = [(e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        raise AssertionError("the profiler recorded no device time")
    busy = union_length(device) / 1e6
    leaves = res.num_evaluations / start.shape[0]
    top = sorted(((e.key[:60], round(e.device_time_total / 1e3, 3), e.count)
                  for e in prof.key_averages() if e.device_time_total > 0), key=lambda r: -r[1])[:6]
    return {"transitions": n, "chains": start.shape[0], "unprofiled_seconds": wall,
            "device_busy_seconds": busy, "busy_share": busy / wall, "idle_share": 1 - busy / wall,
            "device_kernels": len(device), "host_reads_per_transition": res.host_reads / n,
            "lockstep_leaves_per_transition": leaves / n, "leaf_steps_per_second": leaves / wall,
            "top_device_ms_calls": top}


def smc_path(mt, est_map, x_new):
    """smc_density_posterior on the main path's fit (SMC settings): β
    reaches 1, a finite evidence, and a particle-mean log density that
    tracks the MAP's; the posterior predictor at the 1,000 points."""
    from mellon_tpu_torch.inference.smc import smc_density_posterior

    (res, f), seconds = synced_seconds(lambda: smc_density_posterior(est_map, **SMC))
    corr = log_density_corr(f.mean(dim=0), est_map.log_density_x)
    pred = posterior_predictor(est_map, res.particles)
    at_new, u = pred(x_new), pred.uncertainty(x_new)
    stats = {
        "settings": SMC, "seconds": seconds, "stages_last_sweep": len(res.betas),
        "final_beta": res.betas[-1], "log_evidence": res.log_evidence,
        "log_evidence_std": res.log_evidence_std,
        "acceptance_range": [min(res.acceptance_history), max(res.acceptance_history)],
        "ess_range": [min(res.ess_history), max(res.ess_history)], "corr_with_map": corr,
    }
    log("[smc] " + json.dumps(stats))
    log(f"[smc] bars: final beta == 1, finite evidence, corr >= {POSTERIOR_MIN_CORR}")
    if not (res.betas[-1] == 1.0 and math.isfinite(res.log_evidence) and finite(f, at_new, u)
            and corr >= POSTERIOR_MIN_CORR):
        raise AssertionError(f"SMC failed its bars: {stats}")
    return stats


def gene_trends(x, p, seed=GENE_SEED):
    """(n, p) float32 outputs: smooth functions of the standardized cells,
    sin(z·w + b) with w ~ N(0, 0.25/d), plus N(0, 0.1²) noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    z = (x - x.mean(axis=0)) / x.std(axis=0)
    W = rng.normal(scale=0.5 / math.sqrt(x.shape[1]), size=(x.shape[1], p))
    b = rng.uniform(0, 2 * math.pi, size=p)
    return (np.sin(z @ W + b) + 0.1 * rng.normal(size=(x.shape[0], p))).astype(np.float32)


class MessageCount(logging.Handler):
    """Counts the package's log records that contain each of ``needles``
    and keeps those records' messages."""

    def __init__(self, *needles):
        super().__init__(logging.INFO)
        self.counts = dict.fromkeys(needles, 0)
        self.matched = []

    def emit(self, record):
        message = record.getMessage()
        hits = [needle for needle in self.counts if needle in message]
        for needle in hits:
            self.counts[needle] += 1
        if hits:
            self.matched.append(message)


def function_fit(mt, x, Y, x_new, dtype, preset=None, **kwargs):
    """A FunctionEstimator with obs_variance fitted on (x, Y): its
    prediction at x_new, leverage at x and observation variance at x_new,
    with the seconds of each, and the count of leverages recomputed in
    float64.  ``preset`` sets prepared attributes (the lazy chain computes
    only what is unset)."""
    est = mt.FunctionEstimator(obs_variance=True, device=DEVICE, dtype=dtype, **kwargs)
    for name, value in (preset or {}).items():
        setattr(est, name, value)
    x_new = x_new.to(dtype)
    out, seconds = {}, {}
    counter = MessageCount("recomputing in float64")
    logger = logging.getLogger("mellon_tpu_torch")
    logger.addHandler(counter)
    try:
        out["predict"], seconds["fit_predict"] = synced_seconds(
            lambda: est.fit_predict(x, Y, Xnew=x_new))
        out["leverage"], seconds["leverage"] = synced_seconds(est.leverage)
        out["obs_variance"], seconds["obs_variance"] = synced_seconds(
            lambda: est.get_obs_variance(x_new))
    finally:
        logger.removeHandler(counter)
    if not finite(*out.values()):
        raise AssertionError(f"the FunctionEstimator's outputs are not finite ({dtype})")
    lev = out["leverage"]
    if not (float(lev.min()) >= 0.0 and float(lev.max()) <= 1.0):
        raise AssertionError(f"leverage outside [0, 1]: [{float(lev.min())}, {float(lev.max())}]")
    return est, out, seconds, counter.counts["recomputing in float64"]


def function_pair(mt, label, x, Y, x_new, sigma, preset=None, **kwargs):
    """float32 and float64 fits (the float64 on the float32 fit's landmarks
    and length scale): the gaps and the float32 seconds."""
    import torch

    est, out, seconds, recomputed = function_fit(mt, x, Y, x_new, torch.float32, preset, sigma=sigma,
                                                 **kwargs)
    same = dict(ls=est.ls)
    if est.landmarks is not None:
        same["landmarks"] = est.landmarks.double()
    else:
        same["n_landmarks"] = 0
    sigma64 = sigma.double() if isinstance(sigma, torch.Tensor) else sigma
    _, out64, seconds64, _ = function_fit(mt, x, Y, x_new, torch.float64, sigma=sigma64, **same)
    gaps = {k: relative_gap(out[k], out64[k]) for k in out}
    lev = out["leverage"]
    stats = {
        "gp_type": est.gp_type.value, "cells": x.shape[0], "outputs": Y.shape[1],
        "landmarks": None if est.landmarks is None else int(est.landmarks.shape[0]),
        "sigma": "per feature" if isinstance(sigma, torch.Tensor) else sigma,
        "seconds": seconds, "seconds_f64": seconds64,
        "leverage_f64_recomputations": recomputed,
        "leverage_range": [float(lev.min()), float(lev.max())],
        "leverage_shape": list(lev.shape), "f32_vs_f64": gaps,
    }
    log(f"[{label}] " + json.dumps(stats))
    if not all(gaps[k] <= FUNCTION_F64_REL[k] for k in gaps):
        raise AssertionError(f"{label}: float32 disagrees with float64: {gaps} (bars {FUNCTION_F64_REL})")
    return est, stats


def function_path(mt, x_np, x_new, Y):
    """FunctionEstimator(sigma=FUNCTION_SIGMA) on the benchmark cells, with
    a scalar and then a per-feature σ on the first PER_FEATURE_OUTPUTS
    outputs (the second on the first's pruned landmarks, their factor and
    the length scale)."""
    import numpy as np
    import torch

    est, scalar = function_pair(mt, "function", x_np, Y, x_new, FUNCTION_SIGMA)
    if est.gp_type.value != "sparse_cholesky":
        raise AssertionError(f"the function path took gp_type {est.gp_type}")
    Y = Y[:, :PER_FEATURE_OUTPUTS]
    sigma = torch.as_tensor(0.05 + 0.1 * np.random.default_rng(GENE_SEED).random(Y.shape[1]),
                            dtype=torch.float32, device=DEVICE)
    _, per_feature = function_pair(mt, "function", x_np, Y, x_new, sigma, preset={"Lp": est.Lp},
                                   landmarks=est.landmarks, ls=est.ls)
    return {"scalar": scalar, "per_feature": per_feature}


def function_full_path(mt, x_np, x_new, Y):
    """FunctionEstimator(sigma=1.0, n_landmarks=0) on the first FULL_CELLS
    cells: the full GP type."""
    est, stats = function_pair(mt, "function full", x_np[:FULL_CELLS], Y[:FULL_CELLS], x_new, 1.0,
                               n_landmarks=0)
    if est.gp_type.value != "full":
        raise AssertionError(f"the full function path took gp_type {est.gp_type}")
    return stats


def dimensionality_path(mt, x_np, x_new):
    """DimensionalityEstimator(predictor_with_uncertainty=True) on the
    benchmark cells, against a float64 fit on its landmarks and length
    scale; then each fit's L-BFGS continued to its tolerance, and the two
    optima held to each other."""
    import numpy as np
    import torch

    from mellon_tpu_torch.inference.optimizers import minimize_lbfgs

    def fit(dtype, **kwargs):
        est = mt.DimensionalityEstimator(predictor_with_uncertainty=True, device=DEVICE,
                                         dtype=dtype, **kwargs)
        _, seconds = synced_seconds(lambda: est.fit(x_np))
        points = x_new.to(dtype)
        out = {"local_dim_x": est.local_dim_x, "log_density_x": est.log_density_x,
               "predict": est.predict(points), "predict_density": est.predict_density(points),
               "uncertainty": est.predict.uncertainty(points),
               "density_uncertainty": est.predict_density.uncertainty(points)}
        return est, out, seconds

    def optimum(est):
        res, seconds = synced_seconds(lambda: minimize_lbfgs(
            est._value_and_grad, est.pre_transformation.reshape(-1),
            max_iter=DIMENSIONALITY_CONTINUE))
        dims, log_density = est.transform(res.pre_transformation.reshape(2, -1))
        state = {"steps": res.n_steps, "converged": res.converged, "loss": res.loss,
                 "seconds": seconds}
        return {"local_dim_x": dims, "log_density_x": log_density}, state

    def lbfgs(est):
        return {"steps": est.opt_state.n_steps, "converged": est.opt_state.converged,
                "loss": est.opt_state.loss}

    est, out, seconds = fit(torch.float32)
    est64, out64, seconds64 = fit(torch.float64, landmarks=est.landmarks.double(), ls=est.ls)
    corr = {k: log_density_corr(out[k], out64[k]) for k in ("local_dim_x", "log_density_x",
                                                             "predict", "predict_density")}
    best, continued = optimum(est)
    best64, continued64 = optimum(est64)
    corr_optima = {k: log_density_corr(best[k], best64[k]) for k in best}
    d = x_np.shape[1]
    dims = torch.cat([out["local_dim_x"], out["predict"]])
    stats = {
        "gp_type": est.gp_type.value, "landmarks": int(est.landmarks.shape[0]),
        "lbfgs": lbfgs(est), "lbfgs_f64": lbfgs(est64),
        "seconds": seconds, "seconds_f64": seconds64,
        "local_dim_range": [float(dims.min()), float(dims.max())],
        "local_dim_median": float(np.median(out["local_dim_x"].double().cpu().numpy())),
        "raw_local_dim_median": float(est.d.double().median()),
        "corr_f32_f64": corr,
        "continued": continued, "continued_f64": continued64, "corr_optima": corr_optima,
    }
    log("[dimensionality] " + json.dumps(stats))
    log(f"[dimensionality] bars: local dimensions finite and in (0, {2 * d}]; both continued "
        f"fits converged, the optima's corr >= {json.dumps(DIMENSIONALITY_OPTIMUM_MIN_CORR)}")
    ok = (finite(*out.values(), *best.values()) and float(dims.min()) > 0
          and float(dims.max()) <= 2 * d
          and continued["converged"] and continued64["converged"]
          and all(corr_optima[k] >= v for k, v in DIMENSIONALITY_OPTIMUM_MIN_CORR.items()))
    if not ok:
        raise AssertionError(f"dimensionality failed its bars: {stats}")
    return stats, est


def density_full_path(mt, x_np, x_new):
    """The density model's full GP type: DensityEstimator(
    predictor_with_uncertainty=True) on FULL_CELLS cells, d_method=
    "fractal" on the same cells and the README's 100 x 10 fit, each against
    its float64 fit on the card."""
    import numpy as np
    import torch

    readme = np.random.default_rng(0).normal(size=(100, 10))
    cases = {
        "uncertainty": (x_np[:FULL_CELLS], dict(predictor_with_uncertainty=True)),
        "fractal": (x_np[:FULL_CELLS], dict(d_method="fractal")),
        "readme": (readme, {}),
    }
    stats = {}
    for name, (x, kwargs) in cases.items():
        fits = {}
        for dtype in (torch.float32, torch.float64):
            est = mt.DensityEstimator(device=DEVICE, dtype=dtype, **kwargs)
            ld, seconds = synced_seconds(lambda: est.fit_predict(x))
            fits[dtype] = (est, ld, seconds)
        est, ld, seconds = fits[torch.float32]
        if est.gp_type.value != "full" or not finite(ld):
            raise AssertionError(f"density full {name}: gp_type {est.gp_type}, finite {finite(ld)}")
        entry = {"cells": x.shape[0], "d": est.d, "seconds": seconds,
                 "seconds_f64": fits[torch.float64][2],
                 "corr_f32_f64": log_density_corr(ld, fits[torch.float64][1]),
                 "lbfgs_steps": est.opt_state.n_steps}
        if name == "uncertainty":
            points = x_new
            u, entry["uncertainty_seconds"] = synced_seconds(lambda: est.predict.uncertainty(points))
            if not finite(u, est.predict(points)):
                raise AssertionError("density full: the predictor's uncertainty is not finite")
        stats[name] = entry
    log("[density full] " + json.dumps(stats))
    log(f"[density full] bars: full GP type, finite, corr with float64 >= {DENSITY_FULL_MIN_CORR}")
    if not all(v["corr_f32_f64"] >= DENSITY_FULL_MIN_CORR for v in stats.values()):
        raise AssertionError(f"density full failed its bars: {stats}")
    return stats


def load_time_course():
    """(x float32 (n, 2), times float32 (n,), the float64 log density)."""
    import numpy as np

    ref = np.load(TIME_DATA)
    return (np.asarray(ref["x"], dtype=np.float32), np.asarray(ref["times"], dtype=np.float32),
            np.asarray(ref["log_density"], dtype=np.float64))


def time_path(mt, x_np, times, ld_ref):
    """[time]: the time course, certified against its host-float64 fit; a
    stage-synchronized fit, then a warm fit with the same seed, whose
    landmarks, latents and loss must equal the first's.  Returns the first
    estimator."""
    import numpy as np
    import torch

    from mellon_tpu_torch.models.time_density import TIME_PREPARED_ATTRIBUTES

    est = mt.TimeSensitiveDensityEstimator(ls_time=TIME_LS, device=DEVICE)
    stages = staged_fit(est, est._time_x(x_np, times), TIME_PREPARED_ATTRIBUTES)
    corr, rmse = certificate(est.log_density_x, ld_ref)
    warm = mt.TimeSensitiveDensityEstimator(ls_time=TIME_LS, device=DEVICE)
    _, warm_s = synced_seconds(lambda: warm.fit_predict(x_np, times))
    same = (torch.equal(est.landmarks, warm.landmarks)
            and torch.equal(est.pre_transformation, warm.pre_transformation)
            and est.opt_state.loss == warm.opt_state.loss)
    stats = {
        "cells": x_np.shape[0], "time_points": int(np.unique(times).size),
        "landmarks_kept": int(est.landmarks.shape[0]), "gp_type": est.gp_type.value,
        "ls": est.ls, "ls_time": est.ls_time,
        "lbfgs_steps": est.opt_state.n_steps, "lbfgs_evaluations": est.opt_state.n_evals,
        "loss": est.opt_state.loss, "converged": est.opt_state.converged,
        "stage_seconds": {k: round(v, 6) for k, v in stages.items()},
        "staged_fit_seconds": sum(stages.values()), "warm_fit_seconds": warm_s,
        "same_seed_fits_identical": same, "corr": corr, "rmse_over_spread": rmse,
    }
    log("[time] " + json.dumps(stats))
    log(f"[time] bars: certificate corr >= {TIME_CERT_MIN_CORR}, RMSE/spread <= "
        f"{TIME_CERT_MAX_RMSE}; the same seed's two fits identical; finite")
    if not (corr >= TIME_CERT_MIN_CORR and rmse <= TIME_CERT_MAX_RMSE and same
            and finite(est.log_density_x)):
        raise AssertionError(f"the time path failed its bars: {stats}")
    return est


def time_matched_path(mt):
    """[time matched]: the port's fit on the JAX package's float64 prepare
    of the same cells (landmarks, nn_distances, ls, mu, d) with ls_time
    TIME_LS, in float64 against that fit's log density, then in float32."""
    import numpy as np
    import torch

    ref = np.load(TIME_DATA)
    prep = np.load(TIME_PREPARE)
    x_np, times = np.asarray(ref["x"], np.float64), np.asarray(ref["times"], np.float64)
    ld_ref = np.asarray(prep["log_density"], dtype=np.float64)
    stats = {}
    for dtype in (torch.float64, torch.float32):
        est = mt.TimeSensitiveDensityEstimator(
            ls_time=TIME_LS, landmarks=prep["landmarks"], nn_distances=prep["nn_distances"],
            ls=float(prep["ls"]), mu=float(prep["mu"]), d=float(prep["d"]), check_rank=False,
            device=DEVICE, dtype=dtype)
        ld, seconds = synced_seconds(lambda: est.fit_predict(x_np, times))
        corr, rmse = certificate(ld, ld_ref)
        stats[dtype_name(dtype)] = {
            "seconds": seconds, "landmarks_kept": int(est.landmarks.shape[0]),
            "lbfgs_steps": est.opt_state.n_steps, "corr": corr, "rmse_over_spread": rmse,
        }
        del est, ld
        torch.cuda.empty_cache()
    log("[time matched] " + json.dumps(stats))
    log(f"[time matched] bar: float64 corr >= {TIME_MATCHED_MIN_CORR}; float32 printed")
    if not stats["float64"]["corr"] >= TIME_MATCHED_MIN_CORR:
        raise AssertionError(f"the matched time fit failed its bar: {stats}")
    return stats


def time_predict_path(mt, est):
    """[time predict]: the [time] fit's predictor over TIME_GRID times at
    1,000 cells (one call of 200,000 rows), its time derivative, gradient
    and Hessian log-determinant at 1,000 cells and one time; each against
    the same state in float64, the derivatives against autograd through
    the plain version; a gzip JSON round trip on the card."""
    import torch

    from mellon_tpu_torch.inference.derivatives import gradient, hessian
    from mellon_tpu_torch.ops.hopper_kernels import matern52_gram_reference

    pred = est.predict
    g = torch.Generator(device=DEVICE).manual_seed(4)
    states = est.x[:1000, :-1]
    cells = states + 0.01 * states.std(dim=0) * torch.randn(states.shape, device=DEVICE, generator=g)
    grid = torch.linspace(0.0, 7.0, TIME_GRID, device=DEVICE)
    t_one = 3.3
    out, seconds = {}, {}
    calls = {
        "multi_time": lambda p, c: p(c, multi_time=grid.to(p.dtype)),
        "time_derivative": lambda p, c: p.time_derivative(c, t_one),
        "gradient": lambda p, c: p.gradient(c, t_one),
        "hessian_log_determinant": lambda p, c: p.hessian_log_determinant(c, t_one),
    }
    for name, call in calls.items():
        call(pred, cells)  # first call: allocator warm-up
        out[name], seconds[name] = synced_seconds(lambda: call(pred, cells))
    p64 = mt.LandmarksConditionalCholeskyTime.from_state(
        pred.landmarks.double(), pred.weights.double(), pred.mu, pred.cov_func,
        n_obs=pred.n_obs, jitter=pred.jitter)
    gaps = {name: relative_gap(out[name], calls[name](p64, cells.double()))
            for name in ("multi_time", "time_derivative", "gradient")}
    sign, logdet = out["hessian_log_determinant"]
    sign64, logdet64 = calls["hessian_log_determinant"](p64, cells.double())

    def logdet_gap(sign_ref, logdet_ref):
        """(max |logdet − ref| where the signs agree, cells whose signs differ)."""
        same = sign == sign_ref.to(sign.dtype)
        return float((logdet[same].double() - logdet_ref[same].double()).abs().max()), int((~same).sum())
    left, right = pred.cov_func.left, pred.cov_func.right
    xu = pred.landmarks

    def plain_mean(z):
        return pred.mu + (matern52_gram_reference(z[:, :-1], xu[:, :-1], left.ls)
                          * matern52_gram_reference(z[:, -1:], xu[:, -1:], right.ls)) @ pred.weights

    at_t = torch.cat([cells, cells.new_full((cells.shape[0], 1), t_one)], dim=1)
    dt_ref = gradient(plain_mean, at_t)[:, -1]
    g_ref = gradient(lambda s: plain_mean(torch.cat([s, at_t[:, -1:]], dim=1)), cells)
    H_ref = hessian(lambda s: plain_mean(torch.cat([s, at_t[:, -1:]], dim=1)), cells)
    flips = {}
    gaps["logdet"], flips["float64"] = logdet_gap(sign64, logdet64)
    deriv = {"time_derivative": relative_gap(out["time_derivative"], dt_ref),
             "gradient": relative_gap(out["gradient"], g_ref)}
    deriv["logdet"], flips["plain_autograd"] = logdet_gap(*torch.linalg.slogdet(H_ref))
    path = os.path.join(ROOT, "build", "chip_smoke_time_predictor.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pred.to_json(path, compress="gzip")
    back = mt.Predictor.from_json(path + ".gz")
    want = pred(cells, t_one)
    json_gap = float((back(cells, t_one) - want).abs().max() / (want.max() - want.min()))
    stats = {"cells": cells.shape[0], "times": TIME_GRID, "rows": cells.shape[0] * TIME_GRID,
             "seconds": seconds, "f32_vs_f64": gaps, "vs_plain_autograd": deriv,
             "det_sign_flips": flips, "json_gap": json_gap, "json_class": type(back).__name__}
    log("[time predict] " + json.dumps(stats))
    log(f"[time predict] bars: float64 {TIME_PREDICT_F64_REL}, autograd through the plain "
        f"version {DERIV_REL}, logdet {TIME_LOGDET_ABS} absolute against both with at most "
        f"{TIME_LOGDET_SIGN_FLIPS} sign flips, JSON {JSON_REL}, all finite")
    ok = (max(gaps["multi_time"], gaps["time_derivative"], gaps["gradient"]) <= TIME_PREDICT_F64_REL
          and max(deriv["time_derivative"], deriv["gradient"]) <= DERIV_REL
          and max(gaps["logdet"], deriv["logdet"]) <= TIME_LOGDET_ABS
          and max(flips.values()) <= TIME_LOGDET_SIGN_FLIPS
          and json_gap <= JSON_REL and type(back) is type(pred)
          and finite(out["multi_time"], out["time_derivative"], out["gradient"], logdet))
    if not ok:
        raise AssertionError(f"the time predictor failed its bars: {stats}")
    return stats


def ls_time_cells(dtype):
    """LS_TIME_GROUPS cells at d = 2 (twelve clusters of diffusion-map-like
    scale, drifting with time), the time as the last column."""
    import numpy as np

    rng = np.random.default_rng(LS_TIME_SEED)
    n = sum(LS_TIME_GROUPS)
    centers = rng.normal(size=(12, 2)) * 2.0
    scales = 0.3 + 0.4 * rng.random((12, 1))
    assign = rng.integers(0, 12, n)
    x = (centers[assign] + scales[assign] * rng.normal(size=(n, 2))) * np.exp(-0.15 * np.arange(2))
    times = np.repeat(np.arange(len(LS_TIME_GROUPS), dtype=np.float64), LS_TIME_GROUPS)
    return np.concatenate([x + 0.025 * times[:, None], times[:, None]], axis=1).astype(dtype)


def ls_time_path(mt):
    """[ls_time]: automatic ls_time in its hard case (d = 2, f32-singular
    per-time kernels): the batched fits in float32 and float64 and the
    per-time loop in float64, with the jitter escalations and the groups
    that went to float64."""
    import numpy as np
    import torch

    from mellon_tpu_torch.models.ls_time import compute_ls_time
    from mellon_tpu_torch.parameters import compute_nn_distances_within_time_points

    logger = logging.getLogger("mellon_tpu_torch")
    level = logger.level
    logger.setLevel(logging.INFO)
    stats = {}
    try:
        for label, dtype, loop in (("batched float32", np.float32, False),
                                   ("batched float64", np.float64, False),
                                   ("loop float64", np.float64, True)):
            x = torch.as_tensor(ls_time_cells(dtype), device=DEVICE)
            nn = compute_nn_distances_within_time_points(x)
            counter = MessageCount("retrying with escalated jitter", "Float64 predict for")
            logger.addHandler(counter)
            try:
                ls, seconds = synced_seconds(lambda: compute_ls_time(
                    nn, x, mt.Matern52, return_data=loop))
            finally:
                logger.removeHandler(counter)
            ls = ls[0] if loop else ls
            rescued = [re.search(r"Float64 predict for (\d+)", m) for m in counter.matched]
            stats[label] = {"ls_time": ls, "seconds": seconds,
                            "jitter_escalations": counter.counts["retrying with escalated jitter"],
                            "float64_groups": sum(int(m.group(1)) for m in rescued if m)}
    finally:
        logger.setLevel(level)
    b32, b64, l64 = (stats[k]["ls_time"] for k in ("batched float32", "batched float64", "loop float64"))
    rel = {"batched_vs_loop_f64": abs(b64 - l64) / l64, "f32_vs_f64_batched": abs(b32 - b64) / b64}
    out = {"cells": sum(LS_TIME_GROUPS), "groups": list(LS_TIME_GROUPS), "fits": stats, "rel": rel}
    log("[ls_time] " + json.dumps(out))
    log(f"[ls_time] bars: batched vs loop (float64) <= {LS_TIME_LOOP_REL}, float32 vs float64 "
        f"<= {LS_TIME_F32_REL}, all finite and positive")
    ok = (all(math.isfinite(v) and v > 0 for v in (b32, b64, l64))
          and rel["batched_vs_loop_f64"] <= LS_TIME_LOOP_REL and rel["f32_vs_f64_batched"] <= LS_TIME_F32_REL)
    if not ok:
        raise AssertionError(f"ls_time failed its bars: {out}")
    return out


def agreement(ld, want):
    """(corr, RMSE / spread) of a log density against another on the card."""
    return certificate(ld, want.double().cpu().numpy())


def nystroem_path(mt):
    """The sparse Nyström BASELINE row: a float32 fit certified against
    the float64 reference, the warm fit time, the float32-vs-float64 gap
    on the card and the predictor at the training points; then the full
    Nyström type on FULL_CELLS cells, float32 against float64."""
    import numpy as np
    import torch

    from mellon_tpu_torch.ops.linalg import NYSTROEM_DIRECT_EIGH_MAX

    ref = np.load(NYSTROEM_DATA)
    x_np = np.asarray(ref["x"], dtype=np.float32)
    ld_ref = np.asarray(ref["log_density"], dtype=np.float64)
    est = mt.DensityEstimator(device=DEVICE, **NYSTROEM)
    ld, first_s = synced_seconds(lambda: est.fit_predict(x_np))
    corr, rmse = certificate(ld, ld_ref)
    warm = [synced_seconds(lambda: mt.DensityEstimator(device=DEVICE, **NYSTROEM).fit_predict(x_np))[1]
            for _ in range(3)]
    est64 = mt.DensityEstimator(device=DEVICE, dtype=torch.float64, **NYSTROEM)
    ld64, seconds64 = synced_seconds(lambda: est64.fit_predict(x_np))
    spread = float(ld.max() - ld.min())
    # the Nyström predictor (LandmarksConditional through the kept
    # landmarks, y_is_mean) smooths f rather than interpolating it, in the
    # JAX package too (PERF.md): at the training points it is held to the
    # float64 fit's predictor, and its distance from f is printed
    at_train = est.predict(x_np)
    train_err = float((at_train - ld).abs().max()) / spread
    train_corr, _ = agreement(at_train, est64.predict(x_np))
    kept = int(est.landmarks.shape[0])
    stats = {
        "landmarks_kept": kept, "rank": int(est.L.shape[1]),
        "eigensolver": "sketch" if kept > NYSTROEM_DIRECT_EIGH_MAX else "direct",
        "certificate": {"corr": corr, "rmse": rmse},
        "first_fit_seconds": first_s, "warm_fit_seconds": warm,
        "warm_fit_median": statistics.median(warm), "lbfgs_steps": est.opt_state.n_steps,
        "f64": {"landmarks_kept": int(est64.landmarks.shape[0]), "rank": int(est64.L.shape[1]),
                "seconds": seconds64, "certificate": certificate(ld64, ld_ref)},
        "f32_vs_f64": agreement(ld, ld64),
        "predict_at_training_points": {"max_from_f_over_spread": train_err,
                                       "corr_f32_f64": train_corr},
    }
    full = {}
    for dtype in (torch.float32, torch.float64):
        e = mt.DensityEstimator(device=DEVICE, dtype=dtype, **FULL_NYSTROEM)
        full[dtype] = (e, *synced_seconds(lambda: e.fit_predict(x_np[:FULL_CELLS])))
    e32, ld32, s32 = full[torch.float32]
    stats["full_nystroem"] = {"cells": FULL_CELLS, "gp_type": e32.gp_type.value,
                              "rank": int(e32.L.shape[1]),
                              "rank_f64": int(full[torch.float64][0].L.shape[1]),
                              "seconds": s32, "seconds_f64": full[torch.float64][2],
                              "corr_f32_f64": log_density_corr(ld32, full[torch.float64][1])}
    log("[nystroem] " + json.dumps(stats))
    log(f"[nystroem] bars: certificate corr >= {NYSTROEM_CERT_MIN_CORR}, RMSE/spread <= "
        f"{NYSTROEM_CERT_MAX_RMSE}; predict at the training points, float32 vs float64, corr >= "
        f"{DENSITY_FULL_MIN_CORR}; full_nystroem float32 vs float64 corr >= {DENSITY_FULL_MIN_CORR}")
    ok = (finite(ld, ld64, ld32) and est.gp_type.value == "sparse_nystroem"
          and corr >= NYSTROEM_CERT_MIN_CORR and rmse <= NYSTROEM_CERT_MAX_RMSE
          and train_corr >= DENSITY_FULL_MIN_CORR and e32.gp_type.value == "full_nystroem"
          and stats["full_nystroem"]["corr_f32_f64"] >= DENSITY_FULL_MIN_CORR)
    if not ok:
        raise AssertionError(f"nystroem failed its bars: {stats}")
    return stats


def float64_whitening(est, x):
    """L built in float64 on the card independently of the estimator's
    route: the plain kernel, an unescalated Cholesky of K_uu + jitter·I and
    a triangular solve."""
    import torch

    from mellon_tpu_torch.ops.hopper_kernels import matern52_gram_reference

    x64 = torch.as_tensor(x, device=DEVICE, dtype=torch.float64)
    xu = est.landmarks.double()
    K = matern52_gram_reference(xu, xu, est.ls)
    Lp = torch.linalg.cholesky(K + est.jitter * torch.eye(K.shape[0], dtype=K.dtype, device=K.device))
    return torch.linalg.solve_triangular(Lp.T, matern52_gram_reference(x64, xu, est.ls),
                                         upper=True, left=False)


def relative_rms(got, want):
    return float(torch_rms(got.double() - want) / torch_rms(want))


def torch_rms(t):
    return t.pow(2).mean().sqrt()


def full_capacity_path(mt, x_np, ld_ref, default):
    """config.PRUNE_SINGULAR_LANDMARKS = False at the bench shape: every
    landmark kept, L against a float64 construction, the certificate
    beside the pruned default's; then EXTENDED_PRECISION_WHITEN = False
    (printed).  Both flags are restored."""
    from mellon_tpu_torch import config

    flags = (config.PRUNE_SINGULAR_LANDMARKS, config.EXTENDED_PRECISION_WHITEN)
    stats = {"pruned_default": default}
    try:
        config.PRUNE_SINGULAR_LANDMARKS = False
        for whiten in (True, False):
            config.EXTENDED_PRECISION_WHITEN = whiten
            est = mt.DensityEstimator(device=DEVICE)
            ld, seconds = synced_seconds(lambda: est.fit_predict(x_np))
            L_ref = float64_whitening(est, x_np)
            corr, rmse = certificate(ld, ld_ref)
            stats["float64_whitening" if whiten else "float32_whitening"] = {
                "landmarks_kept": int(est.landmarks.shape[0]),
                "float64_factor": est._f64_Lp is not None, "seconds": seconds,
                "L_relative_rms": relative_rms(est.L, L_ref),
                "certificate": {"corr": corr, "rmse": rmse}, "finite": finite(ld),
                "lbfgs_steps": est.opt_state.n_steps,
            }
            del est, L_ref
    finally:
        config.PRUNE_SINGULAR_LANDMARKS, config.EXTENDED_PRECISION_WHITEN = flags
    log("[full capacity] " + json.dumps(stats))
    n_landmarks = mt.parameters.DEFAULT_N_LANDMARKS
    log(f"[full capacity] bars (float64 whitening): all {n_landmarks} landmarks kept, L "
        f"relative RMS <= {CAPACITY_L_REL}, certificate corr >= {CERT_MIN_CORR}, RMSE/spread "
        f"<= {CERT_MAX_RMSE}")
    main = stats["float64_whitening"]
    ok = (main["finite"] and main["float64_factor"] and main["landmarks_kept"] == n_landmarks
          and main["L_relative_rms"] <= CAPACITY_L_REL
          and main["certificate"]["corr"] >= CERT_MIN_CORR
          and main["certificate"]["rmse"] <= CERT_MAX_RMSE)
    if not ok:
        raise AssertionError(f"full capacity failed its bars: {stats}")
    return stats


def atlas_cells(n, d, seed):
    """bench.make_data's recipe in numpy: 12 centres ~ N(0, 2²), scales
    0.3 + 0.4·U, per-dimension decay e^(−0.15 j); float32 (n, d)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, d)) * 2.0
    assign = rng.integers(0, 12, n)
    scales = 0.3 + 0.4 * rng.random((12, 1))
    x = centers[assign] + scales[assign] * rng.normal(size=(n, d))
    return (x * np.exp(-0.15 * np.arange(d))[None, :]).astype(np.float32)


def atlas_path(mt):
    """Configuration 5's single-card slice: the stage-synchronised float32
    fit of the 1M x 50 cells with 5,000 landmarks, the bf16 MAP on the same
    prepared model held to it, and the 50,000 x 50 subscale float32 fit
    certified against its float64 reference.  Returns (stats, the atlas
    cells and landmarks for the kernel phase's 2**31-element check, the
    estimator holding the float32 MAP again for [atlas nuts])."""
    import numpy as np
    import torch

    from mellon_tpu_torch.models.density import PREPARED_ATTRIBUTES

    x_np, data_s = synced_seconds(lambda: atlas_cells(ATLAS_CELLS, ATLAS_DIMS, ATLAS_SEED))
    est = mt.DensityEstimator(n_landmarks=ATLAS_LANDMARKS, device=DEVICE)
    stages = staged_fit(est, x_np, PREPARED_ATTRIBUTES)
    z32, ld32 = est.pre_transformation, est.log_density_x
    steps32 = est.opt_state.n_steps
    lbfgs32 = stages["lbfgs"]
    est.precision = "bf16"
    _, lbfgs16 = synced_seconds(est.run_inference)
    ld16 = est.process_inference(build_predict=False)
    bf16_opt = est.opt_state
    corr, rmse = agreement(ld16, ld32)
    # the float32 MAP again, for [atlas nuts]
    est.precision, est.pre_transformation, est.log_density_x = None, z32, ld32
    L = est.L
    stats = {
        "cells": list(x_np.shape), "data_seconds": data_s, "stage_seconds": stages,
        "prepare_seconds": sum(v for k, v in stages.items() if k in PREPARED_ATTRIBUTES),
        "process_seconds": stages["log_density_x"] + stages["predictor"],
        "knn_seconds": stages["nn_distances"], "landmarks_kept": int(est.landmarks.shape[0]),
        "rank": int(L.shape[1]), "L_bytes": L.numel() * L.element_size(),
        "lbfgs_f32": {"seconds": lbfgs32, "steps": steps32},
        "lbfgs_bf16": {"seconds": lbfgs16, "phase_steps": list(bf16_opt.phase_steps),
                       "evaluations": bf16_opt.n_evals},
        "bf16_vs_f32": {"corr": corr, "rmse": rmse},
    }
    big = (torch.as_tensor(x_np, device=DEVICE), est.landmarks[:ATLAS_BIG_COLUMNS], est.ls)
    if big[1].shape[0] < ATLAS_BIG_COLUMNS:
        g = torch.Generator(device=DEVICE).manual_seed(ATLAS_SEED)
        pick = torch.randperm(x_np.shape[0], device=DEVICE, generator=g)[:ATLAS_BIG_COLUMNS]
        big = (big[0], big[0][pick], est.ls)
    del L
    sub = np.load(ATLAS_SUB)
    est_sub = mt.DensityEstimator(n_landmarks=ATLAS_LANDMARKS, device=DEVICE)
    ld_sub, sub_s = synced_seconds(lambda: est_sub.fit_predict(np.asarray(sub["x"], dtype=np.float32)))
    sub_corr, sub_rmse = certificate(ld_sub, np.asarray(sub["log_density"], dtype=np.float64))
    stats["subscale"] = {"cells": list(sub["x"].shape), "seconds": sub_s,
                         "landmarks_kept": int(est_sub.landmarks.shape[0]),
                         "certificate": {"corr": sub_corr, "rmse": sub_rmse}}
    log("[atlas] " + json.dumps(stats))
    log(f"[atlas] bars: bf16 vs float32 corr >= {BF16_MIN_CORR}, RMSE/spread <= {BF16_MAX_RMSE}; "
        f"subscale certificate corr >= {CERT_MIN_CORR}, RMSE/spread <= {CERT_MAX_RMSE}; finite")
    ok = (finite(ld32, ld16, ld_sub) and corr >= BF16_MIN_CORR and rmse <= BF16_MAX_RMSE
          and sub_corr >= CERT_MIN_CORR and sub_rmse <= CERT_MAX_RMSE)
    if not ok:
        raise AssertionError(f"atlas failed its bars: {stats}")
    return stats, big, est


class CountedCalls:
    """A batched potential that counts its calls: one per lockstep leaf."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, Z):
        self.calls += 1
        return self.fn(Z)


def latent_subset(k):
    """ATLAS_SUBSET latents of k, drawn as scripts/atlas_nuts_bench.py draws
    them."""
    import numpy as np

    return np.sort(np.random.RandomState(0).choice(k, size=min(k, ATLAS_SUBSET), replace=False))


def atlas_nuts_path(mt, est, smi):
    """Configuration 5's sampler on one card (scripts/atlas_nuts_bench.py's
    flow with precond) from the float32 MAP of [atlas]: the zero-centred
    potential, the Newton polish, the MAP-Hessian Cholesky and T = R⁻ᵀ
    (each timed), NUTS in w (ATLAS_NUTS), the draws unwhitened; bars over
    ATLAS_SUBSET latents (split-R-hat, min-ESS, each posterior std against
    sqrt(diag(T Tᵀ))) and the posterior-mean log density at the cells
    against the MAP's; its predictor at 1,000 cells against f there.  The
    posterior mean goes to ATLAS_POSTERIOR for the atlas mesh phase."""
    import numpy as np
    import torch

    from mellon_tpu_torch.inference import mcmc
    from mellon_tpu_torch.inference.diagnostics import effective_sample_size, split_rhat
    from mellon_tpu_torch.inference.losses import density_hessian

    args = est._loss_args
    z0, ld_map = est.pre_transformation, est.log_density_x
    value_and_grad, offset = mcmc.zero_centered_potential(z0, *args)
    hessian = lambda z: density_hessian(z, *args)  # noqa: E731
    (z_map, gn0, gn1), polish_s = synced_seconds(
        lambda: mcmc.newton_polish(value_and_grad, hessian, z0))
    H, build_s = synced_seconds(lambda: hessian(z_map))
    T, factor_s = synced_seconds(lambda: mcmc.precondition_transform(mcmc.hessian_cholesky(H)))
    del H
    potential = CountedCalls(mcmc.preconditioned_potential(value_and_grad, T, z_map))
    opts = {k: v for k, v in ATLAS_NUTS.items() if k != "num_chains"}
    w0 = torch.zeros(ATLAS_NUTS["num_chains"], z_map.shape[0], device=DEVICE, dtype=z_map.dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(ATLAS_NUTS_SEED)
    res, seconds = synced_seconds(lambda: mcmc.run_mcmc(potential, w0, gen, **opts))
    samples = mcmc.unwhiten_samples(res.samples, T, z_map)
    chains, draws, k = samples.shape
    sub = latent_subset(k)
    picked = samples[:, :, torch.as_tensor(sub, device=samples.device)]
    ess = effective_sample_size(picked)
    rhat = float(np.max(split_rhat(picked)))
    std = picked.reshape(-1, len(sub)).std(dim=0, correction=0)
    gauss = torch.sqrt((T * T).sum(dim=1))
    ratio = (std / gauss[torch.as_tensor(sub, device=gauss.device)]).double().cpu().numpy()
    all_ratio = (samples.reshape(-1, k).std(dim=0, correction=0) / gauss).double().cpu().numpy()
    z_mean = samples.reshape(-1, k).mean(dim=0)
    ld_post = est.transform(z_mean)
    corr = log_density_corr(ld_post, ld_map)
    pred = posterior_predictor(est, samples.reshape(-1, k))
    cells = torch.as_tensor(est.x[:1000], device=DEVICE)
    at_cells = pred(cells)
    spread = float(ld_post.max() - ld_post.min())
    pred_err = float((at_cells - ld_post[:1000]).abs().max()) / spread
    os.makedirs(os.path.dirname(ATLAS_POSTERIOR), exist_ok=True)
    np.savez(ATLAS_POSTERIOR, z_mean=z_mean.double().cpu().numpy(),
             log_density=ld_post.double().cpu().numpy())
    stats = {
        "cells": list(est.x.shape), "latents": k, "settings": ATLAS_NUTS,
        "seed": ATLAS_NUTS_SEED, "offset_per_cell": offset, "newton_grad_norm": [gn0, gn1],
        "newton_seconds": polish_s, "hessian_build_seconds": build_s,
        "hessian_factor_seconds": factor_s, "sampling_seconds": seconds,
        "step_size": float(res.step_size), "mean_accept": float(res.accept_prob.mean()),
        "divergences": int(res.diverging.sum()),
        "leapfrogs_per_draw": float(res.num_leapfrog.double().mean()),
        "lockstep_leaves": potential.calls, "ms_per_leaf": 1e3 * seconds / potential.calls,
        "host_reads_per_draw_transition": res.host_reads / draws,
        "draws_per_second": chains * draws / seconds,
        "ess_min": float(ess.min()), "ess_median": float(np.median(ess)),
        "ess_min_per_second": float(ess.min()) / seconds, "max_rhat": rhat,
        "std_ratio_subset": [float(ratio.min()), float(np.median(ratio)), float(ratio.max())],
        "std_ratio_all": [float(all_ratio.min()), float(np.median(all_ratio)),
                          float(all_ratio.max())],
        "corr_with_map": corr, "predictor_at_cells_err_over_spread": pred_err,
    }
    log("[atlas nuts] " + json.dumps(stats))
    log(f"[atlas nuts] card {smi}; times: the polish, the Hessian build, its float64 factor "
        f"and inverse, the sampling (warmup and draws; ms per leaf over both); std ratios "
        f"[min, median, max]")
    log(f"[atlas nuts] bars over {len(sub)} latents: max split-R-hat <= {NUTS_MAX_RHAT}, "
        f"min-ESS >= {NUTS_MIN_ESS}, each std ratio in {list(STD_RATIO)}; corr >= "
        f"{POSTERIOR_MIN_CORR}; predictor at the cells within {ATLAS_PREDICT_REL} of the "
        f"spread; all finite")
    ok = (finite(samples, ld_post, at_cells) and rhat <= NUTS_MAX_RHAT
          and float(ess.min()) >= NUTS_MIN_ESS
          and STD_RATIO[0] <= float(ratio.min()) and float(ratio.max()) <= STD_RATIO[1]
          and corr >= POSTERIOR_MIN_CORR and pred_err <= ATLAS_PREDICT_REL)
    if not ok:
        raise AssertionError(f"atlas nuts failed its bars: {stats}")
    return stats


def dimensionality_nuts_path(mt, x_np, est_map):
    """DimensionalityEstimator(optimizer="nuts") at [nuts]'s budget: split-R-hat,
    the draws' shape (chains, draws, 2, k), finite local dimensions; their
    correlation with the L-BFGS fit; optimizer="smc" raises ValueError."""
    import numpy as np

    from mellon_tpu_torch.inference.diagnostics import split_rhat

    est = mt.DimensionalityEstimator(optimizer="nuts", sampler_options=DIM_NUTS_OPTIONS,
                                     device=DEVICE)
    dims, fit_s = synced_seconds(lambda: est.fit_predict(x_np))
    res = est.mcmc_result
    chains, draws = res.samples.shape[:2]
    k = est.L.shape[1]
    shape = tuple(est.posterior_samples.shape)
    rhat = float(np.max(split_rhat(res.samples)))
    try:
        mt.DimensionalityEstimator(optimizer="smc", device=DEVICE).fit(x_np[:500])
        smc = "no error"
    except ValueError as e:
        smc = str(e)
    stats = {
        "fit_seconds": fit_s, "sampling_seconds": est.sampling_time,
        "posterior_samples": list(shape), "step_size": float(res.step_size),
        "mean_accept": float(res.accept_prob.mean()), "divergences": int(res.diverging.sum()),
        "leapfrogs_per_draw": float(res.num_leapfrog.double().mean()),
        "ess_min": float(est.ess.min()), "ess_per_second": est.ess_per_second, "max_rhat": rhat,
        "corr_with_lbfgs": {"local_dim_x": log_density_corr(dims, est_map.local_dim_x),
                            "log_density_x": log_density_corr(est.log_density_x,
                                                              est_map.log_density_x)},
        "local_dim_range": [float(dims.min()), float(dims.max())], "smc": smc,
    }
    log("[dimensionality nuts] " + json.dumps(stats))
    log(f"[dimensionality nuts] bars: max split-R-hat <= {NUTS_MAX_RHAT}, draws "
        f"({chains}, {draws}, 2, {k}), local dimensions finite and positive, smc raises "
        "ValueError")
    ok = (finite(dims, res.samples) and float(dims.min()) > 0 and rhat <= NUTS_MAX_RHAT
          and shape == (chains, draws, 2, k) and "1-d latent vectors" in smc)
    if not ok:
        raise AssertionError(f"dimensionality nuts failed its bars: {stats}")
    return stats


def checkpoint_path(mt, est, x_new):
    """The [nuts] fit's chains through save_sampler_state and
    load_sampler_state: CHECKPOINT_DRAWS draws resumed from the loaded
    checkpoint equal, bit for bit, those resumed from the state in memory."""
    import torch

    from mellon_tpu_torch.inference.mcmc import resume_mcmc

    res = est.mcmc_result
    potential = est._sampler_potential(est.pre_transformation)
    z_last = res.samples[:, -1]
    generator = torch.Generator(device=DEVICE).manual_seed(ATLAS_SEED + 7)
    path = os.path.join(ROOT, "build", "chip_smoke_checkpoint")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _, save_s = synced_seconds(lambda: mt.save_sampler_state(
        path, samples=res.samples, state=z_last, step_size=res.step_size,
        inv_mass_diag=res.inv_mass_diag, rng_key=generator, metadata={"algorithm": "nuts"}))
    loaded, load_s = synced_seconds(lambda: mt.load_sampler_state(path))
    nbytes = os.path.getsize(path + ".npz") + os.path.getsize(path + ".json")
    kw = dict(num_samples=CHECKPOINT_DRAWS, max_tree_depth=10)
    memory = resume_mcmc(potential, z_last, generator, res.step_size, res.inv_mass_diag, **kw)
    disk = resume_mcmc(potential, loaded["state"][0], loaded["rng_key"], loaded["step_size"],
                       loaded["inv_mass_diag"], **kw)
    identical = bool(torch.equal(memory.samples, disk.samples))
    # the resumed draws' predictor at the 1,000 points, from each source
    draws = [r.samples.reshape(-1, r.samples.shape[-1]) for r in (memory, disk)]
    at = [posterior_predictor(est, z)(x_new) for z in draws]
    stats = {"bytes": nbytes, "save_seconds": save_s, "load_seconds": load_s,
             "chains": int(z_last.shape[0]), "resumed_draws": CHECKPOINT_DRAWS,
             "bit_identical": identical, "predictors_equal": bool(torch.equal(*at)),
             "finite": finite(memory.samples, *at)}
    log("[checkpoint] " + json.dumps(stats))
    log("[checkpoint] bars: draws resumed from the loaded checkpoint bit-identical to those "
        "resumed from memory")
    if not (identical and stats["predictors_equal"] and stats["finite"]):
        raise AssertionError(f"checkpoint failed its bars: {stats}")
    return stats


def run_ranks(phase, backend, devices, out):
    """Start one rank of chip_smoke_parallel.py per device, wait for all of
    them (PARALLEL_TIMEOUT; a rank that outlasts it is killed, with the
    others), relay their [parallel] lines and return their results."""
    store = os.path.join(out, f"store_{phase}")
    if os.path.exists(store):
        os.remove(store)
    world = len(devices)
    procs = [subprocess.Popen([sys.executable, PARALLEL_WORKER, phase, backend, str(world), str(r),
                               devices[r], store, out],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=PARALLEL_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"a [parallel] {phase} rank hung past {PARALLEL_TIMEOUT} s")
    for rank, (p, text) in enumerate(zip(procs, texts)):
        for line in text.splitlines():
            if line.startswith("[parallel]") or p.returncode:
                log(line if line.startswith("[parallel]") else f"[parallel {phase} {rank}] {line}")
        if p.returncode:
            raise AssertionError(f"[parallel] {phase} rank {rank} exited {p.returncode}")
    results = []
    for rank in range(world):
        with open(os.path.join(out, f"{phase}_rank{rank}.json")) as f:
            results.append(json.load(f))
    return results


def parallel_path(est_nuts, smi):
    """Path 27: two ranks (NCCL on two cards, else gloo on one), then one
    rank on NCCL, then the atlas on the 2 x 2 mesh (four NCCL ranks on four
    cards at 1M cells, else four gloo ranks on one card at 100k); returns
    (launches, the ranks' kernel calls as (n, m, d, dtype, ls), stats)."""
    import numpy as np
    import torch

    out = os.path.join(ROOT, "build", "parallel")
    os.makedirs(out, exist_ok=True)
    for name in os.listdir(out):
        os.remove(os.path.join(out, name))
    np.savez(os.path.join(out, "nuts_reference.npz"),
             log_density=est_nuts.log_density_x.double().cpu().numpy())
    cards = torch.cuda.device_count()
    if cards >= 2:
        backend, devices, mode = "nccl", ["cuda:0", "cuda:1"], "NCCL, one card per rank"
    else:
        backend, devices, mode = "gloo", ["cuda:0", "cuda:0"], "gloo, both ranks on cuda:0"
    if cards >= 4:
        atlas = ("nccl", [f"cuda:{r}" for r in range(4)],
                 f"NCCL, one card per rank, {ATLAS_CELLS:,} x {ATLAS_DIMS}")
    else:
        atlas = ("gloo", ["cuda:0"] * 4, f"gloo, all four ranks on cuda:0, 100,000 x {ATLAS_DIMS}")
    torch.cuda.empty_cache()
    results = (run_ranks("ranks", backend, devices, out) + run_ranks("one", "nccl", ["cuda:0"], out)
               + run_ranks("atlas", *atlas[:2], out))
    log(f"[parallel] ran: two ranks on {backend} ({mode}; {cards} card(s) on this machine), "
        f"then one rank on NCCL on cuda:0, then the atlas on 2 x 2 ranks on {atlas[0]} "
        f"({atlas[2]}); card {smi}")
    launches = [r["launches"] for r in results]
    log(f"[parallel] kernel launches per rank (two ranks, one, the four atlas ranks): {launches}")
    if min(launches) <= 0:
        raise AssertionError(f"a [parallel] rank launched the matern52 kernel no time: {launches}")
    stats = {f"{r['phase']} rank {r['rank']} ({r['backend']}, {r['device']})": r["stats"]
             for r in results}
    for key, value in stats.items():
        for name in ("rate 1x1", "rate 1x2", "chain-sharded nuts", "atlas nuts"):
            if name in value:
                figure = {k: value[name][k] for k in ("evals_per_second", "ms_per_eval", "leaf_ms",
                                                       "all_reduce_ms_per_leaf", "seconds")
                          if k in value[name]}
                log(f"[parallel] {key} {name}: {json.dumps(figure)} ({smi})")
    calls = [tuple(c) for r in results for c in r["calls"]]
    return sum(launches), calls, stats


def wrapper_host_us(calls=1000, turns=4):
    """Host time of one ``matern52_gram`` call (checks, allocation, the
    ctypes call and the launch): a host clock over ``calls`` calls without
    a synchronise, at a shape whose kernel is shorter than that; the median
    of ``turns`` turns, taken in turns with the call below the autograd
    routing (``_matern52_gram``), whose time is printed beside it."""
    import torch

    from mellon_tpu_torch.ops import hopper_kernels as hk

    g = torch.Generator(device=DEVICE).manual_seed(3)
    x = torch.randn(256, 20, device=DEVICE, generator=g)
    times = {"matern52_gram": [], "_matern52_gram": []}
    for turn in range(2 * turns):
        name = ("matern52_gram", "_matern52_gram")[(turn + turn // 2) % 2]
        fn = getattr(hk, name)
        for _ in range(10):
            fn(x, x, 2.5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(x, x, 2.5)
        times[name].append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    host_us = statistics.median(times["matern52_gram"])
    log(f"[wrapper] host time per matern52_gram call (256x256x20 float32, {calls} "
        f"calls, no synchronise, median of {turns} turns): {host_us!r} us; below the "
        f"autograd routing: {statistics.median(times['_matern52_gram'])!r} us; "
        f"turns {json.dumps(times)}")
    return host_us


def staged_fit(est, x, prepared_attributes):
    """A fit of ``est`` on x with the card synchronized between its stages
    (``prepared_attributes`` in order, then L-BFGS, the log density and
    the predictor): seconds per stage."""
    import torch

    from mellon_tpu_torch.models.density import SIZE_ATTRIBUTES

    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0

    def validate():
        est.set_x(x)
        for attr in SIZE_ATTRIBUTES:
            est._prepare_attribute(attr)
        est.validate_parameter()

    timed("validate", validate)
    for attr in prepared_attributes:
        timed(attr, lambda a=attr: est._prepare_attribute(a))
    timed("lbfgs", est.run_inference)
    timed("log_density_x", lambda: est.process_inference(build_predict=False))
    timed("predictor", lambda: est.predict)
    return stages


def main():
    import torch

    script_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run.", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import mellon_tpu_torch as mt
    from mellon_tpu_torch.ops import hopper_kernels as hk

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: {name}")
    log(f"[device] nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    path = hk.build_library()
    log(f"[build] {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.3f} s")
    lib = hk._library()

    # 3. the main path: fit, then the lazily built predictor, with the
    # kernel's launches counted and their operands kept
    ref = np.load(DATA)
    x_np = np.asarray(ref["x"], dtype=np.float32)
    ld_ref = np.asarray(ref["log_density"], dtype=np.float64)
    x = torch.as_tensor(x_np, device=DEVICE)
    x_new = x[:1000] + 0.01 * x.std(dim=0) * torch.randn(
        1000, x.shape[1], device=DEVICE, generator=torch.Generator(device=DEVICE).manual_seed(1)
    )
    g = torch.Generator(device=DEVICE).manual_seed(2)
    idx = torch.randint(0, x.shape[0], (PREDICT_BATCH,), device=DEVICE, generator=g)
    xq = (x[idx] + 0.05 * x.std(dim=0) * torch.randn(
        PREDICT_BATCH, x.shape[1], device=DEVICE, generator=g)).contiguous()
    calls, stop_recording = record_operands()
    hk.matern52_gram.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = mt.DensityEstimator(device=DEVICE)
    ld = est.fit_predict(x_np)
    torch.cuda.synchronize()
    first_fit_s = time.perf_counter() - t0
    fit_launches = hk.matern52_gram.launches
    pred = est.predict
    at_train = pred(x_np)
    at_new = pred(x_new)
    torch.cuda.synchronize()
    launches = hk.matern52_gram.launches

    if ld.shape != (x_np.shape[0],) or not bool(torch.isfinite(ld).all()):
        raise AssertionError("the fit's log density is not finite or has the wrong shape")
    if fit_launches <= 0 or launches <= fit_launches:
        raise AssertionError(
            f"the main path launched the matern52 kernel {fit_launches} times in the "
            f"fit and {launches} times in all"
        )
    if len(calls) != launches:
        raise AssertionError(f"{len(calls)} kernel calls were made but {launches} launched")
    n_kept = int(est.landmarks.shape[0])
    corr, rmse = certificate(ld, ld_ref)
    log(f"[fit] first fit {first_fit_s:.3f} s; kernel launches in the fit: {fit_launches}")
    log(f"[fit] landmarks kept {n_kept} of 5000 (power of two: {n_kept & (n_kept - 1) == 0}); "
        f"L-BFGS {est.opt_state.n_steps} steps, {est.opt_state.n_evals} evaluations "
        f"(one host read each); loss {est.opt_state.loss!r}")
    log(f"[fit] certificate vs host-f64 full-landmark fit: corr {corr!r}, RMSE/spread {rmse!r}")
    if not (corr >= CERT_MIN_CORR and rmse <= CERT_MAX_RMSE):
        raise AssertionError(f"certificate failed: corr {corr}, RMSE/spread {rmse}")
    ld_spread = float(ld.max() - ld.min())
    train_err = float((at_train - ld).abs().max()) / ld_spread
    log(f"[predict] training points: max |pred - f| / spread = {train_err!r}; "
        f"1000 perturbed points finite: {bool(torch.isfinite(at_new).all())}; "
        f"kernel launches over fit + predict: {launches}, shapes "
        + ", ".join(f"{a.shape[0]}x{b.shape[0]}x{a.shape[1]}" for a, b, _ in calls))
    if not (train_err <= 1e-3 and bool(torch.isfinite(at_train).all()) and bool(torch.isfinite(at_new).all())):
        raise AssertionError(f"predictor disagrees with f at the training points: {train_err}")
    path_launches = {"main": launches}

    default = {"landmarks_kept": n_kept, "certificate": {"corr": corr, "rmse": rmse}}

    def run(label, fn):
        (result, path_launches[label]), seconds = synced_seconds(lambda: counted_path(hk, label, fn))
        log(f"[{label}] path seconds {seconds!r}")
        return result

    # 5-8. the paths of the predictor's uncertainty, ADVI, derivatives and
    # JSON, each with its own launch count
    run("uncertainty", lambda: uncertainty_path(mt, x_np, x_new, xq, ld_ref))
    run("advi", lambda: advi_path(mt, x_np, ld_ref))
    check_derivatives(pred, *run("derivatives", lambda: derivatives_path(pred, x_new)))
    run("json", lambda: json_path(mt, pred, x_new))
    # 11-13. the posterior samplers
    nuts = run("nuts", lambda: nuts_path(mt, x_np, x_new, est))
    run("nuts precond", lambda: precond_path(mt, est, x_new))
    run("smc", lambda: smc_path(mt, est, x_new))
    # 14-17. the FunctionEstimator, the DimensionalityEstimator and the
    # full GP type
    Y = gene_trends(x_np, FUNCTION_OUTPUTS)
    run("function", lambda: function_path(mt, x_np, x_new, Y))
    run("function full", lambda: function_full_path(mt, x_np, x_new, Y))
    dim = run("dimensionality", lambda: dimensionality_path(mt, x_np, x_new))
    run("density full", lambda: density_full_path(mt, x_np, x_new))
    # 18-21. the time-sensitive density model
    time_est = run("time", lambda: time_path(mt, *load_time_course()))
    run("time predict", lambda: time_predict_path(mt, time_est))
    del time_est
    torch.cuda.empty_cache()
    run("time matched", lambda: time_matched_path(mt))
    run("ls_time", lambda: ls_time_path(mt))
    # 22-26. the Nyström types, full capacity, the atlas slice, the
    # dimensionality model's NUTS and the sampler checkpoint
    run("nystroem", lambda: nystroem_path(mt))
    run("full capacity", lambda: full_capacity_path(mt, x_np, ld_ref, default))
    atlas = run("atlas", lambda: atlas_path(mt))
    run("atlas nuts", lambda: atlas_nuts_path(mt, atlas[2], smi))
    atlas = atlas[:2]
    torch.cuda.empty_cache()
    run("dimensionality nuts", lambda: dimensionality_nuts_path(mt, x_np, dim[1]))
    run("checkpoint", lambda: checkpoint_path(mt, nuts[1], x_new))
    stop_recording()
    launches = sum(path_launches.values())
    if len(calls) != launches:
        raise AssertionError(f"{len(calls)} kernel calls were made but {launches} launched")
    # 27. the ranks count their own launches; their calls are timed and
    # checked again below on operands of the same shapes
    (path_launches["parallel"], rank_calls, _), seconds = synced_seconds(
        lambda: parallel_path(nuts[1], smi))
    log(f"[parallel] path seconds {seconds!r}")
    g = torch.Generator(device=DEVICE).manual_seed(4)
    for n, m, d, dtype, ls in rank_calls:
        dtype = getattr(torch, dtype)
        calls.append((torch.randn(n, d, device=DEVICE, dtype=dtype, generator=g),
                      torch.randn(m, d, device=DEVICE, dtype=dtype, generator=g), ls))
    launches = sum(path_launches.values())
    log(f"[paths] kernel launches: {json.dumps(path_launches)}")

    # 4. the kernel against its plain version, on the paths' operands, and
    # at an atlas-shaped call past 2**31 output elements
    del nuts, dim
    torch.cuda.empty_cache()
    max_err, rows = kernel_phase(lib, calls)
    xa, ya, ls = atlas[1]
    del atlas
    err, row = predict_batch_phase(lib, xa, ya, ls, 0)
    max_err = max(max_err, err)
    rows.append(row)
    ms = sum(r["ms"] * r["launches"] for r in rows)
    plain_ms = sum(r["plain_ms"] * r["launches"] for r in rows)
    bound_ms = sum(r["bound_ms"] * r["launches"] for r in rows)
    log(f"[kernel] the paths' {launches} launches: kernel {ms!r} ms, plain "
        f"{plain_ms!r} ms, bound {bound_ms!r} ms, share {bound_ms / ms!r}")

    # 9. the wrapper's host time
    host_us = wrapper_host_us()

    # 10. timing
    fit_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mt.DensityEstimator(device=DEVICE).fit_predict(x_np)
        torch.cuda.synchronize()
        fit_times.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("a warm fit's log density is not finite")
    log(f"[fit] warm fit seconds {fit_times!r}; median {statistics.median(fit_times)!r}")
    from mellon_tpu_torch.models.density import PREPARED_ATTRIBUTES

    stages = staged_fit(mt.DensityEstimator(device=DEVICE), x_np, PREPARED_ATTRIBUTES)
    log("[fit] stage seconds " + json.dumps({k: round(v, 6) for k, v in stages.items()}))

    log(f"[total] script seconds {time.perf_counter() - script_start!r} (build included)")
    log(json.dumps({"kernels": [{
        "name": "matern52_gram",
        "route": "cuda",
        "source": "mellon_tpu_torch/csrc/matern52_tile.cu",
        "replaces": "mellon_tpu/ops/pallas_kernels.py:62",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows if r["launches"]) else "operations",
        "library_ms": None,
        "share": bound_ms / ms,
        "wrapper_host_us": host_us,
        "shapes": rows,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
