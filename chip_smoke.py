#!/usr/bin/env python3
"""Drive mellon_tpu_torch's estimators once on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each printed as it runs (any failure raises and exits non-zero).
Each path (3, 5-8, 11-26 and 28-32) runs with the kernels' launch counts set to 0
just before it and read just after, and fails if the Matern-5/2 kernel was
not launched; the pivot step's launches are reported per path, and the
main fit (3) fails unless it launched the pivot step past stage 1's
1,024 steps (its selection continues them on the card); the operands of every kernel call the covariance module makes on
these paths are kept for phase 4.  Path 27's ranks are processes of their
own: each counts its launches from 0 over its fit and its sharded
predictor and reports them with its calls' shapes, and the path fails if
any rank launched the kernel no time.

1. device: the card's name and power limit (from nvidia-smi);
2. build: nvcc builds the Matern-5/2 kernel from csrc/ into build/ (the
   pivot step's library is built at its first use);
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
10. timing: the warm fit time (median of 3) with the fused prepare on
   (its CUDA graphs replayed) and off (the lazy chain), in turns, and a
   per-stage breakdown of the lazy chain;
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
   The ranks' kernel calls join phase 4's.  The atlas phase also saves
   the chain-sharded chains (rank 0 writes), reloads them on every rank
   and resumes ATLAS_RESUME_DRAWS transitions (finite; the saved chains
   continued by them within split-R-hat <= NUTS_MAX_RHAT);
28. ivf (right after 24, on its float32 fit's cells): nn_distances(x,
   method="ivf") (8 probes) timed in three synchronised parts (the coarse
   quantizer, the assignment and table, the search), with the cell count,
   the table's cap and the points it truncates: every distance finite,
   > 0 and not below 24's exact 1-NN distance, the card's search equal to
   the CPU's on the same quantizer and table on IVF_CPU_ROWS rows, its
   share within IVF_REL of exact >= IVF_DEFAULT_MIN_EQUAL; knn_ivf at IVF_HELD_PROBES
   probes held to a share >= IVF_MIN_EQUAL; a float32 DensityEstimator on
   each's distances and 24's kept landmarks, its log density against 24's
   (the held one with the certificate's bars, the default one with corr
   >= IVF_DEFAULT_MIN_CORR and the certificate's RMSE) and its prepare seconds
   beside 24's; knn_distances(k=IVF_SUB_K, method="ivf") on the 50,000 x
   50 subscale cells with a recall > IVF_MIN_RECALL against the exact
   search; knn(x, 3) of IVF_QUERY atlas rows in column strips of
   IVF_COL_BLOCK equal to one strip, both timed;
29. tutorials (after 26): the four examples/*_tutorial_torch.py run to
   their end through runpy on the card, seconds for each;
30. fused (right after 3): the fused prepare of each estimator family
   (fused_path): every attribute of a replayed prepare equal to the lazy
   chain's bit for bit; its seconds, its synchronizing calls, and the
   stage graphs' nodes, pool bytes and capture seconds; the density's
   stage seconds replayed and eager;
31. bf16 sampling (right after 24's atlas nuts): precision="bf16" on 3's
   fit.  The card's bf16 density value and gradient at its MAP and three
   perturbed points held to the same function in float64 on the card
   (bf16_parity: >= 99% of the gradient entries bit for bit, each within
   one bfloat16 ulp of the likelihood part plus twice the float32
   formula's own error there, the value within its float32 bound);
   sample_density_posterior(
   precondition="hessian") in bf16 and in float32 at BF16_SAMPLING (trees
   capped at depth 6) with ms per leaf, step size, leapfrogs per draw,
   the share of trees at the cap, min-ESS, the share of latents whose
   std differs beyond MC error and the function means' corr, no posterior
   bar (the JAX package's own bf16 check failed); finite draws, the
   warning logged, the bf16 draws' predictor at the 1,000 points finite;
   the samplers' 8-chain potential at the atlas shape in float32 and in
   bf16, device ms per call beside the bytes bound of reading L twice.  The kernel's launches inside a
   graph count at each replay, with the graph's buffers as operands.
32. pivots (right after 30): select_stable_landmarks' selection
   (``ops.linalg._pivot_selection``, before the round-down) on the tutorial's
   5,000 x 5,000 landmark gram (the main path's 5,000 k-means landmarks and
   length scale) in float32 and in float64, through the step kernel, whose
   chunks replay a CUDA graph, against the plain step on the card
   (compare_pivot_selections): each run's factor on its kept pivots
   against the float64 Cholesky, their order's ``pivot_gap``, the kept
   count, and the kept landmarks shared (float32) or the same pivots
   (float64), each held to its limit; where the pivots part, the first
   step at which they do and the two candidates' residual variances.
   Then in float32 the seconds of each (median of PIVOT_RUNS, warm), the
   steps, and the bytes bound of reading L[:, :j] once a step at HBM's
   rate (``bound_ms``), which overstates the share: the steps whose
   L[:, :j] fits in L2 (``l2_bytes_share`` of the bytes) may read faster.

Phase 4 also checks the kernel at an atlas-shaped call past 2**31 output
elements (the atlas cells against ATLAS_BIG_COLUMNS of their landmarks),
on 2,000 rows at each end, the plain version timed in row blocks.
The script prints its total seconds before the result lines.

The line before the last is the JSON kernel report: for the Matern-5/2
tile ``launches`` over all paths; ``ms``, ``plain_ms`` and ``bound_ms``:
the kernel's, the plain version's and the bound's time summed over those
launches; ``shapes``: each shape and type with its launches, its own times
and share of the bound; for the pivot step its launches over all paths and
phase 32's times of one float32 selection; the last line is ``{"ok": true, "device": {...}}``.  Without a
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
# [functional]: the JAX form of the inference API on the main path's fit.
# The fused route's run against the batched call (bit for bit) is cut to a
# depth of 6, which the unpreconditioned trees reach; the two routes are
# compared in the Hessian-whitened coordinates, where trees turn early.
FUNCTIONAL_NUTS = dict(num_chains=16, num_warmup=20, num_samples=5, max_tree_depth=6)
FUNCTIONAL_PRECOND = dict(num_chains=16, num_warmup=100, num_samples=100, max_tree_depth=10)
FUNCTIONAL_MAX_RHAT = 1.05
# the corr bar of the torch.func route (and of the inline loss through the
# optimizers) against the fused route: the H100 read 1 - 6e-9 and, for the
# inline L-BFGS, 0.99999998 (PERF.md)
FUNCTIONAL_MIN_CORR = 0.99999
FUNCTIONAL_LAPLACE_REL = 1e-5
FUNCTIONAL_ADAM_STEPS = 100
FUNCTIONAL_SMC_PARTICLES = 256
FUNCTIONAL_TIME_CELLS = 200
FUNCTIONAL_DIM_CELLS = 2000
FUNCTIONAL_DIM_LANDMARKS = 500
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
# [ivf]: the IVF 1-NN on the atlas cells against the float32 fit's exact
# distances, with the 1-NN bar of tests/test_ops.py:261 (a share of at
# least IVF_MIN_EQUAL within IVF_REL relative) at IVF_HELD_PROBES probes:
# at the default 8 the reference algorithm reaches 0.9467 on these 1M x 50
# cells on the H100 (the JAX package reads the port's share at 200,000
# cells on the CPU; PERF.md), 0.9926 at 16 and 0.99975 at 32.  The
# subscale recall over IVF_SUB_K columns, and the column-streamed exact
# search on IVF_QUERY atlas rows in strips of IVF_COL_BLOCK against one
# strip
IVF_MIN_EQUAL = 0.999
# the default 8 probes, held below the reference's 1-NN bar at what the
# H100 read twice (a share of 0.94672, the refit's corr 0.998719 and
# RMSE/spread 0.00897; PERF.md) less a margin, the RMSE at the
# certificate's bar
IVF_DEFAULT_MIN_EQUAL = 0.94
IVF_DEFAULT_MIN_CORR = 0.998
IVF_HELD_PROBES = 32
IVF_REL = 1e-6
IVF_SUB_K = 3
IVF_MIN_RECALL = 0.97
IVF_QUERY = 8192
IVF_CPU_ROWS = 1024
IVF_COL_BLOCK = 2**18
TUTORIALS = ("basic", "gene_change_analysis", "time_series", "trajectory_trends")
# the dimensionality model's NUTS at [nuts]'s budget, its trees capped at
# depth 7, the depth its draws reach at the default cap of 10 (127
# leapfrogs each; the warmup's deeper trees took most of its time, and at
# a cap of 6 its split-R-hat fails, PERF.md); the checkpoint resumes its
# chains for CHECKPOINT_DRAWS draws
DIM_NUTS_OPTIONS = dict(NUTS_OPTIONS, max_tree_depth=7)
CHECKPOINT_DRAWS = 10
# [bf16 sampling] (right after [atlas nuts]).  Its function parity holds the
# card's bf16 density value and gradient at the main fit's MAP and
# BF16_POINTS - 1 points at BF16_PERTURB·N(0, I) from it (one batch) to
# the same function in float64 on the card (bf16_parity), BF16_EQUAL_SHARE
# of the gradient entries bit for bit (the CPU tests' bar against JAX).  Its sampler runs
# sample_density_posterior(precondition="hessian") in bf16 and in float32
# with one seed and BF16_SAMPLING, trees capped at depth 6: the JAX
# package's bf16 trees ran to their cap (its round-5 log), so a cap of 10
# could cost 1,023 leaves a draw.  A latent's std differs from the other
# precision's beyond MC error where |Δstd| / se > BF16_MC_Z, se from each
# run's ESS (scripts/bf16_agreement_direct.py's test); ms per leaf over
# BF16_LEAF_TRANSITIONS transitions resumed from the last draws.  Then
# the samplers' 8-chain potential at the atlas shape, timed over
# BF16_ATLAS_CALLS calls in each precision
BF16_POINTS = 4
BF16_EQUAL_SHARE = 0.99
BF16_PERTURB = 0.05
BF16_SAMPLING = dict(num_chains=16, num_warmup=100, num_samples=100, max_tree_depth=6)
BF16_SEED = 3
BF16_MC_Z = 3.0
BF16_LEAF_TRANSITIONS = 10
BF16_ATLAS_CHAINS = 8
BF16_ATLAS_CALLS = 10
BF16_WARNING = "round-5 posterior-agreement"
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
    for a library that takes one, is allocated here once.  A length scale
    that is a 0-d tensor on the card (a captured graph's) goes to the
    entry that reads it there (``matern52_gram_*_dev_ls``)."""
    import torch

    dev_ls = isinstance(ls, torch.Tensor)
    fn = getattr(lib, "matern52_gram_" + ("f32" if x.dtype == torch.float32 else "f64")
                 + ("_dev_ls" if dev_ls else ""))
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    scratch = ()
    if hasattr(lib, "matern52_scratch_elems"):
        numel = lib.matern52_scratch_elems(n, m, d, x.element_size())
        scratch = (torch.empty(numel, dtype=x.dtype, device=x.device),)
    args = (x.data_ptr(), y.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in scratch),
            n, m, d, ls.data_ptr() if dev_ls else float(ls), x.device.index,
            torch.cuda.current_stream().cuda_stream)

    def launch():
        code = fn(*args)
        if code != 0:
            raise RuntimeError(f"matern52 launch failed: {lib.matern52_error_string(code).decode()}")

    launch.scratch = scratch  # every launch writes it: it lives as long as the launcher
    return launch


# the covariance-level recorder (record_operands): the calls made while
# each CUDA graph was captured, under id() of the graph's list of captured
# launches (with the list, which keeps the id taken), the lists of the
# recorders now active, and the wrapped functions while any is
_GRAPH_CALLS = {}
_RECORDINGS = []
_WRAPPED = {}


def _install_recorder():
    """Wrap the covariance module's kernel call (``kernels.matern52_gram``,
    above the wrapper that counts launches) and the wrapper's replay count
    (``hopper_kernels.count_replay``): a call goes to every active
    recording, or, made while a CUDA graph is being captured (when it runs
    only at the graph's replays), to the graph's calls, which each replay
    adds to the active recordings."""
    import torch

    from mellon_tpu_torch.ops import hopper_kernels, kernels

    launch, count_replay = kernels.matern52_gram, hopper_kernels.count_replay

    def recording(x, y, ls):
        call = (x.detach(), y.detach(), ls)
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            graph = hopper_kernels._captured
            if graph is None:
                raise AssertionError("a matern52 call was captured outside captured_launches()")
            _GRAPH_CALLS.setdefault(id(graph), (graph, []))[1].append(call)
        else:
            for calls in _RECORDINGS:
                calls.append(call)
        return launch(x, y, ls)

    def replaying(graph):
        for calls in _RECORDINGS:
            calls.extend(_GRAPH_CALLS.get(id(graph), (graph, []))[1])
        return count_replay(graph)

    _WRAPPED.update(launch=launch, count_replay=count_replay)
    kernels.matern52_gram = recording
    hopper_kernels.count_replay = replaying


def record_operands():
    """Keep the operands of every kernel call the covariance module makes,
    eagerly or by replaying a graph captured while a recording ran, until
    the returned ``stop()`` is called; returns ``(calls, stop)``.  The
    count is kept apart from the wrapper's launch count, so that the two
    agree only where every call launched the kernel.  A length scale is
    kept as given: a number, or a 0-d tensor on the card (a graph's)."""
    from mellon_tpu_torch.ops import hopper_kernels, kernels

    if not _WRAPPED:
        _install_recorder()
    calls = []
    _RECORDINGS.append(calls)

    def stop():
        _RECORDINGS.remove(calls)
        if not _RECORDINGS:
            kernels.matern52_gram = _WRAPPED["launch"]
            hopper_kernels.count_replay = _WRAPPED.pop("count_replay")
            _WRAPPED.clear()

    return calls, stop


def host_calls(calls):
    """The recorded calls whose operands lie off the card."""
    return [(x, y) for x, y, _ in calls if x.device.type != "cuda" or y.device.type != "cuda"]


def ls_source(ls):
    """Where a kernel call's length scale lies: "device" for a 0-d tensor
    on the card (a captured graph's), else "host"."""
    return "device" if hasattr(ls, "data_ptr") else "host"


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
    returns the float32 error.  ``ls`` goes to the kernel as given (a
    number, or a 0-d tensor on the card) and to the plain version as a
    number."""
    import torch

    from mellon_tpu_torch.ops.hopper_kernels import matern52_gram, matern52_gram_reference

    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    for dtype in (torch.float32, torch.float64):
        xa, ya = x.to(dtype), y.to(dtype)
        K = matern52_gram(xa, ya, ls)
        torch.cuda.synchronize()
        plain = matern52_gram_reference(xa, ya, float(ls))
        name = dtype_name(dtype)
        err, kernel_f64, plain_f64, bar, ok = kernel_errors(K, plain, xa, ya, float(ls), name)
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
        plain_ms = device_ms(lambda: matern52_gram_reference(xa, ya, float(ls)))
        bound_ms, bound_by = matern52_bound_ms(n, m, d, name)
        rows.append({"shape": f"{n}x{m}x{d}", "dtype": name, "ls": ls_source(ls),
                     "launches": launches.get(name, 0),
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "share": bound_ms / ms})
        log(f"[kernel] {n}x{m}x{d} {name} ({ls_source(ls)} length scale): kernel {ms!r} ms, "
            f"plain {plain_ms!r} ms, "
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
        # a graph's launches read their length scale on the card: they are
        # timed and checked through that entry, in rows of their own
        key = (x.shape[0], y.shape[0], x.shape[1], ls_source(ls))
        entry = seen.setdefault(key, [x, y, ls, {}])
        entry[3][dtype_name(x.dtype)] = entry[3].get(dtype_name(x.dtype), 0) + 1
    for (n, m, d, _), (x, y, ls, launches) in seen.items():
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
        plain = matern52_gram_reference(xs, ys, float(ls))
        e, k64, p64, bar, ok = kernel_errors(got, plain, xs, ys, float(ls), dtype_label)
        err, kernel_f64, plain_f64 = max(err, e), max(kernel_f64, k64), max(plain_f64, p64)
        if not ok:
            raise AssertionError(f"matern52 kernel disagrees at {n}x{m}x{d} {dtype_label}: "
                                 f"{k64} against float64 (bar {bar})")
    del out
    if n * m <= 2**31:
        plain_ms = device_ms(lambda: matern52_gram_reference(x, y, float(ls)),
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
        plain_ms = device_ms(lambda: [matern52_gram_reference(a, b, float(ls)) for a, b in blocks],
                             launches=1, runs=BIG_PLAIN_RUNS)
    bound_ms, bound_by = matern52_bound_ms(n, m, d, dtype_label)
    log(f"[predict batch] {n}x{m}x{d} {dtype_label}: kernel {ms!r} ms, plain {plain_ms!r} ms, "
        f"bound {bound_ms!r} ms ({bound_by}), share {bound_ms / ms!r}; "
        f"{n * m * ITEMSIZE[dtype_label] / 1e9!r} GB written; max_abs_err on 4000 "
        f"{'rows' if n >= m else 'columns'} {err!r}; against float64: kernel {kernel_f64!r}, "
        f"plain version {plain_f64!r}")
    return err, {"shape": f"{n}x{m}x{d}", "dtype": dtype_label, "ls": ls_source(ls),
                 "launches": launches, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                 "share": bound_ms / ms}


def counted_path(hk, label, fn):
    """``fn()`` with the kernels' launch counts set to 0 just before it and
    read just after; fails if the path launched the Matern-5/2 kernel no
    time (a path need not run the pivot step, whose count is logged and
    left in ``hk.pivot_step.launches``).  Returns (fn's result, Matern-5/2
    launches)."""
    import torch

    torch.cuda.synchronize()
    hk.matern52_gram.launches = 0
    hk.pivot_step.launches = 0
    result = fn()
    torch.cuda.synchronize()
    launches, pivot_launches = hk.matern52_gram.launches, hk.pivot_step.launches
    log(f"[{label}] kernel launches in this path: {launches}; pivot steps: {pivot_launches}")
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

    from mellon_tpu_torch.inference.laplace import laplace_std_from_diagonal

    est = mt.DensityEstimator(predictor_with_uncertainty=True, device=DEVICE)
    ld, fit_s = synced_seconds(lambda: est.fit_predict(x_np))
    corr, rmse = certificate(ld, ld_ref)
    std = est.pre_transformation_std
    _, laplace_s = synced_seconds(
        lambda: laplace_std_from_diagonal(est._hessian_diagonal(est.pre_transformation)))
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
    from mellon_tpu_torch.inference.laplace import laplace_std_from_diagonal

    est = mt.DensityEstimator(optimizer="nuts", predictor_with_uncertainty=True,
                              sampler_options=NUTS_OPTIONS, device=DEVICE)
    ld, fit_s = synced_seconds(lambda: est.fit_predict(x_np))
    res = est.mcmc_result
    chains, draws = res.samples.shape[:2]
    rhat = float(np.max(split_rhat(res.samples)))
    laplace = laplace_std_from_diagonal(est_map._hessian_diagonal(est_map.pre_transformation))
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
    value_and_grad, _ = mcmc.zero_centered_density_potential(z0, *args)
    hessian = lambda z: density_hessian(z, *args)  # noqa: E731
    (z_map, gn0, gn1), polish_s = synced_seconds(lambda: mcmc.newton_polish_value_and_grad(value_and_grad, hessian, z0))
    H, build_s = synced_seconds(lambda: hessian(z_map))
    _, factor_s = synced_seconds(lambda: mcmc.precondition_transform(mcmc.factor_hessian(H)))
    (res, _), seconds = synced_seconds(lambda: mcmc.sample_density_posterior(
        est_map, precondition="hessian", function_samples=False, **PRECOND))
    R = mcmc.factor_hessian(H)
    trace = trace_transitions(
        mcmc.precondition_value_and_grad(value_and_grad, mcmc.precondition_transform(R), z_map),
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


def inline_density_loss(z, L, nn_distances, d, mu, loss_offset_per_term=0.0):
    """The density loss written out in torch ops, as a user writes a scalar
    potential: the functional API evaluates it by torch.func."""
    import torch

    k = z.shape[0]
    const = d * math.log(math.pi) / 2 - math.lgamma(d / 2 + 1)
    V = torch.log(nn_distances) * d + const
    Vdr = math.log(d) + (d - 1) * torch.log(nn_distances) + const
    f = L @ z + mu
    prior = -0.5 * torch.sum(z * z) - (k / 2) * math.log(2 * math.pi)
    return -(prior + torch.sum(f + Vdr - torch.exp(f + V) + loss_offset_per_term))


def same_fields(a, b, fields):
    import torch

    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)


def functional_path(mt, est, x_np, ld):
    """The JAX form of the inference API (a scalar potential and its
    operands) on the main path's fit: run_mcmc(density_loss, ...) draws
    what the batched call draws, bit for bit, through the fused factory;
    the density loss written inline runs 16 chains through torch.func in
    the Hessian-whitened coordinates, held to the fused route (split-R-hat,
    the corr of the posterior means of f), with ms per leaf for both;
    compute_laplace_std against the closed-form diagonal; minimize_lbfgs,
    minimize_adam and run_advi against their value_and_grad forms; a short
    run_smc from laplace_start; est(x) and PredictorTime's Xnew=."""
    import numpy as np
    import torch

    from mellon_tpu_torch.inference import advi, laplace, losses, mcmc, optimizers, samplers, smc
    from mellon_tpu_torch.inference.diagnostics import split_rhat
    from mellon_tpu_torch.inference.losses import (
        density_hessian_diagonal,
        density_loss,
        make_density_loss_batch,
        make_density_value_and_grad,
        make_density_value_and_grad_batch,
    )

    def gen(seed):
        return torch.Generator(device=DEVICE).manual_seed(seed)

    def check(label, ok, stats):
        log(f"[functional] {label} " + json.dumps(stats))
        if not ok:
            raise AssertionError(f"[functional] {label} failed its bars: {stats}")

    args, z_map, z0 = est._loss_args, est.pre_transformation, est.initial_value
    L, mu = args[0], args[3]
    fields = ("samples", "potential", "accept_prob", "step_size", "inv_mass_diag", "num_leapfrog")

    # run_mcmc(density_loss, ..., potential_args) against the batched call
    fn, cargs = mcmc.zero_centered_potential(density_loss, z_map, args)
    built, fused = [], losses.make_density_value_and_grad_batch

    def spy(*a, **kw):
        built.append(len(a))
        return fused(*a, **kw)

    losses.make_density_value_and_grad_batch = spy
    try:
        functional, functional_s = synced_seconds(lambda: mcmc.run_mcmc(
            fn, z_map, gen(5), potential_args=cargs, **FUNCTIONAL_NUTS))
    finally:
        losses.make_density_value_and_grad_batch = fused
    batched = make_density_value_and_grad_batch(*cargs[:5], center=cargs[5])
    direct, direct_s = synced_seconds(lambda: mcmc.run_mcmc(batched, z_map, gen(5), **FUNCTIONAL_NUTS))
    check("fused route", built == [5] and same_fields(functional, direct, fields), {
        "settings": FUNCTIONAL_NUTS, "bit_identical": same_fields(functional, direct, fields),
        "fused_factory_calls": len(built), "seconds": [functional_s, direct_s]})

    # the two routes in the whitened coordinates of the same Newton-polished MAP
    (z_star, gn0, gn1), polish_s = synced_seconds(lambda: mcmc.newton_polish(fn, z_map, cargs))
    T = mcmc.precondition_transform(mcmc.hessian_cholesky(fn, z_star, 1e-6, *cargs))
    routes = {}
    for route, base, base_args in (("fused", density_loss, cargs),
                                   ("torch.func", inline_density_loss, cargs[:5])):
        pot = counted_calls(samplers.as_batched(mcmc.preconditioned_potential(base),
                                                (T, z_star) + base_args))
        res, seconds = synced_seconds(lambda: mcmc.run_mcmc(
            pot, torch.zeros_like(z_star), gen(6), **FUNCTIONAL_PRECOND))
        samples = mcmc.unwhiten_samples(res.samples, T, z_star)
        routes[route] = dict(
            f_mean=L @ samples.reshape(-1, samples.shape[-1]).mean(dim=0) + mu,
            stats={"seconds": seconds, "leaves": pot.calls, "ms_per_leaf": 1e3 * seconds / pot.calls,
                   "max_rhat": float(np.max(split_rhat(samples))), "step_size": float(res.step_size),
                   "leapfrogs_per_draw": float(res.num_leapfrog.double().mean()),
                   "finite": finite(samples)})
    corr = log_density_corr(routes["torch.func"]["f_mean"], routes["fused"]["f_mean"])
    stats = {"settings": FUNCTIONAL_PRECOND, "newton_grad_norm": [gn0, gn1], "polish_seconds": polish_s,
             "corr_of_posterior_mean_f": corr, **{r: v["stats"] for r, v in routes.items()}}
    check("routes", corr > FUNCTIONAL_MIN_CORR and all(v["stats"]["finite"] for v in routes.values())
          and routes["torch.func"]["stats"]["max_rhat"] <= FUNCTIONAL_MAX_RHAT, stats)

    # compute_laplace_std: the closed form by identity; torch.func's
    # Hessian-vector products of the inline loss (float64)
    closed = laplace.laplace_std_from_diagonal(density_hessian_diagonal(z_map, *args))
    by_identity = laplace.compute_laplace_std(density_loss, z_map, loss_args=args)
    args64 = (L.double(), args[1].double(), args[2], args[3])
    closed64 = laplace.laplace_std_from_diagonal(density_hessian_diagonal(z_map.double(), *args64))
    by_hvp, hvp_s = synced_seconds(lambda: laplace.compute_laplace_std(
        inline_density_loss, z_map.double(), loss_args=args64))
    gaps = [relative_gap(by_identity, closed), relative_gap(by_hvp, closed64)]
    check("laplace", max(gaps) <= FUNCTIONAL_LAPLACE_REL,
          {"rel_gap_fused_f32": gaps[0], "rel_gap_torch_func_f64": gaps[1], "hvp_seconds": hvp_s})

    # the optimizers and ADVI: the scalar form against the value_and_grad
    # form (the same numbers), and the inline loss by autograd or torch.func
    vg = make_density_value_and_grad(*args)
    runs = {
        "lbfgs": (lambda f: optimizers.minimize_lbfgs(f, z0, loss_args=args).pre_transformation,
                  lambda: optimizers.minimize_lbfgs_value_and_grad(vg, z0).pre_transformation),
        "adam": (lambda f: optimizers.minimize_adam(
                     f, z0, n_iter=FUNCTIONAL_ADAM_STEPS, loss_args=args).pre_transformation,
                 lambda: optimizers.minimize_adam_value_and_grad(
                     vg, z0, n_iter=FUNCTIONAL_ADAM_STEPS).pre_transformation),
        "advi": (lambda f: advi.run_advi(f, z0, seed=0, loss_args=args).pre_transformation,
                 lambda: advi.run_advi_batch(make_density_loss_batch(*args), z0,
                                             generator=gen(0)).pre_transformation),
    }
    stats, ok = {}, True
    for name, (scalar, value_and_grad) in runs.items():
        (got, want, inline), seconds = synced_seconds(
            lambda: (scalar(density_loss), value_and_grad(), scalar(inline_density_loss)))
        inline_corr = log_density_corr(L @ inline + mu, L @ want + mu)
        stats[name] = {"bit_identical": bool(torch.equal(got, want)), "inline_corr": inline_corr,
                       "seconds": seconds}
        ok = ok and torch.equal(got, want) and inline_corr > FUNCTIONAL_MIN_CORR
    check("optimizers", ok, stats)

    # a short SMC sweep from the JAX form's Laplace start
    loglik, prior = smc.laplace_start(density_loss, args, z0, z_map=z_map)
    res, seconds = synced_seconds(lambda: smc.run_smc(
        loglik, int(z_map.shape[0]), gen(7), num_particles=FUNCTIONAL_SMC_PARTICLES,
        loglik_args=args, **prior))
    corr = log_density_corr(L @ res.particles.mean(dim=0) + mu, est.log_density_x)
    check("smc", res.betas[-1] == 1.0 and math.isfinite(res.log_evidence) and finite(res.particles)
          and corr >= POSTERIOR_MIN_CORR,
          {"particles": FUNCTIONAL_SMC_PARTICLES, "stages": len(res.betas), "seconds": seconds,
           "log_evidence": res.log_evidence, "corr_with_map": corr})

    # est(x) is est.fit_predict(x); PredictorTime takes Xnew
    rng = np.random.RandomState(8)
    course = np.concatenate([rng.randn(FUNCTIONAL_TIME_CELLS, 2) + 0.5 * t for t in (0.0, 1.0, 2.0)])
    course = np.concatenate(
        [course, np.repeat([0.0, 1.0, 2.0], FUNCTIONAL_TIME_CELLS)[:, None]], axis=1).astype(np.float32)
    x_dim = x_np[:FUNCTIONAL_DIM_CELLS]
    made = {
        "density": (lambda: mt.DensityEstimator(device=DEVICE), x_np),
        "time": (lambda: mt.TimeSensitiveDensityEstimator(
            ls_time=1.5, predictor_with_uncertainty=True, device=DEVICE), course),
        "dimensionality": (lambda: mt.DimensionalityEstimator(
            n_landmarks=FUNCTIONAL_DIM_LANDMARKS, device=DEVICE), x_dim),
    }
    stats, ok, time_est = {}, True, None
    for name, (make, data) in made.items():
        called_est = make()
        called = called_est(data)
        fitted = ld if name == "density" else make().fit_predict(data)
        stats[name] = bool(torch.equal(called, fitted))
        ok = ok and stats[name] and finite(called)
        if name == "time":
            time_est = called_est
    xq = rng.randn(64, 2).astype(np.float32)
    mean = time_est.predict.mean(Xnew=xq, time=1.0)
    grid = time_est.predict.mean(Xnew=xq, multi_time=np.array([0.5, 1.5], dtype=np.float32))
    uncertainty = time_est.predict.covariance(Xnew=xq, time=1.0)
    xnew_ok = (torch.equal(mean, time_est.predict.mean(xq, 1.0)) and grid.shape == (64, 2)
               and finite(mean, grid, uncertainty))
    check("est(x) and Xnew", ok and xnew_ok, {"call_equals_fit_predict": stats, "xnew": xnew_ok})


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

    from mellon_tpu_torch.inference.optimizers import minimize_lbfgs_value_and_grad

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
        res, seconds = synced_seconds(lambda: minimize_lbfgs_value_and_grad(
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


def ivf_path(mt, est, exact_prepare_s):
    """[ivf] on the atlas cells of ``est`` (the float32 fit).  The default
    search, nn_distances(method="ivf"), timed in three synchronised parts
    (quantizer, assignment and table, search): finite and > 0, never below
    the fit's exact 1-NN distances (it searches a subset), the card's
    search equal to the CPU's on the same quantizer and table for
    IVF_CPU_ROWS rows, its share within IVF_REL of exact >=
    IVF_DEFAULT_MIN_EQUAL.  The same search at IVF_HELD_PROBES probes held
    to a share >= IVF_MIN_EQUAL.  A float32 fit on each's distances and
    ``est``'s landmarks against ``est``'s log density: the held one with
    the certificate's bars, the default one with corr >=
    IVF_DEFAULT_MIN_CORR and RMSE/spread <= CERT_MAX_RMSE.  The
    subscale recall over IVF_SUB_K columns; the column-streamed exact
    search against one strip.  Returns the stats."""
    import numpy as np
    import torch

    from mellon_tpu_torch.models.density import PREPARED_ATTRIBUTES
    from mellon_tpu_torch.ops import neighbors

    marks, helpers = {}, (neighbors._ivf_quantizer, neighbors._ivf_table)

    def marked(name, fn):
        def wrapped(*args):
            result = fn(*args)
            torch.cuda.synchronize()
            marks[name] = (time.perf_counter(), result)
            return result
        return wrapped

    neighbors._ivf_quantizer = marked("quantizer", helpers[0])
    neighbors._ivf_table = marked("table", helpers[1])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ivf = mt.ops.nn_distances(est.x, method="ivf")
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    finally:
        neighbors._ivf_quantizer, neighbors._ivf_table = helpers
    (t1, centroids), (t2, (table, cap, truncated)) = marks["quantizer"], marks["table"]
    exact = est.nn_distances
    probes = 8  # knn_ivf's default, which nn_distances(method="ivf") takes

    def share(got, want):
        return float(((got - want).abs() <= IVF_REL * want).double().mean())

    def sound(d):
        return bool(torch.isfinite(d).all() and (d > 0).all() and (d >= exact * (1 - IVF_REL)).all())

    # the card's search against the CPU's on the same quantizer and table
    # (the CPU's is held to the JAX package's by tests/test_torch_neighbors.py)
    x_cpu = est.x[:IVF_CPU_ROWS].cpu()
    x_padded = torch.cat([est.x.cpu(), x_cpu.new_full((1, x_cpu.shape[1]), float("inf"))])
    cpu = torch.cat([neighbors._ivf_search(x_cpu[s : s + 512], centroids.cpu(), table.cpu(),
                                           x_padded, 1, probes)[0][:, 1]
                     for s in range(0, IVF_CPU_ROWS, 512)])
    (held, _), held_s = synced_seconds(lambda: neighbors.knn_ivf(est.x, 1, n_probe=IVF_HELD_PROBES))
    held = held[:, 0]
    stats = {"cells": list(est.x.shape), "n_clusters": int(table.shape[0]), "cap": cap,
             "truncated": truncated,
             "default": {"n_probe": probes, "equal_share": share(ivf, exact), "sound": sound(ivf),
                         "seconds": {"quantizer": t1 - t0, "assign_table": t2 - t1,
                                     "search": t3 - t2, "total": t3 - t0},
                         "cpu_rows": IVF_CPU_ROWS,
                         "cpu_equal_share": share(ivf[:IVF_CPU_ROWS].cpu(), cpu)},
             "held": {"n_probe": IVF_HELD_PROBES, "equal_share": share(held, exact),
                      "sound": sound(held), "seconds": held_s}}

    for name, nn in (("default", ivf), ("held", held)):
        fit = mt.DensityEstimator(nn_distances=nn, landmarks=est.landmarks, device=DEVICE)
        stages = staged_fit(fit, est.x, PREPARED_ATTRIBUTES)
        corr, rmse = agreement(fit.log_density_x, est.log_density_x)
        prepare_s = sum(v for k, v in stages.items() if k in PREPARED_ATTRIBUTES)
        search_s = t3 - t0 if name == "default" else held_s
        stats[name]["fit"] = {"ls": fit.ls, "exact_ls": est.ls, "prepare_seconds": prepare_s,
                              "prepare_with_ivf_seconds": prepare_s + search_s,
                              "exact_prepare_seconds": exact_prepare_s,
                              "lbfgs_seconds": stages["lbfgs"], "corr": corr, "rmse": rmse,
                              "finite": finite(fit.log_density_x)}
        del fit

    sub = np.load(ATLAS_SUB)
    x_sub = torch.as_tensor(np.asarray(sub["x"], dtype=np.float32), device=DEVICE)
    sub_exact, exact_s = synced_seconds(lambda: mt.ops.knn_distances(x_sub, IVF_SUB_K))
    sub_ivf, ivf_s = synced_seconds(
        lambda: mt.ops.knn_distances(x_sub, IVF_SUB_K, method="ivf"))
    recall = share(sub_ivf, sub_exact)
    stats["subscale"] = {"cells": list(x_sub.shape), "k": IVF_SUB_K, "recall": recall,
                         "ivf_seconds": ivf_s, "exact_seconds": exact_s}

    query = est.x[:IVF_QUERY]
    (d1, i1), one_s = synced_seconds(lambda: mt.ops.knn(est.x, 3, query=query))
    (d2, i2), strips_s = synced_seconds(
        lambda: mt.ops.knn(est.x, 3, query=query, col_block=IVF_COL_BLOCK))
    streamed = bool(torch.equal(i1, i2) and torch.equal(d1, d2))
    stats["streamed"] = {"query": IVF_QUERY, "col_block": IVF_COL_BLOCK, "equal": streamed,
                         "one_strip_seconds": one_s, "strips_seconds": strips_s}
    log("[ivf] " + json.dumps(stats))
    log(f"[ivf] bars: at 8 probes (the default) and {IVF_HELD_PROBES} every distance finite, "
        f"> 0 and not below exact, the refits finite; at 8 the card's search equal to the "
        f"CPU's on >= {IVF_MIN_EQUAL} of {IVF_CPU_ROWS} rows, a share >= "
        f"{IVF_DEFAULT_MIN_EQUAL} within {IVF_REL} relative of exact and its refit corr >= "
        f"{IVF_DEFAULT_MIN_CORR}, RMSE/spread <= {CERT_MAX_RMSE}; at {IVF_HELD_PROBES} a share >= "
        f"{IVF_MIN_EQUAL} within {IVF_REL} relative of exact and its refit corr >= "
        f"{CERT_MIN_CORR}, RMSE/spread <= {CERT_MAX_RMSE}; subscale recall > {IVF_MIN_RECALL}; "
        f"streamed strips equal to one")
    default, held = stats["default"], stats["held"]
    ok = (default["sound"] and held["sound"] and default["fit"]["finite"]
          and default["cpu_equal_share"] >= IVF_MIN_EQUAL
          and default["equal_share"] >= IVF_DEFAULT_MIN_EQUAL
          and default["fit"]["corr"] >= IVF_DEFAULT_MIN_CORR
          and default["fit"]["rmse"] <= CERT_MAX_RMSE
          and held["equal_share"] >= IVF_MIN_EQUAL and held["fit"]["finite"]
          and held["fit"]["corr"] >= CERT_MIN_CORR and held["fit"]["rmse"] <= CERT_MAX_RMSE
          and recall > IVF_MIN_RECALL and streamed)
    if not ok:
        raise AssertionError(f"ivf failed its bars: {stats}")
    return stats


def tutorials_path():
    """[tutorials]: the four examples/*_tutorial_torch.py, each run to its
    end through runpy on the card; returns their seconds."""
    import runpy

    seconds = {}
    for name in TUTORIALS:
        path = os.path.join(ROOT, "examples", f"{name}_tutorial_torch.py")
        _, seconds[name] = synced_seconds(lambda p=path: runpy.run_path(p, run_name="__main__"))
        log(f"[tutorials] {name}: {seconds[name]!r} s")
    return seconds


def counted_calls(fn):
    """The batched potential ``fn`` as a ``BatchedPotential`` that counts
    its calls in ``.calls``: one per lockstep leaf."""
    from mellon_tpu_torch.inference.losses import BatchedPotential

    def counted(Z):
        potential.calls += 1
        return fn(Z)

    potential = BatchedPotential(counted)
    potential.calls = 0
    return potential


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
    value_and_grad, offset = mcmc.zero_centered_density_potential(z0, *args)
    hessian = lambda z: density_hessian(z, *args)  # noqa: E731
    (z_map, gn0, gn1), polish_s = synced_seconds(
        lambda: mcmc.newton_polish_value_and_grad(value_and_grad, hessian, z0))
    H, build_s = synced_seconds(lambda: hessian(z_map))
    T, factor_s = synced_seconds(lambda: mcmc.precondition_transform(mcmc.factor_hessian(H)))
    del H
    potential = counted_calls(mcmc.precondition_value_and_grad(value_and_grad, T, z_map))
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


def bf16_parity(est, Z):
    """The card's bf16 batched density value and gradient at the rows of
    Z against the same function in float64 on the card: the bfloat16 L
    and bf16(Z) upcast exactly, Lᵀ(1 − e) rounded to float32 and then to
    bfloat16 as the JAX package rounds it.

    Bars: at least BF16_EQUAL_SHARE of the gradient entries equal to that
    reference's bits, and every entry within one bfloat16 ulp of its
    likelihood part plus twice the float32 error of that part (and two
    float32 ulps of the entry, its subtraction from z): rounding two
    numbers |a − b| apart to bfloat16 leaves them at most |a − b| + one ulp
    apart.  The float32 error is the plain float32 formula's distance from
    float64 at that entry (L·bf16(z), e and Lᵀ(1 − e) in float32 torch
    ops): any float32 evaluation, the JAX package's too, is about that far
    from float64, by several ulps where Lᵀ(1 − e) cancels to a small
    number.  The value is held
    to the float32 bound u·((n + 3)·Σᵢ(|Fᵢ| + |Vdrᵢ| + eᵢ) + (k + 2)·Σᵢ|1 −
    eᵢ|·(Σⱼ|Lᵢⱼ zⱼ| + |μ|) + (k + 2)·|z|²), u = 2⁻²⁴: the rounding of the
    k-term products F, the n-term sum and the prior, for any summation
    order.  Returns the gaps over those bars, the largest gradient gap in
    ulps, the bit-equal share, the entries whose float32 error exceeds half
    an ulp, and, for the function
    without the roundings, its value gap and the share of its gradient
    entries outside the bar."""
    import math

    import torch

    from mellon_tpu_torch.inference.likelihoods import nearest_neighbors_terms
    from mellon_tpu_torch.inference.losses import make_density_value_and_grad_batch
    from mellon_tpu_torch.inference.optimizers import bf16_operands

    ops = bf16_operands(est._loss_args)
    L, nn, d, mu = ops
    values, grads = make_density_value_and_grad_batch(*ops)(Z)
    n, k = L.shape
    L64, Z64 = L.double(), Z.double()
    V, Vdr = (t[:, None] for t in nearest_neighbors_terms(nn, d))
    u = 2.0**-24

    def exponent(x):
        return torch.floor(torch.log2(x.abs().clamp_min(torch.finfo(torch.float32).tiny)))

    def reference(Zr):
        F = L64 @ Zr.T + mu
        E = torch.exp(F + V.double())
        value = (0.5 * (Z64 * Z64).sum(1) + 0.5 * k * math.log(2 * math.pi)
                 - (F + Vdr.double() - E).sum(0))
        bound = u * ((n + 3) * (F.abs() + Vdr.double().abs() + E).sum(0)
                     + (k + 2) * ((1 - E).abs() * (L64.abs() @ Zr.abs().T + abs(float(mu)))).sum(0)
                     + (k + 2) * (Z64 * Z64).sum(1))
        return value, (L64.T @ (1 - E)).T, bound

    rounded = Z.to(torch.bfloat16)
    value, exact, bound = reference(rounded.double())
    likelihood = exact.float().to(torch.bfloat16).double()
    grad = Z64 - likelihood
    Lf = L.float()
    plain = (Lf.T @ (1 - torch.exp(Lf @ rounded.float().T + mu + V))).T.double()
    f32_error = (plain - exact).abs()
    card = Z64 - grads.double()
    ulp = torch.exp2(exponent(torch.maximum(likelihood.abs(), card.abs())) - 7)
    grad_tol = ulp + 2 * f32_error + 2 * torch.exp2(exponent(grad) - 23)
    plain_value, plain_likelihood, _ = reference(Z64)
    return {
        "value_gap_over_bound": float(((values.double() - value).abs() / bound).max()),
        "value_bound": [float(b) for b in bound],
        "grad_gap_over_tolerance": float(((grads.double() - grad).abs() / grad_tol).max()),
        "grad_gap_over_ulp": float(((grads.double() - grad).abs() / ulp).max()),
        "grad_bit_equal_share": float((grads == grad.float()).double().mean()),
        "entries_with_f32_error_over_half_ulp": int((2 * f32_error > ulp).sum()),
        "unrounded_value_gap_over_bound": float(((plain_value - value).abs() / bound).max()),
        "unrounded_grad_outside_share": float(
            ((((Z64 - plain_likelihood) - grad).abs() / grad_tol) > 1).double().mean()),
    }


def bf16_sampler(est, precision):
    """sample_density_posterior(precondition="hessian") at BF16_SAMPLING
    in ``precision`` (None: float32) without function samples: the result,
    its ESS and its figures, ms per leaf from BF16_LEAF_TRANSITIONS
    transitions resumed from the last draws on the whitened potential."""
    import torch

    from mellon_tpu_torch.inference import mcmc
    from mellon_tpu_torch.inference.diagnostics import effective_sample_size
    from mellon_tpu_torch.inference.losses import density_hessian
    from mellon_tpu_torch.inference.optimizers import bf16_operands

    (res, _), seconds = synced_seconds(lambda: mcmc.sample_density_posterior(
        est, precision=precision, precondition="hessian", function_samples=False,
        seed=BF16_SEED, **BF16_SAMPLING))
    ops = bf16_operands(est._loss_args) if precision == "bf16" else est._loss_args
    z0 = est.pre_transformation
    value_and_grad, _ = mcmc.zero_centered_density_potential(z0, *ops)
    hessian = lambda z: density_hessian(z, *ops)  # noqa: E731
    z_map, _, _ = mcmc.newton_polish_value_and_grad(value_and_grad, hessian, z0)
    R = mcmc.factor_hessian(hessian(z_map))
    potential = counted_calls(mcmc.precondition_value_and_grad(
        value_and_grad, mcmc.precondition_transform(R), z_map))
    gen = torch.Generator(device=DEVICE).manual_seed(BF16_SEED)
    cap = BF16_SAMPLING["max_tree_depth"]
    _, leaf_s = synced_seconds(lambda: mcmc.resume_mcmc(
        potential, (res.samples[:, -1] - z_map) @ R, gen, res.step_size, res.inv_mass_diag,
        num_samples=BF16_LEAF_TRANSITIONS, max_tree_depth=cap))
    ess = effective_sample_size(res.samples)
    stats = {
        "seconds": seconds, "ms_per_leaf": 1e3 * leaf_s / potential.calls,
        "step_size": float(res.step_size), "mean_accept": float(res.accept_prob.mean()),
        "divergences": int(res.diverging.sum()),
        "leapfrogs_per_draw": float(res.num_leapfrog.double().mean()),
        # a tree that began its cap's doubling took at least 2**(cap - 1) leapfrogs
        "share_of_trees_at_cap": float((res.num_leapfrog >= 2 ** (cap - 1)).double().mean()),
        "ess_min": float(ess.min()),
    }
    return res, ess, stats


def bf16_atlas(est):
    """The samplers' zero-centred potential of the atlas estimator at
    BF16_ATLAS_CHAINS rows near its MAP, in float32 and in bf16: device
    ms per call over BF16_ATLAS_CALLS calls (median of 3 runs) beside the
    bytes bound of reading L twice."""
    import torch

    from mellon_tpu_torch.inference import mcmc
    from mellon_tpu_torch.inference.optimizers import bf16_operands

    z0 = est.pre_transformation
    g = torch.Generator(device=DEVICE).manual_seed(BF16_SEED)
    Z = z0 + BF16_PERTURB * torch.randn(BF16_ATLAS_CHAINS, z0.shape[0], device=DEVICE,
                                        dtype=z0.dtype, generator=g)
    out = {}
    for label, ops in (("float32", est._loss_args), ("bf16", bf16_operands(est._loss_args))):
        value_and_grad, _ = mcmc.zero_centered_density_potential(z0, *ops)
        values, grads = value_and_grad(Z)
        ms = device_ms(lambda: value_and_grad(Z), launches=BF16_ATLAS_CALLS, runs=3)
        L = ops[0]
        bound = 1e3 * 2 * L.numel() * L.element_size() / MEMORY_BYTES_PER_S
        out[label] = {"L": [list(L.shape), str(L.dtype)], "ms_per_call": ms,
                      "bytes_bound_ms": bound, "share": bound / ms,
                      "finite": finite(values, grads)}
        del ops, L, value_and_grad
    return out


def bf16_path(mt, est, est_atlas, x_new, smi):
    """[bf16 sampling]: precision="bf16" on the main path's fit, its
    function parity, both samplers and the draws' predictor at the 1,000
    points; then the atlas potential's times (bf16_atlas)."""
    import numpy as np
    import torch

    z0 = est.pre_transformation
    g = torch.Generator(device=DEVICE).manual_seed(BF16_SEED)
    Z = torch.cat([z0[None], z0 + BF16_PERTURB * torch.randn(
        BF16_POINTS - 1, z0.shape[0], device=DEVICE, dtype=z0.dtype, generator=g)])
    parity = bf16_parity(est, Z)
    log(f"[bf16 sampling] function parity at {list(est.L.shape)}, {BF16_POINTS} points: "
        + json.dumps(parity))
    counter = MessageCount(BF16_WARNING)
    logger = logging.getLogger("mellon_tpu_torch")
    logger.addHandler(counter)
    try:
        res16, ess16, stats16 = bf16_sampler(est, "bf16")
    finally:
        logger.removeHandler(counter)
    res32, ess32, stats32 = bf16_sampler(est, None)
    k = res16.samples.shape[-1]
    flat16, flat32 = (r.samples.reshape(-1, k) for r in (res16, res32))
    s16, s32 = (f.std(dim=0, correction=0).double().cpu().numpy() for f in (flat16, flat32))
    se = np.sqrt(s16**2 / (2 * (ess16 - 1)) + s32**2 / (2 * (ess32 - 1)))
    ratio = s16 / s32
    corr = log_density_corr(est.transform(flat16.mean(dim=0)), est.transform(flat32.mean(dim=0)))
    pred = posterior_predictor(est, flat16)
    at_new, u = pred(x_new), pred.uncertainty(x_new)
    stats = {
        "settings": BF16_SAMPLING, "seed": BF16_SEED, "bf16": stats16, "float32": stats32,
        "std_outside_mc_error_share": float(np.mean(np.abs(s16 - s32) / se > BF16_MC_Z)),
        "std_ratio_bf16_over_f32": [float(ratio.min()), float(np.median(ratio)),
                                    float(ratio.max())],
        "function_mean_corr": corr, "warnings_logged": counter.counts[BF16_WARNING],
    }
    log(f"[bf16 sampling] card {smi}; samplers " + json.dumps(stats))
    log(f"[bf16 sampling] trees capped at depth {BF16_SAMPLING['max_tree_depth']}: the JAX "
        f"package's bf16 trees ran to their cap; no posterior bar, since the JAX package's own "
        f"bf16 agreement check failed (benchdata/logs_r5/bf16_agreement_direct_r5.log)")
    atlas = bf16_atlas(est_atlas)
    log(f"[bf16 sampling] card {smi}; atlas potential, {BF16_ATLAS_CHAINS} chains: "
        + json.dumps(atlas))
    log(f"[bf16 sampling] bars: >= {BF16_EQUAL_SHARE} of the gradient entries bit-equal to the "
        "float64 reference's rounding, each within one bfloat16 ulp of the likelihood part plus "
        "twice the float32 formula's own error there, the value within its float32 bound; "
        "finite draws; the warning logged; the bf16 draws' predictor at the 1,000 points "
        "finite; the atlas potentials finite")
    ok = (parity["grad_gap_over_tolerance"] <= 1 and parity["value_gap_over_bound"] <= 1
          and parity["grad_bit_equal_share"] >= BF16_EQUAL_SHARE
          and finite(res16.samples, res32.samples, at_new, u) and counter.counts[BF16_WARNING] >= 1
          and all(a["finite"] for a in atlas.values()))
    if not ok:
        raise AssertionError(f"bf16 sampling failed its bars: {parity} {stats} {atlas}")
    return {"parity": parity, "samplers": stats, "atlas": atlas}


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


FUSED_FIELDS = {
    "density": ("nn_distances", "d", "mu", "ls", "landmarks", "n_landmarks", "Lp", "L",
                "initial_value"),
    "nystroem": ("nn_distances", "d", "mu", "ls", "landmarks", "n_landmarks", "L",
                 "initial_value"),
    "function": ("nn_distances", "ls", "landmarks"),
    "dimensionality": ("distances", "nn_distances", "d", "mu_dens", "ls", "landmarks",
                       "n_landmarks", "Lp", "L", "initial_value"),
    "time": ("nn_distances", "d", "mu", "ls", "landmarks", "n_landmarks", "Lp", "L",
             "initial_value"),
}


def same_bits(a, b):
    """Two attributes equal bit for bit (tensors: dtype, shape, bits)."""
    import torch

    if not isinstance(a, torch.Tensor):
        return a == b
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}.get(a.dtype)
    return bool(torch.equal(a.view(bits), b.view(bits)) if bits else torch.equal(a, b))


def fused_prepare(fused, make, args, enabled, count_syncs=False):
    """One prepare_inference of ``make()`` on ``args`` with the fused
    prepare on or off: (the estimator, synced seconds, and with
    ``count_syncs`` the synchronizing CUDA calls that
    torch.cuda.set_sync_debug_mode flagged in it, in all and up to and
    including the fused prepare's one host read)."""
    import warnings

    import torch

    old = fused.ENABLED
    fused.ENABLED = enabled
    read, marks = fused._read_host, []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if count_syncs:
                fused._read_host = lambda packed: marks.append(len(caught)) or read(packed)
                torch.cuda.set_sync_debug_mode("warn")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est = make()
            est.prepare_inference(*args)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            torch.cuda.set_sync_debug_mode(0)
        syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
        fused.ENABLED, fused._read_host = old, read
    if not count_syncs:
        return est, seconds
    return est, seconds, {"all": len(syncs), "to_the_read": marks[0] + 1 if marks else None}


def stage_seconds(fused, make, args, eager):
    """The fused prepare's stages in one prepare, read from the program's
    ``prepare.stage1`` and ``prepare.stage2`` spans: device seconds between
    the spans' CUDA events where the card timed them (host seconds on the
    CPU), of the replayed graphs or (``eager``) of the stage functions run
    eagerly, a graph memory share of 0 capturing nothing.  An eager run
    drops the slots' graphs; they are put back after it, so that later
    prepares replay them.  Returns {span: seconds}."""
    from mellon_tpu_torch.utils import profiling

    share, graphs = fused.GRAPH_MEMORY_SHARE, dict(fused._GRAPHS)
    if eager:
        fused.GRAPH_MEMORY_SHARE = 0
    profiling.start()
    try:
        fused_prepare(fused, make, args, True)
    finally:
        profiling.stop()
        fused.GRAPH_MEMORY_SHARE = share
        if eager:
            fused._GRAPHS.update(graphs)
    rows = {}
    for s in profiling.take()["spans"]:
        if s["name"] in ("prepare.stage1", "prepare.stage2"):
            seconds = s["host_s"] if s["device_s"] is None else s["device_s"]
            rows[s["name"]] = rows.get(s["name"], 0.0) + seconds
    return rows


def graph_pool_bytes(fused):
    """The bytes the caching allocator holds in each cached stage graph's
    private memory pool: {slot: bytes}."""
    import torch

    by_pool = {}
    if not fused._GRAPHS:
        return {}
    for segment in torch.cuda.memory_snapshot():
        pool = tuple(segment.get("segment_pool_id", ()))
        by_pool[pool] = by_pool.get(pool, 0) + segment["total_size"]
    return {slot: by_pool.get(tuple(g.graph.pool()), 0) for slot, g in fused._GRAPHS.items()}


def fused_path(mt, x_np, Y):
    """[fused]: each family's default prepare through the fused prepare's
    CUDA graphs: the density at the bench shape, the function estimator on
    its 2,000 gene trends, the dimensionality model on the bench cells, the
    time model on the 98,192-cell course (ls_time=TIME_LS) and the sparse
    Nyström BASELINE row.  For each: the lazy prepare (ENABLED off), the
    first fused prepare (eager run, capture, one replay held to the eager
    run), then a replayed one, which must equal the lazy prepare bit for
    bit, with its synchronizing calls counted; the graphs' nodes and
    capture seconds, pool bytes; after the density's, its stage seconds,
    replayed and eager (phase 10 times the warm fits with the fused
    prepare on and off).  The Nyström type goes first: it shares the
    density's stage-1 slot, and the later paths replay the density's
    graphs."""
    import numpy as np

    from mellon_tpu_torch.models import fused

    x_time, times, _ = load_time_course()
    x_ny = np.asarray(np.load(NYSTROEM_DATA)["x"], dtype=np.float32)
    families = {
        "nystroem": (lambda: mt.DensityEstimator(device=DEVICE, **NYSTROEM), (x_ny,)),
        "density": (lambda: mt.DensityEstimator(device=DEVICE), (x_np,)),
        "function": (lambda: mt.FunctionEstimator(sigma=FUNCTION_SIGMA, device=DEVICE), (x_np,)),
        "dimensionality": (lambda: mt.DimensionalityEstimator(device=DEVICE), (x_np,)),
        "time": (lambda: mt.TimeSensitiveDensityEstimator(ls_time=TIME_LS, device=DEVICE),
                 (x_time, times)),
    }
    stats, failed = {}, []
    for family, (make, args) in families.items():
        lazy, lazy_s = fused_prepare(fused, make, args, False)
        first, first_s = fused_prepare(fused, make, args, True)
        replayed, replay_s, syncs = fused_prepare(fused, make, args, True, count_syncs=True)
        differ = [name for name in FUSED_FIELDS[family]
                  if not (same_bits(getattr(first, name), getattr(lazy, name))
                          and same_bits(getattr(replayed, name), getattr(lazy, name)))]
        if repr(replayed.cov_func) != repr(lazy.cov_func):
            differ.append("cov_func")
        failed += [f"{family}.{name}" for name in differ]
        # the Nyström type replays the density's stage 1 and no stage 2
        graphs = [g for g in fused.graph_stats() if (
            g["slot"] == "density" if family == "nystroem" else g["slot"].split()[0] == family)]
        pools = graph_pool_bytes(fused)
        for g in graphs:
            g["pool_bytes"] = pools.get(g["slot"])
        stats[family] = {
            "lazy_s": lazy_s, "first_s": first_s, "replayed_s": replay_s,
            "landmarks_kept": int(replayed.landmarks.shape[0]), "syncs": syncs,
            "graphs": graphs, "bit_identical": not differ,
        }
        log(f"[fused] {family}: " + json.dumps(stats[family]))
        del lazy, first, replayed
        if family == "density":
            stats["density_stage_s"] = {"replayed": stage_seconds(fused, make, args, eager=False),
                                        "eager": stage_seconds(fused, make, args, eager=True)}
            log("[fused] density stage seconds: " + json.dumps(stats["density_stage_s"]))
    if failed:
        raise AssertionError(f"[fused] replayed prepares differ from the lazy ones: {failed}")
    return stats


PIVOT_RUNS = 3
PIVOT_LANDMARKS = 5000
# the kernel against the plain step (tests/test_torch_cuda.py holds the same):
# the factor on the kept pivots within PIVOT_FACTOR_TOL of float64's Cholesky
# (or 1.25 times the plain step's gap), pivot_gap within 2e-6 (or twice the
# plain step's), the same kept count; in float32 PIVOT_SHARED_F32 of the
# kept landmarks shared, in float64 the same pivots
PIVOT_FACTOR_TOL = {"float32": 1e-5, "float64": 1e-12}
PIVOT_SHARED_F32 = 0.95
# H100's L2 (NVIDIA's data sheet)
L2_BYTES = 50 * 2**20


def kept_factor(K, state, r):
    """(the kept pivots, the largest gap between the run's factor on them
    and the float64 Cholesky of K on them, their order's departure from the
    greedy rule in float64: the benchmark's ``pivot_gap``) of a pivoted
    selection's ``state`` that counted r steps, its count rounded down to
    RANK_BUCKETS."""
    import torch

    from mellon_tpu_torch.ops import linalg

    kept = state.piv[:max(b for b in linalg.RANK_BUCKETS if b <= r)]
    K64 = K.double()[kept][:, kept]
    R = torch.linalg.cholesky(K64)
    error = float((state.L[kept, :len(kept)].double() - R).abs().max())
    sq = R * R
    residual = torch.diagonal(K64)[:, None] - (torch.cumsum(sq, dim=1) - sq)
    later = torch.ones_like(K64, dtype=torch.bool).tril(-1)
    excess = torch.where(later, residual - torch.diagonal(residual)[None, :], -torch.inf)
    return kept, error, max(float(excess.max()), 0.0) / float(torch.diagonal(K64).max())


def compare_pivot_selections(K):
    """The selection of ``select_stable_landmarks`` (before its round-down)
    on the CUDA gram K through the step kernel and through the plain step,
    held to the criteria above (raises AssertionError where one fails).
    Returns the numbers, and where the pivots part the first step at which
    they do and the two candidates' residual variances there (float64,
    from the plain run's columns before it)."""
    import torch

    from mellon_tpu_torch.ops import linalg

    dtype = str(K.dtype).removeprefix("torch.")
    state, r = linalg._pivot_selection(K, linalg.PIVOT_REL_TOL)
    plain, r_plain = linalg._pivot_selection(K, linalg.PIVOT_REL_TOL, plain=True)
    kept, error, gap = kept_factor(K, state, r)
    kept_plain, error_plain, gap_plain = kept_factor(K, plain, r_plain)
    shared = len(set(kept.tolist()) & set(kept_plain.tolist()))
    same = r == r_plain and torch.equal(state.piv[:r], plain.piv[:r])
    stats = {"dtype": dtype, "m": K.shape[0], "r": r, "r_plain": r_plain, "kept": len(kept),
             "kept_plain": len(kept_plain), "shared": shared, "same_pivots": same,
             "factor_gap": error, "factor_gap_plain": error_plain,
             "pivot_gap": gap, "pivot_gap_plain": gap_plain}
    width = min(state.piv.shape[0], plain.piv.shape[0])
    parted = (state.piv[:width] != plain.piv[:width]).nonzero()
    if len(parted):
        i = int(parted[0])
        L64 = plain.L[:, :i].double()
        stats["parted_at"] = i
        stats["residuals"] = {
            name: float(K[c, c].double() - (L64[c] ** 2).sum())
            for name, c in (("kernel", int(state.piv[i])), ("plain", int(plain.piv[i])))}
    failed = []
    if error > max(PIVOT_FACTOR_TOL[dtype], 1.25 * error_plain):
        failed.append("factor_gap")
    if gap > max(2e-6, 2 * gap_plain):
        failed.append("pivot_gap")
    if len(kept) != len(kept_plain):
        failed.append("kept")
    if dtype == "float64" and not same:
        failed.append("same_pivots")
    if dtype == "float32" and shared < PIVOT_SHARED_F32 * len(kept):
        failed.append("shared")
    if failed:
        raise AssertionError(f"the pivot step kernel fails {failed}: {json.dumps(stats)}")
    return stats


def pivots_path(mt, x_np, est):
    """[pivots]: the pivoted landmark selection on the tutorial's landmark
    gram, step kernel against plain step (see phase 32)."""
    import torch

    from mellon_tpu_torch.ops import hopper_kernels, linalg
    from mellon_tpu_torch.parameters import compute_landmarks

    xu = compute_landmarks(torch.as_tensor(x_np, device=DEVICE), n_landmarks=PIVOT_LANDMARKS)
    grams = {dtype: est.cov_func(xu.to(dtype), xu.to(dtype))
             for dtype in (torch.float32, torch.float64)}
    checks = [compare_pivot_selections(K) for K in grams.values()]
    for check in checks:
        log("[pivots] " + json.dumps(check))
    K = grams[torch.float32]
    m = K.shape[0]
    select = lambda: linalg._pivot_selection(K, linalg.PIVOT_REL_TOL)  # noqa: E731
    launches = hopper_kernels.pivot_step.launches
    kernel_s, plain_s = [], []
    for _ in range(PIVOT_RUNS):
        (_, r), seconds = synced_seconds(select)
        kernel_s.append(seconds)
        _, seconds = synced_seconds(
            lambda: linalg._pivot_selection(K, linalg.PIVOT_REL_TOL, plain=True))
        plain_s.append(seconds)
    chunks = -(-min(m, (r // linalg.PIVOT_CHUNK + 1) * linalg.PIVOT_CHUNK) // linalg.PIVOT_CHUNK)
    steps = min(m, chunks * linalg.PIVOT_CHUNK)
    launched = hopper_kernels.pivot_step.launches - launches
    if launched != PIVOT_RUNS * chunks * linalg.PIVOT_CHUNK:
        raise AssertionError(f"[pivots] {launched} kernel launches for {PIVOT_RUNS} selections "
                             f"of {chunks} chunks")
    # the bytes bound: L[:, :j] read once a step at HBM's rate; the steps
    # whose L[:, :j] fits in L2 may read it faster, so the bound is high and
    # the share with it (l2_bytes_share: those steps' part of the bytes)
    step_bytes = [m * j * K.element_size() for j in range(steps)]
    bound_ms = 1e3 * sum(step_bytes) / MEMORY_BYTES_PER_S
    kernel_ms = 1e3 * statistics.median(kernel_s)
    stats = {"m": m, "r": r, "steps": steps, "chunks": chunks,
             "kernel_ms": kernel_ms, "kernel_runs_ms": [1e3 * t for t in kernel_s],
             "plain_ms": 1e3 * statistics.median(plain_s),
             "bound_ms": bound_ms, "bound_by": "bytes at HBM's rate",
             "share": bound_ms / kernel_ms,
             "l2_bytes_share": sum(b for b in step_bytes if b <= L2_BYTES) / sum(step_bytes),
             "kernel_us_per_step": 1e3 * kernel_ms / steps}
    log("[pivots] " + json.dumps(stats))
    return {"timing": stats, "checks": checks}


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
    hk.pivot_step.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = mt.DensityEstimator(device=DEVICE)
    ld = est.fit_predict(x_np)
    torch.cuda.synchronize()
    first_fit_s = time.perf_counter() - t0
    fit_launches = hk.matern52_gram.launches
    fit_pivot_launches = hk.pivot_step.launches
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
    if len(calls) != launches or host_calls(calls):
        raise AssertionError(f"{len(calls)} kernel calls were made, {len(host_calls(calls))} "
                             f"of them on the host, but {launches} launched")
    from mellon_tpu_torch.models.fused import FUSED_PIVOT_CAP

    # stage 1's steps, then the selection's continued from them
    if fit_pivot_launches <= FUSED_PIVOT_CAP:
        raise AssertionError(f"the main fit launched the pivot step kernel {fit_pivot_launches} "
                             f"times, not past stage 1's {FUSED_PIVOT_CAP}")
    n_kept = int(est.landmarks.shape[0])
    corr, rmse = certificate(ld, ld_ref)
    log(f"[fit] first fit {first_fit_s:.3f} s; kernel launches in the fit: {fit_launches}; "
        f"pivot steps: {fit_pivot_launches}")
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
    pivot_launches = {"main": hk.pivot_step.launches}

    default = {"landmarks_kept": n_kept, "certificate": {"corr": corr, "rmse": rmse}}

    def run(label, fn):
        (result, path_launches[label]), seconds = synced_seconds(lambda: counted_path(hk, label, fn))
        pivot_launches[label] = hk.pivot_step.launches
        log(f"[{label}] path seconds {seconds!r}")
        return result

    # 30. the fused prepare's graphs, family by family, against the lazy
    # prepare, and the warm fits with and without them
    Y = gene_trends(x_np, FUNCTION_OUTPUTS)
    run("fused", lambda: fused_path(mt, x_np, Y))
    # 32. the pivoted landmark selection, step kernel against plain step
    pivots = run("pivots", lambda: pivots_path(mt, x_np, est))["timing"]
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
    run("functional", lambda: functional_path(mt, est, x_np, ld))
    # 14-17. the FunctionEstimator, the DimensionalityEstimator and the
    # full GP type
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
    run("ivf", lambda: ivf_path(mt, atlas[2], atlas[0]["prepare_seconds"]))
    torch.cuda.empty_cache()
    run("atlas nuts", lambda: atlas_nuts_path(mt, atlas[2], smi))
    torch.cuda.empty_cache()
    run("bf16 sampling", lambda: bf16_path(mt, est, atlas[2], x_new, smi))
    atlas = atlas[:2]
    torch.cuda.empty_cache()
    run("dimensionality nuts", lambda: dimensionality_nuts_path(mt, x_np, dim[1]))
    run("checkpoint", lambda: checkpoint_path(mt, nuts[1], x_new))
    run("tutorials", tutorials_path)
    stop_recording()
    launches = sum(path_launches.values())
    if len(calls) != launches or host_calls(calls):
        raise AssertionError(f"{len(calls)} kernel calls were made, {len(host_calls(calls))} "
                             f"of them on the host, but {launches} launched")
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
    log(f"[paths] pivot step launches: {json.dumps(pivot_launches)}")

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

    # 10. timing: warm fits with the fused prepare on and off, in turns
    from mellon_tpu_torch.models import fused

    # every fit's log density equals the others bit for bit: the fused
    # prepare's optimistic factor (in fit) is the lazy chain's
    fit_times, fit_outs = {True: [], False: []}, []
    for enabled in (True, False) * 3:
        fused.ENABLED = enabled
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = mt.DensityEstimator(device=DEVICE).fit_predict(x_np)
            torch.cuda.synchronize()
        finally:
            fused.ENABLED = True
        fit_times[enabled].append(time.perf_counter() - t0)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("a warm fit's log density is not finite")
        fit_outs.append(out)
    differ = [i for i, out in enumerate(fit_outs) if not same_bits(out, fit_outs[1])]
    log(f"[fit] warm fits' log densities, fused prepare on and off in turns, bit for bit "
        f"equal: {not differ}")
    if differ:
        raise AssertionError(f"warm fits {differ} differ from the first fit with the fused "
                             "prepare off")
    log(f"[fit] warm fit seconds {fit_times[True]!r}; median {statistics.median(fit_times[True])!r}")
    log(f"[fit] warm fit seconds with the fused prepare off {fit_times[False]!r}; "
        f"median {statistics.median(fit_times[False])!r}")
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
    }, {
        "name": "pivot_step",
        "route": "cuda",
        "source": "mellon_tpu_torch/csrc/pivot_step.cu",
        "replaces": None,
        "launches": sum(pivot_launches.values()),
        "ms": pivots["kernel_ms"],
        "plain_ms": pivots["plain_ms"],
        "bound_ms": pivots["bound_ms"],
        "bound_by": pivots["bound_by"],
        "library_ms": None,
        "share": pivots["share"],
        "l2_bytes_share": pivots["l2_bytes_share"],
        "shape": f"{pivots['m']}x{pivots['m']} float32, {pivots['steps']} steps",
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
