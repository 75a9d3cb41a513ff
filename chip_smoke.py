#!/usr/bin/env python3
"""Drive mellon_tpu_torch's density main path once on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each printed as it runs (any failure raises and exits non-zero):

1. device: the card's name and power limit (from nvidia-smi);
2. build: nvcc builds the Matern-5/2 kernel from csrc/ into build/;
3. fit: DensityEstimator().fit_predict on the 8,627 x 20 benchmark cells,
   certified against the host-float64 full-landmark fit stored in
   benchdata/ld_ref_8627x20_f64.npz (corr >= 0.999, RMSE <= 0.01 of the
   spread), then .predict at the training points (equal to f = Lz + mu
   within 1e-3 of the spread) and at 1,000 perturbed points (finite).
   The kernel's launches are counted over this run, and the operands of
   each launch are kept;
4. kernel: the CUDA tile against its plain PyTorch version on the card, on
   the operands the main path gave it (K_uu, C, the two predictor calls)
   and at two synthetic shapes (ragged 1000x333x7; more than 65535 row
   tiles), in float32 (max abs error <= 1e-5) and float64 (<= 1e-12), with
   the median time of 20 launches of each at every main-path shape;
5. timing: the warm fit time (median of 3) and a per-stage breakdown.

The line before the last is the JSON kernel report (``ms``/``plain_ms``:
the kernel's and the plain version's time summed over the main path's
launches); the last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script exits with status 2 and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "benchdata", "ld_ref_8627x20_f64.npz")
# edge cases the main path does not reach: ragged tiles and a feature
# count below one staged chunk; more row tiles than grid.y could hold
SYNTHETIC_SHAPES = ((1000, 333, 7), (65535 * 64 + 5, 3, 2))
TOLERANCE = {"float32": 1e-5, "float64": 1e-12}
CERT_MIN_CORR = 0.999
CERT_MAX_RMSE = 0.01
N_TIMED = 20
DEVICE = "cuda"


def log(*parts):
    print(*parts, flush=True)


def cuda_median_ms(fn, repeats=N_TIMED):
    """Median time of ``fn()`` on the card over ``repeats`` runs after one
    warm-up, each bracketed by CUDA events."""
    import torch

    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def record_operands():
    """Keep the operands of every kernel call the covariance module makes
    until the returned ``stop()`` is called; returns ``(calls, stop)``."""
    from mellon_tpu_torch.ops import kernels

    launch = kernels.matern52_gram
    calls = []

    def recording(x, y, ls):
        calls.append((x, y, float(ls)))
        return launch(x, y, ls)

    def stop():
        kernels.matern52_gram = launch

    kernels.matern52_gram = recording
    return calls, stop


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
        err = (K - matern52_gram_reference(xa, ya, ls)).abs().max().item()
        name = str(dtype).replace("torch.", "")
        ok = err <= TOLERANCE[name]
        log(f"[kernel] {label} {n}x{m}x{d} {name}: max_abs_err={err!r} (tol {TOLERANCE[name]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"matern52 kernel disagrees at {n}x{m}x{d} {name}: {err}")
        if dtype == torch.float32:
            err32 = err
    return err32


def kernel_phase(calls):
    """Kernel against plain version on every main-path call's operands and
    at the synthetic shapes; returns (max float32 error over the main path,
    kernel ms, plain ms), the times summed over the main path's calls."""
    import torch

    from mellon_tpu_torch.ops.hopper_kernels import matern52_gram, matern52_gram_reference

    worst, total_ms, total_plain_ms, timed = 0.0, 0.0, 0.0, {}
    for x, y, ls in calls:
        shape = (x.shape[0], y.shape[0], x.shape[1])
        if shape not in timed:
            worst = max(worst, check_kernel(x, y, ls, "main path"))
            ms = cuda_median_ms(lambda: matern52_gram(x, y, ls))
            plain_ms = cuda_median_ms(lambda: matern52_gram_reference(x, y, ls))
            timed[shape] = (ms, plain_ms)
            log(f"[kernel] {'x'.join(map(str, shape))} float32: kernel {ms!r} ms, "
                f"plain {plain_ms!r} ms (median of {N_TIMED})")
        total_ms += timed[shape][0]
        total_plain_ms += timed[shape][1]
    g = torch.Generator(device=DEVICE).manual_seed(0)
    for n, m, d in SYNTHETIC_SHAPES:
        x = torch.randn(n, d, device=DEVICE, dtype=torch.float64, generator=g)
        y = torch.randn(m, d, device=DEVICE, dtype=torch.float64, generator=g)
        check_kernel(x, y, 2.5, "synthetic")
    return worst, total_ms, total_plain_ms


def staged_fit(mt, x):
    """One more fit with the card synchronized between the main path's
    stages: seconds per stage."""
    import torch

    from mellon_tpu_torch.models.density import PREPARED_ATTRIBUTES, SIZE_ATTRIBUTES

    est = mt.DensityEstimator(device=DEVICE)
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
    for attr in PREPARED_ATTRIBUTES:
        timed(attr, lambda a=attr: est._prepare_attribute(a))
    timed("lbfgs", est.run_inference)
    timed("log_density_x", lambda: est.process_inference(build_predict=False))
    timed("predictor", lambda: est.predict)
    return stages


def main():
    import torch

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
    lib = hk.build_library()
    log(f"[build] {os.path.relpath(lib, ROOT)} in {time.perf_counter() - t0:.3f} s")

    # 3. the main path: fit, then the lazily built predictor, with the
    # kernel's launches counted and their operands kept
    ref = np.load(DATA)
    x_np = np.asarray(ref["x"], dtype=np.float32)
    x = torch.as_tensor(x_np, device=DEVICE)
    x_new = x[:1000] + 0.01 * x.std(dim=0) * torch.randn(
        1000, x.shape[1], device=DEVICE, generator=torch.Generator(device=DEVICE).manual_seed(1)
    )
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
    stop_recording()

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
    ld_np = ld.double().cpu().numpy()
    ld_ref = np.asarray(ref["log_density"], dtype=np.float64)
    corr = float(np.corrcoef(ld_np, ld_ref)[0, 1])
    spread = float(ld_ref.max() - ld_ref.min())
    rmse = float(np.sqrt(np.mean((ld_np - ld_ref) ** 2))) / spread
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

    # 4. the kernel against its plain version, on the main path's operands
    max_err, ms, plain_ms = kernel_phase(calls)

    # 5. timing
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
    stages = staged_fit(mt, x_np)
    log("[fit] stage seconds " + json.dumps({k: round(v, 6) for k, v in stages.items()}))

    log(json.dumps({"kernels": [{
        "name": "matern52_gram",
        "route": "cuda",
        "source": "mellon_tpu_torch/csrc/matern52_tile.cu",
        "replaces": "mellon_tpu/ops/pallas_kernels.py:62",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
