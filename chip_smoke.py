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
   and at synthetic shapes (ragged and unaligned, d from 1 to 130, one
   output element, more rows or columns than 65535 tiles of 64), in
   float32 (max abs error <= 1e-5) and float64 (<= 1e-12).  At every
   main-path shape, in both types, the kernel's device time (median of
   N_RUNS runs of CUDA events around N_LAUNCHES back-to-back launches of
   its C entry point into one output, divided by N_LAUNCHES) beside the
   plain version's, timed the same way, and the bound: the larger of the
   bytes over the memory rate and the flops over the peak rate;
5. predictor batch: the kernel alone (the plain version's temporaries are
   several times the 1.64 GB output) at PREDICT_BATCH query points
   against the kept landmarks, float32, checked against the plain version
   on its first and last rows;
6. wrapper: the host time of one ``matern52_gram`` call, over 1,000 calls
   without a synchronise;
7. timing: the warm fit time (median of 3) and a per-stage breakdown.

The line before the last is the JSON kernel report (``ms``, ``plain_ms``
and ``bound_ms``: the kernel's, the plain version's and the bound's time
summed over the main path's launches in float32; ``shapes``: each shape
and type with its own times and share of the bound); the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
with status 2 and prints no result.
"""

import json
import os
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
CERT_MIN_CORR = 0.999
CERT_MAX_RMSE = 0.01
N_LAUNCHES = 20
N_RUNS = 7
PREDICT_BATCH = 200_000
DEVICE = "cuda"

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


def time_shape(lib, x, y, ls, launches):
    """The kernel's and the plain version's device time and the bound at
    the operands (x, y), in float32 and float64: one report row each."""
    import torch

    from mellon_tpu_torch.ops.hopper_kernels import matern52_gram_reference

    rows = []
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        xa, ya = x.to(dtype).contiguous(), y.to(dtype).contiguous()
        out = torch.empty((n, m), dtype=dtype, device=x.device)
        ms = device_ms(bare_launcher(lib, xa, ya, out, ls))
        plain_ms = device_ms(lambda: matern52_gram_reference(xa, ya, ls))
        bound_ms, bound_by = matern52_bound_ms(n, m, d, name)
        rows.append({"shape": f"{n}x{m}x{d}", "dtype": name,
                     "launches": launches if dtype == x.dtype else 0,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "share": bound_ms / ms})
        log(f"[kernel] {n}x{m}x{d} {name}: kernel {ms!r} ms, plain {plain_ms!r} ms, "
            f"bound {bound_ms!r} ms ({bound_by}), share {bound_ms / ms!r} "
            f"(median of {N_RUNS} runs of {N_LAUNCHES} launches)")
        del out
    return rows


def kernel_phase(lib, calls):
    """Kernel against plain version on every main-path call's operands and
    at the synthetic shapes, and its times at each main-path shape; returns
    (max float32 error over the main path, report rows)."""
    import torch

    worst, rows, seen = 0.0, [], {}
    for x, y, ls in calls:
        shape = (x.shape[0], y.shape[0], x.shape[1])
        seen.setdefault(shape, [x, y, ls, 0])[3] += 1
    for x, y, ls, launches in seen.values():
        worst = max(worst, check_kernel(x, y, ls, "main path"))
        rows += time_shape(lib, x, y, ls, launches)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    for n, m, d in SYNTHETIC_SHAPES:
        x = torch.randn(n, d, device=DEVICE, dtype=torch.float64, generator=g)
        y = torch.randn(m, d, device=DEVICE, dtype=torch.float64, generator=g)
        check_kernel(x, y, 2.5, "synthetic")
    return worst, rows


def predict_batch_phase(lib, x, landmarks, ls):
    """The kernel alone at PREDICT_BATCH query points (the training cells,
    perturbed) against the kept landmarks, float32: its report row."""
    import torch

    from mellon_tpu_torch.ops.hopper_kernels import matern52_gram_reference

    g = torch.Generator(device=DEVICE).manual_seed(2)
    idx = torch.randint(0, x.shape[0], (PREDICT_BATCH,), device=DEVICE, generator=g)
    xq = (x[idx] + 0.05 * x.std(dim=0) * torch.randn(
        PREDICT_BATCH, x.shape[1], device=DEVICE, generator=g)).contiguous()
    y = landmarks.float().contiguous()
    n, m, d = PREDICT_BATCH, y.shape[0], y.shape[1]
    out = torch.empty((n, m), dtype=torch.float32, device=DEVICE)
    ms = device_ms(bare_launcher(lib, xq, y, out, ls), runs=5)
    err = max(
        (out[rows] - matern52_gram_reference(xq[rows], y, ls)).abs().max().item()
        for rows in (slice(0, 2000), slice(n - 2000, n))
    )
    if not err <= TOLERANCE["float32"]:
        raise AssertionError(f"matern52 kernel disagrees at the predictor batch: {err}")
    bound_ms, bound_by = matern52_bound_ms(n, m, d, "float32")
    log(f"[predict batch] {n}x{m}x{d} float32: kernel {ms!r} ms, bound {bound_ms!r} ms "
        f"({bound_by}), share {bound_ms / ms!r}; {out.numel() * 4 / 1e9!r} GB written; "
        f"max_abs_err on 4000 rows {err!r}")
    return {"shape": f"{n}x{m}x{d}", "dtype": "float32", "launches": 0, "ms": ms,
            "plain_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "share": bound_ms / ms}


def wrapper_host_us(calls=1000):
    """Host time of one ``matern52_gram`` call (checks, allocation, the
    ctypes call and the launch): a host clock over ``calls`` calls without
    a synchronise, at a shape whose kernel is shorter than that."""
    import torch

    from mellon_tpu_torch.ops.hopper_kernels import matern52_gram

    g = torch.Generator(device=DEVICE).manual_seed(3)
    x = torch.randn(256, 20, device=DEVICE, generator=g)
    for _ in range(10):
        matern52_gram(x, x, 2.5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        matern52_gram(x, x, 2.5)
    host_us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    log(f"[wrapper] host time per matern52_gram call (256x256x20 float32, {calls} "
        f"calls, no synchronise): {host_us!r} us")
    return host_us


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
    path = hk.build_library()
    log(f"[build] {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.3f} s")
    lib = hk._library()

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
    max_err, rows = kernel_phase(lib, calls)
    path_rows = [r for r in rows if r["dtype"] == "float32"]
    ms = sum(r["ms"] * r["launches"] for r in path_rows)
    plain_ms = sum(r["plain_ms"] * r["launches"] for r in path_rows)
    bound_ms = sum(r["bound_ms"] * r["launches"] for r in path_rows)
    log(f"[kernel] main path's {launches} float32 launches: kernel {ms!r} ms, plain "
        f"{plain_ms!r} ms, bound {bound_ms!r} ms, share {bound_ms / ms!r}")

    # 5. the kernel at a large predictor batch, 6. the wrapper's host time
    rows.append(predict_batch_phase(lib, x, est.landmarks, calls[-1][2]))
    host_us = wrapper_host_us()

    # 7. timing
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
        "bound_ms": bound_ms,
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in path_rows) else "operations",
        "library_ms": None,
        "share": bound_ms / ms,
        "wrapper_host_us": host_us,
        "shapes": rows,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
