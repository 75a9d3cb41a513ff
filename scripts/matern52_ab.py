#!/usr/bin/env python3
"""A/B of the Matern-5/2 CUDA tile against an older version, on one GPU.

Unpack the older tree's port package into a directory that .gitignore
lists, then run from the root of the repository:

    mkdir -p build/ab_old && git archive <commit> mellon_tpu_torch | tar -x -C build/ab_old
    python3 scripts/matern52_ab.py --old build/ab_old

Both kernels are built from source with their package's nvcc flags.  At
each main-path shape (K_uu 5000x5000x20 as k(x, x), C 8627x2048x20, the
predictor's 1000x2048x20) and at a 200,000 x 2,048 x 20 predictor batch, in float32
and float64, each kernel is checked against the plain PyTorch version on
its first 2,000 rows, then old and new are timed in PAIRS alternating
pairs (old, new, new, old, ...), each a median of CUDA events around 20
back-to-back launches of the C entry point into one output
(``chip_smoke.device_ms``).  Last, the host time of one wrapper call of
each version (``matern52_gram`` at 256x256x20, 1,000 calls, no
synchronise), four times in turns.  Prints a table, then all of it as
one JSON line.
"""

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

SHAPES = ((5000, 5000, 20), (8627, 2048, 20), (1000, 2048, 20), (200_000, 2048, 20))
PAIRS = 5


def load_wrapper(root, name):
    """The module ``mellon_tpu_torch/ops/hopper_kernels.py`` of the tree at
    ``root``, loaded under ``name``; it builds into ``root/build``."""
    spec = importlib.util.spec_from_file_location(
        name, Path(root) / "mellon_tpu_torch" / "ops" / "hopper_kernels.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def host_us(wrapper, calls=1000):
    """Host time of one ``wrapper.matern52_gram`` call at 256x256x20 f32."""
    import torch

    x = torch.randn(256, 20, device="cuda", generator=torch.Generator("cuda").manual_seed(3))
    for _ in range(10):
        wrapper.matern52_gram(x, x, 2.5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        wrapper.matern52_gram(x, x, 2.5)
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * elapsed / calls


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", required=True, help="root of the older tree")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("matern52_ab: no CUDA device is available.", file=sys.stderr)
        return 2

    from mellon_tpu_torch.ops import hopper_kernels as new

    wrappers = {"old": load_wrapper(args.old, "matern52_old_wrapper"), "new": new}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    libs = {label: wrapper._library() for label, wrapper in wrappers.items()}

    g = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for n, m, d in SHAPES:
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).replace("torch.", "")
            x = torch.randn(n, d, device="cuda", dtype=dtype, generator=g)
            # K_uu on the main path is k(x, x): one buffer on both sides
            y = x if n == m else torch.randn(m, d, device="cuda", dtype=dtype, generator=g)
            out = torch.empty((n, m), device="cuda", dtype=dtype)
            launch = {k: chip_smoke.bare_launcher(lib, x, y, out, 3.1) for k, lib in libs.items()}
            rows = slice(0, min(n, 2000))
            plain = new.matern52_gram_reference(x[rows], y, 3.1)
            errors = {}
            for label, fn in launch.items():
                out.fill_(float("nan"))
                fn()
                errors[label] = (out[rows] - plain).abs().max().item()
            if not all(e <= chip_smoke.TOLERANCE[name] for e in errors.values()):
                raise AssertionError(f"a kernel disagrees with the plain version: {errors}")
            times = {k: [] for k in launch}
            for p in range(PAIRS):
                for label in ("old", "new") if p % 2 == 0 else ("new", "old"):
                    times[label].append(chip_smoke.device_ms(launch[label], runs=3))
            bound_ms, bound_by = chip_smoke.matern52_bound_ms(n, m, d, name)
            row = {"shape": f"{n}x{m}x{d}", "dtype": name, "bound_ms": bound_ms,
                   "bound_by": bound_by, "max_abs_err": errors,
                   "ms": {k: statistics.median(v) for k, v in times.items()}, "runs": times}
            results.append(row)
            print(f"[ab] {row['shape']} {name}: bound {bound_ms:.5f} ms; " + "; ".join(
                f"{k} {row['ms'][k]:.5f} ms (share {bound_ms / row['ms'][k]:.3f}, "
                f"err {errors[k]:.2e})" for k in launch), flush=True)
            del x, y, out, launch, plain

    host = {k: [] for k in wrappers}
    for p in range(4):
        for label in ("old", "new") if p % 2 == 0 else ("new", "old"):
            host[label].append(host_us(wrappers[label]))
    print("[ab] wrapper host time per call (us): " + json.dumps(host), flush=True)
    print(json.dumps({"device": smi, "results": results, "wrapper_host_us": host}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
