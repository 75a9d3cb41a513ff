#!/usr/bin/env python3
"""Time three ways of Lloyd's per-cluster sums on the card, and check
which give the same bits on every run.

Run from the root of the repository on a machine with an NVIDIA GPU:

    python3 scripts/cluster_sums_bench.py
    python3 scripts/cluster_sums_bench.py --cpu   # a small shape, for a dry run

At each k-means shape the fits run (the time course's 98,192 cells with
the time column scaled by ls / ls_time, and the 8,627 x 20 benchmark
cells, each into 5,000 clusters) it seeds the centroids with k-means++,
then times, for each candidate: one update on the first assignment (CUDA
events around 30 back-to-back calls, median of 5 runs), and a whole
30-step Lloyd run with the candidate in place of the module's update (the
assignment included; median of 3). The candidates:

- ``index_add_``: the scatter-add of float atomics (not deterministic);
- ``one-hot blocks``: (k, rows) one-hot products over fixed row blocks;
- ``sort + segment_reduce``: ops/cluster.py's own update.

Each update runs 5 times on the same assignment and each Lloyd run twice:
whether all its outputs are equal bit for bit is printed beside its
times. The last line is all of it as JSON.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mellon_tpu_torch.ops import cluster  # noqa: E402

N_ITER = 30
K = 5000
# the [time] fit's length scale on the card and its ls_time (PERF.md)
TIME_FACTOR = 0.349 / 0.375
# elements of one (rows, k) one-hot block: 128 MiB in float32, whatever k is
ONEHOT_BLOCK_ELEMS = 1 << 25


def index_add_sums(x_ones, idx, k):
    return x_ones.new_zeros((k, x_ones.shape[1])).index_add_(0, idx, x_ones)


def onehot_sums(x_ones, idx, k):
    rows = max(1, ONEHOT_BLOCK_ELEMS // k)
    sums = x_ones.new_zeros((k, x_ones.shape[1]))
    for s in range(0, x_ones.shape[0], rows):
        block = idx[s : s + rows]
        onehot = x_ones.new_zeros((block.shape[0], k)).scatter_(1, block[:, None], 1.0)
        sums += onehot.T @ x_ones[s : s + rows]
    return sums


CANDIDATES = {
    "index_add_": index_add_sums,
    "one-hot blocks": onehot_sums,
    "sort + segment_reduce": cluster._cluster_sums,
}


def timed_ms(fn, device, calls, runs):
    """Median over ``runs`` of the time of ``calls`` back-to-back ``fn()``
    per call, in ms (CUDA events on the card, the host clock on the CPU)."""
    fn()
    times = []
    for _ in range(runs):
        if device == "cuda":
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / calls)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append(1e3 * (time.perf_counter() - t0) / calls)
    return statistics.median(times)


def same_bits(tensors):
    return all(torch.equal(tensors[0], t) for t in tensors[1:])


def bench_shape(label, x, k, device):
    generator = torch.Generator(device=device).manual_seed(42)
    init = cluster._kmeanspp_init(x, k, generator)
    block = min(cluster.DEFAULT_ASSIGN_BLOCK, x.shape[0])
    idx = cluster._assign(x, init, block)
    x_ones = torch.cat([x, x.new_ones((x.shape[0], 1))], dim=1)
    reference = index_add_sums(x_ones.double(), idx, k)
    rows = {}
    module_update = cluster._cluster_sums
    for name, sums in CANDIDATES.items():
        outs = [sums(x_ones, idx, k) for _ in range(5)]
        err = float((outs[0].double() - reference).abs().max())
        update_ms = timed_ms(lambda: sums(x_ones, idx, k), device, calls=N_ITER, runs=5)
        cluster._cluster_sums = sums
        try:
            runs = [cluster._lloyd(x, init, k, N_ITER, block) for _ in range(2)]
            lloyd_ms = timed_ms(lambda: cluster._lloyd(x, init, k, N_ITER, block), device, calls=1, runs=3)
        finally:
            cluster._cluster_sums = module_update
        rows[name] = {"update_ms": update_ms, "lloyd_ms": lloyd_ms,
                      "update_bits_equal_over_5": same_bits(outs),
                      "lloyd_bits_equal_over_2": same_bits(runs),
                      "max_abs_err_vs_float64": err}
        print(f"[{label}] {name}: update {update_ms!r} ms, {N_ITER}-step Lloyd {lloyd_ms!r} ms, "
              f"update identical over 5 runs {rows[name]['update_bits_equal_over_5']}, "
              f"Lloyd identical over 2 runs {rows[name]['lloyd_bits_equal_over_2']}, "
              f"max |err| vs float64 {err!r}", flush=True)
    return {"cells": x.shape[0], "features": x.shape[1], "clusters": k, "candidates": rows}


def main():
    cpu = "--cpu" in sys.argv[1:]
    device = "cpu" if cpu else "cuda"
    if not cpu and not torch.cuda.is_available():
        print("cluster_sums_bench: no CUDA device is available; nothing was run.", file=sys.stderr)
        return 2
    result = {}
    if not cpu:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
        result["device"] = smi
    ref = np.load(os.path.join(ROOT, "benchdata", "ref_time_98192x2_f64.npz"))
    course = np.concatenate([ref["x"], TIME_FACTOR * ref["times"][:, None]], axis=1)
    cells = np.load(os.path.join(ROOT, "benchdata", "ld_ref_8627x20_f64.npz"))["x"]
    shapes = {"time course": course, "bench cells": cells}
    for label, data in shapes.items():
        x = torch.as_tensor(np.asarray(data, dtype=np.float32), device=device)
        k = K
        if cpu:
            x, k = x[:: max(1, x.shape[0] // 2000)], 100
        result[label] = bench_shape(label, x, k, device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
