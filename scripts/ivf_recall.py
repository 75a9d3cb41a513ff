#!/usr/bin/env python3
"""The IVF search's 1-NN recall on chip_smoke's atlas cells.

    python3 scripts/ivf_recall.py [--cells N] [--probes 8,16,32] [--device cuda] [--jax]

Makes N x 50 float32 cells by chip_smoke.atlas_cells (its seed), computes
their exact 1-NN distances (mellon_tpu_torch.ops.nn_distances), then for
each probe count the IVF 1-NN distances (knn_ivf at its default cells,
n // 256): seconds, the table's cap and truncated points, the share within
1e-6 relative of exact (chip_smoke's [ivf] bar), the share of points that
are truncated, and the largest IVF / exact ratio.  With --jax (the CPU
only: the JAX package must be installed) the JAX package's knn_ivf at 8
probes on the same cells, held to the same exact distances.  Prints one
JSON line.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from mellon_tpu_torch.ops import neighbors  # noqa: E402


def synced(device, fn):
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def shares(ivf, exact):
    """(share within IVF_REL relative of exact, largest ivf / exact)."""
    equal = float(((ivf - exact).abs() <= chip_smoke.IVF_REL * exact).double().mean())
    return equal, float((ivf / exact).max())


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cells", type=int, default=chip_smoke.ATLAS_CELLS)
    parser.add_argument("--probes", default="8,16,32")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--jax", action="store_true")
    args = parser.parse_args()
    device = torch.device(args.device)
    x = torch.as_tensor(chip_smoke.atlas_cells(args.cells, chip_smoke.ATLAS_DIMS,
                                               chip_smoke.ATLAS_SEED), device=device)
    exact, exact_s = synced(device, lambda: neighbors.nn_distances(x))
    out = {"cells": list(x.shape), "device": str(device),
           "card": torch.cuda.get_device_name(device) if device.type == "cuda" else None,
           "exact_seconds": exact_s, "ivf": []}
    tables = []
    table = neighbors._ivf_table

    def keep_table(*a):
        tables.append(table(*a))
        return tables[-1]

    neighbors._ivf_table = keep_table
    try:
        for n_probe in (int(p) for p in args.probes.split(",")):
            (ivf, _), seconds = synced(device, lambda: neighbors.knn_ivf(x, 1, n_probe=n_probe))
            equal, worst = shares(ivf[:, 0], exact)
            _, cap, truncated = tables[-1]
            out["ivf"].append({"n_probe": n_probe, "seconds": seconds, "cap": cap,
                               "truncated": truncated, "equal_share": equal,
                               "truncated_share": truncated / x.shape[0],
                               "max_ratio": worst})
    finally:
        neighbors._ivf_table = table
    if args.jax:
        import jax.numpy as jnp

        from mellon_tpu.ops import neighbors as jax_neighbors

        (jd, _), seconds = synced(device, lambda: jax_neighbors.knn_ivf(
            jnp.asarray(x.cpu().numpy()), 1, n_probe=8))
        equal, worst = shares(torch.as_tensor(np.asarray(jd))[:, 0], exact.cpu())
        out["jax_ivf"] = {"n_probe": 8, "seconds": seconds, "equal_share": equal,
                          "max_ratio": worst}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
