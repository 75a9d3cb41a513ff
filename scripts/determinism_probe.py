#!/usr/bin/env python3
"""List the operations on the default fit's path that PyTorch calls
nondeterministic on the card, and check that two same-seed fits agree.

Run from the root of the repository on a machine with an NVIDIA GPU:

    python3 scripts/determinism_probe.py

It runs DensityEstimator() on the 8,627 x 20 benchmark cells
(benchdata/ld_ref_8627x20_f64.npz) in float32 under
``torch.use_deterministic_algorithms(True, warn_only=True)`` (with
CUBLAS_WORKSPACE_CONFIG set, as that mode needs), collects the warnings
PyTorch raises for operations without a deterministic implementation,
and prints them with their counts as one JSON line; then two more fits
without the flag, and whether their k-means landmarks, kept landmarks,
latents and final loss are identical.
"""

import collections
import json
import os
import subprocess
import sys
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("determinism_probe: no CUDA device is available; nothing was run.", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import mellon_tpu_torch as mt
    from mellon_tpu_torch.parameters import compute_landmarks

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    x = np.asarray(np.load(os.path.join(ROOT, "benchdata", "ld_ref_8627x20_f64.npz"))["x"], dtype=np.float32)

    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mt.DensityEstimator(device="cuda").fit(x)
        torch.cuda.synchronize()
    torch.use_deterministic_algorithms(False)
    found = collections.Counter(
        str(w.message).splitlines()[0] for w in caught if "deterministic" in str(w.message))
    print(json.dumps({"nondeterministic_ops_on_the_fit": dict(found)}), flush=True)

    xt = torch.as_tensor(x, device="cuda")
    kmeans = [compute_landmarks(xt, n_landmarks=5000, random_state=42) for _ in range(2)]
    fits = []
    for _ in range(2):
        est = mt.DensityEstimator(device="cuda")
        est.fit(x)
        fits.append(est)
    a, b = fits
    print(json.dumps({
        "kmeans_landmarks_identical": bool(torch.equal(*kmeans)),
        "kept_landmarks_identical": bool(torch.equal(a.landmarks, b.landmarks)),
        "latents_identical": bool(torch.equal(a.pre_transformation, b.pre_transformation)),
        "losses": [a.opt_state.loss, b.opt_state.loss],
        "lbfgs_steps": [a.opt_state.n_steps, b.opt_state.n_steps],
        "landmarks_kept": int(a.landmarks.shape[0]),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
