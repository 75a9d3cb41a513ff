"""How many landmarks each package keeps at the benchmark shape, in float32.

Both packages prune the 5,000 k-means landmarks of the 8,627 x 20 benchmark
cells by pivoted Cholesky when the float32 landmark gram is singular.  This
crosses the two landmark sets (the JAX package's k-means and the port's)
with the two pruning paths (``mellon_tpu`` with x64 off, ``mellon_tpu_torch``
on the CPU in float32), so a difference in the kept count is traced either
to the landmarks or to the pruning.  It takes a few minutes on the CPU:

    JAX_PLATFORMS=cpu python tests/_torch_bench_rank.py
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import mellon_tpu  # noqa: E402
import mellon_tpu_torch  # noqa: E402
from mellon_tpu.parameters import compute_landmarks as jax_compute_landmarks  # noqa: E402
from mellon_tpu_torch.parameters import compute_landmarks as torch_compute_landmarks  # noqa: E402

DATA = os.path.join(ROOT, "benchdata", "ld_ref_8627x20_f64.npz")
N_LANDMARKS = 5000
SEED = 42


def kept_by_jax(x, xu):
    est = mellon_tpu.DensityEstimator(landmarks=jnp.asarray(xu))
    est.prepare_inference(jnp.asarray(x))
    return int(est.landmarks.shape[0])


def kept_by_torch(x, xu):
    est = mellon_tpu_torch.DensityEstimator(landmarks=xu, device="cpu", dtype=torch.float32)
    est.prepare_inference(x)
    return int(est.landmarks.shape[0])


def main():
    torch.set_num_threads(4)
    x = np.asarray(np.load(DATA)["x"], dtype=np.float32)
    landmarks = {
        "jax_kmeans": np.asarray(
            jax_compute_landmarks(jnp.asarray(x), n_landmarks=N_LANDMARKS, random_state=SEED)
        ),
        "torch_kmeans": torch_compute_landmarks(
            torch.as_tensor(x), n_landmarks=N_LANDMARKS, random_state=SEED
        ).numpy(),
    }
    rows = []
    for name, xu in landmarks.items():
        for side, kept in (("jax", kept_by_jax), ("torch", kept_by_torch)):
            t0 = time.perf_counter()
            n_kept = kept(x, xu)
            rows.append({"landmarks": name, "pruned_by": side, "kept": n_kept,
                         "seconds": time.perf_counter() - t0})
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
