"""Shared helpers of the tests that hold mellon_tpu_torch against mellon_tpu.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs in float64 (``conftest.py`` turns x64 on for the session)
and the port on the CPU in ``torch.float64`` with the plain kernel
versions, unless a test states otherwise.
"""

import contextlib

import jax
import numpy as np
import torch

# the suite runs under several xdist workers: keep each worker's torch
# pool small so they do not oversubscribe the cores
torch.set_num_threads(2)

CPU64 = dict(device="cpu", dtype=torch.float64)


def t64(a):
    """A numpy (or JAX) array as a CPU float64 tensor."""
    return torch.tensor(np.asarray(a, dtype=np.float64))


def to_np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def clustered(n, d, seed, n_clusters=6, spread=0.3):
    """Clustered points with a decaying per-dimension scale, like the
    benchmark's diffusion-map coordinates."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_clusters, d) * 2.0
    assign = rng.randint(0, n_clusters, n)
    x = centers[assign] + spread * rng.randn(n, d)
    return x * np.exp(-0.15 * np.arange(d))[None, :]


@contextlib.contextmanager
def jax_x64_off():
    """Run the JAX side in float32 (the pruning branch needs f32 grams)."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)
