"""Shared helpers of the tests that hold mellon_tpu_torch against mellon_tpu.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs in float64 (``conftest.py`` turns x64 on for the session)
and the port on the CPU in ``torch.float64`` with the plain kernel
versions, unless a test states otherwise.
"""

import contextlib
import functools

import jax
import numpy as np
import torch

from mellon_tpu_torch.inference.samplers import Draws

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


class JaxReplayDraws(Draws):
    """A draw source for mellon_tpu_torch's samplers that replays the
    draws mellon_tpu takes from a PRNG key, so that whole runs can be
    compared number for number.

    It rebuilds the key schedule of ``mellon_tpu.inference.mcmc``'s
    ``run_mcmc`` (the jitter's split of the key, then one
    ``split(fold_in(key, phase), (transitions, chains))`` per phase) and
    ``resume_mcmc`` (``split(key, (transitions, chains))``), and of one
    chain's transition: ``key_mom, key_2 = split(key)``, the momentum from
    key_mom; for HMC the accept uniform from key_2; for NUTS key_2 is the
    tree key, split in 4 at each doubling (next, direction, subtree,
    accept) with the subtree key split once per leaf (next, leaf).
    ``set_keys`` hands it the keys of transitions directly.
    """

    def __init__(self, key=None):
        super().__init__(torch.Generator())
        self.key = key
        self._pending = None
        self._keys = None
        self._t = -1

    @staticmethod
    def _tensor(a, like):
        return torch.tensor(np.asarray(a), dtype=like.dtype, device=like.device)

    def set_keys(self, keys):
        """Keys of the coming transitions, shape (transitions, chains, 2)."""
        self._keys, self._t, self._pending = keys, -1, None

    def phase(self, index, num_transitions):
        base = self.key if index is None else jax.random.fold_in(self.key, index)
        self._pending = (base, num_transitions)
        self._keys, self._t = None, -1

    def jitter(self, shape, like):
        self.key, sub = jax.random.split(self.key)
        return self._tensor(jax.random.normal(sub, shape), like)

    def momentum(self, shape, like):
        C, dim = shape
        if self._keys is None:
            base, n = self._pending
            self._keys = jax.random.split(base, (n, C))
        self._t += 1
        split = _vsplit(self._keys[self._t], 2)
        self._second = split[:, 1]
        return self._tensor(_vnormal(split[:, 0], dim), like)

    def direction(self, n, like):
        split = _vsplit(self._second, 4)
        self._second, self._sub, self._accept = split[:, 0], split[:, 2], split[:, 3]
        return self._tensor(_vuniform(split[:, 1]), like)

    def leaf(self, n, like):
        split = _vsplit(self._sub, 2)
        self._sub = split[:, 0]
        return self._tensor(_vuniform(split[:, 1]), like)

    def subtree_accept(self, n, like):
        return self._tensor(_vuniform(self._accept), like)

    def hmc_accept(self, n, like):
        return self._tensor(_vuniform(self._second), like)


@functools.partial(jax.jit, static_argnums=1)
def _vsplit(keys, num):
    return jax.vmap(lambda k: jax.random.split(k, num))(keys)


@functools.partial(jax.jit, static_argnums=1)
def _vnormal(keys, dim):
    return jax.vmap(lambda k: jax.random.normal(k, (dim,)))(keys)


@jax.jit
def _vuniform(keys):
    return jax.vmap(jax.random.uniform)(keys)
