"""Cells made from a seed: the clustered mixture of the JAX package's
``bench.make_data``, in numpy (the recipe ``chip_smoke.atlas_cells`` uses).
A seed is a whole number or a list of them (numpy's seed entropy)."""

import numpy as np

CENTERS = 12


def mixture(n, d, seed):
    """``(cells, centres, scales)``: ``CENTERS`` centres ~ N(0, 2²), each
    of the n cells a centre plus N(0, s²) with a per-centre scale
    s = 0.3 + 0.4·U, every dimension j then scaled by e^(−0.15 j); the
    cells (n, d) in float32."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(CENTERS, d)) * 2.0
    assign = rng.integers(0, CENTERS, n)
    scales = 0.3 + 0.4 * rng.random((CENTERS, 1))
    return _place(centres, scales, assign, rng.normal(size=(n, d))), centres, scales


def mixture_cells(n, d, seed):
    """The (n, d) float32 cells of :func:`mixture`."""
    return mixture(n, d, seed)[0]


def new_cells(centres, scales, n, seed):
    """n more float32 cells of the mixture with these centres and scales,
    drawn from their own ``seed``."""
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, CENTERS, n)
    return _place(centres, scales, assign, rng.normal(size=(n, centres.shape[1])))


def _place(centres, scales, assign, noise):
    x = centres[assign] + scales[assign] * noise
    return (x * np.exp(-0.15 * np.arange(centres.shape[1]))[None, :]).astype(np.float32)
