"""Effective sample size of MCMC draws over chain-averaged
autocorrelations estimated by FFT.

:func:`effective_sample_size` is a copy of
``mellon_tpu_torch/inference/diagnostics.py``'s (the same definition as
the JAX package's): Geyer's pairs from lag 1, which caps the ESS at
chains × draws.  ``ess_per_s`` takes it.  NUTS's draws are antithetic
(ρ₁ < 0), so it reads chains × draws for most latents and cannot tell a
sampler that mixes better than that; :func:`ess_from_lag0`, Geyer's
initial monotone sequence from lag 0 as Stan and ArviZ estimate it,
reads above chains × draws there, and gives the per-layer
``nuts.ess_per_draw``.  Both are kept here so that the yardstick does
not move with the program.
"""

import numpy as np


def _autocov_fft(x):
    """Autocovariance of every series along axis 1 via FFT."""
    n = x.shape[1]
    x = x - x.mean(axis=1, keepdims=True)
    f = np.fft.rfft(x, 2 * n, axis=1)
    return np.fft.irfft(f * np.conj(f), axis=1)[:, :n].real / n


def _rho(samples):
    """(chains, draws, the chain-averaged autocorrelations (draws, dim))."""
    samples = np.asarray(samples, dtype=np.float64)
    c, n, d = samples.shape
    acovs = _autocov_fft(samples)  # (c, n, d)
    mean_var = acovs[:, 0].mean(axis=0)
    var_plus = mean_var * (n - 1) / n
    if c > 1:
        var_plus = var_plus + samples.mean(axis=1).var(axis=0, ddof=1)
    return c, n, 1 - (mean_var - acovs.mean(axis=0)) / var_plus


def effective_sample_size(samples):
    """ESS per dimension of ``samples``, a (num_chains, num_samples, dim)
    array."""
    c, n, rho = _rho(samples)
    # Geyer: add the pairs rho[t] + rho[t + 1], t = 1, 3, ... < n - 1, up
    # to the first negative one
    t = np.arange(1, n - 1, 2)
    pairs = rho[t] + rho[t + 1]
    kept = np.cumprod(~(pairs < 0), axis=0)
    tau = 1.0 + 2 * np.sum(np.where(kept, pairs, 0.0), axis=0)
    return c * n / np.maximum(tau, 1e-8)


def ess_from_lag0(samples):
    """ESS per dimension of a (chains, draws, dim) array: the pairs
    ρ₂ₖ + ρ₂ₖ₊₁ from k = 0 up to the first negative one, made monotone
    (each at most the one before), τ = −1 + 2·Σ pairs, plus ρ₂ₘ where the
    first negative pair m starts with a positive lag; the ESS is
    chains · draws / τ, at most chains · draws · log10(chains · draws)
    (Stan's ``compute_effective_sample_size``, ArviZ's ``ess``)."""
    c, n, rho = _rho(samples)
    m = (n - 1) // 2
    pairs = rho[0 : 2 * m : 2] + rho[1 : 2 * m : 2]  # (m, d)
    kept = np.cumprod(pairs >= 0, axis=0).astype(bool)
    monotone = np.minimum.accumulate(np.where(kept, pairs, np.inf), axis=0)
    tau = -1.0 + 2 * np.sum(np.where(kept, monotone, 0.0), axis=0)
    first_negative = kept.sum(axis=0)  # the pair index m at which the sum stops
    stop = np.minimum(2 * first_negative, n - 1)
    tail = rho[stop, np.arange(rho.shape[1])]
    tau = tau + np.where((first_negative < m) & (tail > 0), tail, 0.0)
    total = c * n
    return total / np.maximum(tau, 1.0 / np.log10(total))


def ess_by_blocks(samples, block=256, estimator=effective_sample_size):
    """``estimator`` of a (chains, draws, dim) array over blocks of
    ``block`` dimensions, which bounds the FFT's memory."""
    return np.concatenate([estimator(samples[:, :, s : s + block])
                           for s in range(0, samples.shape[2], block)])
