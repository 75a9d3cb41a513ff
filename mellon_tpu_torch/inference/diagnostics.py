"""MCMC convergence diagnostics: split-R̂ and effective sample size
(counterpart of ``mellon_tpu/inference/diagnostics.py``, same definitions).

Split-R̂ from within/between-chain variances (BDA3, without Vehtari et
al.'s rank normalization) and ESS from Geyer's initial positive sequence
over chain-averaged autocorrelations estimated by FFT.  They run on the
host in numpy and take tensors (on any device) or arrays.
"""

import numpy as np
import torch


def _as_numpy(samples):
    if isinstance(samples, torch.Tensor):
        return samples.detach().cpu().numpy()
    return np.asarray(samples)


def split_rhat(samples):
    """Split-R̂ per dimension of ``samples`` (num_chains, num_samples, dim):
    a (dim,) array, ≈ 1 at convergence."""
    samples = _as_numpy(samples)
    c, n, d = samples.shape
    half = n // 2
    splits = np.concatenate([samples[:, :half], samples[:, half : 2 * half]], axis=0)
    m, n_, _ = splits.shape
    chain_means = splits.mean(axis=1)
    chain_vars = splits.var(axis=1, ddof=1)
    between = n_ * chain_means.var(axis=0, ddof=1)
    within = chain_vars.mean(axis=0)
    var_est = (n_ - 1) / n_ * within + between / n_
    return np.sqrt(var_est / within)


def _autocov_fft(x):
    """Autocovariance of every series along axis 1 via FFT."""
    n = x.shape[1]
    x = x - x.mean(axis=1, keepdims=True)
    f = np.fft.rfft(x, 2 * n, axis=1)
    return np.fft.irfft(f * np.conj(f), axis=1)[:, :n].real / n


def effective_sample_size(samples, return_truncation=False):
    """ESS per dimension of ``samples`` (num_chains, num_samples, dim).

    With ``return_truncation`` it also returns, per dimension, the lag at
    which Geyer's initial positive sequence stopped; a lag that reaches
    the chain length (``lag + 2 > num_samples``) means the ESS of that
    dimension is a lower bound limited by the window, not a measurement.
    All dimensions at once: the JAX package's loop over them, vectorized.
    """
    samples = _as_numpy(samples)
    c, n, d = samples.shape
    acovs = _autocov_fft(samples)  # (c, n, d)
    mean_var = acovs[:, 0].mean(axis=0)
    var_plus = mean_var * (n - 1) / n
    if c > 1:
        var_plus = var_plus + samples.mean(axis=1).var(axis=0, ddof=1)
    rho = 1 - (mean_var - acovs.mean(axis=0)) / var_plus  # (n, d)
    # Geyer: add the pairs rho[t] + rho[t + 1], t = 1, 3, ... < n - 1, up
    # to the first negative one
    t = np.arange(1, n - 1, 2)
    pairs = rho[t] + rho[t + 1]
    kept = np.cumprod(~(pairs < 0), axis=0)
    tau = 1.0 + 2 * np.sum(np.where(kept, pairs, 0.0), axis=0)
    ess = c * n / np.maximum(tau, 1e-8)
    if return_truncation:
        return ess, 1 + 2 * kept.sum(axis=0).astype(np.int64)
    return ess


def summarize(samples):
    """Per-dimension mean, std (ddof 1), split-R̂ and ESS as a dict."""
    samples = _as_numpy(samples)
    flat = samples.reshape(-1, samples.shape[-1])
    return {
        "mean": flat.mean(axis=0),
        "std": flat.std(axis=0, ddof=1),
        "rhat": split_rhat(samples),
        "ess": effective_sample_size(samples),
    }
