"""Prior and likelihood of the whitened sparse-GP density model
(counterpart of ``mellon_tpu/inference/likelihoods.py``)."""

import math

import torch


def normal_prior(k):
    """Log-pdf of z ~ N(0, I_k)."""

    def logpdf(z):
        return -(1 / 2) * torch.sum(z * z) - (k / 2) * math.log(2 * math.pi)

    return logpdf


def nearest_neighbors_terms(r, d):
    """The per-cell constants ``(V, Vdr)`` of the 1-NN likelihood: the
    log-volume of the d-sphere of radius r and the log of its derivative."""
    d = torch.as_tensor(d, dtype=r.dtype, device=r.device)
    const = (d * math.log(math.pi) / 2) - torch.lgamma(d / 2 + 1)
    log_r = torch.log(r)
    V = log_r * d + const
    Vdr = torch.log(d) + ((d - 1) * log_r) + const
    return V, Vdr


def nearest_neighbors_likelihood(r, d):
    """Likelihood of the log density given observed 1-NN distances r in
    dimension d: log P(r | f) = f + log V'(r) - exp(f + log V(r))."""
    V, Vdr = nearest_neighbors_terms(r, d)

    def logpdf(log_density):
        return torch.sum((log_density + Vdr) - torch.exp(log_density + V))

    return logpdf
