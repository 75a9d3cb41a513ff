"""Priors and likelihoods of the whitened sparse-GP models: the density
model's 1-NN likelihood and the dimensionality model's k-NN Poisson
likelihood (counterpart of ``mellon_tpu/inference/likelihoods.py``)."""

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


def poisson_terms(distances):
    """The per-cell, per-rank constants of the k-NN Poisson likelihood:
    ``(ldist, counts, lgamma(counts))`` with ldist = log(sorted distances)
    + log(π)/2 (n, k) and counts 1..k.  The distances are sorted here,
    once.  bfloat16 distances (the coarse phase of the two-phase bf16
    MAP) give ldist rounded to bfloat16, as the JAX package computes it
    from bf16 operands, returned in float32 beside float32 counts."""
    k = distances.shape[1]
    dtype = torch.float32 if distances.dtype == torch.bfloat16 else distances.dtype
    counts = torch.arange(1, k + 1, dtype=dtype, device=distances.device)
    ldist = torch.log(torch.sort(distances, dim=-1).values) + math.log(math.pi) / 2
    return ldist.to(dtype), counts, torch.lgamma(counts)


def poisson_likelihood(distances):
    """Joint k-NN Poisson likelihood of (local dimension, log density):
    the counts 1..k against the expected counts in the spheres through the
    k nearest neighbours, log-volume V(d) = d·ldist − lgamma(d/2 + 1)."""
    ldist, counts, lgamma_counts = poisson_terms(distances)

    def logpdf(dims, log_dens):
        pred = log_dens[:, None] + dims[:, None] * ldist - torch.lgamma(dims[:, None] / 2 + 1)
        return torch.sum(pred * counts - torch.exp(pred) - lgamma_counts)

    return logpdf
