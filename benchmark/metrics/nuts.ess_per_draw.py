"""The sampler's effective draws per draw: the median over the latents
of the window's multi-chain ESS by Geyer's sequence from lag 0
(``ess.ess_from_lag0``, which reads above chains × draws for antithetic
draws), over chains × draws.  It shows a sampler that mixes better or
worse at the same rate of draws, which ``ess_per_s``'s capped estimate
shows only where it mixes worse."""


def read(record):
    return record.get("ess_per_draw")
