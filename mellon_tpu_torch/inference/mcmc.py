"""Multi-chain MCMC with warmup adaptation, and the density model's
posterior sampler (counterpart of ``mellon_tpu/inference/mcmc.py``).

``run_mcmc`` runs the chains as one batch (:mod:`.samplers`): three warmup
phases (step size with an identity mass; step size and Welford's diagonal
mass over every chain's state; step size again under that mass), then the
draws.  The step size, dual averaging and Welford stay on the device
between transitions; the only host reads are the NUTS leaf loop's, one per
leaf.  PyTorch runs eagerly, so the JAX package's ``steps_per_call`` (it
bounds how long one compiled XLA program runs) is accepted, validated and
ignored, as ``jit`` is.

``chain_sharding=`` (:func:`..parallel.chain_sharding`) splits the chains
in blocks over the ranks of a mesh axis.  Each rank runs its block in
lockstep, draws through a chain block of the generator
(:meth:`.samplers.Draws.chain_block`), and joins the others in one
``all_reduce`` per warmup transition for dual averaging's mean acceptance
and one ``all_gather`` for Welford's per-block summaries, merged in chain
order; the result is gathered to every rank.  The potential may itself be
cell-sharded (:func:`..parallel.shard_density_model`) on the same mesh.

``sample_density_posterior`` samples the density model's whitened latents
with the potential zero-centred (:func:`zero_centered_potential`) and,
with ``precondition="hessian"``, in the coordinates w = Rᵀ(z − z*) of the
MAP Hessian H = R Rᵀ, which the density model gives in closed form
(:func:`..losses.density_hessian`).  :func:`hessian_preconditioner` builds
that whitening from any batched potential and Hessian, the cell-sharded
ones of :func:`..parallel.shard_density_model` too.
"""

import logging
from typing import NamedTuple

import numpy as np
import torch

from ..ops.linalg import _cholesky_f64_rescue, _jittered_cholesky
from ..parallel.mesh import broadcast_from_first_rank, check_sharding, sampling_block
from .losses import density_hessian, make_density_value_and_grad_batch, zero_centering_offset
from .samplers import (
    as_draws,
    da_init,
    da_update,
    hmc_init,
    hmc_kernel,
    nuts_kernel,
    welford_init,
    welford_merge,
    welford_variance,
)

logger = logging.getLogger("mellon_tpu_torch")

BF16_SAMPLING = (
    "precision='bf16' sampling is not ported to mellon_tpu_torch: it failed the "
    "JAX package's posterior-agreement check (ROADMAP, \"Do not port\")."
)
NEWTON_JITTER = 1e-6


class MCMCResult(NamedTuple):
    samples: torch.Tensor  # (num_chains, num_samples, dim)
    potential: torch.Tensor  # (num_chains, num_samples)
    accept_prob: torch.Tensor  # (num_chains, num_samples)
    diverging: torch.Tensor  # (num_chains, num_samples)
    step_size: torch.Tensor  # 0-d, shared by the chains
    inv_mass_diag: torch.Tensor  # (dim,)
    num_leapfrog: torch.Tensor  # (num_chains, num_samples)
    # over the sampling transitions, as num_leapfrog: the NUTS leaf loop's
    # host reads, and the rows the potential evaluated (chains x calls; the
    # chains run in lockstep, so this counts stopped chains' rows too)
    host_reads: int = 0
    num_evaluations: int = 0


def _welford_chains(state, z, sharding):
    """``state`` updated with every chain's row of ``z`` (this rank's block
    under ``sharding``): one (mean, M2) summary per block, gathered and
    merged in chain order."""
    mean = z.mean(dim=0)
    summary = torch.stack([mean, torch.sum((z - mean) ** 2, dim=0)])
    for block_mean, block_m2 in sharding.gather(summary[None]):
        state = welford_merge(state, z.shape[0], block_mean, block_m2)
    return state


def _gather_result(result, sharding):
    fields = ("samples", "potential", "accept_prob", "diverging", "num_leapfrog")
    return result._replace(**{f: sharding.gather(getattr(result, f)) for f in fields})


def _check_steps_per_call(steps_per_call):
    if steps_per_call is not None and (
        isinstance(steps_per_call, bool) or int(steps_per_call) != steps_per_call
        or steps_per_call <= 0
    ):
        raise ValueError(f"steps_per_call must be a positive integer, got {steps_per_call!r}.")


def _kernel_for(value_and_grad, algorithm, max_tree_depth, num_leapfrog_steps):
    if algorithm == "nuts":
        return nuts_kernel(value_and_grad, max_tree_depth=int(max_tree_depth))
    if algorithm == "hmc":
        return hmc_kernel(value_and_grad, num_steps=int(num_leapfrog_steps))
    raise ValueError(f"Unknown MCMC algorithm: {algorithm}")


class _Counted:
    """The potential, counting the rows it evaluates."""

    def __init__(self, value_and_grad):
        self.value_and_grad = value_and_grad
        self.rows = 0

    def __call__(self, Z):
        self.rows += Z.shape[0]
        return self.value_and_grad(Z)


def _sample(kernel, states, draws, step_size, inv_mass, num_samples, potential):
    """``num_samples`` transitions at the adapted step size and mass."""
    kernel.host_reads = potential.rows = 0
    outs = []
    for _ in range(num_samples):
        states, info = kernel(states, draws, step_size, inv_mass)
        outs.append((states.z, states.potential, info.accept_prob, info.diverging, info.num_steps))
    C, dim = states.z.shape
    if outs:
        zs, pots, accepts, divs, steps = (torch.stack([o[i] for o in outs], dim=1) for i in range(5))
    else:
        zs = states.z.new_empty((C, 0, dim))
        pots = accepts = states.z.new_empty((C, 0))
        divs = torch.zeros((C, 0), dtype=torch.bool, device=states.z.device)
        steps = torch.zeros((C, 0), dtype=torch.int64, device=states.z.device)
    return MCMCResult(zs, pots, accepts, divs, step_size, inv_mass, steps,
                      kernel.host_reads, potential.rows)


def run_mcmc(
    value_and_grad,
    z0,
    generator,
    num_warmup=500,
    num_samples=500,
    num_chains=4,
    algorithm="nuts",
    max_tree_depth=10,
    num_leapfrog_steps=32,
    initial_step_size=0.1,
    target_accept=0.8,
    chain_sharding=None,
    steps_per_call=None,
):
    """Sample from exp(−potential) with NUTS or HMC.

    ``value_and_grad(Z (C, k)) -> (potentials (C,), gradients (C, k))``
    evaluates every chain at once (:func:`..losses.make_density_value_and_grad_batch`,
    or :func:`.samplers.batched_value_and_grad` of a row-wise torch
    potential).  ``z0`` is (k,) or (num_chains, k); a single row is spread
    over the chains by 0.1·N(0, I).  ``generator`` is a ``torch.Generator``
    on z0's device (or a :class:`.samplers.Draws` source).  Returns an
    :class:`MCMCResult` with samples of shape (num_chains, num_samples, k).

    With ``chain_sharding`` (a sharding of :mod:`..parallel`) every rank
    passes the same global ``z0`` and a generator seeded alike, runs its
    block of the chains and returns the global result; ``host_reads`` and
    ``num_evaluations`` are its block's.
    """
    check_sharding(chain_sharding, "chain_sharding")
    _check_steps_per_call(steps_per_call)
    draws = as_draws(generator)
    z0 = torch.atleast_2d(z0)
    if z0.shape[0] == 1 and num_chains > 1:
        z0 = z0 + 0.1 * draws.jitter((int(num_chains), z0.shape[1]), z0)
    num_chains = z0.shape[0]
    sharding, z0, draws = sampling_block(chain_sharding, z0, draws, "chains")
    potential = _Counted(value_and_grad)
    kernel = _kernel_for(potential, algorithm, max_tree_depth, num_leapfrog_steps)
    states = hmc_init(potential, z0)
    dim = z0.shape[1]
    num_warmup = int(num_warmup)
    n_phase_a = max(num_warmup // 10, 1)
    n_phase_b = max(num_warmup - 2 * n_phase_a, 0)
    n_phase_c = n_phase_a

    identity_mass = torch.ones(dim, dtype=z0.dtype, device=z0.device)

    def warmup(phase, n, da, mass, welford=None):
        nonlocal states
        draws.phase(phase, n)
        for _ in range(n):
            states, info = kernel(states, draws, torch.exp(da.log_step), mass)
            da = da_update(da, sharding.mean(info.accept_prob, num_chains), target=target_accept)
            if welford is not None:
                welford = _welford_chains(welford, states.z, sharding)
        return da, welford

    # A: step size only, identity mass
    da = da_init(torch.as_tensor(initial_step_size, dtype=z0.dtype, device=z0.device))
    da, _ = warmup(0, n_phase_a, da, identity_mass)
    # B: step size and Welford's mass over every chain's state
    da, wf = warmup(1, n_phase_b, da, identity_mass, welford_init(dim, z0.dtype, z0.device))
    inv_mass = torch.where(wf.count > 2, welford_variance(wf), identity_mass)
    # C: the step size again, under the adapted mass
    da, _ = warmup(2, n_phase_c, da_init(torch.exp(da.log_step_avg)), inv_mass)
    step_size = torch.exp(da.log_step_avg)

    draws.phase(3, int(num_samples))
    return _gather_result(
        _sample(kernel, states, draws, step_size, inv_mass, int(num_samples), potential), sharding)


def resume_mcmc(
    value_and_grad,
    z0,
    generator,
    step_size,
    inv_mass_diag,
    num_samples=500,
    algorithm="nuts",
    max_tree_depth=10,
    num_leapfrog_steps=32,
    chain_sharding=None,
):
    """Continue sampling from the chains' last positions ``z0`` with an
    adapted ``step_size`` and ``inv_mass_diag``: no warmup, fresh momenta
    (exact: the momentum is drawn anew at every transition anyway).
    ``chain_sharding`` as in :func:`run_mcmc`, on any mesh: the run that
    is resumed may have had another."""
    check_sharding(chain_sharding, "chain_sharding")
    draws = as_draws(generator)
    z0 = torch.atleast_2d(z0)
    sharding, z0, draws = sampling_block(chain_sharding, z0, draws, "chains")
    potential = _Counted(value_and_grad)
    kernel = _kernel_for(potential, algorithm, max_tree_depth, num_leapfrog_steps)
    states = hmc_init(potential, z0)
    step_size = torch.as_tensor(step_size, dtype=z0.dtype, device=z0.device)
    inv_mass = torch.as_tensor(inv_mass_diag, dtype=z0.dtype, device=z0.device)
    draws.phase(None, int(num_samples))
    return _gather_result(
        _sample(kernel, states, draws, step_size, inv_mass, int(num_samples), potential), sharding)


def zero_centered_potential(z0, L, nn_distances, d, mu):
    """The density potential re-centred to ~0 at ``z0``: returns the
    batched ``value_and_grad`` with ``loss_offset_per_term`` = loss(z0)/n
    (as a float32 number) and its z-dependent part computed around z0
    (``center=z0``), and that offset.

    The potential is O(n), and one float32 ulp of it can exceed the energy
    differences of a leapfrog step, which then quantize; dual averaging
    collapses the step size and every tree runs to the depth cap.  The
    offset is subtracted inside the likelihood's reduction, where it keeps
    the bits that subtracting after the sum would already have lost.  The
    centre does the same for the rounding of F = L z, which at 10⁶ cells
    in float32 moves the potential by ~0.3–0.8 between neighbouring z
    (:func:`..losses.make_density_value_and_grad_batch`); the JAX package
    subtracts the offset alone.  ``shard_density_model(..., center=z0)``
    gives the same potential with its cells sharded
    (:func:`..parallel.shard_density_model`).
    """
    offset, v0 = zero_centering_offset(z0, L, nn_distances, d, mu)
    logger.info(
        "Zero-centering the sampled potential: loss(z0) = %.6g over %s cells "
        "(offset %.6g/term); reported potentials are relative to z0.",
        v0, f"{L.shape[0]:,}", offset,
    )
    return make_density_value_and_grad_batch(L, nn_distances, d, mu, offset, center=z0), offset


def sample_density_posterior(
    estimator,
    num_warmup=500,
    num_samples=500,
    num_chains=4,
    algorithm="nuts",
    seed=0,
    precision=None,
    precondition=None,
    function_samples=True,
    generator=None,
    **kwargs,
):
    """Posterior draws of a prepared (or fitted) density estimator's
    latents: ``(MCMCResult, function samples (draws, n) or None)``.

    Chains start at ``pre_transformation`` when the estimator is fitted,
    else at its ``initial_value``.  The draws come from a generator seeded
    with ``seed`` on the estimator's device, or from ``generator``.
    ``function_samples=False`` returns ``(result, None)``: at scale the
    (draws × n) matrix of f = L z + μ does not fit in memory.
    """
    if estimator.loss_func is None:
        raise ValueError("Estimator not prepared. Call prepare_inference(x) first.")
    if precision == "bf16":
        raise NotImplementedError(BF16_SAMPLING)
    if precision is not None:
        raise ValueError(f"Unknown precision option: {precision}")
    z0 = estimator.initial_value
    if getattr(estimator, "pre_transformation", None) is not None:
        z0 = estimator.pre_transformation
    args = (estimator.L, estimator.nn_distances, estimator.d, estimator.mu)
    value_and_grad, _ = zero_centered_potential(z0, *args)
    if generator is None:
        generator = torch.Generator(device=z0.device).manual_seed(int(seed))
    run = dict(num_warmup=num_warmup, num_samples=num_samples, num_chains=num_chains,
               algorithm=algorithm, **kwargs)
    if precondition == "hessian":
        # dense-metric sampling: in w = Rᵀ(z − z*) the target is near N(0, I)
        # where the density posterior's spread of scales defeats a diagonal
        # mass.  Needs a (near-)MAP z*, hence the Newton polish.
        hessian = lambda z: density_hessian(z, *args)  # noqa: E731
        z_map, T, _ = hessian_preconditioner(value_and_grad, hessian, z0,
                                             chain_sharding=kwargs.get("chain_sharding"))
        result = run_mcmc(preconditioned_potential(value_and_grad, T, z_map),
                          torch.zeros_like(z_map), generator, **run)
        result = result._replace(samples=unwhiten_samples(result.samples, T, z_map))
    elif precondition is not None:
        raise ValueError(
            f"Unknown precondition option: {precondition!r}. "
            'Available options are "hessian" and None.'
        )
    else:
        result = run_mcmc(value_and_grad, z0, generator, **run)
    if not function_samples:
        return result, None
    flat = result.samples.reshape(-1, result.samples.shape[-1])
    return result, estimator.transform(flat.T).T


# ---------------------------------------------------------------------------
# Hessian preconditioning: dense-metric NUTS through a potential transform
# ---------------------------------------------------------------------------


def hessian_preconditioner(value_and_grad, hessian, z0, chain_sharding=None):
    """The whitening of Hessian-preconditioned sampling from a near-MAP z0:
    the Newton-polished z* (:func:`newton_polish`) and T = R⁻ᵀ with
    H(z*) + NEWTON_JITTER·I = R Rᵀ.  Returns ``(z_map, T, (‖g‖ before, after))``.

    ``value_and_grad`` and ``hessian`` may be cell-sharded
    (``loss_func.value_and_grad`` and ``loss_func.hessian`` of
    :func:`..parallel.shard_density_model`): the polish steers by the
    potential and ‖g‖, all-reduced and so equal on the ranks of a cells
    group, which therefore take the same steps.  With the chains split
    over ranks (``chain_sharding``), the blocks merge dual averaging's and
    Welford's statistics, so every block must whiten with the same bits,
    which cells groups on other cards need not compute: z* and T are then
    rank 0's, sent to every rank in one broadcast.
    """
    z_map, gn0, gn1 = newton_polish(value_and_grad, hessian, z0)
    T = precondition_transform(hessian_cholesky(hessian(z_map)))
    sharding = check_sharding(chain_sharding, "chain_sharding")
    if sharding is not None and sharding.size > 1:
        both = broadcast_from_first_rank(torch.cat([z_map[None], T]))
        z_map, T = both[0], both[1:]
    return z_map, T, (gn0, gn1)


def autograd_hessian(potential):
    """``z -> H`` of a row-wise torch potential ``Z (C, k) -> (C,)`` by
    autograd: the Hessian of potentials without a closed form (the tests'
    small targets)."""

    def hessian(z):
        return torch.autograd.functional.hessian(lambda v: potential(v[None])[0], z)

    return hessian


def hessian_cholesky(H, jitter=NEWTON_JITTER):
    """Lower Cholesky factor R of the Hessian H (H + jitter·I = R Rᵀ), in
    H's dtype.  H is symmetrized and factored in float64 on its device,
    the jitter raised ×10 while the factorization fails (up to 8 tries,
    from max(jitter, 1e-12)): the MAP Hessian of a large density model is
    too ill-conditioned for a float32 factor that still whitens."""
    H64 = H.to(torch.float64)
    R64 = _cholesky_f64_rescue(0.5 * (H64 + H64.T), jitter)
    if R64 is None:
        raise ValueError(
            "The Hessian is not factorizable in float64 even after jitter escalation."
        )
    return R64.to(H.dtype)


def precondition_transform(R):
    """T = R⁻ᵀ, computed in float64 and returned in R's dtype: in w
    coordinates z = z* + T w, one (k, k) product per leapfrog."""
    R64 = R.to(torch.float64)
    eye = torch.eye(R.shape[0], dtype=torch.float64, device=R.device)
    return torch.linalg.solve_triangular(R64.T, eye, upper=True).to(R.dtype)


def preconditioned_potential(value_and_grad, T, z_map):
    """The potential of w with z = z_map + T w, batched: the gradient in w
    is Tᵀ∇z, row by row g @ T."""

    def potential(W):
        values, grads = value_and_grad(z_map + W @ T.T)
        return values, grads @ T

    return potential


def unwhiten_samples(samples_w, T, z_map, block=65536):
    """w-space draws back to z = z_map + T w, over blocks of draws."""
    shape = samples_w.shape
    flat = samples_w.reshape(-1, shape[-1])
    out = torch.cat([z_map + flat[s : s + block] @ T.T for s in range(0, flat.shape[0], block)])
    return out.reshape(shape)


def newton_polish(value_and_grad, hessian, z0, iters=10, jitter=NEWTON_JITTER, tol=1e-8):
    """Newton iterations from a near-MAP point z0 of the batched potential,
    with ``hessian(z) -> (k, k)``: each step factors H + jitter·I in the
    potential's dtype (in float64 when that fails) and halves the step up
    to 5 times while the potential does not decrease.  Stops once
    ‖g‖ ≤ tol·max(1, |potential|).  Returns (z, ‖g‖ before, ‖g‖ after)."""

    def evaluate(z):
        v, g = value_and_grad(z[None])
        v, g = v[0], g[0]
        value, gnorm = torch.stack([v, torch.linalg.vector_norm(g)]).tolist()
        return value, g, gnorm

    z = z0
    value, g, gnorm = evaluate(z)
    gn0 = gnorm
    for _ in range(int(iters)):
        if gnorm <= tol * max(1.0, abs(value)):
            break
        H = hessian(z)
        R, ok = _jittered_cholesky(0.5 * (H + H.T), jitter)
        if not bool(ok):
            R = hessian_cholesky(H, jitter)
        dz = torch.cholesky_solve(g[:, None], R)[:, 0]
        step = 1.0
        for _try in range(5):
            z_new = z - step * dz
            v_new, g_new, gn_new = evaluate(z_new)
            if np.isfinite(v_new) and v_new <= value:
                z, value, g, gnorm = z_new, v_new, g_new, gn_new
                break
            step *= 0.5
        else:
            break  # no decrease: keep the best point found
    logger.info("Newton polish: |grad| %.3g -> %.3g (potential %.6g).", gn0, gnorm, value)
    return z, gn0, gnorm
