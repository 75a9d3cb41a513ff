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

The public functions take the JAX package's arguments: a scalar
``potential_fn(z, *potential_args)`` (:func:`.samplers.as_batched` says
how it is evaluated; ``losses.density_loss`` in closed form), and a
``torch.Generator`` where JAX takes a key.  The port's own forms, on a
batched potential, a Hessian matrix or a Hessian function, keep names of
their own: :func:`newton_polish_value_and_grad`, :func:`factor_hessian`,
:func:`precondition_value_and_grad` and :func:`zero_centered_density_potential`.
"""

import logging
from typing import NamedTuple

import numpy as np
import torch

from ..ops.linalg import _cholesky_f64_rescue, _jittered_cholesky
from ..parallel.mesh import broadcast_from_first_rank, check_sharding, sampling_block
from .losses import BatchedPotential, density_hessian, density_loss
from .optimizers import bf16_operands
from .samplers import (
    ScalarPotential,
    as_batched,
    as_draws,
    da_init,
    da_update,
    hmc_init,
    hmc_kernel,
    nuts_kernel,
    welford_init,
    welford_merge,
    welford_update,
    welford_variance,
)

logger = logging.getLogger("mellon_tpu_torch")

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
    """The batched transition of ``algorithm`` on a batched potential."""
    if algorithm == "nuts":
        return nuts_kernel(value_and_grad, max_tree_depth=int(max_tree_depth))
    if algorithm == "hmc":
        return hmc_kernel(value_and_grad, num_steps=int(num_leapfrog_steps))
    raise ValueError(f"Unknown MCMC algorithm: {algorithm}")


class _Counted(BatchedPotential):
    """A batched potential, counting the rows it evaluates."""

    def __init__(self, value_and_grad):
        super().__init__(value_and_grad)
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
    potential_fn,
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
    potential_args=(),
):
    """Sample from exp(−potential_fn) with NUTS or HMC.

    ``potential_fn(z, *potential_args)`` is the negative log density of one
    latent vector z (k,); every chain is evaluated at once through
    :func:`.samplers.as_batched` (``losses.density_loss`` in closed form, a
    :class:`..losses.BatchedPotential` such as
    ``losses.make_density_value_and_grad_batch(...)`` as it is, any other
    torch function by ``torch.func.vmap``).  ``z0`` is (k,) or
    (num_chains, k); a single row is spread over the chains by
    0.1·N(0, I).  ``generator`` is a ``torch.Generator`` on z0's device (or
    a :class:`.samplers.Draws` source), where the JAX package takes a key.
    Returns an :class:`MCMCResult` with samples of shape (num_chains,
    num_samples, k).

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
    potential = _Counted(as_batched(potential_fn, potential_args))
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
    potential_fn,
    z0,
    generator,
    step_size,
    inv_mass_diag,
    num_samples=500,
    algorithm="nuts",
    max_tree_depth=10,
    num_leapfrog_steps=32,
    chain_sharding=None,
    potential_args=(),
):
    """Continue sampling from the chains' last positions ``z0`` with an
    adapted ``step_size`` and ``inv_mass_diag``: no warmup, fresh momenta
    (exact: the momentum is drawn anew at every transition anyway).
    ``potential_fn``, ``potential_args`` and ``chain_sharding`` as in
    :func:`run_mcmc`, on any mesh: the run that is resumed may have had
    another."""
    check_sharding(chain_sharding, "chain_sharding")
    draws = as_draws(generator)
    z0 = torch.atleast_2d(z0)
    sharding, z0, draws = sampling_block(chain_sharding, z0, draws, "chains")
    potential = _Counted(as_batched(potential_fn, potential_args))
    kernel = _kernel_for(potential, algorithm, max_tree_depth, num_leapfrog_steps)
    states = hmc_init(potential, z0)
    step_size = torch.as_tensor(step_size, dtype=z0.dtype, device=z0.device)
    inv_mass = torch.as_tensor(inv_mass_diag, dtype=z0.dtype, device=z0.device)
    draws.phase(None, int(num_samples))
    return _gather_result(
        _sample(kernel, states, draws, step_size, inv_mass, int(num_samples), potential), sharding)


def zero_centered_potential(potential_fn, z0, potential_args):
    """The density potential re-centred to ~0 at ``z0``: returns
    ``(potential_fn, potential_args)`` with ``loss_offset_per_term`` =
    loss(z0)/n (as a float32 number) and ``center`` z0 appended to the
    operands, for which ``losses.density_loss`` computes its z-dependent
    part around z0 (the ``centered_operands`` of its
    :func:`.samplers.as_batched` form).  Any other potential, or one whose
    operands already carry an offset, comes back unchanged, as in the JAX
    package.

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
    centered_operands = as_batched(potential_fn, potential_args).centered_operands
    if centered_operands is None:
        return potential_fn, potential_args
    return potential_fn, centered_operands(z0)


def zero_centered_density_potential(z0, L, nn_distances, d, mu):
    """:func:`zero_centered_potential` of the density loss as the batched
    potential (a :class:`..losses.BatchedPotential`), and its offset."""
    potential_fn, args = zero_centered_potential(density_loss, z0, (L, nn_distances, d, mu))
    return as_batched(potential_fn, args), args[4]


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

    ``precision="bf16"`` samples, polishes and whitens with every 2-d
    float32 operand in bfloat16 (:func:`.optimizers.bf16_operands`), the
    JAX package's bf16 function (:mod:`.losses`), and logs its warning:
    the function samples come from the float32 L.
    """
    if estimator.loss_func is None:
        raise ValueError("Estimator not prepared. Call prepare_inference(x) first.")
    args = (estimator.L, estimator.nn_distances, estimator.d, estimator.mu)
    if precision == "bf16":
        logger.warning(
            "precision='bf16' sampling failed the JAX package's round-5 posterior-agreement "
            "check on its 100k-cell benchmark model, run on a TPU "
            "(benchdata/logs_r5/bf16_agreement_direct_r5.log): the ~1e-3 perturbation of "
            "the latent function acts as high-frequency potential noise, trees ran to the "
            "depth cap and posterior stds were biased in 92% of dimensions.  This samples "
            "the same bf16 function.  Use it only with your own agreement check; the "
            "float32 default is certified."
        )
        args = bf16_operands(args)
    elif precision is not None:
        raise ValueError(f"Unknown precision option: {precision}")
    z0 = estimator.initial_value
    if getattr(estimator, "pre_transformation", None) is not None:
        z0 = estimator.pre_transformation
    value_and_grad, _ = zero_centered_density_potential(z0, *args)
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
        result = run_mcmc(precondition_value_and_grad(value_and_grad, T, z_map),
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
    the Newton-polished z* (:func:`newton_polish_value_and_grad`) and T = R⁻ᵀ with
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
    z_map, gn0, gn1 = newton_polish_value_and_grad(value_and_grad, hessian, z0)
    T = precondition_transform(factor_hessian(hessian(z_map)))
    sharding = check_sharding(chain_sharding, "chain_sharding")
    if sharding is not None and sharding.size > 1:
        both = broadcast_from_first_rank(torch.cat([z_map[None], T]))
        z_map, T = both[0], both[1:]
    return z_map, T, (gn0, gn1)


def _hvp_hessian(potential_fn, potential_args, z, block):
    """The Hessian of the scalar ``potential_fn(z, *potential_args)`` at z
    from forward-over-reverse Hessian-vector products with the basis
    vectors, ``block`` of them at a time (the JAX package's
    ``_hessian_block``)."""
    grad = torch.func.grad(lambda v: potential_fn(v, *potential_args))
    k = z.shape[-1]
    eye = torch.eye(k, dtype=z.dtype, device=z.device)

    def hvp(e):
        return torch.func.jvp(grad, (z,), (e,))[1]

    return torch.cat([torch.func.vmap(hvp)(eye[s : s + block]) for s in range(0, k, block)])


def hessian_of(potential_fn, potential_args=(), block=512):
    """``z -> H``, the Hessian of ``potential_fn(z, *potential_args)``: the
    closed form where its batched form (:func:`.samplers.as_batched`) has
    one (the density loss's :func:`..losses.density_hessian`, also the
    cell-sharded one), else blocked Hessian-vector products of the scalar
    function; a :class:`..losses.BatchedPotential` without one raises."""
    batched = as_batched(potential_fn, potential_args)
    if batched.hessian is not None:
        return batched.hessian
    if isinstance(potential_fn, BatchedPotential):
        raise TypeError(
            "This batched potential has no Hessian; pass the scalar potential_fn."
        )
    return lambda z: _hvp_hessian(potential_fn, potential_args, z, int(block))


def hessian_cholesky(potential_fn, z_map, jitter, *potential_args, block=512, host_f64=True):
    """Lower Cholesky factor R of the potential's Hessian at ``z_map``
    (H + jitter·I = R Rᵀ), as the JAX package's: H from
    :func:`hessian_of` (``block`` basis vectors per vmapped group of
    Hessian-vector products), factored by :func:`factor_hessian` in
    float64 on the device, which the JAX package does on the host.
    ``host_f64`` is accepted and ignored: the factor is always the float64
    one."""
    return factor_hessian(hessian_of(potential_fn, potential_args, block)(z_map), float(jitter))


def factor_hessian(H, jitter=NEWTON_JITTER):
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


def preconditioned_potential(potential_fn):
    """``pot(w, T, z_map, *args)`` = ``potential_fn(z_map + T w, *args)``,
    the JAX package's wrapper (T = R⁻ᵀ, :func:`precondition_transform`).
    It remembers its base: batched, it is
    :func:`precondition_value_and_grad` of the base's batched form, so a
    base of ``losses.density_loss`` runs in closed form."""

    def pot(w, T, z_map, *args):
        return potential_fn(z_map + T @ w, *args)

    def batched(T, z_map, *args):
        return precondition_value_and_grad(as_batched(potential_fn, args), T, z_map)

    return ScalarPotential(pot, batched)


def precondition_value_and_grad(value_and_grad, T, z_map):
    """The potential of w with z = z_map + T w, batched: the gradient in w
    is Tᵀ∇z, row by row g @ T."""

    def potential(W):
        values, grads = value_and_grad(z_map + W @ T.T)
        return values, grads @ T

    return BatchedPotential(potential)


def unwhiten_samples(samples_w, T, z_map, block=65536):
    """w-space draws back to z = z_map + T w, over blocks of draws."""
    shape = samples_w.shape
    flat = samples_w.reshape(-1, shape[-1])
    out = torch.cat([z_map + flat[s : s + block] @ T.T for s in range(0, flat.shape[0], block)])
    return out.reshape(shape)


def newton_polish(potential_fn, z0, potential_args=(), iters=10, jitter=NEWTON_JITTER, tol=1e-8):
    """Newton iterations from a near-MAP point z0 of ``potential_fn(z,
    *potential_args)``, as the JAX package's: the potential through
    :func:`.samplers.as_batched`, the Hessian through :func:`hessian_of`
    (:func:`newton_polish_value_and_grad`).  Returns (z, ‖g‖ before,
    ‖g‖ after)."""
    return newton_polish_value_and_grad(
        as_batched(potential_fn, potential_args), hessian_of(potential_fn, potential_args), z0,
        iters=iters, jitter=jitter, tol=tol)


def newton_polish_value_and_grad(value_and_grad, hessian, z0, iters=10, jitter=NEWTON_JITTER,
                                 tol=1e-8):
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
            R = factor_hessian(H, jitter)
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
