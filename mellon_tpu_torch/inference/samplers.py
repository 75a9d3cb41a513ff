"""HMC and NUTS over a batch of chains (counterpart of
``mellon_tpu/inference/samplers.py``).

The JAX package writes one chain's transition and ``vmap``s it.  Under
``vmap`` every chain that is still building its tree is at the same tree
depth and the same leaf index: all start at 0 and advance together, and a
chain that has stopped is frozen by the batched loop's select.  This module
runs the chains in that lockstep directly:

* the tree depth and the leaf index are Python integers shared by the
  chains, with a per-chain ``active`` mask; every carried tensor advances
  only under ``torch.where(active, new, old)``;
* the checkpoint ranges of the U-turn test (:func:`_leaf_checkpoint_idxs`)
  are host integer arithmetic;
* each leaf makes one batched potential call for all chains,
  ``value_and_grad(Z (C, k)) -> (values (C,), grads (C, k))``;
* the leaf loop learns whether any chain is still active by one host read
  per leaf (the kernel's ``host_reads`` counts them); nothing else is read.

Every random number comes from a :class:`Draws` source, which the tests
replace with one that replays the JAX package's key schedule.

One deliberate divergence: a NUTS transition counts the leapfrog steps it
really took (:func:`_subtree_steps`).  The JAX package adds 2**depth for a
subtree even when it stopped early on a U-turn or a divergence, which
reports too many steps and too low an acceptance probability, and so
pushes dual averaging's step size down.
"""

import copy
import math
from typing import NamedTuple

import torch

DIVERGENCE_THRESHOLD = 1000.0


class Draws:
    """The samplers' random numbers, from one ``torch.Generator``.

    The samplers ask for each draw by what it is for, in the order they
    use them.  Here every request is a standard normal or uniform tensor
    from the generator on the operands' device; a generator on another
    device than the operands is refused, not copied across.  A source
    that replays another package's stream overrides the named requests.

    A chain block (:meth:`chain_block`) draws the global shape, all the
    chains' numbers, and keeps this rank's rows: the ranks of a chain-
    sharded run never share a stream, and a run whose ranks make the same
    requests (HMC, SMC) draws what the unsharded run draws.
    """

    # (start, stop, total): the rows this source keeps of ``total`` chains
    block = None

    def __init__(self, generator):
        self.generator = generator

    def chain_block(self, start, stop, total):
        """A copy of this source on the same generator that keeps chains
        ``start:stop`` of ``total``."""
        blocked = copy.copy(self)
        blocked.block = (start, stop, total)
        return blocked

    def _check(self, like):
        device = torch.device(self.generator.device)
        # a CUDA generator made for "cuda" reports no index: the current card
        if device.type != like.device.type or device.index not in (None, like.device.index):
            raise ValueError(
                f"The random generator is on {self.generator.device} but the "
                f"sampler's operands are on {like.device}; pass a generator "
                "on the operands' device."
            )

    def _draw(self, sample, shape, like):
        self._check(like)
        if self.block is None or len(shape) == 0:
            return sample(shape, generator=self.generator, dtype=like.dtype, device=like.device)
        start, stop, total = self.block
        full = sample((total, *shape[1:]), generator=self.generator, dtype=like.dtype,
                      device=like.device)
        return full[start:stop]

    def normal(self, shape, like):
        return self._draw(torch.randn, shape, like)

    def uniform(self, shape, like):
        return self._draw(torch.rand, shape, like)

    def phase(self, index, num_transitions):
        """A run of ``num_transitions`` transitions starts: warmup phase
        ``index`` 0-2 or sampling 3 of ``run_mcmc``, or ``None`` for
        ``resume_mcmc``.  Nothing to do for a generator."""

    def jitter(self, shape, like):
        """``run_mcmc``'s spread of a one-row start over the chains."""
        return self.normal(shape, like)

    def momentum(self, shape, like):
        """The momentum that starts a transition (standard normal)."""
        return self.normal(shape, like)

    def direction(self, n, like):
        """NUTS: the uniform that picks the direction of a doubling."""
        return self.uniform((n,), like)

    def leaf(self, n, like):
        """NUTS: the uniform of a leaf's multinomial choice."""
        return self.uniform((n,), like)

    def subtree_accept(self, n, like):
        """NUTS: the uniform that takes a doubling's proposal."""
        return self.uniform((n,), like)

    def hmc_accept(self, n, like):
        """HMC: the uniform of the Metropolis test."""
        return self.uniform((n,), like)


def as_draws(generator):
    """A :class:`Draws` source from a ``torch.Generator`` (or the source)."""
    return generator if isinstance(generator, Draws) else Draws(generator)


def batched_value_and_grad(potential):
    """A row-wise potential ``Z (C, k) -> (C,)`` in torch ops as the
    samplers' ``Z -> (values (C,), grads (C, k))``, by autograd (for small
    targets such as the tests' Gaussians)."""

    def value_and_grad(Z):
        with torch.enable_grad():
            Zg = Z.detach().requires_grad_(True)
            values = potential(Zg)
            (grads,) = torch.autograd.grad(values.sum(), Zg)
        return values.detach(), grads

    return value_and_grad


def _where(mask, new, old):
    """Rows of ``new`` where ``mask`` (C,) holds, else rows of ``old``."""
    return torch.where(mask.view((-1,) + (1,) * (new.dim() - 1)), new, old)


def _where_tuple(mask, new, old):
    return type(new)(*(_where(mask, a, b) for a, b in zip(new, old)))


# ---------------------------------------------------------------------------
# leapfrog
# ---------------------------------------------------------------------------


class IntegratorState(NamedTuple):
    z: torch.Tensor  # (C, k)
    r: torch.Tensor  # (C, k)
    potential: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, k)


def _leapfrog(value_and_grad, inv_mass_diag, step_size, state):
    """One leapfrog step of every chain; ``step_size`` is a 0-d tensor or
    one per chain, (C, 1)."""
    return _scaled_leapfrog(value_and_grad, 0.5 * step_size, step_size * inv_mass_diag, state)


def _scaled_leapfrog(value_and_grad, half_step, step_mass, state):
    """:func:`_leapfrog` with its factors 0.5·ε and ε·M⁻¹ computed once by
    the caller: the same numbers, fewer launches per step in NUTS's leaf
    loop."""
    z, r, _, grad = state
    r = r - half_step * grad
    z = z + step_mass * r
    potential, grad = value_and_grad(z)
    r = r - half_step * grad
    return IntegratorState(z, r, potential, grad)


def _kinetic(inv_mass_diag, r):
    return 0.5 * torch.sum(r * r * inv_mass_diag, dim=-1)


# ---------------------------------------------------------------------------
# HMC kernel
# ---------------------------------------------------------------------------


class HMCState(NamedTuple):
    z: torch.Tensor
    potential: torch.Tensor
    grad: torch.Tensor


class HMCInfo(NamedTuple):
    accept_prob: torch.Tensor
    diverging: torch.Tensor
    num_steps: torch.Tensor
    energy: torch.Tensor


def hmc_init(value_and_grad, z0):
    """The chains' state at the rows of ``z0`` (C, k)."""
    potential, grad = value_and_grad(z0)
    return HMCState(z0, potential, grad)


def hmc_kernel(value_and_grad, num_steps=32, divergence_threshold=DIVERGENCE_THRESHOLD):
    """Fixed-trajectory-length HMC with a Metropolis correction; returns
    ``step(state, draws, step_size, inv_mass_diag) -> (state, info)``.  It
    reads nothing on the host (``step.host_reads`` stays 0)."""

    def step(state, draws, step_size, inv_mass_diag):
        z = state.z
        r0 = draws.momentum(z.shape, z) / torch.sqrt(inv_mass_diag)
        energy0 = state.potential + _kinetic(inv_mass_diag, r0)
        s = IntegratorState(z, r0, state.potential, state.grad)
        for _ in range(num_steps):
            s = _leapfrog(value_and_grad, inv_mass_diag, step_size, s)
        energy1 = s.potential + _kinetic(inv_mass_diag, s.r)
        delta = energy1 - energy0
        delta = torch.where(torch.isnan(delta), math.inf, delta)
        diverging = delta > divergence_threshold
        accept_prob = torch.clamp(torch.exp(-delta), max=1.0)
        accept = draws.hmc_accept(z.shape[0], z) < accept_prob
        new_state = _where_tuple(accept, HMCState(s.z, s.potential, s.grad), state)
        steps = torch.full_like(accept, num_steps, dtype=torch.int64)
        return new_state, HMCInfo(accept_prob, diverging, steps, energy1)

    step.host_reads = 0
    return step


# ---------------------------------------------------------------------------
# NUTS kernel (iterative, multinomial)
# ---------------------------------------------------------------------------


class _TreeState(NamedTuple):
    z_proposal: torch.Tensor
    potential_proposal: torch.Tensor
    grad_proposal: torch.Tensor
    z_left: torch.Tensor
    r_left: torch.Tensor
    grad_left: torch.Tensor
    potential_left: torch.Tensor
    z_right: torch.Tensor
    r_right: torch.Tensor
    grad_right: torch.Tensor
    potential_right: torch.Tensor
    r_sum: torch.Tensor
    weight: torch.Tensor  # logsumexp of -(energy - energy0) over the trajectory
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept_prob: torch.Tensor
    num_steps: torch.Tensor


def _is_turning(inv_mass_diag, r_left, r_right, r_sum):
    """Generalized U-turn criterion on the momentum sum (over the last axis)."""
    v = inv_mass_diag * r_sum
    turn_left = torch.sum(v * r_left, dim=-1) <= 0
    turn_right = torch.sum(v * r_right, dim=-1) <= 0
    return turn_left | turn_right


def _leaf_checkpoint_idxs(n):
    """``(idx_min, idx_max)``: the checkpoints leaf n (0-based, within its
    subtree) is tested against.  idx_max is the number of set bits of
    n >> 1 and idx_max - idx_min + 1 the number of trailing set bits of n:
    the power-of-two scheme that makes the iterative tree equal the
    recursive one.  An even leaf stores its checkpoint at idx_max."""
    idx_max = bin(n >> 1).count("1")
    trailing_ones = (n ^ (n + 1)).bit_length() - 1
    return idx_max - trailing_ones + 1, idx_max


def _iterative_turning_check(inv_mass_diag, idx_min, idx_max, r, r_sum, r_ckpts, r_sum_ckpts):
    """A new odd leaf against the checkpoints idx_min..idx_max of every
    chain: turning where any aligned subtree ending at it makes a U-turn."""
    ck_r = r_ckpts[:, idx_min : idx_max + 1]
    sub_r_sum = r_sum[:, None] - r_sum_ckpts[:, idx_min : idx_max + 1] + ck_r
    return _is_turning(inv_mass_diag, ck_r, r[:, None], sub_r_sum).any(dim=1)


def _subtree_steps(leaves_run, depth):
    """Leapfrog steps a doubling of ``depth`` added: the leaves each chain
    really ran.  The JAX package counts 2**depth here, also for a subtree
    that stopped early (ROADMAP Queue 3, "The NUTS step count")."""
    return leaves_run


def nuts_kernel(value_and_grad, max_tree_depth=10, divergence_threshold=DIVERGENCE_THRESHOLD):
    """One NUTS transition of every chain: iterative tree doubling with
    multinomial sampling.  Returns ``step(state, draws, step_size,
    inv_mass_diag) -> (state, info)``; ``step.host_reads`` counts the
    host reads of the active mask (one per leaf after the first of a
    doubling, and one per doubling after the first)."""

    def any_active(active):
        step.host_reads += 1
        return bool(active.any())

    def build_subtree(tree, draws, depth, direction, step_size, inv_mass_diag, energy0, active):
        """Up to 2**depth leapfrog steps in ``direction`` from the moving
        end of every active chain's trajectory, with the checkpoints of
        the U-turn test; a chain stops at a U-turn or a divergence.

        A chain that is not active stays so for the rest of the
        transition: its tree stopped before this doubling (the caller
        keeps its old tree) or stops at it (U-turn or divergence, so the
        transition's proposal, acceptance and step count are all that is
        used of it).  So only the proposal and the counters are masked;
        the leaves go on computing its trajectory unmasked."""
        C, dim = tree.z_left.shape
        like = tree.z_left
        right = direction > 0
        eps = torch.where(right, step_size, -step_size)[:, None]
        half_step, step_mass = 0.5 * eps, eps * inv_mass_diag
        state = IntegratorState(
            _where(right, tree.z_right, tree.z_left),
            _where(right, tree.r_right, tree.r_left),
            _where(right, tree.potential_right, tree.potential_left),
            _where(right, tree.grad_right, tree.grad_left),
        )
        sub_r_sum = torch.zeros_like(like)
        sub_weight = torch.full((C,), -math.inf, dtype=like.dtype, device=like.device)
        z_prop, pot_prop, grad_prop = state.z, state.potential, state.grad
        turning = torch.zeros(C, dtype=torch.bool, device=like.device)
        diverging = torch.zeros_like(turning)
        sum_accept = torch.zeros_like(sub_weight)
        leaves = torch.zeros(C, dtype=torch.int64, device=like.device)
        r_ckpts = like.new_zeros((C, max_tree_depth, dim))
        r_sum_ckpts = like.new_zeros((C, max_tree_depth, dim))

        for leaf_idx in range(2**depth):
            if leaf_idx > 0 and not any_active(active):
                break
            state = _scaled_leapfrog(value_and_grad, half_step, step_mass, state)
            energy = torch.nan_to_num(state.potential + _kinetic(inv_mass_diag, state.r),
                                      nan=math.inf, posinf=math.inf, neginf=-math.inf)
            # log weight of the leaf relative to the start, -(energy - energy0)
            leaf_weight = energy0 - energy
            leaf_diverging = leaf_weight < -divergence_threshold
            accept_prob = torch.clamp(torch.exp(leaf_weight), max=1.0)
            sub_weight_new = torch.logaddexp(sub_weight, leaf_weight)
            # progressive multinomial sampling within the subtree
            take = active & (draws.leaf(C, like) < torch.exp(leaf_weight - sub_weight_new))
            sub_weight = sub_weight_new
            sub_r_sum = sub_r_sum + state.r

            # checkpointing: even leaves store, odd leaves test
            idx_min, idx_max = _leaf_checkpoint_idxs(leaf_idx)
            if leaf_idx % 2 == 0:
                r_ckpts[:, idx_max] = state.r
                r_sum_ckpts[:, idx_max] = sub_r_sum
                stop = leaf_diverging
            else:
                leaf_turning = _iterative_turning_check(
                    inv_mass_diag, idx_min, idx_max, state.r, sub_r_sum, r_ckpts, r_sum_ckpts
                )
                turning = turning | (active & leaf_turning)
                stop = leaf_turning | leaf_diverging

            rows = take[:, None]
            z_prop = torch.where(rows, state.z, z_prop)
            pot_prop = torch.where(take, state.potential, pot_prop)
            grad_prop = torch.where(rows, state.grad, grad_prop)
            diverging = diverging | (active & leaf_diverging)
            sum_accept = torch.where(active, sum_accept + accept_prob, sum_accept)
            leaves += active
            active = active & ~stop

        return (state, sub_r_sum, sub_weight, z_prop, pot_prop, grad_prop,
                turning, diverging, sum_accept, _subtree_steps(leaves, depth))

    def step(state, draws, step_size, inv_mass_diag):
        z = state.z
        C = z.shape[0]
        r0 = draws.momentum(z.shape, z) / torch.sqrt(inv_mass_diag)
        energy0 = state.potential + _kinetic(inv_mass_diag, r0)
        no = torch.zeros(C, dtype=torch.bool, device=z.device)
        tree = _TreeState(
            z_proposal=z,
            potential_proposal=state.potential,
            grad_proposal=state.grad,
            z_left=z,
            r_left=r0,
            grad_left=state.grad,
            potential_left=state.potential,
            z_right=z,
            r_right=r0,
            grad_right=state.grad,
            potential_right=state.potential,
            r_sum=r0,
            weight=torch.zeros_like(state.potential),
            turning=no,
            diverging=no,
            sum_accept_prob=torch.zeros_like(state.potential),
            num_steps=torch.zeros(C, dtype=torch.int64, device=z.device),
        )
        active = ~no
        for depth in range(max_tree_depth):
            if depth > 0 and not any_active(active):
                break
            direction = torch.where(draws.direction(C, z) < 0.5, -1, 1)
            (end, sub_r_sum, sub_weight, z_prop, pot_prop, grad_prop,
             sub_turning, sub_diverging, sum_accept, n_steps) = build_subtree(
                tree, draws, depth, direction, step_size, inv_mass_diag, energy0, active
            )
            # biased progressive sampling between the old tree and the subtree
            take_new = (
                (torch.log(draws.subtree_accept(C, z)) < sub_weight - tree.weight)
                & ~sub_turning & ~sub_diverging
            )
            went_right = direction > 0
            r_left = _where(went_right, tree.r_left, end.r)
            r_right = _where(went_right, end.r, tree.r_right)
            new_r_sum = tree.r_sum + sub_r_sum
            new_tree = _TreeState(
                z_proposal=_where(take_new, z_prop, tree.z_proposal),
                potential_proposal=torch.where(take_new, pot_prop, tree.potential_proposal),
                grad_proposal=_where(take_new, grad_prop, tree.grad_proposal),
                z_left=_where(went_right, tree.z_left, end.z),
                r_left=r_left,
                grad_left=_where(went_right, tree.grad_left, end.grad),
                potential_left=torch.where(went_right, tree.potential_left, end.potential),
                z_right=_where(went_right, end.z, tree.z_right),
                r_right=r_right,
                grad_right=_where(went_right, end.grad, tree.grad_right),
                potential_right=torch.where(went_right, end.potential, tree.potential_right),
                r_sum=new_r_sum,
                weight=torch.logaddexp(tree.weight, sub_weight),
                # U-turn across the whole (doubled) trajectory
                turning=sub_turning | _is_turning(inv_mass_diag, r_left, r_right, new_r_sum),
                diverging=sub_diverging,
                sum_accept_prob=tree.sum_accept_prob + sum_accept,
                num_steps=tree.num_steps + n_steps,
            )
            tree = _where_tuple(active, new_tree, tree)
            active = active & ~tree.turning & ~tree.diverging

        # the proposal's gradient is carried through the tree for this
        # hand-off: no extra potential call per transition
        new_state = HMCState(tree.z_proposal, tree.potential_proposal, tree.grad_proposal)
        accept_prob = tree.sum_accept_prob / torch.clamp_min(tree.num_steps, 1)
        info = HMCInfo(accept_prob, tree.diverging, tree.num_steps, tree.potential_proposal)
        return new_state, info

    step.host_reads = 0
    return step


# ---------------------------------------------------------------------------
# warmup adaptation: dual averaging + diagonal Welford mass
# ---------------------------------------------------------------------------


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    gradient_avg: torch.Tensor
    t: torch.Tensor
    mu: torch.Tensor


def da_init(step_size):
    """Dual averaging from ``step_size``, a 0-d tensor on the chains' device."""
    log_step = torch.log(step_size)
    zero = torch.zeros_like(log_step)
    return DualAveragingState(log_step, log_step, zero, zero, torch.log(10 * step_size))


def da_update(state, accept_prob, target=0.8, gamma=0.05, t0=10.0, kappa=0.75):
    """One dual-averaging step towards ``target`` acceptance, on the device."""
    t = state.t + 1
    g = target - accept_prob
    gradient_avg = (1 - 1 / (t + t0)) * state.gradient_avg + g / (t + t0)
    log_step = state.mu - torch.sqrt(t) / gamma * gradient_avg
    eta = t**-kappa
    log_step_avg = eta * log_step + (1 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, gradient_avg, t, state.mu)


class WelfordState(NamedTuple):
    mean: torch.Tensor
    m2: torch.Tensor
    count: torch.Tensor


def welford_init(dim, dtype=torch.float32, device=None):
    zeros = torch.zeros(dim, dtype=dtype, device=device)
    return WelfordState(zeros, zeros, torch.zeros((), dtype=dtype, device=device))


def welford_update(state, x):
    count = state.count + 1
    delta = x - state.mean
    mean = state.mean + delta / count
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(mean, m2, count)


def welford_merge(state, count, mean, m2):
    """``state`` combined with the summary (``count`` rows, their ``mean``
    and ``m2``) of more rows: Chan, Golub and LeVeque's pairwise update,
    equal to feeding those rows to :func:`welford_update` up to rounding."""
    total = state.count + count
    delta = mean - state.mean
    new_mean = state.mean + delta * (count / total)
    new_m2 = state.m2 + m2 + delta * delta * (state.count * count / total)
    return WelfordState(new_mean, new_m2, total)


def welford_variance(state, regularize=True):
    var = state.m2 / torch.clamp_min(state.count - 1, 1)
    if regularize:
        # Stan's shrinkage towards unit variance
        n = state.count
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var
