"""L-BFGS and adam for the MAP fit (counterpart of
``mellon_tpu/inference/optimizers.py``).

adam (:func:`minimize_adam`) follows ``optax.adam`` with the JAX package's
schedule; its update is :func:`adam_step`, which ADVI reuses.

The JAX package runs ``optax.lbfgs`` inside one ``lax.while_loop``.  This
is the same method written for PyTorch: memory 10, the two-loop recursion
with the identity scaled by sᵀy/yᵀy (and by min(1, 1/‖g‖) on the first
step), a strong-Wolfe zoom line search that starts every iteration at step
1 (c1 = 1e-4, c2 = 0.9, at most 20 evaluations, doubling while
bracketing), and the stopping rule ‖g‖ < tol·max(1, |loss|) with
max_iter = 400 and tol = 1e-5.  Like optax, sufficient decrease is
Armijo's condition or, close to the minimum where float32 cannot resolve
the Armijo decrease, Hager and Zhang's approximate one (slope at most
(2c1 − 1) times the initial slope, loss at most 1e-6·|loss| above the
start).  Where the line search finds no such step within its budget, the
lowest loss that decreased is taken; where none decreased, the run stops
(optax would move to its last trial).

Host reads: the line search decides on the host, so every loss evaluation
ends in exactly one read of a small tensor (the loss, the slope along the
direction and the gradient norm, which the stopping rule reuses).  A step
that takes its first trial costs one evaluation and one read; ``n_evals``
in the result is therefore also the number of host reads.  The two-loop
recursion itself stays on the device.
"""

import logging
import math
from collections import deque, namedtuple

import torch

logger = logging.getLogger("mellon_tpu_torch")

DEFAULT_OPTIMIZER = "L-BFGS-B"
# accepted by minimize_lbfgsb and ignored: PyTorch runs eagerly
DEFAULT_JIT = False
DEFAULT_LBFGS_MAX_ITER = 400
DEFAULT_LBFGS_TOL = 1e-5
DEFAULT_MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4  # c1, sufficient decrease
CURV_RTOL = 0.9  # c2, strong curvature
APPROX_DEC_RTOL = 1e-6  # approximate-decrease slack, relative to |loss|

DEFAULT_N_ITER = 100
DEFAULT_INIT_LEARN_RATE = 1e-1
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8  # added outside the square root, as optax's eps
LEARN_RATE_DECAY = 1e-2  # the rate at step i is exp(-0.01 i)·lr0

# phase_steps: (bf16 steps, float32 steps) of a two-phase run, else None
LBFGSResult = namedtuple(
    "LBFGSResult", "pre_transformation loss n_steps n_evals converged phase_steps",
    defaults=(None,),
)
ResultsLoss = namedtuple("Results", "pre_transformation opt_state loss")
AdamResult = namedtuple("AdamResult", "pre_transformation opt_state losses")
AdamState = namedtuple("AdamState", "count mu nu")
_Trial = namedtuple("_Trial", "step phi dphi gnorm z value grad")


def _two_loop(grad, history, gamma):
    """L-BFGS inverse-Hessian product H·grad from the stored pairs
    (s, y, rho), oldest first; a pair with rho = 0 contributes nothing."""
    q = grad
    alphas = []
    for s, y, rho in reversed(history):
        a = rho * torch.dot(s, q)
        alphas.append(a)
        q = q - a * y
    r = gamma * q
    for (s, y, rho), a in zip(history, reversed(alphas)):
        b = rho * torch.dot(y, r)
        r = r + s * (a - b)
    return r


def _interpolate(lo, hi):
    """Minimizer of the cubic through the bracket ends, kept inside the
    middle 80% of the bracket; bisection where the cubic does not help."""
    a, b = lo.step, hi.step
    mid = (a + b) / 2
    if not all(math.isfinite(v) for v in (lo.phi, lo.dphi, hi.phi, hi.dphi)) or a == b:
        return mid
    d1 = lo.dphi + hi.dphi - 3 * (lo.phi - hi.phi) / (a - b)
    disc = d1 * d1 - lo.dphi * hi.dphi
    if disc < 0:
        return mid
    d2 = math.copysign(math.sqrt(disc), b - a)
    denom = hi.dphi - lo.dphi + 2 * d2
    if denom == 0:
        return mid
    t = b - (b - a) * (hi.dphi + d2 - d1) / denom
    low, high = min(a, b), max(a, b)
    margin = 0.1 * (high - low)
    if not (low + margin <= t <= high - margin):
        return mid
    return t


def _line_search(fun, z, value, grad, direction, phi0):
    """Strong-Wolfe zoom line search (Nocedal & Wright, Alg. 3.5/3.6).
    Returns (trial, dphi0, number of evaluations); the trial is None when
    no step decreased the loss."""
    dphi0_dev = torch.dot(grad, direction)
    dphi0 = None
    tried = []

    def evaluate(step):
        nonlocal dphi0
        z_t = z + step * direction
        v, g = fun(z_t)
        parts = [v, torch.dot(g, direction), torch.linalg.vector_norm(g)]
        if dphi0 is None:
            parts.append(dphi0_dev)
        host = torch.stack(parts).tolist()
        if dphi0 is None:
            dphi0 = host[3]
        trial = _Trial(step, host[0], host[1], host[2], z_t, v, g)
        tried.append(trial)
        return trial

    def decreases(t):
        if not math.isfinite(t.phi):
            return False
        armijo = t.phi <= phi0 + SLOPE_RTOL * t.step * dphi0
        approx = (
            t.dphi <= (2 * SLOPE_RTOL - 1) * dphi0
            and t.phi <= phi0 + APPROX_DEC_RTOL * abs(phi0)
        )
        return armijo or approx

    def too_long(t, ref_phi):
        return not decreases(t) or t.phi >= ref_phi

    def zoom(lo, hi):
        while len(tried) < MAX_LINESEARCH_STEPS:
            if abs(hi.step - lo.step) <= 1e-12 * max(1.0, lo.step):
                return None
            t = evaluate(_interpolate(lo, hi))
            if too_long(t, lo.phi):
                hi = t
            else:
                if abs(t.dphi) <= CURV_RTOL * abs(dphi0):
                    return t
                if t.dphi * (hi.step - lo.step) >= 0:
                    hi = lo
                lo = t
        return None

    prev = _Trial(0.0, phi0, None, None, z, value, grad)
    step = 1.0
    found = None
    while len(tried) < MAX_LINESEARCH_STEPS:
        t = evaluate(step)
        if dphi0 >= 0:
            return None, dphi0, len(tried)
        if prev.dphi is None:
            prev = prev._replace(dphi=dphi0)
        if too_long(t, prev.phi if prev.step > 0 else math.inf):
            found = zoom(prev, t)
            break
        if abs(t.dphi) <= CURV_RTOL * abs(dphi0):
            found = t
            break
        if t.dphi >= 0:
            found = zoom(t, prev)
            break
        prev = t
        step *= 2.0
    if found is None:
        # no point met both Wolfe conditions within the budget: take the
        # lowest loss among the sufficiently decreasing steps
        safe = [t for t in tried if decreases(t)]
        found = min(safe, key=lambda t: t.phi) if safe else None
    return found, dphi0, len(tried)


def bf16_operands(loss_args):
    """The loss operands with every 2-d float32 tensor rounded to
    bfloat16 (round to nearest even, as XLA's convert)."""
    return tuple(
        a.to(torch.bfloat16)
        if isinstance(a, torch.Tensor) and a.ndim == 2 and a.dtype == torch.float32
        else a
        for a in loss_args
    )


def minimize_lbfgs(
    value_and_grad,
    initial_value,
    max_iter=DEFAULT_LBFGS_MAX_ITER,
    tol=DEFAULT_LBFGS_TOL,
    memory_size=DEFAULT_MEMORY_SIZE,
    precision=None,
    make_value_and_grad=None,
    loss_args=(),
):
    """Minimize ``value_and_grad(z) -> (loss, grad)`` from ``initial_value``.

    Stops once ‖g‖ < tol·max(1, |loss|) (after at least one step), after
    ``max_iter`` steps, or when the line search finds no decrease; the
    result's ``converged`` says whether the first of these held.

    ``precision="bf16"`` runs two phases, as the JAX package does:
    max(3·max_iter // 4, 1) steps on ``make_value_and_grad(*loss_args)``
    with every 2-d float32 operand stored as bfloat16 (:func:`bf16_operands`),
    then max(max_iter − that, 1) steps on ``value_and_grad`` from the first
    phase's optimum.  Without ``loss_args`` (and a ``make_value_and_grad``
    to build the loss from them) it runs the single float32 phase.  The
    result's ``n_steps`` and ``n_evals`` cover both phases.
    """
    if precision == "bf16" and (make_value_and_grad is None or not loss_args):
        logger.info(
            "precision='bf16' has no effect without operand-threaded "
            "loss_args; running the single-phase f32 solve."
        )
        precision = None
    if precision == "bf16":
        coarse_iter = max(int(max_iter) * 3 // 4, 1)
        polish_iter = max(int(max_iter) - coarse_iter, 1)
        coarse = _lbfgs(make_value_and_grad(*bf16_operands(loss_args)), initial_value,
                        coarse_iter, tol, memory_size)
        fine = _lbfgs(value_and_grad, coarse.pre_transformation, polish_iter, tol, memory_size)
        logger.info(
            "L-BFGS finished after %d bf16 + %d f32 steps with loss %.6g.",
            coarse.n_steps,
            fine.n_steps,
            fine.loss,
        )
        return fine._replace(n_steps=coarse.n_steps + fine.n_steps,
                             n_evals=coarse.n_evals + fine.n_evals,
                             phase_steps=(coarse.n_steps, fine.n_steps))
    if precision is not None and precision != "f32":
        raise ValueError(f"Unknown precision option: {precision}")
    result = _lbfgs(value_and_grad, initial_value, max_iter, tol, memory_size)
    logger.info("L-BFGS finished after %d steps with loss %.6g.", result.n_steps, result.loss)
    return result


def _autograd_value_and_grad(loss_func, *loss_args):
    """``z -> (loss, gradient)`` of the scalar torch loss
    ``loss_func(z, *loss_args)`` by autograd."""

    def value_and_grad(z):
        with torch.enable_grad():
            zg = z.detach().requires_grad_(True)
            value = loss_func(zg, *loss_args)
            (grad,) = torch.autograd.grad(value, zg)
        return value.detach(), grad

    return value_and_grad


def minimize_lbfgsb(
    loss_func,
    initial_value,
    jit=DEFAULT_JIT,
    max_iter=DEFAULT_LBFGS_MAX_ITER,
    tol=DEFAULT_LBFGS_TOL,
    loss_args=(),
    precision=None,
):
    """:func:`minimize_lbfgs` under the JAX package's name and signature:
    ``loss_func(z, *loss_args)`` is a scalar torch loss, differentiated by
    autograd; ``precision="bf16"`` runs the two phases on ``loss_args``
    (:func:`bf16_operands`); ``jit`` is ignored.  Returns ``(pre_transformation,
    opt_state, loss)`` with the :class:`LBFGSResult` as ``opt_state``."""
    result = minimize_lbfgs(
        _autograd_value_and_grad(loss_func, *loss_args),
        initial_value,
        max_iter=max_iter,
        tol=tol,
        precision=precision,
        make_value_and_grad=lambda *args: _autograd_value_and_grad(loss_func, *args),
        loss_args=tuple(loss_args),
    )
    return ResultsLoss(result.pre_transformation, result, result.loss)


def _lbfgs(value_and_grad, initial_value, max_iter, tol, memory_size):
    fun = value_and_grad
    z = initial_value.clone()
    value, grad = fun(z)
    phi, gnorm = torch.stack([value, torch.linalg.vector_norm(grad)]).tolist()
    n_evals = 1
    history = deque(maxlen=memory_size)
    gamma = min(1.0, 1.0 / gnorm) if gnorm > 0 else 1.0
    count = 0
    while count == 0 or (count < max_iter and gnorm >= tol * max(1.0, abs(phi))):
        if not math.isfinite(phi):
            logger.warning("L-BFGS stopped at a non-finite loss %s.", phi)
            break
        direction = -_two_loop(grad, history, gamma)
        trial, dphi0, evals = _line_search(fun, z, value, grad, direction, phi)
        n_evals += evals
        if trial is None and dphi0 >= 0 and history:
            # the quasi-Newton direction is not a descent direction:
            # forget the curvature pairs and retry along the gradient
            history.clear()
            direction = -min(1.0, 1.0 / gnorm) * grad
            trial, _, evals = _line_search(fun, z, value, grad, direction, phi)
            n_evals += evals
        if trial is None:
            logger.info(
                "L-BFGS line search found no decrease after %d steps "
                "(gradient norm %.3g); stopping.",
                count,
                gnorm,
            )
            break
        s = trial.z - z
        y = trial.grad - grad
        sy = torch.dot(s, y)
        yy = torch.dot(y, y)
        # pairs without positive curvature are kept inert (rho = 0)
        rho = torch.where(sy > 0, 1.0 / sy, torch.zeros_like(sy))
        history.append((s, y, rho))
        gamma = torch.where((sy > 0) & (yy > 0), sy / yy, torch.ones_like(sy))
        z, value, grad, phi, gnorm = trial.z, trial.value, trial.grad, trial.phi, trial.gnorm
        count += 1
    return LBFGSResult(z, phi, count, n_evals, gnorm < tol * max(1.0, abs(phi)))


def adam_init(params):
    """adam's state for a tuple of parameter tensors."""
    zeros = tuple(torch.zeros_like(p) for p in params)
    return AdamState(0, zeros, zeros)


def adam_step(params, grads, state, init_learn_rate):
    """One ``optax.adam`` step (β₁ 0.9, β₂ 0.999, ε 1e-8 outside the root,
    bias correction) on a tuple of tensors, at the learning rate
    exp(−0.01·i)·lr0 of the step count i before this step (0 on the first).
    Returns ``(params, state)``; the count stays on the host."""
    rate = math.exp(-LEARN_RATE_DECAY * state.count) * init_learn_rate
    count = state.count + 1
    new_params, mus, nus = [], [], []
    for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
        mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
        nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu
        mu_hat = mu / (1 - ADAM_B1**count)
        nu_hat = nu / (1 - ADAM_B2**count)
        new_params.append(p - rate * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)))
        mus.append(mu)
        nus.append(nu)
    return tuple(new_params), AdamState(count, tuple(mus), tuple(nus))


def minimize_adam(
    value_and_grad,
    initial_value,
    n_iter=DEFAULT_N_ITER,
    init_learn_rate=DEFAULT_INIT_LEARN_RATE,
):
    """``n_iter`` adam steps on ``value_and_grad(z) -> (loss, grad)`` from
    ``initial_value``.  Nothing is read on the host: the losses before each
    step come back as one tensor."""
    params = (initial_value.clone(),)
    state = adam_init(params)
    losses = []
    for _ in range(int(n_iter)):
        value, grad = value_and_grad(params[0])
        losses.append(value)
        params, state = adam_step(params, (grad,), state, init_learn_rate)
    losses = torch.stack(losses) if losses else initial_value.new_empty(0)
    return AdamResult(params[0], state, losses)
