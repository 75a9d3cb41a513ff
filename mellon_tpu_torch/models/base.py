"""Shared estimator machinery: validated constructor, lazy attribute
preparation, the landmark factorization with its float32 policies, and
the optimizer dispatch (counterpart of ``mellon_tpu/models/base.py``).

The optimizers and the Laplace step see the latents flattened: the
estimator provides ``_value_and_grad``, ``_loss_batch`` and
``_hessian_diagonal`` on the flattened vector (and, for the two-phase
``precision="bf16"`` MAP, ``_make_value_and_grad`` with ``_loss_args``;
for NUTS, ``_sampler_potential`` and ``_sampler_hessian``), and the
fitted latents take the initial value's shape again ((k,) for the
density, (2, k) for the dimensionality model).

A float32 landmark kernel that does not factor is pruned to its
pivoted-Cholesky subset, or, with ``config.PRUNE_SINGULAR_LANDMARKS``
off, kept whole with a float64 factor (and, with
``config.EXTENDED_PRECISION_WHITEN``, L built in float64).  The sparse
Nyström type above :data:`..ops.linalg.NYSTROEM_EXACT_MAX` landmarks
prunes the same way before its whitened eigensolver, as the JAX
package's fused Nyström prepare does.

Every tensor of an estimator lives on its ``device`` in its ``dtype``
(``cuda`` and float32 unless asked otherwise).
"""

import logging
import math
import time

import numpy as np
import torch

from .. import config
from ..config import resolve_device_dtype
from ..inference.advi import run_advi
from ..inference.conditionals import _landmarks_lp_with_pruning
from ..inference.diagnostics import effective_sample_size
from ..inference.laplace import compute_laplace_std
from ..inference.losses import make_density_loglik_batch, make_density_value_and_grad_batch
from ..inference.mcmc import (
    BF16_SAMPLING,
    hessian_cholesky,
    newton_polish,
    precondition_transform,
    preconditioned_potential,
    run_mcmc,
    unwhiten_samples,
)
from ..inference.optimizers import (
    DEFAULT_INIT_LEARN_RATE,
    DEFAULT_N_ITER,
    DEFAULT_OPTIMIZER,
    minimize_adam,
    minimize_lbfgs,
)
from ..inference.smc import laplace_start, run_smc
from ..ops.kernels import Matern52
from ..ops.linalg import (
    NYSTROEM_EXACT_MAX,
    _cholesky_f64_rescue,
    _jittered_cholesky,
    _nystroem_select_and_project,
    _standard_low_rank,
    safe_cholesky,
)
from ..parameters import (
    DEFAULT_RANDOM_SEED,
    compute_cov_func,
    compute_gp_type,
    compute_L,
    compute_landmarks,
    compute_Lp,
    compute_ls,
    compute_n_landmarks,
    compute_nn_distances,
    compute_rank,
)
from ..utils.parameter_validation import (
    validate_cov_func,
    validate_cov_func_curry,
    validate_params,
)
from ..utils.util import DEFAULT_JITTER, GaussianProcessType, object_str, test_rank
from ..utils.validation import (
    validate_array,
    validate_bool,
    validate_float,
    validate_float_or_int,
    validate_float_or_iterable_numerical,
    validate_nn_distances,
    validate_positive_float,
    validate_positive_int,
    validate_string,
)

DEFAULT_COV_FUNC = Matern52
RANK_FRACTION_THRESHOLD = 0.8
SAMPLE_LANDMARK_RATIO = 10

OPTIMIZERS = ("adam", "advi", "L-BFGS-B", "nuts", "smc")
PRECISIONS = (None, "f32", "bf16")

# ``sampler_options=`` keys of optimizer="nuts" and optimizer="smc", as in
# the JAX package.  "steps_per_call" bounds one compiled XLA program's run
# time there; it is validated and ignored here (PyTorch runs eagerly).
_NUTS_OPTION_KEYS = {
    "num_chains",
    "num_warmup",
    "num_samples",
    "target_accept",
    "max_tree_depth",
    "initial_step_size",
    "steps_per_call",
    "precondition",
}
_SMC_OPTION_KEYS = {
    "num_particles",
    "target_ess_frac",
    "num_mutation_steps",
    "mutation_step_size",
    "num_leapfrog_steps",
    "max_stages",
    "start",
}
# string-valued options with their allowed values
_STR_SAMPLER_OPTIONS = {
    "start": ("prior", "laplace"),
    "precondition": ("hessian",),
}
_SAMPLER_OPTION_KEYS = _NUTS_OPTION_KEYS | _SMC_OPTION_KEYS
# count-valued options: the samplers int()-cast these, so 0.5 would become 0
_INT_SAMPLER_OPTION_KEYS = {
    "num_chains",
    "num_warmup",
    "num_samples",
    "max_tree_depth",
    "num_particles",
    "num_mutation_steps",
    "num_leapfrog_steps",
    "max_stages",
    "steps_per_call",
}

logger = logging.getLogger("mellon_tpu_torch")


def _validate_sampler_options(options):
    """Validate the ``sampler_options`` dict (None -> {}), with the JAX
    package's messages."""
    if options is None:
        return {}
    if not isinstance(options, dict):
        raise ValueError(
            "sampler_options must be a dict of sampler settings, got "
            f"{type(options).__name__}."
        )
    unknown = set(options) - _SAMPLER_OPTION_KEYS
    if unknown:
        raise ValueError(
            f"Unknown sampler_options key(s) {sorted(unknown)}. "
            f"NUTS accepts {sorted(_NUTS_OPTION_KEYS)}; "
            f"SMC accepts {sorted(_SMC_OPTION_KEYS)}."
        )
    for name, value in options.items():
        if name in _STR_SAMPLER_OPTIONS:
            if value not in _STR_SAMPLER_OPTIONS[name]:
                raise ValueError(
                    f"sampler_options[{name!r}] must be one of "
                    f"{_STR_SAMPLER_OPTIONS[name]}, got {value!r}."
                )
            continue
        # finiteness first: inf would overflow int() below, and NaN passes
        # `value <= 0`
        if (
            isinstance(value, bool)
            or not isinstance(value, (int, float))
            or not math.isfinite(value)
            or value <= 0
        ):
            raise ValueError(
                f"sampler_options[{name!r}] must be a positive number, got {value!r}."
            )
        if name in _INT_SAMPLER_OPTION_KEYS and value != int(value):
            raise ValueError(
                f"sampler_options[{name!r}] must be a positive integer, got {value!r}."
            )
    return dict(options)


class BaseEstimator:
    """Base class of the estimators."""

    def __init__(
        self,
        cov_func_curry=DEFAULT_COV_FUNC,
        n_landmarks=None,
        rank=None,
        jitter=DEFAULT_JITTER,
        optimizer=DEFAULT_OPTIMIZER,
        n_iter=DEFAULT_N_ITER,
        init_learn_rate=DEFAULT_INIT_LEARN_RATE,
        landmarks=None,
        gp_type=None,
        nn_distances=None,
        d=None,
        mu=0,
        ls=None,
        ls_factor=1,
        cov_func=None,
        Lp=None,
        L=None,
        initial_value=None,
        predictor_with_uncertainty=False,
        jit=False,
        check_rank=None,
        random_state=DEFAULT_RANDOM_SEED,
        precision=None,
        sampler_options=None,
        device=None,
        dtype=None,
    ):
        if precision not in PRECISIONS:
            raise ValueError(
                f"Unknown precision option: {precision!r}. "
                'Available options are "bf16", "f32" and None.'
            )
        if precision == "bf16" and optimizer in ("nuts", "smc"):
            raise NotImplementedError(BF16_SAMPLING)
        self.precision = precision
        self.device, self.dtype = resolve_device_dtype(device, dtype)
        self.optimizer = validate_string(optimizer, "optimizer", choices=set(OPTIMIZERS))
        self.n_iter = validate_positive_int(n_iter, "n_iter")
        self.init_learn_rate = validate_positive_float(init_learn_rate, "init_learn_rate")
        self.predictor_with_uncertainty = validate_bool(
            predictor_with_uncertainty, "predictor_with_uncertainty"
        )
        # accepted for the JAX package's signature: PyTorch runs eagerly
        self.jit = validate_bool(jit, "jit")
        array = dict(optional=True, dtype=self.dtype, device=self.device)
        self.cov_func_curry = validate_cov_func_curry(cov_func_curry, cov_func, "cov_func_curry")
        self.n_landmarks = validate_positive_int(n_landmarks, "n_landmarks", optional=True)
        self.random_state = validate_positive_int(random_state, "random_state", optional=True)
        self.rank = validate_float_or_int(rank, "rank", optional=True)
        self.jitter = validate_positive_float(jitter, "jitter")
        self.landmarks = validate_array(landmarks, "landmarks", **array)
        self.gp_type = GaussianProcessType.from_string(gp_type, optional=True)
        self.nn_distances = validate_nn_distances(
            validate_array(nn_distances, "nn_distances", **array), optional=True
        )
        self.mu = validate_float(mu, "mu", optional=True)
        self.ls = validate_positive_float(ls, "ls", optional=True)
        self.ls_factor = validate_positive_float(ls_factor, "ls_factor")
        self.cov_func = validate_cov_func(cov_func, "cov_func", optional=True)
        self.Lp = validate_array(Lp, "Lp", **array)
        self.L = validate_array(L, "L", **array)
        self.d = validate_float_or_iterable_numerical(d, "d", optional=True, positive=True)
        if isinstance(self.d, torch.Tensor):
            self.d = self.d.to(device=self.device, dtype=self.dtype)
        self.initial_value = validate_array(initial_value, "initial_value", **array)
        self.check_rank = validate_bool(check_rank, "check_rank", optional=True)
        self.sampler_options = _validate_sampler_options(sampler_options)
        self.x = None
        self.pre_transformation = None
        # the float64 landmark factor of a full-capacity fit
        self._f64_Lp = None

    def __repr__(self):
        return (
            f"{self.__class__.__name__}("
            f"\n    cov_func={self.cov_func},"
            f"\n    device={self.device}, dtype={self.dtype},"
            f"\n    gp_type={self.gp_type},"
            f"\n    jitter={self.jitter},"
            f"\n    landmarks={object_str(self.landmarks, ['landmarks', 'dims'])},"
            f"\n    L={object_str(self.L, ['cells', 'ranks'])},"
            f"\n    ls={self.ls},"
            f"\n    mu={self.mu},"
            f"\n    n_landmarks={self.n_landmarks},"
            f"\n    optimizer={self.optimizer},"
            f"\n    predictor_with_uncertainty={self.predictor_with_uncertainty},"
            f"\n    random_state={self.random_state},"
            "\n)"
        )

    def set_x(self, x):
        """Validate and pin the training data on the estimator's device."""
        if self.x is not None and x is not None and self.x is not x:
            message = "self.x has been set already, but is not equal to the argument x."
            logger.error(message)
            raise ValueError(message)
        if self.x is None and x is None:
            message = "Required argument x is missing and self.x has not been set."
            logger.error(message)
            raise ValueError(message)
        if x is None:
            x = self.x
        self.x = validate_array(x, "x", ndim=2, dtype=self.dtype, device=self.device)
        return self.x

    def _compute_n_landmarks(self):
        return compute_n_landmarks(self.gp_type, self.x.shape[0], self.landmarks)

    def _compute_rank(self):
        return compute_rank(self.gp_type)

    def _compute_gp_type(self):
        return compute_gp_type(self.n_landmarks, self.rank, self.x.shape[0])

    def _landmark_seed(self):
        """The k-means seed, after the advice for many cells and few
        landmarks."""
        n_samples = self.x.shape[0]
        if n_samples > 100 * self.n_landmarks and n_samples > 1e6:
            logger.info(
                f"Large number of {n_samples:,} cells and small number of "
                f"{self.n_landmarks:,} landmarks. Consider computing k-means on a "
                "subset of cells and passing the results as 'landmarks' to speed "
                "up the process."
            )
        return self.random_state if self.random_state is not None else DEFAULT_RANDOM_SEED

    def _compute_landmarks(self):
        return compute_landmarks(
            self.x, self.gp_type, n_landmarks=self.n_landmarks, random_state=self._landmark_seed()
        )

    def _compute_nn_distances(self):
        logger.info("Computing nearest neighbor distances.")
        return validate_nn_distances(compute_nn_distances(self.x))

    def _compute_ls(self):
        return compute_ls(self.nn_distances) * self.ls_factor

    def _compute_cov_func(self):
        cov_func = compute_cov_func(self.cov_func_curry, self.ls)
        logger.info("Using covariance function %s.", str(cov_func))
        return cov_func

    def _lp_accept_or_prune(self, K, L, ok):
        """The float32 landmark factor after the Cholesky attempt (L, ok)
        of K: L itself where it factored; else, by default, the
        pivoted-Cholesky subset of the landmarks and its factor; with
        ``config.PRUNE_SINGULAR_LANDMARKS`` off, every landmark with a
        float64 factor of the kernel rebuilt in float64 from their
        coordinates (kept for :meth:`_compute_L`; Lp is its float32 cast),
        or, where even that fails, the escalated float32 factor."""
        if bool(ok):
            return L
        if not config.PRUNE_SINGULAR_LANDMARKS:
            logger.warning(
                "Landmark kernel is singular at f32; keeping all %d "
                "landmarks (pruning disabled) and factorizing once in float64.",
                self.landmarks.shape[0],
            )
            xu = self.landmarks.double()
            K64 = K.double() if self.cov_func is None else self.cov_func(xu, xu)
            L64 = _cholesky_f64_rescue(K64, self.jitter)
            if L64 is None:
                return safe_cholesky(K, jitter=self.jitter, max_tries=3)
            self._f64_Lp = L64
            return L64.to(K.dtype)
        landmarks, Lp = _landmarks_lp_with_pruning(
            self.landmarks, self.cov_func, self.jitter, K=K, known_singular=True
        )
        self._set_pruned_landmarks(landmarks)
        return Lp

    def _set_pruned_landmarks(self, landmarks):
        if landmarks is self.landmarks:
            return
        self.landmarks = landmarks
        self.n_landmarks = int(landmarks.shape[0])
        if self.check_rank is None:
            # rank is known by construction; skip the SVD check
            self.check_rank = False

    def _compute_Lp(self):
        # float32 sparse case: accept, prune or keep every landmark in
        # float64 (_lp_accept_or_prune)
        if (
            self.landmarks is not None
            and self.gp_type
            in (GaussianProcessType.SPARSE_CHOLESKY, GaussianProcessType.FIXED)
            and self.dtype != torch.float64
        ):
            K = self.cov_func(self.landmarks, self.landmarks)
            L, ok = _jittered_cholesky(K, self.jitter)
            return self._lp_accept_or_prune(K, L, ok)
        return compute_Lp(
            self.x, self.cov_func, self.gp_type, self.landmarks, sigma=0, jitter=self.jitter
        )

    def _whiten_f64(self):
        """L = k(x, xu) Lp⁻ᵀ in float64 against the float64 landmark factor
        (the kernel tile's float64 entry, a float64 triangular solve), cast
        to the estimator's dtype."""
        logger.info(
            "Whitening %s cells against the float64 landmark factor in float64.",
            f"{self.x.shape[0]:,}",
        )
        L = _standard_low_rank(
            self.x.double(), self.cov_func, self.landmarks.double(), Lp=self._f64_Lp
        )
        return L.to(self.dtype)

    def _nystroem_L(self):
        """The sparse Nyström L above NYSTROEM_EXACT_MAX landmarks: the
        landmark factor (at float32 pruned to the pivoted-Cholesky subset
        where the kernel does not factor), H = k(x, xu) Lp⁻ᵀ and the mass
        selection on HᵀH; Lp itself is not kept (the predictor builds
        its own)."""
        landmarks, Lp = _landmarks_lp_with_pruning(self.landmarks, self.cov_func, self.jitter)
        self._set_pruned_landmarks(landmarks)
        H = _standard_low_rank(self.x, self.cov_func, landmarks, Lp=Lp)
        return _nystroem_select_and_project(H, self.rank)

    def _compute_L(self):
        n_samples = self.x.shape[0]
        gp_type = self.gp_type
        if (
            self._f64_Lp is not None
            and config.EXTENDED_PRECISION_WHITEN
            and self.landmarks is not None
            and gp_type in (GaussianProcessType.SPARSE_CHOLESKY, GaussianProcessType.FIXED)
        ):
            L = self._whiten_f64()
        elif (
            gp_type == GaussianProcessType.SPARSE_NYSTROEM
            and self.landmarks is not None
            and NYSTROEM_EXACT_MAX < self.landmarks.shape[0] < n_samples
        ):
            L = self._nystroem_L()
        else:
            L = compute_L(
                self.x,
                self.cov_func,
                gp_type,
                landmarks=self.landmarks,
                Lp=self.Lp,
                rank=self.rank,
                sigma=0,
                jitter=self.jitter,
            )
        new_rank = L.shape[1]
        n_landmarks = n_samples if self.landmarks is None else self.landmarks.shape[0]
        if gp_type in (
            GaussianProcessType.SPARSE_NYSTROEM,
            GaussianProcessType.FULL_NYSTROEM,
        ) and new_rank > (self.rank * RANK_FRACTION_THRESHOLD * n_landmarks):
            logger.warning(
                f"Shallow rank reduction from {n_landmarks:,} to {new_rank:,} "
                "indicates underrepresentation by landmarks. Consider "
                "increasing n_landmarks!"
            )
        check_rank = self.check_rank
        if (
            check_rank is None
            and gp_type == GaussianProcessType.SPARSE_CHOLESKY
            and SAMPLE_LANDMARK_RATIO * n_landmarks < n_samples
        ) or bool(check_rank):
            logger.info(
                "Estimating approximation accuracy "
                f"since {n_samples:,} samples are more than "
                f"{SAMPLE_LANDMARK_RATIO} x {n_landmarks:,} landmarks."
            )
            test_rank(L, threshold=RANK_FRACTION_THRESHOLD)
        logger.info(f"Using rank {new_rank:,} covariance representation.")
        return L

    def validate_parameter(self):
        """Cross-check the parameter combination."""
        validate_params(
            self.rank, self.gp_type, self.x.shape[0], self.n_landmarks, self.landmarks
        )

    def _run_inference(self):
        """Fit the latents with the estimator's optimizer; with
        ``predictor_with_uncertainty``, their stds come from ADVI, NUTS or
        SMC or, after L-BFGS or adam, from the diagonal Laplace
        approximation."""
        optimizer = self.optimizer
        logger.info("Running inference using %s.", optimizer)
        self.pre_transformation_std = None
        shape = self.initial_value.shape
        z0 = self.initial_value.reshape(-1)
        if optimizer == "adam":
            results = minimize_adam(
                self._value_and_grad,
                z0,
                n_iter=self.n_iter,
                init_learn_rate=self.init_learn_rate,
            )
            self.pre_transformation = results.pre_transformation.reshape(shape)
            self.losses = results.losses
            self.opt_state = results.opt_state
        elif optimizer == "advi":
            seed = self.random_state if self.random_state is not None else DEFAULT_RANDOM_SEED
            results = run_advi(
                self._loss_batch,
                z0,
                n_iter=self.n_iter,
                init_learn_rate=self.init_learn_rate,
                generator=torch.Generator(device=self.device).manual_seed(seed),
            )
            self.pre_transformation = results.pre_transformation.reshape(shape)
            self.pre_transformation_std = results.pre_transformation_std.reshape(shape)
            self.losses = results.losses
        elif optimizer == "nuts":
            self._run_nuts()
        elif optimizer == "smc":
            self._run_smc()
        else:
            results = minimize_lbfgs(
                self._value_and_grad,
                z0,
                precision=self.precision,
                make_value_and_grad=getattr(self, "_make_value_and_grad", None),
                loss_args=getattr(self, "_loss_args", ()),
            )
            self.pre_transformation = results.pre_transformation.reshape(shape)
            self.losses = [results.loss]
            self.opt_state = results
        if self.predictor_with_uncertainty and self.pre_transformation_std is None:
            logger.info("Computing Laplace approximation for posterior uncertainty.")
            self.pre_transformation_std = compute_laplace_std(
                self._hessian_diagonal(self.pre_transformation.reshape(-1))
            ).reshape(shape)

    def _sampler_generator(self):
        seed = self.random_state if self.random_state is not None else DEFAULT_RANDOM_SEED
        return torch.Generator(device=self.device).manual_seed(seed)

    def _run_nuts(self):
        """The full posterior by NUTS over the flattened latents; the
        draws' mean and std (ddof 0) become the latents and their stds,
        in the initial value's shape, and ``posterior_samples`` is
        (chains, draws, *that shape).

        The chains start at the L-BFGS MAP, where the potential is
        zero-centred (the estimator's ``_sampler_potential``), as
        ``sample_density_posterior`` does for a fitted estimator.  The JAX
        package's estimator path starts them at the warm start and does
        not centre (ROADMAP Queue 3): there the loss is ~1e7 at the bench
        shape against ~4e4 at the MAP, and centring at the warm start
        would leave the posterior's potential at ~1e7, whose float32
        rounding froze NUTS on the H100 (step size 1e-5, every tree at the
        depth cap)."""
        opts = {
            "num_warmup": max(self.n_iter, 200),
            "num_samples": max(self.n_iter, 200),
            "num_chains": 4,
            "target_accept": 0.8,
            "max_tree_depth": 10,
            "initial_step_size": 0.1,
        }
        opts.update({k: v for k, v in self.sampler_options.items() if k in _NUTS_OPTION_KEYS})
        precondition = opts.pop("precondition", None)
        shape = self.initial_value.shape
        z0 = minimize_lbfgs(self._value_and_grad, self.initial_value.reshape(-1)).pre_transformation
        potential = self._sampler_potential(z0)
        if precondition == "hessian":
            z_map, _, _ = newton_polish(potential, self._sampler_hessian, z0)
            T = precondition_transform(hessian_cholesky(self._sampler_hessian(z_map), self.jitter))
            potential = preconditioned_potential(potential, T, z_map)
            z0 = torch.zeros_like(z_map)
        for key in ("num_warmup", "num_samples", "num_chains", "max_tree_depth"):
            opts[key] = int(opts[key])
        start = time.perf_counter()
        result = run_mcmc(potential, z0, self._sampler_generator(), **opts)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.sampling_time = time.perf_counter() - start
        if precondition == "hessian":
            result = result._replace(samples=unwhiten_samples(result.samples, T, z_map))
        flat = result.samples.reshape(-1, result.samples.shape[-1])
        self.pre_transformation = flat.mean(dim=0).reshape(shape)
        self.pre_transformation_std = flat.std(dim=0, correction=0).reshape(shape)
        self.posterior_samples = (
            result.samples if len(shape) == 1
            else result.samples.reshape(result.samples.shape[:2] + shape)
        )
        self.mcmc_result = result
        self.losses = result.potential.reshape(-1)
        # the north-star throughput metric: effective samples per second
        self.ess = effective_sample_size(result.samples)
        self.ess_per_second = float(self.ess.min() / self.sampling_time)
        logger.info(
            "NUTS: %d draws in %.2fs; ESS min/median %.0f/%.0f "
            "(%.1f effective samples/s, min-ESS basis).",
            flat.shape[0], self.sampling_time, float(self.ess.min()),
            float(np.median(self.ess)), self.ess_per_second,
        )

    def _run_smc(self):
        """The posterior by SMC from the prior (or, with ``start:
        "laplace"``, from the diagonal Laplace Gaussian at the L-BFGS MAP);
        the particles' mean and std (ddof 0) become the latents and their
        stds."""
        if self.initial_value.ndim != 1:
            raise ValueError("optimizer='smc' currently supports 1-d latent vectors.")
        opts = {"num_particles": 1024}
        opts.update({k: v for k, v in self.sampler_options.items() if k in _SMC_OPTION_KEYS})
        for key in _INT_SAMPLER_OPTION_KEYS & set(opts):
            opts[key] = int(opts[key])
        start = opts.pop("start", "prior")
        if start == "laplace":
            loglik, prior_kwargs = laplace_start(
                make_density_value_and_grad_batch(*self._loss_args), self.initial_value,
                self._hessian_diagonal,
            )
        else:
            loglik, prior_kwargs = make_density_loglik_batch(*self._loss_args), {}
        result = run_smc(loglik, int(self.initial_value.shape[0]), self._sampler_generator(),
                         dtype=self.dtype, **prior_kwargs, **opts)
        self.pre_transformation = result.particles.mean(dim=0)
        self.pre_transformation_std = result.particles.std(dim=0, correction=0)
        self.posterior_samples = result.particles
        self.smc_result = result
        self.losses = [-result.log_evidence]

    def _prepare_attribute(self, attribute):
        """Lazy attribute computation via the ``_compute_<attr>`` convention."""
        if getattr(self, attribute) is not None:
            return
        setattr(self, attribute, getattr(self, "_compute_" + attribute)())
