"""Validation and foundation utilities (the names of ``mellon_tpu.utils``
but ``set_jax_config``, which configures JAX)."""

from .util import (
    DEFAULT_JITTER,
    GaussianProcessType,
    add_diagonal,
    add_variance,
    batched_vmap,
    distance,
    distance_grad,
    deserialize,
    ensure_2d,
    expand_to_inactive,
    make_multi_time_argument,
    make_serializable,
    mle,
    object_html,
    object_str,
    select_active_dims,
    set_verbosity,
    stabilize,
    test_rank,
)
from . import validation
from . import parameter_validation
