"""Operations of the estimators on tensors: kernels, neighbours,
clustering, factorizations (the names of ``mellon_tpu.ops``)."""

from .kernels import (
    Add,
    Covariance,
    CovariancePair,
    ExpQuad,
    Exponential,
    Linear,
    Matern32,
    Matern52,
    Mul,
    Pow,
    RatQuad,
)
from .linalg import (
    DEFAULT_RANK,
    DEFAULT_SIGMA,
    _eigendecomposition,
    _full_decomposition_low_rank,
    _full_rank,
    _modified_low_rank,
    _standard_low_rank,
    ridge_solve,
    safe_cholesky,
    solve_psd_from_cholesky,
)
from .neighbors import knn, knn_distances, local_dimensionality, nn_distances
from .cluster import k_means
