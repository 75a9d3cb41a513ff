"""The Nyström GP types of mellon_tpu_torch against mellon_tpu: the
eigenpair selection, the randomized eigensolver, the full and the
improved (sparse) Nyström factors on both sides of NYSTROEM_EXACT_MAX,
the whitened sketch route, whole fits, and the float32 landmark prune.

Eigenvectors are defined only up to sign (and within a degenerate
eigenspace only the space is), and ``torch.linalg.eigh`` need not return
``jnp.linalg.eigh``'s columns, so factors are compared through L Lᵀ, the
log densities and the selected rank, never through L's columns.  Inputs
come from numpy seeds; float64 unless a test says otherwise.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU64, clustered, jax_x64_off, t64, to_np
import mellon_tpu
import mellon_tpu.ops.linalg as jlin
import mellon_tpu_torch as mt
import mellon_tpu_torch.ops.linalg as tlin
from mellon_tpu.ops.kernels import Matern52 as JMatern52
from mellon_tpu.parameters import compute_landmarks as jax_compute_landmarks
from mellon_tpu_torch.ops.kernels import Matern52

# L Lᵀ, relative to its largest entry, in float64
GRAM_REL = 1e-10


class Records(logging.Handler):
    """The messages a logger emits inside the block."""

    def __init__(self, name):
        super().__init__(logging.DEBUG)
        self.logger = logging.getLogger(name)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(logging.DEBUG)
        self.logger.addHandler(self)
        return self.messages

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)


def _recovering(messages):
    return [m for m in messages if m.startswith("Recovering")]


def _spectrum(m, seed, negative=0, decay=0.05):
    """A symmetric matrix's ascending eigendecomposition: decaying
    positive eigenvalues (and ``negative`` non-positive ones) and a random
    orthogonal basis."""
    rng = np.random.RandomState(seed)
    s = np.sort(np.concatenate([np.exp(-decay * np.arange(m - negative)),
                                -0.01 * rng.rand(negative)]))
    v, _ = np.linalg.qr(rng.randn(m, m))
    return s, v


def _gram_gap(L, L_ref):
    A, B = to_np(L) @ to_np(L).T, np.asarray(L_ref) @ np.asarray(L_ref).T
    return np.abs(A - B).max() / np.abs(B).max()


@pytest.mark.parametrize("m", [100, 300])
@pytest.mark.parametrize("rank", [0.5, 0.9, 0.999, 1.0, 7, 40, 1000])
@pytest.mark.parametrize("force", [False, True])
def test_select_eigenpairs_matches_jax(m, rank, force):
    """The same ascending (s, v) through both selections: a fractional
    rank by searchsorted (rounded up to a power of two above 256 rows or
    when forced), an integer one by count: the same pairs, the same raw
    rank and the same "Recovering" message, exactly."""
    s, v = _spectrum(m, seed=m, negative=3)
    with Records("mellon_tpu") as jmsg:
        sj, vj, pj = jlin._select_eigenpairs(jnp.asarray(s), jnp.asarray(v), rank, m,
                                             with_raw_rank=True, force_quantize=force)
    with Records("mellon_tpu_torch") as tmsg:
        st, vt, pt = tlin._select_eigenpairs(t64(s), t64(v), rank, m, with_raw_rank=True,
                                             force_quantize=force)
    assert pt == pj
    np.testing.assert_array_equal(to_np(st), np.asarray(sj))
    np.testing.assert_array_equal(to_np(vt), np.asarray(vj))
    assert _recovering(tmsg) == _recovering(jmsg)


def test_select_eigenpairs_without_positive_eigenvalues_raises():
    """No positive eigenvalue: the same ValueError in both packages."""
    s = -np.linspace(0.1, 1.0, 10)[::-1]
    v = np.eye(10)
    with pytest.raises(ValueError, match="no positive eigenvalues"):
        jlin._select_eigenpairs(jnp.asarray(s), jnp.asarray(v), 0.9, 10)
    with pytest.raises(ValueError, match="no positive eigenvalues"):
        tlin._select_eigenpairs(t64(s), t64(v), 0.9, 10)


@pytest.mark.parametrize("rank", [10, 60])
def test_eigendecomposition_matches_jax(rank):
    """The whole truncated eigendecomposition of a PSD matrix: the same
    kept eigenvalues (1e-12) and the same projector v vᵀ (1e-10)."""
    s, v = _spectrum(120, seed=1)
    A = (v * s) @ v.T
    sj, vj = jlin._eigendecomposition(jnp.asarray(A), rank=rank)
    st, vt = tlin._eigendecomposition(t64(A), rank=rank)
    np.testing.assert_allclose(to_np(st), np.asarray(sj), rtol=1e-12)
    np.testing.assert_allclose(to_np(vt) @ to_np(vt).T, np.asarray(vj) @ np.asarray(vj).T,
                               atol=1e-10)


def _jax_omega(m, rank, seed=0, dtype=jnp.float64):
    p = min(m, rank + 16)
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (m, p), dtype=dtype))


@pytest.mark.parametrize("rank", [8, 40])
def test_randomized_eigh_with_jax_omega(rank):
    """randomized_eigh with JAX's threefry test matrix handed in: the
    same eigenvalues (1e-10) and the same projector Q U (U Q)ᵀ (1e-9)."""
    s, v = _spectrum(200, seed=2)
    A = (v * s) @ v.T
    sj, vj = jlin.randomized_eigh(jnp.asarray(A), rank)
    st, vt = tlin.randomized_eigh(t64(A), rank, omega=t64(_jax_omega(200, rank)))
    assert st.shape == (rank,) and vt.shape == (200, rank)
    np.testing.assert_allclose(to_np(st), np.asarray(sj), rtol=1e-10)
    np.testing.assert_allclose(to_np(vt) @ to_np(vt).T, np.asarray(vj) @ np.asarray(vj).T,
                               atol=1e-9)


def test_randomized_eigh_default_omega_is_seeded():
    """Without omega the test matrix comes from a generator seeded with
    ``seed``: the same seed gives the same result, and the top
    eigenvalues of a fast-decaying spectrum are found (1e-8)."""
    s, v = _spectrum(150, seed=3, decay=0.5)
    A = t64((v * s) @ v.T)
    s1, v1 = tlin.randomized_eigh(A, 20, seed=4)
    s2, v2 = tlin.randomized_eigh(A, 20, seed=4)
    assert torch.equal(s1, s2) and torch.equal(v1, v2)
    np.testing.assert_allclose(to_np(s1), s[-20:], rtol=1e-8)


def _problem(n, m, d=4, seed=5):
    x = clustered(n, d, seed=seed)
    xu = x[np.random.RandomState(seed).choice(n, m, replace=False)]
    return x, xu


@pytest.mark.parametrize("m", [100, 600])
@pytest.mark.parametrize("rank", [0.99, 0.999, 30])
def test_modified_low_rank_matches_jax(m, rank):
    """The improved Nyström factor on both sides of NYSTROEM_EXACT_MAX
    (512): the reference's QR and two eighs at 100 landmarks, the
    Cholesky-whitened selection at 600; the same rank and L Lᵀ to
    GRAM_REL."""
    x, xu = _problem(900, m)
    jcov, tcov = JMatern52(ls=1.0), Matern52(ls=1.0)
    Lj = jlin._modified_low_rank(jnp.asarray(x), jcov, jnp.asarray(xu), rank=rank)
    Lt = tlin._modified_low_rank(t64(x), tcov, t64(xu), rank=rank)
    assert Lt.shape == Lj.shape
    assert _gram_gap(Lt, Lj) <= GRAM_REL


@pytest.mark.parametrize("rank", [0.99, 25])
def test_full_decomposition_low_rank_matches_jax(rank):
    """The full Nyström factor v√s of k(x, x) + jitter·I: the same rank and
    L Lᵀ to GRAM_REL."""
    x, _ = _problem(300, 10)
    Lj = jlin._full_decomposition_low_rank(jnp.asarray(x), JMatern52(ls=1.0), rank=rank)
    Lt = tlin._full_decomposition_low_rank(t64(x), Matern52(ls=1.0), rank=rank)
    assert Lt.shape == Lj.shape
    assert _gram_gap(Lt, Lj) <= GRAM_REL


@pytest.mark.parametrize("rank", [0.999, 100])
def test_select_and_project_sketch_route_matches_jax(monkeypatch, rank):
    """Above NYSTROEM_DIRECT_EIGH_MAX whitened columns the selection runs
    on a randomized sketch of HᵀH (doubled while saturated); with JAX's
    test matrices handed to the port's sketch, the same rank and L Lᵀ to
    1e-8 of its largest entry (the sketch's subspace iteration)."""
    rng = np.random.RandomState(6)
    m = 1100
    basis, _ = np.linalg.qr(rng.randn(1300, m))
    H = basis * np.exp(-0.03 * np.arange(m))[None, :] @ np.linalg.qr(rng.randn(m, m))[0]
    sketches = []

    def jax_omega(mm, p, dtype, device, seed):
        sketches.append(p)
        return t64(np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (mm, p),
                                                dtype=jnp.float64)))

    monkeypatch.setattr(tlin, "_sketch_omega", jax_omega)
    Lj = jlin._nystroem_select_and_project(jnp.asarray(H), rank)
    Lt = tlin._nystroem_select_and_project(t64(H), rank)
    assert sketches and Lt.shape == Lj.shape
    A, B = to_np(Lt) @ to_np(Lt).T, np.asarray(Lj) @ np.asarray(Lj).T
    assert np.abs(A - B).max() <= 1e-8 * np.abs(B).max()


def _agreement(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return np.corrcoef(got, want)[0, 1], np.abs(got - want).max() / np.ptp(want)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(gp_type="sparse_nystroem", rank=0.99, n_landmarks=100),
        dict(gp_type="sparse_nystroem", rank=0.999, n_landmarks=600),
        dict(rank=20, n_landmarks=100),
        dict(gp_type="full_nystroem", rank=0.99),
    ],
)
def test_fit_predict_matches_jax(kwargs):
    """Whole fits of both Nyström types on JAX's landmarks: the same
    rank, L Lᵀ to GRAM_REL, the log density and the predictor at new
    points to corr >= 0.99999 and max |Δ| <= 1e-3 of the spread (the
    bound the optimizers' stopping rule leaves, as in test_torch_slice)."""
    full = kwargs.get("gp_type") == "full_nystroem"
    x = clustered(400 if full else 1000, 4, seed=7)
    jest = mellon_tpu.DensityEstimator(**kwargs)
    ld_j = np.asarray(jest.fit_predict(jnp.asarray(x)))
    landmarks = None if jest.landmarks is None else np.asarray(jest.landmarks)
    port_kwargs = {k: v for k, v in kwargs.items() if k != "n_landmarks"}
    est = mt.DensityEstimator(landmarks=landmarks, **port_kwargs, **CPU64)
    ld = to_np(est.fit_predict(x))
    assert est.gp_type == mt.GaussianProcessType(jest.gp_type.value)
    assert est.Lp is None and jest.Lp is None
    assert est.L.shape == jest.L.shape
    assert _gram_gap(est.L, jest.L) <= GRAM_REL
    corr, err = _agreement(ld, ld_j)
    assert corr >= 0.99999 and err <= 1e-3, (corr, err)
    x_new = clustered(60, 4, seed=8)
    assert type(est.predict).__name__ == type(jest.predict).__name__
    corr, err = _agreement(to_np(est.predict(x_new)), np.asarray(jest.predict(jnp.asarray(x_new))))
    assert corr >= 0.99999 and err <= 1e-3, (corr, err)


def test_shallow_rank_reduction_warns_like_jax():
    """A rank above 0.8 of the landmarks warns "Shallow rank reduction"
    in both packages."""
    x = clustered(500, 4, seed=9)
    with Records("mellon_tpu") as jmsg:
        jest = mellon_tpu.DensityEstimator(gp_type="sparse_nystroem", rank=0.9999999,
                                           n_landmarks=40)
        jest.prepare_inference(jnp.asarray(x))
    with Records("mellon_tpu_torch") as tmsg:
        est = mt.DensityEstimator(gp_type="sparse_nystroem", rank=0.9999999,
                                  landmarks=np.asarray(jest.landmarks), **CPU64)
        est.prepare_inference(x)
    assert est.L.shape == jest.L.shape
    shallow = [any("Shallow rank reduction" in m for m in msgs) for msgs in (jmsg, tmsg)]
    assert shallow == [True, True]


@pytest.fixture
def nystroem_data():
    """tests/test_fused_prepare.py's data of the fused Nyström prepare."""
    rs = np.random.RandomState(1)
    return np.concatenate([rs.randn(500, 4) * 0.5 + 2.0, rs.randn(500, 4) * 0.8 - 2.0])


def _nearest_matches(a, b, tol=1e-4):
    d = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))
    return int((d.min(axis=1) <= tol).sum())


def test_f32_nystroem_prunes_like_jax(nystroem_data):
    """Float32 on both sides (JAX with x64 off, its fused Nyström prepare
    from its own k-means; the port from JAX's k-means landmarks): the 550
    landmarks' float32 kernel does not factor, and both prune by pivoted
    Cholesky to the same power-of-two count before the whitened
    selection.  The kept sets agree on at least 95% (float32 pivots part
    after ~100 steps, as test_torch_slice's sparse prune); the selected
    ranks are equal and the log densities agree to corr >= 0.999."""
    x = nystroem_data.astype(np.float32)
    kw = dict(gp_type="sparse_nystroem", rank=0.999)
    with jax_x64_off():
        xj = jnp.asarray(x)
        xu = np.asarray(jax_compute_landmarks(xj, n_landmarks=550, random_state=42))
        jest = mellon_tpu.DensityEstimator(n_landmarks=550, **kw)
        ld_j = np.asarray(jest.fit_predict(xj))
        kept_j = np.asarray(jest.landmarks)
    est = mt.DensityEstimator(landmarks=xu, device="cpu", dtype=torch.float32, **kw)
    ld = est.fit_predict(x)
    assert ld.dtype == torch.float32 and torch.isfinite(ld).all()
    n_kept = kept_j.shape[0]
    assert n_kept < 550 and n_kept in tlin.RANK_BUCKETS
    assert est.landmarks.shape[0] == n_kept and est.n_landmarks == n_kept
    assert _nearest_matches(to_np(est.landmarks), kept_j) >= 0.95 * n_kept
    assert est.L.shape == jest.L.shape
    corr, _ = _agreement(to_np(ld), ld_j)
    assert corr >= 0.999, corr


def test_function_estimator_refuses_nystroem_like_jax():
    """The FunctionEstimator refuses the Nyström types with the JAX
    package's ValueError."""
    for gp_type in ("sparse_nystroem", "full_nystroem"):
        with pytest.raises(ValueError, match="Nyström rank reduction is not available"):
            mellon_tpu.FunctionEstimator(gp_type=gp_type)
        with pytest.raises(ValueError, match="Nyström rank reduction is not available"):
            mt.FunctionEstimator(gp_type=gp_type, **CPU64)


def test_time_and_dimensionality_estimators_take_nystroem():
    """The time-sensitive density and the dimensionality model on the
    sparse Nyström type, on JAX's landmarks: the same rank and L Lᵀ to
    GRAM_REL, fits within corr >= 0.99999 of JAX's."""
    x = clustered(400, 3, seed=11)
    times = np.repeat(np.arange(4.0), 100)
    jest = mellon_tpu.TimeSensitiveDensityEstimator(rank=0.99, n_landmarks=60, ls_time=1.5)
    ld_j = np.asarray(jest.fit_predict(jnp.asarray(x), jnp.asarray(times)))
    est = mt.TimeSensitiveDensityEstimator(rank=0.99, landmarks=np.asarray(jest.landmarks),
                                           ls_time=1.5, **CPU64)
    ld = to_np(est.fit_predict(x, times))
    assert est.gp_type == mt.GaussianProcessType.SPARSE_NYSTROEM
    assert _gram_gap(est.L, jest.L) <= GRAM_REL
    assert _agreement(ld, ld_j)[0] >= 0.99999

    jdim = mellon_tpu.DimensionalityEstimator(rank=0.99, n_landmarks=60)
    dims_j = np.asarray(jdim.fit_predict(jnp.asarray(x)))
    dim = mt.DimensionalityEstimator(rank=0.99, landmarks=np.asarray(jdim.landmarks), **CPU64)
    dims = to_np(dim.fit_predict(x))
    assert dim.gp_type == mt.GaussianProcessType.SPARSE_NYSTROEM
    assert _gram_gap(dim.L, jdim.L) <= GRAM_REL
    assert _agreement(dims, dims_j)[0] >= 0.99999
