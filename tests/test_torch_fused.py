"""The fused prepare of mellon_tpu_torch (``models/fused.py``) on the CPU:
the case-for-case counterparts of ``tests/test_fused_prepare.py`` (its
TRSM-chunking cases excepted: that route is not ported).  Each family's
fused prepare sets the lazy chain's attributes bit for bit, agrees with
``mellon_tpu.models.fused`` on the same numpy input (float64 at 1e-8 with
JAX's k-means landmarks handed to the port, whose generator cannot draw
JAX's stream; float32 kept landmark sets to 95%, the bar of
``test_torch_slice.py``), and declines where the JAX package's declines."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU64, clustered, jax_x64_off, t64, to_np
import mellon_tpu
import mellon_tpu.models.fused as jfused
import mellon_tpu_torch as mt
import mellon_tpu_torch.models.fused as fused
from mellon_tpu.ops.cluster import k_means as jax_k_means
from mellon_tpu_torch.ops.cluster import _kmeanspp_init, _lloyd, _weighted_draw

SEED = 42


@pytest.fixture
def data():
    rs = np.random.RandomState(0)
    # two clusters; n > n_landmarks selects the sparse (fused) type
    return np.concatenate([rs.randn(150, 3) * 0.5 + 2.0, rs.randn(150, 3) * 0.8 - 2.0])


@pytest.fixture
def time_data():
    rs = np.random.RandomState(3)
    return rs.randn(240, 3), rs.randint(0, 4, 240).astype(np.float64)


@pytest.fixture
def nystroem_data():
    rs = np.random.RandomState(1)
    return np.concatenate([rs.randn(500, 4) * 0.5 + 2.0, rs.randn(500, 4) * 0.8 - 2.0])


def _y(x):
    return np.sin(x[:, 0]) + 0.1 * x[:, 1]


# each family: (its estimator and keyword arguments, the data fixture, how
# it is prepared, the attributes the fused prepare sets, the fit's output)
FAMILIES = {
    "density": (mt.DensityEstimator, dict(n_landmarks=50), "data", "prepare",
                ("nn_distances", "d", "mu", "ls", "landmarks", "Lp", "L", "initial_value"),
                "fit_predict"),
    "nystroem": (mt.DensityEstimator,
                 dict(gp_type="sparse_nystroem", n_landmarks=550, rank=0.999), "nystroem_data",
                 "prepare", ("nn_distances", "d", "mu", "ls", "landmarks", "L", "initial_value"),
                 "fit_predict"),
    "function": (mt.FunctionEstimator, dict(n_landmarks=50, sigma=0.1), "data", "fit",
                 ("nn_distances", "ls", "landmarks", "Lp"), "predict"),
    "dimensionality": (mt.DimensionalityEstimator, dict(n_landmarks=50), "data", "prepare",
                       ("distances", "nn_distances", "d", "mu_dens", "ls", "landmarks", "Lp",
                        "L", "initial_value"), "fit_predict"),
    "time": (mt.TimeSensitiveDensityEstimator, dict(n_landmarks=40, ls_time=1.5), "time_data",
             "prepare", ("nn_distances", "d", "mu", "ls", "landmarks", "Lp", "L",
                         "initial_value"), "fit_predict"),
    "time normalized": (mt.TimeSensitiveDensityEstimator,
                        dict(n_landmarks=40, ls_time=1.5, normalize_per_time_point=True),
                        "time_data", "prepare",
                        ("nn_distances", "d", "mu", "ls", "landmarks", "Lp", "L",
                         "initial_value"), "fit_predict"),
}


def _args(family, request):
    data = request.getfixturevalue(FAMILIES[family][2])
    if family == "function":
        return (data, _y(data))
    return data if isinstance(data, tuple) else (data,)


def _prepared(family, args, enabled, dtype=torch.float64, **extra):
    cls, kwargs, _, how, _, _ = FAMILIES[family]
    old, fused.ENABLED = fused.ENABLED, enabled
    try:
        est = cls(device="cpu", dtype=dtype, **kwargs, **extra)
        est.fit(*args) if how == "fit" else est.prepare_inference(*args)
    finally:
        fused.ENABLED = old
    return est


def _same_bits(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return a == b


def _assert_same_attributes(got, want, fields):
    for name in fields:
        assert _same_bits(getattr(got, name), getattr(want, name)), name
    assert repr(got.cov_func) == repr(want.cov_func)


@pytest.mark.parametrize("family", FAMILIES)
def test_fused_prepare_matches_lazy_bitwise(family, request):
    """Every attribute the fused prepare sets equals the lazy chain's bit
    for bit (float64; the float32 prune is held below), and the fused
    prepare did apply (the lazy chain computed nothing after it)."""
    args = _args(family, request)
    calls = []
    spy = fused._read_host
    fused._read_host = lambda packed: calls.append(1) or spy(packed)
    try:
        got = _prepared(family, args, True)
    finally:
        fused._read_host = spy
    assert len(calls) == 1
    want = _prepared(family, args, False)
    _assert_same_attributes(got, want, FAMILIES[family][4])


@pytest.mark.parametrize("family", FAMILIES)
def test_fused_fit_matches_lazy(family, request):
    """The whole fit agrees too: bit for bit, as its inputs do."""
    cls, kwargs, _, how, _, output = FAMILIES[family]
    args = _args(family, request)
    results = []
    for enabled in (True, False):
        old, fused.ENABLED = fused.ENABLED, enabled
        try:
            est = cls(**kwargs, **CPU64)
            if output == "predict":
                est.fit(*args)
                results.append(est.predict(t64(args[0][:20])))
            else:
                results.append(est.fit_predict(*args))
        finally:
            fused.ENABLED = old
    assert torch.equal(results[0], results[1])


def _jax_landmarks(monkeypatch, seed=SEED):
    """The port's fused k-means replaced by the JAX package's on the same
    points (its fused program's k-means++/Lloyd with PRNGKey(seed))."""
    def landmarks(x, k, n_sub, sub_generator, generator):
        assert n_sub is None
        return t64(jax_k_means(jnp.asarray(to_np(x)), k, random_state=seed)).to(x.dtype)

    monkeypatch.setattr(fused, "_landmarks", landmarks)


def _jax_prepared(family, args):
    cls = {"density": mellon_tpu.DensityEstimator, "nystroem": mellon_tpu.DensityEstimator,
           "function": mellon_tpu.FunctionEstimator,
           "dimensionality": mellon_tpu.DimensionalityEstimator,
           "time": mellon_tpu.TimeSensitiveDensityEstimator,
           "time normalized": mellon_tpu.TimeSensitiveDensityEstimator}[family]
    est = cls(**FAMILIES[family][1])
    jargs = tuple(jnp.asarray(a) for a in args)
    est.fit(*jargs) if FAMILIES[family][3] == "fit" else est.prepare_inference(*jargs)
    return est


@pytest.mark.parametrize("family", FAMILIES)
def test_fused_prepare_matches_jax_fused_f64(family, request, monkeypatch):
    """The port's fused prepare against the JAX package's on the same numpy
    input in float64, with JAX's k-means landmarks: 1e-8.  The Nyström
    factor is compared through L Lᵀ (eigenvectors are defined up to sign),
    at the JAX package's own fused-vs-lazy bar for it (1e-6)."""
    args = _args(family, request)
    jest = _jax_prepared(family, args)
    _jax_landmarks(monkeypatch)
    est = _prepared(family, args, True)
    for name in FAMILIES[family][4]:
        got, want = getattr(est, name), getattr(jest, name)
        if name == "L" and family == "nystroem":
            got, want = to_np(got) @ to_np(got).T, np.asarray(want) @ np.asarray(want).T
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=name)
        elif name == "initial_value" and family == "nystroem":
            continue  # a function of L's columns, whose signs differ
        else:
            np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-8, atol=1e-8,
                                       err_msg=name)


def _singular_f64_gram(m=60, seed=2):
    """A float64 landmark gram with repeated landmarks: not factorable at a
    tiny jitter, so the fused pivot branch runs."""
    rs = np.random.RandomState(seed)
    xu = rs.randn(m // 2, 3)
    xu = np.concatenate([xu, xu])
    return xu, np.asarray(mellon_tpu.ops.kernels.Matern52(2.0)(jnp.asarray(xu), jnp.asarray(xu)))


def test_pivot_branch_matches_jax_f64():
    """Stage 1's Cholesky attempt with its in-graph pivot selection against
    the JAX package's (_chol_attempt_with_pivot) on one float64 gram that
    does not factor: the same flag, identical pivots and the same count."""
    _, K = _singular_f64_gram()
    jitter = 1e-300
    Lj, okj, pj, rj = jfused._chol_attempt_with_pivot(jnp.asarray(K), jitter)
    Lt, okt, pt, rt, *_ = fused._chol_attempt_with_pivot(t64(K), jitter)
    assert not bool(okj) and not bool(okt)
    assert int(rt) == int(rj) and 0 < int(rt) < K.shape[0]
    np.testing.assert_array_equal(to_np(pt)[: int(rt)], np.asarray(pj)[: int(rj)])
    # where the attempt factors, no pivot step runs
    _, K_ok = _singular_f64_gram(seed=3)
    K_ok = K_ok[:30, :30]
    _, okt, pt, rt, *_ = fused._chol_attempt_with_pivot(t64(K_ok), 1e-6)
    assert bool(okt) and int(rt) == 0 and not bool(pt.any())


def test_fused_f32_prune_keeps_jax_landmarks():
    """Float32 on both sides (JAX with x64 off), at the slice test's shape:
    the 400-landmark gram is singular, both fused prepares prune to 256 by
    their in-stage pivots, and the kept sets agree to at least 95% (the
    residual updates round differently in float32); the port's fused
    prepare equals its lazy chain bit for bit."""
    x = clustered(1500, 10, seed=23, n_clusters=6, spread=1.0).astype(np.float32)
    with jax_x64_off():
        jest = mellon_tpu.DensityEstimator(n_landmarks=400)
        jest.prepare_inference(jnp.asarray(x))
        kept_j = np.asarray(jest.landmarks)
        xu = np.asarray(jax_k_means(jnp.asarray(x), 400, random_state=SEED))
    assert kept_j.shape[0] == 256
    mp = pytest.MonkeyPatch()
    mp.setattr(fused, "_landmarks", lambda *a: torch.tensor(xu))
    try:
        est = mt.DensityEstimator(n_landmarks=400, device="cpu", dtype=torch.float32)
        est.prepare_inference(x)
    finally:
        mp.undo()
    assert est.landmarks.shape[0] == 256 and est.n_landmarks == 256
    kept = {tuple(r) for r in to_np(est.landmarks)}
    assert len(kept & {tuple(r) for r in kept_j}) >= 0.95 * 256
    got = _f32_prepared(x, True)
    want = _f32_prepared(x, False)
    _assert_same_attributes(got, want, ("nn_distances", "mu", "ls", "landmarks", "n_landmarks",
                                        "check_rank", "Lp", "L", "initial_value"))


def _f32_prepared(x, enabled, **kwargs):
    old, fused.ENABLED = fused.ENABLED, enabled
    try:
        est = mt.DensityEstimator(n_landmarks=400, device="cpu", dtype=torch.float32, **kwargs)
        est.prepare_inference(x)
    finally:
        fused.ENABLED = old
    return est


def test_fused_prepare_with_custom_seed_and_ls_factor(data):
    got = _prepared("density", (data,), True, random_state=7, ls_factor=2.0)
    want = _prepared("density", (data,), False, random_state=7, ls_factor=2.0)
    _assert_same_attributes(got, want, FAMILIES["density"][4])


def _sized(est, x, time=False):
    est.set_x(est._time_x(x[0], x[1]) if time else x)
    est._prepare_attribute("n_landmarks")
    est._prepare_attribute("rank")
    est._prepare_attribute("gp_type")
    return est


# (entry point, estimator keyword arguments, the data: "data", the first 40
# rows, or "nystroem"); each declines in both packages but the first
DECLINE_CASES = [
    ("maybe_fused_sparse_prepare", {}, "data", True),
    ("maybe_fused_sparse_prepare", {"d_method": "fractal"}, "data", False),
    ("maybe_fused_sparse_prepare", {"d": 3}, "data", False),
    ("maybe_fused_sparse_prepare", {"ls": 2.0}, "data", False),
    ("maybe_fused_sparse_prepare", {"mu": -3.0}, "data", False),
    ("maybe_fused_sparse_prepare", {"nn_distances": "given"}, "data", False),
    ("maybe_fused_sparse_prepare", {"landmarks": "given"}, "data", False),
    ("maybe_fused_sparse_prepare", {"initial_value": "given"}, "data", False),
    ("maybe_fused_sparse_prepare", {"cov_func_curry": "RatQuad"}, "data", False),
    ("maybe_fused_sparse_prepare", {"n_landmarks": None}, "small", False),
    ("maybe_fused_sparse_prepare", {"gp_type": "sparse_nystroem", "rank": 0.999},
     "nystroem", False),
    ("maybe_fused_nystroem_prepare", {"gp_type": "sparse_nystroem", "rank": 0.999},
     "nystroem", True),
    ("maybe_fused_nystroem_prepare", {"gp_type": "sparse_nystroem", "rank": 0.999,
                                      "n_landmarks": 100}, "nystroem", False),
    ("maybe_fused_nystroem_prepare", {"gp_type": "sparse_nystroem", "rank": 0.999,
                                      "check_rank": True}, "nystroem", False),
    ("maybe_fused_function_prepare", {}, "data", True),
    ("maybe_fused_function_prepare", {"ls": 2.0}, "data", False),
    ("maybe_fused_dimensionality_prepare", {}, "data", True),
    ("maybe_fused_dimensionality_prepare", {"n_landmarks": 20}, "tiny", False),
]


def _decline_estimator(package, entry, kwargs, data_name, data, nystroem_data):
    x = {"data": data, "small": data[:40], "tiny": data[:30], "nystroem": nystroem_data}[data_name]
    kwargs = dict(kwargs)
    cls = {"maybe_fused_function_prepare": "FunctionEstimator",
           "maybe_fused_dimensionality_prepare": "DimensionalityEstimator"}.get(entry, "DensityEstimator")
    if entry == "maybe_fused_nystroem_prepare" or "gp_type" in kwargs:
        kwargs.setdefault("n_landmarks", 550)
    elif "n_landmarks" not in kwargs:
        kwargs["n_landmarks"] = 50
    if kwargs["n_landmarks"] is None:
        del kwargs["n_landmarks"]
    if kwargs.get("cov_func_curry") == "RatQuad":
        kwargs["cov_func_curry"] = getattr(package.ops.kernels if package is mellon_tpu
                                           else mt.ops.kernels, "RatQuad")
    for name, value in (("nn_distances", np.full(x.shape[0], 0.1)),
                        ("landmarks", x[:50]), ("initial_value", np.zeros(50))):
        if kwargs.get(name) == "given":
            kwargs[name] = value
    if package is mellon_tpu:
        kwargs = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kwargs.items()}
        est = getattr(mellon_tpu, cls)(**kwargs)
        x = jnp.asarray(x)
    else:
        est = getattr(mt, cls)(**kwargs, **CPU64)
    est.set_x(x)
    est._prepare_attribute("n_landmarks")
    est._prepare_attribute("gp_type")
    if cls != "FunctionEstimator":
        est._prepare_attribute("rank")
    return est


@pytest.mark.parametrize("entry, kwargs, data_name, applies", DECLINE_CASES)
def test_fused_applies_and_declines_as_jax(entry, kwargs, data_name, applies, data,
                                           nystroem_data):
    """Each entry point applies in its default configuration and declines
    each customization, case for case as the JAX package's does."""
    results = []
    for package, module in ((mellon_tpu, jfused), (mt, fused)):
        est = _decline_estimator(package, entry, kwargs, data_name, data, nystroem_data)
        results.append(bool(getattr(module, entry)(est)))
    assert results == [applies, applies]


def test_fused_time_declines_without_ls_time_and_for_many_groups(time_data):
    x, times = time_data
    for package, module, arr in ((mellon_tpu, jfused, jnp.asarray), (mt, fused, t64)):
        kwargs = {} if package is mellon_tpu else CPU64
        est = package.TimeSensitiveDensityEstimator(n_landmarks=40, **kwargs)
        est.set_x(np.column_stack([x, times]) if package is mt else
                  jnp.asarray(np.column_stack([x, times])))
        for attribute in ("n_landmarks", "rank", "gp_type"):
            est._prepare_attribute(attribute)
        assert not module.maybe_fused_time_prepare(est)
        # one cell alone at a time point: the lazy path raises its error
        lonely = np.column_stack([x, np.where(np.arange(240) == 0, 9.0, times)])
        est = package.TimeSensitiveDensityEstimator(n_landmarks=40, ls_time=1.5, **kwargs)
        est.set_x(lonely if package is mt else jnp.asarray(lonely))
        for attribute in ("n_landmarks", "rank", "gp_type"):
            est._prepare_attribute(attribute)
        assert not module.maybe_fused_time_prepare(est)


def test_fused_declines_at_the_cpu_ivf_threshold(data, monkeypatch):
    """Above IVF_THRESHOLD rows the lazy kNN on the CPU takes the IVF
    search, so the fused exact search declines (in both packages)."""
    import mellon_tpu.ops.neighbors as jneighbors
    import mellon_tpu_torch.ops.neighbors as tneighbors

    monkeypatch.setattr(jneighbors, "IVF_THRESHOLD", 100)
    monkeypatch.setattr(tneighbors, "IVF_THRESHOLD", 100)
    for package, module in ((mellon_tpu, jfused), (mt, fused)):
        est = _decline_estimator(package, "maybe_fused_sparse_prepare", {}, "data", data, data)
        assert not module.maybe_fused_sparse_prepare(est)


def test_fused_declines_above_50_dimensions():
    x = clustered(300, 51, seed=4)
    for package, module in ((mellon_tpu, jfused), (mt, fused)):
        kwargs = {} if package is mellon_tpu else CPU64
        est = package.DensityEstimator(n_landmarks=50, **kwargs)
        est.set_x(x if package is mt else jnp.asarray(x))
        for attribute in ("n_landmarks", "rank", "gp_type"):
            est._prepare_attribute(attribute)
        assert not module.maybe_fused_sparse_prepare(est)


def test_disabled_takes_the_lazy_chain(data, monkeypatch):
    monkeypatch.setattr(fused, "ENABLED", False)
    est = _decline_estimator(mt, "maybe_fused_sparse_prepare", {}, "data", data, data)
    assert not fused.maybe_fused_sparse_prepare(est)


def test_prune_factorize_stage_matches_lazy_components(data):
    """Stage 2 on a pivoted subset equals the lazy pipeline it fuses:
    submatrix Cholesky, cross-covariance solve and ridge warm start."""
    from mellon_tpu_torch.ops.cluster import k_means
    from mellon_tpu_torch.ops.kernels import Matern52
    from mellon_tpu_torch.ops.linalg import _standard_low_rank, ridge_solve, safe_cholesky
    from mellon_tpu_torch.parameters import compute_nn_distances
    from mellon_tpu_torch.utils.util import mle

    x = t64(data)
    nn = compute_nn_distances(x)
    ls, mu, d, jitter = 3.0, -4.0, 3, 1e-6
    xu = k_means(x, 40, random_state=0)
    K = Matern52(ls)(xu, xu)
    piv = torch.as_tensor(np.random.RandomState(1).permutation(40)[:16])
    Lp_f, xu_sel_f, L_f, z0_f, tries = fused._prune_factorize_stage(
        K, piv, x, xu, torch.tensor(ls, dtype=torch.float64), nn,
        torch.tensor(float(d), dtype=torch.float64), torch.tensor(mu, dtype=torch.float64),
        curry=Matern52, n_params=1, targets=fused._density_target, jitter=jitter)
    assert int(tries) <= fused.PRUNE_MAX_TRIES
    Lp_l = safe_cholesky(K[piv][:, piv], jitter=jitter, max_tries=3)
    L_l = _standard_low_rank(x, Matern52(ls), xu[piv], Lp=Lp_l)
    z0_l = ridge_solve(L_l, mle(nn, d) - mu, 1.0)
    for got, want in ((Lp_f, Lp_l), (xu_sel_f, xu[piv]), (L_f, L_l), (z0_f, z0_l)):
        assert torch.equal(got, want)


def _prepared_fit_stage(data):
    """A density estimator through the fused prepare with an optimistic
    factor, as inside fit."""
    est = mt.DensityEstimator(n_landmarks=50, **CPU64)
    est._in_fit = True
    try:
        est.prepare_inference(data)
    finally:
        est._in_fit = False
    return est


def _corrupt(est):
    """NaN factors, as if the optimistic Cholesky had failed, with the
    fallback the pruned path leaves."""
    K = est.cov_func(est.landmarks, est.landmarks)
    piv = torch.arange(est.landmarks.shape[0])
    est.Lp = est.Lp * torch.nan
    est.L = est.L * torch.nan
    est.initial_value = est.initial_value * torch.nan
    est.transform = None
    est.loss_func = None
    est._prepare_attribute("transform")
    est._prepare_attribute("loss_func")
    est._fused_lp_fallback = (K, piv, torch.tensor(fused.PRUNE_MAX_TRIES + 1))


def test_optimistic_factorization_recovery(data):
    """A failed optimistic factor shows as a non-finite first loss; the
    L-BFGS run rebuilds from the stored fallback and converges to the fit
    without it."""
    good = mt.DensityEstimator(n_landmarks=50, **CPU64).fit_predict(data)
    est = _prepared_fit_stage(data)
    _corrupt(est)
    est.run_inference()
    est.process_inference()
    assert est._fused_lp_fallback is None
    np.testing.assert_allclose(to_np(est.log_density_x), to_np(good), rtol=1e-6)


def test_optimistic_fallback_checked_for_other_optimizers(data):
    est = _prepared_fit_stage(data)
    _corrupt(est)
    est.optimizer = "adam"
    est.n_iter = 30
    est.run_inference()
    assert est._fused_lp_fallback is None
    assert torch.isfinite(est.pre_transformation).all()


def test_optimistic_only_within_fit():
    """A bare prepare_inference leaves no unverified factor: on a float32
    prune the fit's prepare keeps the fallback, a bare one reads the
    factor's flag instead."""
    x = clustered(1500, 10, seed=23, n_clusters=6, spread=1.0).astype(np.float32)
    bare = _f32_prepared(x, True)
    assert getattr(bare, "_fused_lp_fallback", None) is None
    assert torch.isfinite(bare.initial_value).all()
    inside = mt.DensityEstimator(n_landmarks=400, device="cpu", dtype=torch.float32)
    inside._in_fit = True
    inside.prepare_inference(x)
    assert inside._fused_lp_fallback is not None
    _assert_same_attributes(inside, bare, ("landmarks", "Lp", "L", "initial_value"))


def test_user_initial_value_is_not_clobbered(data):
    z0 = torch.zeros(50, dtype=torch.float64)
    est = mt.DensityEstimator(n_landmarks=50, initial_value=z0, **CPU64)
    est.prepare_inference(data)
    assert torch.equal(est.initial_value, z0)


def test_check_rank_true_runs_diagnostic_on_prune_path(data, caplog):
    """An explicit check_rank=True on the prune path sets only the factor
    and the kept landmarks, so that _compute_L runs the rank diagnostic."""
    est = mt.DensityEstimator(n_landmarks=50, check_rank=True, **CPU64)
    est.set_x(data)
    for attribute in ("n_landmarks", "rank", "gp_type", "nn_distances", "d", "mu", "ls",
                      "cov_func", "landmarks"):
        est._prepare_attribute(attribute)
    xu = est.landmarks
    K = est.cov_func(xu, xu)

    def must_not_run(*args):
        raise AssertionError("the stage-2 graph ran")

    fused._finish_factorization(est, est.x, xu, K, K * torch.nan, False, False, must_not_run,
                                must_not_run, pivot=(torch.arange(50), 40))
    assert est.L is None and est.Lp is not None and est.check_rank is True
    assert est.landmarks.shape[0] == 40 and est.n_landmarks == 40  # below the smallest bucket
    with caplog.at_level(logging.INFO, logger="mellon_tpu_torch"):
        est._prepare_attribute("L")
    assert any("approximation accuracy" in r.message for r in caplog.records)


def test_fused_prepare_nn_repair_warning(data, caplog):
    """Duplicate rows give zero 1-NN distances: the repair warning fires
    from the fused prepare's one host read, and the distances are repaired."""
    x = np.concatenate([data, data[:5]])
    with caplog.at_level(logging.WARNING, logger="mellon_tpu_torch"):
        est = _prepared("density", (x,), True)
    assert any("invalid values" in r.message for r in caplog.records)
    assert bool((est.nn_distances > 0).all())


def test_no_prune_config_keeps_all_landmarks(caplog):
    """config.PRUNE_SINGULAR_LANDMARKS off: the fused finisher keeps every
    landmark with the lazy chain's float64 factor (its own hook) and leaves
    L to the lazy chain."""
    import mellon_tpu_torch.config as config

    m = 60
    rs = np.random.RandomState(2)
    xu = torch.tensor(rs.randn(m, 3), dtype=torch.float32) * 1e-3
    est = mt.DensityEstimator(n_landmarks=m, device="cpu", dtype=torch.float32)
    est.landmarks = xu
    est.cov_func = mt.ops.kernels.Matern52(1.0)
    K = est.cov_func(xu, xu)
    x = torch.tensor(rs.randn(200, 3), dtype=torch.float32)
    old = config.PRUNE_SINGULAR_LANDMARKS
    try:
        config.PRUNE_SINGULAR_LANDMARKS = False
        with caplog.at_level(logging.WARNING, logger="mellon_tpu_torch"):
            fused._finish_factorization(
                est, x, xu, K, torch.full((m, m), torch.nan), False, False,
                lambda *a: pytest.fail("run_ok"), lambda *a: pytest.fail("run_prune"), pivot=None)
    finally:
        config.PRUNE_SINGULAR_LANDMARKS = old
    assert any("pruning disabled" in r.message for r in caplog.records)
    assert est.Lp.shape == (m, m) and torch.isfinite(est.Lp).all()
    assert est._f64_Lp is not None and est.L is None and est.landmarks.shape[0] == m


@pytest.mark.parametrize("n", [1, 7, 500, 3000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_weighted_draw_equals_multinomial(n, dtype):
    """k-means++'s written-out draw gives torch.multinomial's index for the
    same generator state, bit for bit, over several seeds."""
    for seed in range(4):
        w = torch.rand(n, dtype=dtype, generator=torch.Generator().manual_seed(100 + seed)) ** 3
        g1, g2 = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
        want = torch.cat([torch.multinomial(w, 1, generator=g1) for _ in range(20)])
        got = torch.cat([_weighted_draw(w, g2) for _ in range(20)])
        assert torch.equal(got, want)


def test_kmeanspp_reads_nothing_on_the_host():
    """The seeding's draws read nothing back: every op of it dispatched
    here is a device op (no aten._local_scalar_dense)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Reads(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                Reads.n += 1
            return func(*args, **(kwargs or {}))

    x = t64(clustered(500, 4, seed=16))
    with Reads():
        centers = _kmeanspp_init(x, 50, torch.Generator().manual_seed(0))
        _lloyd(x, centers, 50, 3, 128)
    assert Reads.n == 0


def _escalation_case(case):
    """A float32 matrix whose factor needs no retry, one or more retries,
    or fails at every rung."""
    X = torch.as_tensor(np.random.RandomState(3).randn(60, 3), dtype=torch.float32)
    if case == "none":
        return X @ X.T + torch.eye(60)
    if case == "retry":
        return X @ X.T
    return -torch.eye(60)


@pytest.mark.parametrize("case", ["none", "retry", "fails"])
def test_escalated_cholesky_matches_safe_cholesky(case, caplog):
    """Stage 2's jitter escalation on the device selects safe_cholesky's
    factor bit for bit and logs its warnings from the retries it reports;
    where no rung factors, it reports PRUNE_MAX_TRIES + 1 and a NaN
    factor."""
    from mellon_tpu_torch.ops.linalg import escalated_cholesky, log_escalation, safe_cholesky

    K, jitter, tries_max = _escalation_case(case), 1e-6, fused.PRUNE_MAX_TRIES
    L, tries = escalated_cholesky(K, jitter, tries_max)
    with caplog.at_level(logging.WARNING, logger="mellon_tpu_torch"):
        caplog.clear()
        if case == "fails":
            with pytest.raises(ValueError):
                safe_cholesky(K, jitter=jitter, max_tries=0)
            assert int(tries) == tries_max + 1 and bool(torch.isnan(L).all())
            return
        want = safe_cholesky(K, jitter=jitter, max_tries=tries_max)
        lazy_log = [r.message for r in caplog.records]
        caplog.clear()
        log_escalation(jitter, int(tries))
        assert [r.message for r in caplog.records] == lazy_log
    assert torch.equal(L, want)
    assert (int(tries) > 0) == (case == "retry")


def test_eager_run_drops_the_slot_graph():
    """A stage run without capture (the CPU, or a prepare past
    GRAPH_MEMORY_SHARE) releases the slot's cached graph and its pool."""
    x = torch.ones(4, 2)
    assert not fused._captures(x, 3)
    fused._GRAPHS["probe"] = object()
    try:
        out = fused._run("probe", None, lambda a, g: (a * 2,), (x,), (0,))
    finally:
        left = fused._GRAPHS.pop("probe", None)
    assert left is None and torch.equal(out[0], x * 2)
