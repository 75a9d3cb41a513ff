"""The benchmark's own arithmetic: the copied ESS, the roofline, the
seeded data, and the TF32 rounding of the control."""

import numpy as np
import pytest
import torch

from benchmark import roofline
from benchmark.data import mixture, mixture_cells, new_cells
from benchmark.ess import effective_sample_size, ess_by_blocks, ess_from_lag0
from benchmark.reference.density import F64, matern52, pivot_gap, tf32


def _ar1(phi, chains=4, n=40_000):
    rng = np.random.default_rng(3)
    e = rng.normal(size=(chains, n))
    x = np.empty_like(e)
    x[:, 0] = e[:, 0] / np.sqrt(1 - phi * phi)
    for t in range(1, n):
        x[:, t] = phi * x[:, t - 1] + e[:, t]
    return x[:, :, None]


@pytest.mark.parametrize("phi", [0.0, 0.5, 0.9])
def test_ess_of_an_ar1_chain(phi):
    """An AR(1) chain x_t = φ x_(t−1) + e_t has ESS = N (1 − φ)/(1 + φ)."""
    x = _ar1(phi)
    ess = effective_sample_size(x)[0]
    assert ess == pytest.approx(x.shape[0] * x.shape[1] * (1 - phi) / (1 + phi), rel=0.08)


@pytest.mark.parametrize("phi", [-0.5, 0.0, 0.5, 0.9])
def test_ess_from_lag0_of_an_ar1_chain(phi):
    """The same, and above chains × draws for an antithetic chain (φ < 0),
    where the program's estimator stops at chains × draws."""
    x = _ar1(phi)
    ess = ess_from_lag0(x)[0]
    assert ess == pytest.approx(x.shape[0] * x.shape[1] * (1 - phi) / (1 + phi), rel=0.08)
    if phi < 0:
        assert effective_sample_size(x)[0] == pytest.approx(x.shape[0] * x.shape[1])


@pytest.mark.parametrize("estimator", [effective_sample_size, ess_from_lag0])
def test_ess_by_blocks_equals_one_pass(estimator):
    x = np.random.default_rng(0).normal(size=(3, 200, 70))
    np.testing.assert_allclose(ess_by_blocks(x, block=16, estimator=estimator), estimator(x))


def _greedy_order(K):
    """The order in which the diagonally pivoted Cholesky takes K's rows."""
    d, L, order = K.diagonal().clone(), torch.zeros_like(K), []
    for j in range(K.shape[0]):
        p = int(torch.argmax(d))
        col = (K[:, p] - L[:, :j] @ L[p, :j]) / torch.sqrt(d[p])
        L[:, j], d = col, d - col * col
        d[p] = -1.0  # taken
        order.append(p)
    return order


def test_pivot_gap_reads_0_in_the_greedy_order_and_more_out_of_it():
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(60, 3)))
    K = matern52(x, x, 2.0, F64)
    order = _greedy_order(K)
    assert pivot_gap(K[order][:, order]) < 1e-12
    swapped = order[:]
    swapped[3], swapped[40] = swapped[40], swapped[3]
    assert pivot_gap(K[swapped][:, swapped]) > 0.01
    twice = order[:]
    twice[5] = twice[4]
    assert pivot_gap(K[twice][:, twice]) == float("inf")


@pytest.mark.parametrize("shape, bound_us, by", [
    ((5000, 5000, 20), 30.09, "bytes"),       # K_uu
    ((8627, 2048, 20), 21.35, "bytes"),       # C
    ((200000, 2048, 20), 493.9, "bytes"),     # the predictor's batch
    ((1000000, 2048, 50), 3364.0, "operations"),  # the atlas's C
])
def test_matern52_bound_matches_the_kernel_table(shape, bound_us, by):
    ms, kind = roofline.matern52_bound_ms(*shape, "float32")
    assert kind == by
    assert 1e3 * ms == pytest.approx(bound_us, rel=2e-3)


def test_whole_step_bounds():
    """The predictor's call at 200,000 x 2,048 x 20 is bound by its
    operations (52 per element: 0.318 ms); the atlas leaf by L's 8.2 GB
    (2.45 ms); the tutorial's 16-chain leaf by its 87.5 MB (26 µs)."""
    assert 1e3 * roofline.bound_seconds(*roofline.predict_work(200000, 2048, 20)) == \
        pytest.approx(0.318, rel=5e-3)
    assert 1e3 * roofline.bound_seconds(*roofline.nuts_leaf_work(1_000_000, 2048, 8)) == \
        pytest.approx(2.45, rel=5e-3)
    assert 1e6 * roofline.bound_seconds(*roofline.nuts_leaf_work(8627, 2048, 16)) == \
        pytest.approx(26.1, rel=1e-2)


def test_cells_repeat_from_the_seed():
    big = 2**31 + 12345
    a, b = mixture_cells(500, 7, big), mixture_cells(500, 7, big)
    assert a.dtype == np.float32 and a.shape == (500, 7)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, mixture_cells(500, 7, big + 1))
    _, centres, scales = mixture(500, 7, big)
    q = new_cells(centres, scales, 100, [big, 1])
    np.testing.assert_array_equal(q, new_cells(centres, scales, 100, [big, 1]))


def test_tf32_keeps_ten_mantissa_bits_rounding_to_nearest_even():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 2**-10, 1 + 3 * 2**-11, 1 + 2**-11 + 2**-20, -3.0])
    want = [1.0, 1.0, 1 + 2**-10, 1 + 2**-9, 1 + 2**-10, -3.0]
    assert tf32(x).tolist() == want
