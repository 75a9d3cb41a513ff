"""The work behind the Matern-5/2 tile's bound in ``chip_smoke.py``.

``bound_ms`` is the larger of the bytes the tile must move over the H100's
memory rate and its flops over the peak rate of its type.  These check
the counts at the main path's shapes (K_uu, C and the predictor against
the 2,048 kept landmarks, and a 200,000-point predictor batch) against
figures worked out by hand: every one is bound by writing its output.
"""

import pytest

import chip_smoke


@pytest.mark.parametrize(
    "n,m,d,dtype,mbytes,bound_us",
    [
        (5000, 5000, 20, "float32", 100.8, 30.1),
        (8627, 2048, 20, "float32", 71.5, 21.4),
        (1000, 2048, 20, "float32", 8.4, 2.5),
        (5000, 5000, 20, "float64", 201.6, 60.2),
        (200_000, 2048, 20, "float32", 1654.6, 493.9),
    ],
)
def test_matern52_bound_at_main_path_shapes(n, m, d, dtype, mbytes, bound_us):
    nbytes, flops = chip_smoke.matern52_work(n, m, d, dtype)
    itemsize = chip_smoke.ITEMSIZE[dtype]
    # x and y read once, the output written once
    assert nbytes == itemsize * (n * d + m * d + n * m)
    assert nbytes / 1e6 == pytest.approx(mbytes, abs=0.05)
    # 2d flops of cross term and 10 of epilogue per element, 2d per norm
    assert flops == n * m * (2 * d + 10) + 2 * d * (n + m)
    bound_ms, bound_by = chip_smoke.matern52_bound_ms(n, m, d, dtype)
    assert bound_by == "bytes"
    assert 1e3 * bound_ms == pytest.approx(bound_us, abs=0.05)
    # the flops alone would take well under the write
    assert flops / chip_smoke.PEAK_FLOPS[dtype] < 0.7 * bound_ms / 1e3
