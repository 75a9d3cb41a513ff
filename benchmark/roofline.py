"""The H100's peaks and the work of the benchmark's units of work, counted
from their shapes alone: what any implementation has to read, write and
compute, so a share of the roofline cannot pass 100% unless the time
leaves out part of the work.

``matern52_work`` and ``matern52_bound_ms`` are ``chip_smoke.py``'s."""

# H100 SXM (NVIDIA's data sheet, at the full 700 W): HBM rate and the
# peak rates outside the tensor cores
MEMORY_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
ITEMSIZE = {"float32": 4, "float64": 8}
# per output element after the cross term, counted for the bound: the
# distance's three additions, its floor, sqrt, the scale, the polynomial's
# two fmas, exp and the product
EPILOGUE_FLOPS = 10


def bound_seconds(nbytes, flops, dtype="float32"):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the flops over the peak rate of ``dtype``."""
    return max(nbytes / MEMORY_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def matern52_work(n, m, d, dtype):
    """(bytes, flops) the Matern-5/2 tile k(x (n, d), y (m, d)) needs: x
    and y read once and the (n, m) output written once; 2d flops of cross
    term and EPILOGUE_FLOPS per output element, 2d per row norm."""
    nbytes = ITEMSIZE[dtype] * (n * d + m * d + n * m)
    flops = n * m * (2 * d + EPILOGUE_FLOPS) + 2 * d * (n + m)
    return nbytes, flops


def matern52_bound_ms(n, m, d, dtype):
    """(ms, "bytes" or "operations"): :func:`bound_seconds` of the tile."""
    nbytes, flops = matern52_work(n, m, d, dtype)
    by_bytes = 1e3 * nbytes / MEMORY_BYTES_PER_S
    by_ops = 1e3 * flops / PEAK_FLOPS[dtype]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def predict_work(n, m, d, dtype="float32"):
    """(bytes, flops) of one predictor call mean = μ + k(X (n, d), xu (m,
    d)) w: the tile's operations plus 2 per element for the product with
    the weights; the queries, landmarks and weights read once and the n
    outputs written once (k itself need never be written)."""
    nbytes = ITEMSIZE[dtype] * (n * d + m * d + m + n)
    flops = n * m * (2 * d + EPILOGUE_FLOPS + 2) + 2 * d * (n + m)
    return nbytes, flops


def nuts_leaf_work(n, k, chains, dtype="float32"):
    """(bytes, flops) of one lockstep leaf of Hessian-preconditioned NUTS
    on the density potential, every chain at once: L (n, k), T (k, k),
    the 1-NN distances (n) and the chains' positions, momenta and
    gradients read once; z = z* + T w and Tᵀg (2·chains·k² each), F = L z
    and Lᵀ(1 − e) (2·n·k·chains each) and ~4 operations per cell and
    chain for the likelihood's terms."""
    nbytes = ITEMSIZE[dtype] * (n * k + k * k + n + 3 * chains * k)
    flops = 4 * chains * k * k + 4 * n * k * chains + 4 * n * chains
    return nbytes, flops
