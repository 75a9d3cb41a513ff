"""Numeric policy of mellon_tpu_torch: default device and dtype, and TF32.

The JAX package forces ``Precision.HIGHEST`` on every matrix product of the
density path (the distance cross term, the grams, the Cholesky/TRSM panels,
the loss matvec and the predictor mean): reduced-precision products there
corrupted the kNN and froze NUTS.  The CUDA counterpart of that reduced
precision is TF32, which cuBLAS and cuDNN may use for float32 products.
Importing this package therefore turns TF32 off for the whole process, so
every float32 product runs in IEEE float32:

* ``torch.backends.cuda.matmul.allow_tf32 = False``
* ``torch.backends.cudnn.allow_tf32 = False``
* ``torch.set_float32_matmul_precision("highest")``

Estimators compute in float32 on ``cuda`` by default; float64 and the CPU
are available on request (``device=``/``dtype=``), which is how the tests
hold the port against the JAX package.
"""

import logging

import torch

logger = logging.getLogger("mellon_tpu_torch")

DEFAULT_DEVICE = "cuda"
DEFAULT_DTYPE = torch.float32

# float32 landmark-pruning policy, as in the JAX package.  Where the
# landmark kernel does not factor in float32, the default prunes to the
# pivoted-Cholesky subset (every O(n·m) stage shrinks).  False keeps every
# landmark: the kernel is rebuilt in float64 from the landmarks'
# coordinates and factored once in float64 on the device, Lp its float32
# cast (full capacity, at the cost of the larger factorization).
PRUNE_SINGULAR_LANDMARKS = True

# With that float64 factor (PRUNE_SINGULAR_LANDMARKS = False), build the
# whitening L = k(x, xu) Lp⁻ᵀ in float64 on the device (the kernel's
# float64 entry and a float64 triangular solve) and cast it to float32:
# a float32 solve against the near-singular factor amplifies rounding by
# ~cond(Lp).  The JAX package emulates this in double-single arithmetic;
# the H100 has native float64.  False: the float32 kernel and solve
# against the float32 cast.
EXTENDED_PRECISION_WHITEN = True

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
logger.debug("mellon_tpu_torch turned TF32 off for float32 matrix products.")


def resolve_device_dtype(device=None, dtype=None):
    """The estimator's ``(torch.device, torch.dtype)``, defaulting to
    :data:`DEFAULT_DEVICE` and :data:`DEFAULT_DTYPE`."""
    device = torch.device(DEFAULT_DEVICE if device is None else device)
    dtype = DEFAULT_DTYPE if dtype is None else dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}.")
    return device, dtype
