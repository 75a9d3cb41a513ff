"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterpart of ``mellon_tpu/ops/pallas_kernels.py``.  The one kernel is the
fused Matern-5/2 covariance tile (``csrc/matern52_tile.cu``), which replaces
the Pallas kernel ``matern52_gram_pallas``.  On the density main path it
builds the landmark gram K_uu, the cross-covariance C = k(x, xu) ahead of
the whitening solve, the predictor mean's k(X*, xu), the predictor
covariance's k(xu, X*) and, with a gradient, the forward of the predictor's
derivatives.

:func:`matern52_gram` takes the plain version for tensors on the CPU and
launches the CUDA kernel for tensors on a CUDA device; there is no fallback
from one to the other.  One call launches two kernels (a pre-pass that lays
x and y out feature-major with their norms, into a scratch buffer the
wrapper allocates, then the tile kernel) and counts as one launch.  Its
gradient (:func:`matern52_gram_backward`) is plain torch on either device.
The kernel is compiled by ``nvcc`` from the package's sources at first use,
into ``build/`` beside the package, keyed by a hash of the sources:
nothing prebuilt is shipped.
"""

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
MATERN52_SOURCE = CSRC_DIR / "matern52_tile.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lib = None
_lib_lock = threading.Lock()
# the library's entry point for each dtype, filled when it loads
_entry = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME is not None:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = candidate if os.path.exists(candidate) else None
    if found is None:
        raise RuntimeError(
            "nvcc was not found (neither on PATH nor under CUDA_HOME); the "
            "CUDA kernels of mellon_tpu_torch are built from source at first use."
        )
    return found


def build_library():
    """Compile ``csrc/matern52_tile.cu`` into ``build/`` unless a library
    built from the same sources and flags is there; returns its path."""
    digest = hashlib.sha256(
        MATERN52_SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    target = BUILD_DIR / f"libmatern52_tile-{digest}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(MATERN52_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {MATERN52_SOURCE.name}:\n"
            f"{proc.stderr}"
        )
    os.replace(tmp, target)
    return target


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_double, ctypes.c_int, ctypes.c_void_p,
            ]
            for fn in (lib.matern52_gram_f32, lib.matern52_gram_f64):
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.matern52_scratch_elems.argtypes = [ctypes.c_int] * 4
            lib.matern52_scratch_elems.restype = ctypes.c_longlong
            lib.matern52_error_string.argtypes = [ctypes.c_int]
            lib.matern52_error_string.restype = ctypes.c_char_p
            _entry[torch.float32] = lib.matern52_gram_f32
            _entry[torch.float64] = lib.matern52_gram_f64
            _lib = lib
        return _lib


def matern52_gram_reference(x, y, ls):
    """Plain PyTorch Matern-5/2 k(x, y): the same arithmetic as the kernel
    and as the JAX package's ``Matern52`` (``_matern52_vals``)."""
    from ..utils.util import distance

    r = math.sqrt(5.0) * distance(x, y) / ls
    return (r + r * r / 3 + 1) * torch.exp(-r)


def matern52_gram_backward(grad_out, x, y, ls, needs_input_grad=(True, True)):
    """``(∂/∂x, ∂/∂y)`` of ⟨grad_out, k(x, y)⟩ in plain torch ops, so that a
    second derivative can be taken through it; None where not needed.

    With r = √5‖xᵢ − yⱼ‖/ℓ, ∂k/∂xᵢ = −(5/(3ℓ²))·(1 + r)·e^{−r}·(xᵢ − yⱼ):
    no 1/‖x − y‖ appears, so coincident points need no special case.  r
    comes from the floored :func:`distance`, as in the forward.  The Pallas
    kernel has no backward kernel either (JAX differentiates it with XLA);
    a fused backward tile is ROADMAP Queue 2 speed work.
    """
    from ..utils.util import distance

    r = math.sqrt(5.0) * distance(x, y) / ls
    G = grad_out * (1 + r) * torch.exp(-r)
    c = 5.0 / (3.0 * ls * ls)
    grad_x = grad_y = None
    if needs_input_grad[0]:
        grad_x = c * (G @ y - G.sum(dim=1)[:, None] * x)
    if needs_input_grad[1]:
        grad_y = c * (G.T @ x - G.sum(dim=0)[:, None] * y)
    return grad_x, grad_y


class _Matern52Gram(torch.autograd.Function):
    """k(x, y) with a gradient: the forward is the kernel call on detached
    operands (the CUDA tile, or the plain version on the CPU), the backward
    :func:`matern52_gram_backward`, itself differentiable."""

    @staticmethod
    def forward(ctx, x, y, ls):
        ctx.save_for_backward(x, y)
        ctx.ls = ls
        return _matern52_gram(x.detach(), y.detach(), ls)

    @staticmethod
    def backward(ctx, grad_out):
        x, y = ctx.saved_tensors
        grad_x, grad_y = matern52_gram_backward(
            grad_out, x, y, ctx.ls, ctx.needs_input_grad[:2]
        )
        return grad_x, grad_y, None


def _check_operands(x, y, ls):
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(
            f"matern52_gram needs x (n, d) and y (m, d), got {tuple(x.shape)} "
            f"and {tuple(y.shape)}."
        )
    if x.dtype != y.dtype or x.dtype not in (torch.float32, torch.float64):
        raise TypeError(
            f"matern52_gram takes float32 or float64 operands of one dtype, got "
            f"{x.dtype} and {y.dtype}."
        )
    if x.device != y.device:
        raise ValueError(
            f"matern52_gram operands lie on {x.device} and {y.device}."
        )
    if not ls > 0:
        raise ValueError(f"matern52_gram needs a positive length scale, got {ls}.")


def matern52_gram(x, y, ls):
    """Matern-5/2 cross-covariance k(x, y), shape (n, m), in x's dtype.

    CPU tensors take :func:`matern52_gram_reference`; CUDA tensors launch
    the hand-written kernel on the current stream (``matern52_gram.launches``
    counts those launches) and raise if it cannot launch.  Where grad mode
    is on and an operand requires grad, the call goes through
    :class:`_Matern52Gram` and the result has a gradient; otherwise it adds
    nothing to the call's host time.
    """
    ls = float(ls)
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        return _Matern52Gram.apply(x, y, ls)
    return _matern52_gram(x, y, ls)


def _matern52_gram(x, y, ls):
    _check_operands(x, y, ls)
    device = x.device
    if device.type == "cpu":
        return matern52_gram_reference(x, y, ls)
    if device.type != "cuda":
        raise ValueError(f"matern52_gram runs on cpu or cuda, not {device}.")
    n, d = x.shape
    m = y.shape[0]
    if max(n, m, d) >= 2**31:
        raise ValueError(
            f"matern52_gram takes fewer than 2**31 rows of x and of y and "
            f"features, got {n}, {m} and {d}."
        )
    x = x.contiguous()
    y = y.contiguous()
    # new_empty: half the host time of torch.empty(..., dtype=, device=)
    out = x.new_empty((n, m))
    if n == 0 or m == 0:
        return out
    fn = _entry.get(x.dtype)
    if fn is None:
        _library()
        fn = _entry[x.dtype]
    scratch = x.new_empty(_lib.matern52_scratch_elems(n, m, d, x.element_size()))
    index = device.index
    # the current stream's cudaStream_t, without building a torch.cuda.Stream
    stream = torch._C._cuda_getCurrentRawStream(index)
    code = fn(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        n, m, d, ls, index, stream,
    )
    if code != 0:
        raise RuntimeError(
            "matern52_gram kernel launch failed: "
            f"{_library().matern52_error_string(code).decode()} (cudaError {code})."
        )
    matern52_gram.launches += 1
    return out


matern52_gram.launches = 0
