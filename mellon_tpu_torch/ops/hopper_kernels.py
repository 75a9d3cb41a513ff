"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterpart of ``mellon_tpu/ops/pallas_kernels.py``.  Two kernels:

* the fused Matern-5/2 covariance tile (``csrc/matern52_tile.cu``), which
  replaces the Pallas kernel ``matern52_gram_pallas``;
* the step of the greedy pivoted partial Cholesky (``csrc/pivot_step.cu``,
  :func:`pivot_step`), which replaces no TPU kernel: it reads its step from
  a state on the device (:class:`PivotState`), so that a CUDA graph of its
  launches runs any number of steps (``ops/linalg.py``).

On the density main path the Matern-5/2 tile
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

The length scale is a number, or a 0-d float64 tensor on the operands'
device, which the kernel reads on the device when it runs: a launch
captured in a CUDA graph (``models/fused.py``) then replays with the value
the tensor holds at the replay.  A launch made while a graph is captured
(:func:`captured_launches`) runs only when the graph replays, so it is
counted by :func:`count_replay` at each replay, not when it is captured;
so are the pivot steps captured there.
"""

import contextlib
import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..utils import profiling

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
MATERN52_SOURCE = CSRC_DIR / "matern52_tile.cu"
PIVOT_SOURCE = CSRC_DIR / "pivot_step.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lib = None
_lib_lock = threading.Lock()
# the library's entry points for each dtype, filled when it loads: the
# length scale passed as a number, and read from a device tensor
_entry = {}
_entry_dev_ls = {}
# the operands of the launches made while a CUDA graph is being captured
# (None outside a capture); see captured_launches
_captured = None


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


def build_library(source=MATERN52_SOURCE):
    """Compile ``source`` (a ``csrc/`` file, the Matern-5/2 tile by default)
    into ``build/`` unless a library built from the same source and flags
    is there; returns its path."""
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    target = BUILD_DIR / f"lib{source.stem}-{digest}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source.name}:\n"
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
            # the _dev_ls entries take the length scale's device pointer
            dev_ls_argtypes = argtypes[:7] + [ctypes.c_void_p] + argtypes[8:]
            for fn, types in ((lib.matern52_gram_f32, argtypes),
                              (lib.matern52_gram_f64, argtypes),
                              (lib.matern52_gram_f32_dev_ls, dev_ls_argtypes),
                              (lib.matern52_gram_f64_dev_ls, dev_ls_argtypes)):
                fn.argtypes = types
                fn.restype = ctypes.c_int
            lib.matern52_scratch_elems.argtypes = [ctypes.c_int] * 4
            lib.matern52_scratch_elems.restype = ctypes.c_longlong
            lib.matern52_error_string.argtypes = [ctypes.c_int]
            lib.matern52_error_string.restype = ctypes.c_char_p
            _entry[torch.float32] = lib.matern52_gram_f32
            _entry[torch.float64] = lib.matern52_gram_f64
            _entry_dev_ls[torch.float32] = lib.matern52_gram_f32_dev_ls
            _entry_dev_ls[torch.float64] = lib.matern52_gram_f64_dev_ls
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
    if isinstance(ls, torch.Tensor):
        # its value lies on the device: reading it here would sync
        if ls.ndim != 0 or ls.dtype != torch.float64 or ls.device != x.device:
            raise ValueError(
                "matern52_gram takes a tensor length scale as a 0-d float64 tensor on "
                f"the operands' device, got {tuple(ls.shape)} {ls.dtype} on {ls.device}."
            )
    elif not ls > 0:
        raise ValueError(f"matern52_gram needs a positive length scale, got {ls}.")


def matern52_gram(x, y, ls):
    """Matern-5/2 cross-covariance k(x, y), shape (n, m), in x's dtype.

    CPU tensors take :func:`matern52_gram_reference`; CUDA tensors launch
    the hand-written kernel on the current stream (``matern52_gram.launches``
    counts those launches) and raise if it cannot launch.  ``ls`` is a
    number or a 0-d float64 tensor on the operands' device (read there by
    the kernel).  Where grad mode is on and an operand requires grad, the
    call goes through :class:`_Matern52Gram` and the result has a
    gradient; otherwise it adds nothing to the call's host time.
    """
    if isinstance(ls, torch.Tensor):
        return _matern52_gram(x, y, ls)
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
    if _lib is None:
        _library()
    if isinstance(ls, torch.Tensor):
        fn, ls_arg = _entry_dev_ls[x.dtype], ls.data_ptr()
    else:
        fn, ls_arg = _entry[x.dtype], ls
    scratch = x.new_empty(_lib.matern52_scratch_elems(n, m, d, x.element_size()))
    index = device.index
    # the current stream's cudaStream_t, without building a torch.cuda.Stream
    stream = torch._C._cuda_getCurrentRawStream(index)
    code = fn(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        n, m, d, ls_arg, index, stream,
    )
    if code != 0:
        raise RuntimeError(
            "matern52_gram kernel launch failed: "
            f"{_library().matern52_error_string(code).decode()} (cudaError {code})."
        )
    if _captured is not None:
        _captured.append((x, y, ls))
    else:
        matern52_gram.launches += 1
    return out


class _Captured(list):
    """The Matern-5/2 calls made while a CUDA graph is captured (its items,
    ``(x, y, ls)``) and the pivot steps launched there (``pivot_steps``)."""

    pivot_steps = 0


@contextlib.contextmanager
def captured_launches():
    """Inside this context the kernels' launches are those of a CUDA graph
    being captured: they run when the graph replays.  Yields the list of
    the Matern-5/2 calls' operands ``(x, y, ls)``, filled as the capture
    goes, with the count of pivot steps as its ``pivot_steps``; hand it to
    :func:`count_replay` at each replay of the graph."""
    global _captured
    _captured = _Captured()
    try:
        yield _captured
    finally:
        _captured = None


def count_replay(calls):
    """Count the launches that one replay of a CUDA graph made: one for each
    kernel call captured in it (``calls``, from :func:`captured_launches`),
    and its pivot steps, also in the ``pivot.kernel_steps`` counter."""
    matern52_gram.launches += len(calls)
    steps = getattr(calls, "pivot_steps", 0)
    if steps:
        pivot_step.launches += steps
        profiling.count("pivot.kernel_steps", steps)


# the kernel's launches on CUDA tensors, eager and replayed
matern52_gram.launches = 0


# ---------------------------------------------------------------------------
# the pivoted partial Cholesky's step
# ---------------------------------------------------------------------------

# the slots of PivotState.ints and .vals (csrc/pivot_step.cu)
_J, _R, _P, _ACTIVE, _TICKET, _INT_PARTS = range(6)
_THRESH, _SQRT_DP, _VAL_PARTS = range(3)

_pivot_lib = None
_pivot_entry = {}


class PivotState:
    """The greedy pivoted partial Cholesky of the PSD ``K`` (m, m) between
    two steps, as tensors on K's device that :func:`pivot_step` changes in
    place: ``L`` (m, width), the factor's columns so far and zero past them
    (a view whose rows lie a multiple of 4 elements apart, for the kernel's
    16-byte loads); ``d`` (m,), the residual diagonal; ``piv`` (width,),
    the steps' pivots (0 where a step was masked); ``ints`` (int64): the
    step j, the count r of steps that ran, the next step's pivot p, its
    flag ``active`` (the stopping rule held so far), the kernel's block
    ticket, then one argmax per block of the kernel; ``vals`` (K's dtype):
    the stopping threshold, sqrt(d[p]), then one max per block.  The
    blocks' slots are the kernel's: their count follows m and the rows of
    its block, which the library exports, and the CPU has none.  Every
    buffer is allocated here, zero; ``ops/linalg.py`` writes the first
    step's state."""

    def __init__(self, K, width):
        if K.ndim != 2 or K.shape[0] != K.shape[1] or not K.is_contiguous():
            raise ValueError(f"the pivoted Cholesky takes a contiguous square K, got "
                             f"{tuple(K.shape)} with strides {K.stride()}.")
        if K.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"the pivoted Cholesky takes float32 or float64, got {K.dtype}.")
        m = K.shape[0]
        if m >= 2**31:
            raise ValueError(f"the pivoted Cholesky takes fewer than 2**31 rows, got {m}.")
        blocks = 0
        if K.device.type == "cuda":
            blocks = -(-m // _pivot_library().pivot_step_block_rows())
        self.K = K
        self.L = K.new_zeros((m, -(-width // 4) * 4))[:, :width]
        self.d = K.new_zeros(m)
        self.piv = torch.zeros(width, dtype=torch.int64, device=K.device)
        self.ints = torch.zeros(_INT_PARTS + blocks, dtype=torch.int64, device=K.device)
        self.vals = K.new_zeros(_VAL_PARTS + blocks)

    @property
    def r(self):
        """The count of steps that ran, a 0-d tensor."""
        return self.ints[_R]

    def widened(self, width):
        """A state of ``width`` columns that holds this one's: its L and
        pivots copied into the first columns, the rest zero."""
        wide = PivotState(self.K, width)
        old = self.L.shape[1]
        wide.L[:, :old].copy_(self.L)
        wide.piv[:old].copy_(self.piv)
        for name in ("d", "ints", "vals"):
            getattr(wide, name).copy_(getattr(self, name))
        return wide


def choose_pivot(state, active):
    """Write the next step's pivot p = argmax d (the first of equal
    maxima), sqrt(d[p]) and flag ``active & (max d > thresh)`` into
    ``state``; ``active`` is a bool or a 0-d bool tensor."""
    d = state.d
    dmax = torch.max(d)
    state.ints[_ACTIVE:_ACTIVE + 1].copy_(active & (dmax > state.vals[_THRESH]))
    state.ints[_P:_P + 1].copy_(torch.argmax(d, dim=0, keepdim=True))
    state.vals[_SQRT_DP:_SQRT_DP + 1].copy_(torch.sqrt(dmax))


def pivot_step_reference(state, j):
    """Step ``j`` of the greedy pivoted partial Cholesky on ``state`` in
    plain PyTorch, as the kernel computes it: col = K[:, p] − L[:, :j]
    L[p, :j], L[:, j] = col / sqrt(d[p]), d = max(d − L[:, j]², 0) with
    d[p] = 0, piv[j] = p and r + 1 where the step is active; a masked one
    leaves L, d and r as they are and writes pivot 0.  Then
    :func:`choose_pivot` for the next step.  The pivot stays a one-element
    tensor (``index_select``): indexing with a 0-d tensor would read it on
    the host."""
    K, L, d, ints = state.K, state.L, state.d, state.ints
    active = ints[_ACTIVE] != 0
    p = ints[_P:_P + 1]
    col = K.index_select(1, p)[:, 0] - L[:, :j] @ L.index_select(0, p)[0, :j]
    l_col = torch.where(active, col / state.vals[_SQRT_DP], 0.0)
    d_new = torch.clamp_min(d - l_col * l_col, 0.0)
    rows = torch.arange(d.shape[0], device=d.device)
    d.copy_(torch.where(active & (rows != p), d_new, torch.where(active, 0.0, d)))
    L[:, j] = l_col
    state.piv[j:j + 1] = torch.where(active, p, 0)
    ints[_R:_R + 1].add_(active)
    choose_pivot(state, active)
    ints[_J:_J + 1].add_(1)


def _pivot_library():
    global _pivot_lib
    with _lib_lock:
        if _pivot_lib is None:
            lib = ctypes.CDLL(str(build_library(PIVOT_SOURCE)))
            argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            for fn in (lib.pivot_step_f32, lib.pivot_step_f64):
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.pivot_step_block_rows.argtypes = []
            lib.pivot_step_block_rows.restype = ctypes.c_int
            lib.pivot_step_load.argtypes = [ctypes.c_int]
            lib.pivot_step_load.restype = ctypes.c_int
            lib.pivot_step_error_string.argtypes = [ctypes.c_int]
            lib.pivot_step_error_string.restype = ctypes.c_char_p
            _pivot_entry[torch.float32] = lib.pivot_step_f32
            _pivot_entry[torch.float64] = lib.pivot_step_f64
            _pivot_lib = lib
        return _pivot_lib


def _pivot_check(code, what):
    if code != 0:
        raise RuntimeError(
            f"pivot_step kernel {what} failed: "
            f"{_pivot_library().pivot_step_error_string(code).decode()} (cudaError {code})."
        )


def load_pivot_step(device):
    """Build and load the step kernel on the CUDA ``device`` ahead of a
    CUDA graph's capture, which then need not load it."""
    _pivot_check(_pivot_library().pivot_step_load(torch.device(device).index or 0), "load")


def pivot_step(state, j):
    """Step ``j`` of the greedy pivoted partial Cholesky on ``state`` (a
    :class:`PivotState`), in place.

    CPU tensors take :func:`pivot_step_reference`; CUDA tensors launch the
    hand-written kernel on the current stream (``pivot_step.launches``
    counts the launches, and the ``pivot.kernel_steps`` counter of
    :mod:`..utils.profiling` the steps) and raise if it cannot launch.  The
    kernel reads its step from the state on the device, not ``j`` (the
    plain version's), so a launch captured in a CUDA graph runs, at each
    replay, the step the state has reached; past the state's width it does
    nothing.
    """
    K = state.K
    device = K.device
    if device.type == "cpu":
        pivot_step_reference(state, j)
        return
    if device.type != "cuda":
        raise ValueError(f"pivot_step runs on cpu or cuda, not {device}.")
    if _pivot_lib is None:
        _pivot_library()
    L = state.L
    index = device.index
    code = _pivot_entry[K.dtype](
        K.data_ptr(), L.data_ptr(), state.d.data_ptr(), state.piv.data_ptr(),
        state.ints.data_ptr(), state.vals.data_ptr(), K.shape[0], L.shape[1], L.stride(0),
        index, torch._C._cuda_getCurrentRawStream(index),
    )
    _pivot_check(code, "launch")
    if _captured is not None:
        _captured.pivot_steps += 1
    else:
        pivot_step.launches += 1
        profiling.count("pivot.kernel_steps")


# the step kernel's launches, eager and replayed
pivot_step.launches = 0
