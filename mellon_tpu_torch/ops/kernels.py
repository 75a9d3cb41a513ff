"""Covariance kernels (counterpart of ``mellon_tpu/ops/kernels.py``): six
cores, the Add/Mul/Pow algebra, ``active_dims``, analytic gradients and
JSON in the format the JAX package and the reference Mellon read.

:class:`Matern52`, the default kernel of every estimator, evaluates through
the hand-written Hopper tile (:func:`.hopper_kernels.matern52_gram`) on CUDA
tensors, inside a composite too.  The other five cores are plain PyTorch:
no TPU kernel computes them and no default path uses them.

The JAX package's operand specs (``operand_spec``/``eval_operand_spec``)
exist to key jitted XLA programs; PyTorch evaluates a composite eagerly, so
they are not ported.
"""

import json
import logging
import math
import sys
from abc import ABC, abstractmethod
from datetime import datetime
from importlib import import_module

import torch

from ..utils.util import (
    deserialize,
    distance,
    distance_grad,
    expand_to_inactive,
    make_serializable,
    select_active_dims,
)
from .hopper_kernels import matern52_gram

logger = logging.getLogger("mellon_tpu_torch")

PACKAGE_NAME = __name__.split(".")[0]
# serialization type tag shared with mellon_tpu and the reference Mellon
COV_TYPE_TAG = "mellon.Covariance"
# packages whose classes are not this package's: their module names are
# never imported, a class is resolved by its name here
FOREIGN_PACKAGES = ("mellon", "mellon_tpu")

# the floored distance of a point to itself (``distance``'s 1e-12 floor)
_ZERO_DISTANCE = math.sqrt(1e-12)


class Covariance(ABC):
    """Base covariance function: ``k(x, y)`` on (n, d) and (m, d) tensors."""

    def __init__(self, active_dims=None):
        self.active_dims = active_dims

    def __repr__(self):
        arguments = ", ".join(
            f"{key}={val}"
            for key, val in self.__dict__.items()
            if key != "active_dims" or val is not None
        )
        return f"{self.__class__.__name__}({arguments})"

    def __str__(self):
        return self.__repr__()

    @abstractmethod
    def k(self, x, y):
        ...

    def __call__(self, x, y):
        return self.k(x, y)

    @abstractmethod
    def diag(self, x):
        """Diagonal of k(x, x), shape (n,): each point against itself at
        the floored zero distance, as the JAX package evaluates it."""

    def k_grad(self, x):
        """``y -> ∂k(xᵢ, yⱼ)/∂yⱼ``, shape (n, m, d), by autograd, one row of
        x at a time (every kernel of this module has an analytic one)."""

        def grad_fn(y):
            rows = []
            for i in range(x.shape[0]):
                y_ = y.detach().requires_grad_(True)
                with torch.enable_grad():
                    (g,) = torch.autograd.grad(self.k(x[i : i + 1], y_).sum(), y_)
                rows.append(g)
            return torch.stack(rows)

        return grad_fn

    def __add__(self, other):
        return Add(self, other)

    __radd__ = __add__

    def __mul__(self, other):
        return Mul(self, other)

    __rmul__ = __mul__

    def __pow__(self, other):
        return Pow(self, other)

    # -- serialization ------------------------------------------------------

    def _metadata(self, module_name):
        try:
            version = getattr(import_module(module_name.split(".")[0]), "__version__", "NA")
        except ImportError:
            version = "NA"
        return {
            "classname": self.__class__.__name__,
            "module_name": module_name,
            "module_version": version,
            "serialization_date": datetime.now().isoformat(),
            "python_version": sys.version,
        }

    def __getstate__(self):
        module_name = self.__class__.__module__
        if module_name == "__main__":
            logger.warning(
                f'The covariance function "{self.__class__.__name__}" is not part '
                f"of {PACKAGE_NAME} and seems to be user defined. Make sure the "
                "implementation is available for deserialization."
            )
        return {
            "type": COV_TYPE_TAG,
            "data": {key: make_serializable(val) for key, val in self.__dict__.items()},
            "metadata": self._metadata(module_name),
        }

    def __setstate__(self, state):
        for name, value in state["data"].items():
            setattr(self, name, deserialize(value))

    def to_json(self):
        return json.dumps(self.__getstate__())

    def to_dict(self):
        return self.__getstate__()

    @classmethod
    def from_json(cls, json_str):
        return cls.from_dict(json.loads(json_str))

    @classmethod
    def from_dict(cls, state):
        if not isinstance(state, dict) or state.get("type") != COV_TYPE_TAG:
            raise ValueError("The passed dict does not seem to define a covariance kernel.")
        metadata = state["metadata"]
        Subclass = _resolve_covariance_class(metadata["classname"], metadata["module_name"])
        instance = Subclass.__new__(Subclass)
        instance.__setstate__(state)
        return instance


def _resolve_covariance_class(clsname, module_name):
    """A kernel class by name first (files of mellon_tpu and of the
    reference name their own modules), then from the stated module unless
    that module belongs to another package."""
    if isinstance(globals().get(clsname), type) and issubclass(globals()[clsname], Covariance):
        return globals()[clsname]
    if module_name.split(".")[0] not in FOREIGN_PACKAGES:
        try:
            return getattr(import_module(module_name), clsname)
        except (ImportError, AttributeError):
            pass
    raise ValueError(f"Cannot resolve covariance class {clsname} from module {module_name}.")


class CovariancePair(Covariance):
    """Composite of a covariance and another one or a number."""

    def __init__(self, left, right, active_dims=None):
        super().__init__(active_dims)
        self.left = left
        self.right = right

    def _right(self, method, x):
        """``right.method(x)`` for a covariance, the number itself otherwise."""
        return getattr(self.right, method)(x) if callable(self.right) else self.right

    def __getstate__(self):
        right = self.right
        return {
            "type": COV_TYPE_TAG,
            "left_data": self.left.__getstate__(),
            "right_data": right.__getstate__() if callable(right) else make_serializable(right),
            "active_dims": make_serializable(self.active_dims),
            "metadata": self._metadata(self.__class__.__module__.split(".")[0]),
        }

    def __setstate__(self, state):
        if not isinstance(state, dict) or state.get("type") != COV_TYPE_TAG:
            raise ValueError("The passed dict does not seem to define a covariance kernel.")
        self.active_dims = deserialize(state.get("active_dims", None))
        self.left = Covariance.from_dict(state["left_data"])
        right = state["right_data"]
        if isinstance(right, dict) and right.get("type") == COV_TYPE_TAG:
            self.right = Covariance.from_dict(right)
        else:
            self.right = deserialize(right)


class Add(CovariancePair):
    """Sum kernel."""

    def __repr__(self):
        return f"({self.left!r} + {self.right!r})"

    def k(self, x, y):
        x = select_active_dims(x, self.active_dims)
        y = select_active_dims(y, self.active_dims)
        right = self.right(x, y) if callable(self.right) else self.right
        return self.left(x, y) + right

    def diag(self, x):
        x = select_active_dims(x, self.active_dims)
        return self.left.diag(x) + self._right("diag", x)

    def k_grad(self, x):
        x_shape = x.shape
        dims = self.active_dims
        x = select_active_dims(x, dims)
        left_grad = self.left.k_grad(x)
        right_grad = self.right.k_grad(x) if callable(self.right) else None

        def k_grad(y):
            y_act = select_active_dims(y, dims)
            grad = left_grad(y_act)
            if right_grad is not None:
                grad = grad + right_grad(y_act)
            return expand_to_inactive(grad, x_shape[:-1] + y.shape, dims)

        return k_grad


class Mul(CovariancePair):
    """Product kernel with the product rule for its gradient."""

    def __repr__(self):
        return f"({self.left!r} * {self.right!r})"

    def k(self, x, y):
        x = select_active_dims(x, self.active_dims)
        y = select_active_dims(y, self.active_dims)
        right = self.right(x, y) if callable(self.right) else self.right
        return self.left(x, y) * right

    def diag(self, x):
        x = select_active_dims(x, self.active_dims)
        return self.left.diag(x) * self._right("diag", x)

    def k_grad(self, x):
        x_shape = x.shape
        dims = self.active_dims
        x_act = select_active_dims(x, dims)
        left_grad_func = self.left.k_grad(x_act)
        right_grad_func = self.right.k_grad(x_act) if callable(self.right) else None

        def k_grad(y):
            y_act = select_active_dims(y, dims)
            left_grad = left_grad_func(y_act)
            if right_grad_func is not None:
                left_k = self.left.k(x_act, y_act)[..., None]
                right_k = self.right.k(x_act, y_act)[..., None]
                grad = left_grad * right_k + left_k * right_grad_func(y_act)
            else:
                grad = left_grad * self.right
            return expand_to_inactive(grad, x_shape[:-1] + y.shape, dims)

        return k_grad


class Pow(CovariancePair):
    """Power kernel (a number on the right) with the chain rule for its
    gradient."""

    def __repr__(self):
        return f"({self.left!r} ** {self.right!r})"

    def k(self, x, y):
        x = select_active_dims(x, self.active_dims)
        y = select_active_dims(y, self.active_dims)
        return self.left(x, y) ** self.right

    def diag(self, x):
        return self.left.diag(select_active_dims(x, self.active_dims)) ** self.right

    def k_grad(self, x):
        x_shape = x.shape
        dims = self.active_dims
        x_act = select_active_dims(x, dims)
        base_grad_func = self.left.k_grad(x_act)

        def k_grad(y):
            y_act = select_active_dims(y, dims)
            base_k = self.left.k(x_act, y_act)[..., None]
            grad = self.right * base_k ** (self.right - 1) * base_grad_func(y_act)
            return expand_to_inactive(grad, x_shape[:-1] + y.shape, dims)

        return k_grad


class _RadialKernel(Covariance):
    """Isotropic kernels k(x, y) = g(c·‖x−y‖/ls): each core gives its
    profile ``_profile(dist)`` and the derivative ``_dk_dr(r)`` of g at the
    scaled distance r = ``_r_scale``·dist/ls, from which the analytic
    ∂k/∂y follows by the chain rule."""

    _r_scale = 1.0

    def __init__(self, ls=1.0, active_dims=None):
        super().__init__(active_dims)
        self.ls = ls

    def k(self, x, y):
        x = select_active_dims(x, self.active_dims)
        y = select_active_dims(y, self.active_dims)
        return self._profile(distance(x, y))

    def diag(self, x):
        return self._profile(x.new_full(x.shape[:1], _ZERO_DISTANCE))

    def k_grad(self, x):
        x_shape = x.shape
        dims = self.active_dims
        pairwise = distance_grad(select_active_dims(x, dims))
        scale = self._r_scale / self.ls

        def grad_fn(y):
            dist, ddist_dy = pairwise(select_active_dims(y, dims))
            chain = self._dk_dr(scale * dist[..., None]) * (scale * ddist_dy)
            return expand_to_inactive(chain, x_shape[:-1] + y.shape, dims)

        return grad_fn


class Matern32(_RadialKernel):
    R"""Matern-3/2: :math:`(1 + \sqrt{3} r / l) e^{-\sqrt{3} r / l}`."""

    _r_scale = math.sqrt(3.0)

    def _profile(self, dist):
        r = self._r_scale * dist / self.ls
        return (r + 1) * torch.exp(-r)

    def _dk_dr(self, r):
        return -r * torch.exp(-r)


class Matern52(_RadialKernel):
    R"""Matern-5/2, the default kernel:
    :math:`(1 + \sqrt{5} r / l + 5 r^2 / (3 l^2)) e^{-\sqrt{5} r / l}`.
    Evaluated by the hand-written CUDA tile on CUDA tensors."""

    _r_scale = math.sqrt(5.0)

    def k(self, x, y):
        x = select_active_dims(x, self.active_dims)
        y = select_active_dims(y, self.active_dims)
        return matern52_gram(x, y, self.ls)

    def _profile(self, dist):
        r = self._r_scale * dist / self.ls
        return (r + r * r / 3 + 1) * torch.exp(-r)

    def _dk_dr(self, r):
        return -(r + r * r) / 3 * torch.exp(-r)


class ExpQuad(_RadialKernel):
    R"""Squared-exponential: :math:`e^{-r^2 / (2 l^2)}`."""

    def _profile(self, dist):
        r = dist / self.ls
        return torch.exp(-r * r / 2)

    def _dk_dr(self, r):
        return -r * torch.exp(-r * r / 2)


class Exponential(_RadialKernel):
    R"""Exponential: :math:`e^{-r / (2 l)}`."""

    def _profile(self, dist):
        return torch.exp(-(dist / self.ls) / 2)

    def _dk_dr(self, r):
        return -torch.exp(-r / 2) / 2


class RatQuad(_RadialKernel):
    R"""Rational quadratic: :math:`(1 + r^2/(2\alpha l^2))^{-\alpha}`."""

    def __init__(self, alpha=1.0, ls=1.0, active_dims=None):
        super().__init__(ls=ls, active_dims=active_dims)
        self.alpha = alpha

    def _profile(self, dist):
        r = dist / self.ls
        return (r * r / (2 * self.alpha) + 1) ** -self.alpha

    def _dk_dr(self, r):
        return -r * (r * r / (2 * self.alpha) + 1) ** (-self.alpha - 1)


class Linear(Covariance):
    R"""Linear: :math:`x \cdot y / l`; ∂k(x, y)/∂y = x/l."""

    def __init__(self, ls=1.0, active_dims=None):
        super().__init__(active_dims)
        self.ls = ls

    def k(self, x, y):
        x = select_active_dims(x, self.active_dims)
        y = select_active_dims(y, self.active_dims)
        return (x @ y.T) / self.ls

    def diag(self, x):
        x = select_active_dims(x, self.active_dims)
        return torch.sum(x * x, dim=1) / self.ls

    def k_grad(self, x):
        x_shape = x.shape
        dims = self.active_dims
        x_act = select_active_dims(x, dims)

        def grad_fn(y):
            n_y = select_active_dims(y, dims).shape[0]
            rows = x_act[:, None, :].expand(x_act.shape[0], n_y, x_act.shape[-1])
            return expand_to_inactive(rows / self.ls, x_shape[:-1] + y.shape, dims)

        return grad_fn
