"""Covariance kernels (counterpart of ``mellon_tpu/ops/kernels.py``).

:class:`Matern52`, the default kernel of every estimator, evaluates through
the hand-written Hopper tile (:func:`.hopper_kernels.matern52_gram`) on CUDA
tensors.  The other five cores are plain PyTorch: no TPU kernel computes
them and no default path uses them.  The Add/Mul/Pow algebra, active_dims
and covariance JSON are not ported yet (ROADMAP Queue 1, item 2).
"""

import math
from abc import ABC, abstractmethod

import torch

from ..utils.util import distance
from .hopper_kernels import matern52_gram


def _matern32_vals(x, y, ls):
    r = math.sqrt(3.0) * distance(x, y) / ls
    return (r + 1) * torch.exp(-r)


def _expquad_vals(x, y, ls):
    r = distance(x, y) / ls
    return torch.exp(-r * r / 2)


def _exponential_vals(x, y, ls):
    r = distance(x, y) / ls
    return torch.exp(-r / 2)


def _ratquad_vals(x, y, ls, alpha):
    r = distance(x, y) / ls
    return (r * r / (2 * alpha) + 1) ** -alpha


def _linear_vals(x, y, ls):
    return (x @ y.T) / ls


class Covariance(ABC):
    """Base covariance function: ``k(x, y)`` on (n, d) and (m, d) tensors."""

    def __repr__(self):
        arguments = ", ".join(f"{key}={val}" for key, val in self.__dict__.items())
        return f"{self.__class__.__name__}({arguments})"

    __str__ = __repr__

    @abstractmethod
    def k(self, x, y):
        ...

    def __call__(self, x, y):
        return self.k(x, y)

    @abstractmethod
    def diag(self, x):
        """Diagonal of k(x, x), shape (n,)."""


class _RadialKernel(Covariance):
    """Isotropic kernels k(x, y) = g(‖x−y‖); their diagonal is g at the
    floored zero distance of :func:`distance`."""

    def __init__(self, ls=1.0):
        self.ls = ls

    def diag(self, x):
        xx = torch.sum(x * x, dim=1)
        sq = xx - 2 * xx + xx + 1e-12
        zero = torch.sqrt(torch.clamp_min(sq, 1e-12))
        # evaluate the profile at each point's own (floored) zero distance
        return self._profile(zero)


class Matern32(_RadialKernel):
    R"""Matern-3/2: :math:`(1 + \sqrt{3} r / l) e^{-\sqrt{3} r / l}`."""

    def k(self, x, y):
        return _matern32_vals(x, y, self.ls)

    def _profile(self, dist):
        r = math.sqrt(3.0) * dist / self.ls
        return (r + 1) * torch.exp(-r)


class Matern52(_RadialKernel):
    R"""Matern-5/2, the default kernel:
    :math:`(1 + \sqrt{5} r / l + 5 r^2 / (3 l^2)) e^{-\sqrt{5} r / l}`.
    Evaluated by the hand-written CUDA tile on CUDA tensors."""

    def k(self, x, y):
        return matern52_gram(x, y, self.ls)

    def _profile(self, dist):
        r = math.sqrt(5.0) * dist / self.ls
        return (r + r * r / 3 + 1) * torch.exp(-r)


class ExpQuad(_RadialKernel):
    R"""Squared-exponential: :math:`e^{-r^2 / (2 l^2)}`."""

    def k(self, x, y):
        return _expquad_vals(x, y, self.ls)

    def _profile(self, dist):
        r = dist / self.ls
        return torch.exp(-r * r / 2)


class Exponential(_RadialKernel):
    R"""Exponential: :math:`e^{-r / (2 l)}`."""

    def k(self, x, y):
        return _exponential_vals(x, y, self.ls)

    def _profile(self, dist):
        return torch.exp(-(dist / self.ls) / 2)


class RatQuad(_RadialKernel):
    R"""Rational quadratic: :math:`(1 + r^2/(2\alpha l^2))^{-\alpha}`."""

    def __init__(self, alpha=1.0, ls=1.0):
        super().__init__(ls=ls)
        self.alpha = alpha

    def k(self, x, y):
        return _ratquad_vals(x, y, self.ls, self.alpha)

    def _profile(self, dist):
        r = dist / self.ls
        return (r * r / (2 * self.alpha) + 1) ** -self.alpha


class Linear(Covariance):
    R"""Linear: :math:`x \cdot y / l`."""

    def __init__(self, ls=1.0):
        self.ls = ls

    def k(self, x, y):
        return _linear_vals(x, y, self.ls)

    def diag(self, x):
        return torch.sum(x * x, dim=1) / self.ls
