"""Per-point gradient, Hessian and log-determinant of the Hessian of a
row-wise function (counterpart of ``mellon_tpu/inference/derivatives.py``).

The JAX package vmaps ``jacrev``/``jacfwd`` over the rows.  Here the
function is a predictor's mean, whose i-th value depends on the i-th row
alone, so one backward pass of the sum gives every row's gradient, and one
more pass per feature column gives the Hessian.  (``torch.func.vmap``
cannot trace the kernel's launch.)  :func:`derivative` differentiates a
function of one number (a time) at every point of a 1-d grid.
"""

import torch

from ..utils.validation import validate_1d, validate_float


def gradient(function, x):
    """∂f(xᵢ)/∂xᵢ at each row of x, shape (n, d)."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        (grad,) = torch.autograd.grad(function(x).sum(), x)
    return grad


def hessian(function, x):
    """∂²f(xᵢ)/∂xᵢ∂xᵢ at each row of x, shape (n, d, d)."""
    x = x.detach().requires_grad_(True)
    d = x.shape[1]
    with torch.enable_grad():
        (grad,) = torch.autograd.grad(function(x).sum(), x, create_graph=True)
        rows = [
            torch.autograd.grad(grad[:, j].sum(), x, retain_graph=j < d - 1)[0]
            for j in range(d)
        ]
    return torch.stack(rows, dim=1)


def hessian_log_determinant(function, x):
    """``(sign, log|det|)`` of each row's Hessian, each of shape (n,)."""
    sign, logdet = torch.linalg.slogdet(hessian(function, x))
    return sign, logdet


def derivative(function, x, jit=True):
    """The derivative of ``function``, which maps one number to a tensor,
    at each point of the 1-d grid x: shape ``function(x₀).shape[::-1] +
    (T,)`` as in the JAX package (the Jacobians stacked on the last axis);
    at a single number, the Jacobian itself.  ``function`` is called once
    per point (it takes one number), and every output element is
    differentiated at once: out[t] depends only on x[t], so the
    vector-Jacobian product with cotangent u, vᵤ[t] = Σⱼ u[t, j]·∂out[t, j]/∂x[t],
    is linear in u with ∂vᵤ[t]/∂u[t, j] the wanted derivative, and two
    backward passes (vᵤ, then the gradient of Σ vᵤ in u) give the whole
    Jacobian, whatever the output's size.  ``jit`` is accepted and
    ignored."""
    scalar = isinstance(x, (int, float)) or (hasattr(x, "ndim") and x.ndim == 0)
    x = torch.tensor([validate_float(x, "x")], dtype=torch.float64) if scalar else validate_1d(x)
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        out = torch.stack([torch.as_tensor(function(t)) for t in x])
        u = torch.zeros_like(out, requires_grad=True)
        (vjp,) = torch.autograd.grad(out, x, grad_outputs=u, create_graph=True)
        (jac,) = torch.autograd.grad(vjp.sum(), u)
    return jac[0] if scalar else jac.permute(*reversed(range(jac.ndim)))
