"""Per-point gradient, Hessian and log-determinant of the Hessian of a
row-wise function (counterpart of ``mellon_tpu/inference/derivatives.py``).

The JAX package vmaps ``jacrev``/``jacfwd`` over the rows.  Here the
function is a predictor's mean, whose i-th value depends on the i-th row
alone, so one backward pass of the sum gives every row's gradient, and one
more pass per feature column gives the Hessian.  (``torch.func.vmap``
cannot trace the kernel's launch.)  The derivative of a function of time
on a 1-d grid (``derivative``) comes with the time-sensitive estimator
(ROADMAP Queue 1, item 15).
"""

import torch


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
