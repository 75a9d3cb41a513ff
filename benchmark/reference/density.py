"""Plain PyTorch reference of Mellon's sparse-GP density model.

It imports nothing of the program and takes nothing it computed but the
landmarks: the 1-NN distances, the heuristics d, μ and ls, the Matern-5/2
covariance, the whitening L = k(x, xu) Lp⁻ᵀ, the density loss with its
gradient and Hessian, the MAP by Newton's method and the predictor's mean
are worked out again here from the cells, in the precision ``Arith``
names: float64 for the truth, float32 with every matrix product's
operands rounded to TF32 for the control (the precision a later change
would be tempted to switch on: the program runs float32 with TF32 off).

The model (Otto et al., Mellon): with r the distance of a cell to its
nearest other cell in d dimensions, V = d log r + log(π^(d/2) / Γ(d/2 +
1)) and V' = log d + (d − 1) log r + the same constant, the log density
f = L z + μ has the log likelihood Σ (f + V' − e^(f + V)), and z ~ N(0, I).
"""

import math

import torch

NEWTON_ITERS = 30
JITTER_TRIES = 12
BLOCK = 65536


def tf32(t):
    """float32 ``t`` rounded to TF32 (a 10-bit mantissa), to nearest even,
    as the tensor cores round a TF32 product's operands."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


class Arith:
    """The precision of the reference's arithmetic: ``dtype``, and with
    ``tf32`` every matrix product of float32 operands rounded to TF32 and
    accumulated in float32."""

    def __init__(self, dtype=torch.float64, tf32=False):
        self.dtype = dtype
        self.tf32 = tf32

    def mm(self, a, b):
        if self.tf32:
            return tf32(a) @ tf32(b)
        return a @ b

    def cast(self, t):
        return torch.as_tensor(t).to(self.dtype)


F64 = Arith(torch.float64)
CONTROL = Arith(torch.float32, tf32=True)


def sq_distances(x, y, ar):
    """Pairwise squared distances |x|² − 2x·yᵀ + |y|², floored at 0."""
    xx = (x * x).sum(1)[:, None]
    yy = (y * y).sum(1)[None, :]
    return torch.clamp_min(xx - 2 * ar.mm(x, y.T) + yy, 0)


def nn_distances(x, ar, block=1024):
    """Distance of each row of x to its nearest other row, exactly, over
    blocks of ``block`` rows."""
    n = x.shape[0]
    out = torch.empty(n, dtype=x.dtype, device=x.device)
    for s in range(0, n, block):
        D = sq_distances(x[s : s + block], x, ar)
        rows = torch.arange(D.shape[0], device=x.device)
        D[rows, rows + s] = math.inf
        out[s : s + block] = D.min(dim=1).values
        del D
    return torch.sqrt(out)


def log_volume_terms(nn, d):
    """(V, V') of the 1-NN likelihood."""
    const = d * math.log(math.pi) / 2 - math.lgamma(d / 2 + 1)
    log_r = torch.log(nn)
    return d * log_r + const, math.log(d) + (d - 1) * log_r + const


def heuristics(nn, d):
    """(μ, ls): the 1st percentile of the 1-NN log-density estimate −
    d·log r − const, minus 10, and the geometric mean 1-NN distance times
    e³ (Mellon's defaults)."""
    V, _ = log_volume_terms(nn, d)
    mu = float(torch.quantile(-V.double(), 0.01)) - 10.0
    ls = float(torch.exp(torch.log(nn.double()).mean() + 3.0))
    return mu, ls


def matern52(x, y, ls, ar):
    """Matern-5/2 k(x, y) = (1 + r + r²/3) e^(−r), r = √5·|x − y| / ls."""
    r = math.sqrt(5.0) * torch.sqrt(sq_distances(x, y, ar)) / ls
    return (1 + r + r * r / 3) * torch.exp(-r)


def cholesky(A, jitter=1e-6):
    """(R, jitter): the lower Cholesky factor of A + jitter·I, the jitter
    raised ×10 while it does not factor (from 1e-6 where it starts at 0;
    up to JITTER_TRIES raises)."""
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    for _ in range(JITTER_TRIES + 1):
        R, info = torch.linalg.cholesky_ex(A + jitter * eye)
        if int(info) == 0:
            return R, jitter
        jitter = 10 * jitter if jitter else 1e-6
    raise ValueError("the matrix does not factor")


def landmark_factor(xu, ls, ar):
    """(Lp, jitter): :func:`cholesky` of k(xu, xu)."""
    return cholesky(matern52(xu, xu, ls, ar))


def pivot_gap(K):
    """How far the order of the landmarks departs from the greedy
    diagonally pivoted Cholesky's, which takes at each step the landmark
    of the largest residual variance: over the steps j of the Cholesky of
    K in the given order, the largest amount by which a later landmark's
    residual variance exceeds that of landmark j when j is taken, over
    the largest variance (0 for a greedy order; inf where K does not
    factor, as with a landmark twice)."""
    R, info = torch.linalg.cholesky_ex(K)
    if int(info) != 0:
        return math.inf
    sq = R * R
    residual = torch.diagonal(K)[:, None] - (torch.cumsum(sq, dim=1) - sq)  # (i, before step j)
    later = torch.ones_like(K, dtype=torch.bool).tril(-1)  # i > j
    excess = torch.where(later, residual - torch.diagonal(residual)[None, :], -math.inf)
    return max(float(excess.max()), 0.0) / float(torch.diagonal(K).max())


def whitening(x, xu, ls, Lp, ar, block=BLOCK):
    """L = k(x, xu) Lp⁻ᵀ (n, m), over blocks of rows."""
    return torch.cat([
        torch.linalg.solve_triangular(Lp, matern52(x[s : s + block], xu, ls, ar).T,
                                      upper=False).T
        for s in range(0, x.shape[0], block)])


class Model:
    """The density model's operands in the reference's precision: the
    cells x, the landmarks xu (both cast), and everything worked out from
    them."""

    def __init__(self, x, xu, ar):
        self.ar = ar
        self.x = ar.cast(x)
        self.xu = ar.cast(xu)
        self.d = self.x.shape[1]
        self.nn = nn_distances(self.x, ar)
        self.mu, self.ls = heuristics(self.nn, self.d)
        V, Vd = log_volume_terms(self.nn, self.d)
        self.V, self.Vd = V, Vd
        self.Lp, self.jitter = landmark_factor(self.xu, self.ls, ar)
        self.L = whitening(self.x, self.xu, self.ls, self.Lp, ar)

    def loss_grad(self, Z):
        """(values (C,), gradients (C, k)) of the negative log posterior
        at the rows of Z, without the constant (k/2)·log 2π."""
        Z = self.ar.cast(Z).to(self.L.device)
        values = 0.5 * (Z * Z).sum(1)
        grads = Z.clone()
        for s in range(0, self.L.shape[0], BLOCK):
            Lb = self.L[s : s + BLOCK]
            F = self.ar.mm(Z, Lb.T) + self.mu
            E = torch.exp(F + self.V[s : s + BLOCK])
            values = values - (F + self.Vd[s : s + BLOCK] - E).sum(1)
            grads = grads - self.ar.mm(1 - E, Lb)
        return values, grads

    def hessian(self, z):
        """I + Lᵀ diag(e^(f + V)) L at z (k,)."""
        z = self.ar.cast(z).to(self.L.device)
        k = self.L.shape[1]
        H = torch.eye(k, dtype=self.L.dtype, device=self.L.device)
        for s in range(0, self.L.shape[0], BLOCK):
            Lb = self.L[s : s + BLOCK]
            E = torch.exp(self.ar.mm(Lb, z[:, None])[:, 0] + self.mu + self.V[s : s + BLOCK])
            H = H + self.ar.mm(Lb.T, E[:, None] * Lb)
        return H

    def newton_map(self, z0, tol=1e-10):
        """The MAP z* by Newton's method from z0 (the loss is strictly
        convex, so z* does not depend on z0), halving a step up to 30
        times while the loss does not fall; stops at ‖g‖ ≤ tol·max(1,
        |loss|)."""
        z = self.ar.cast(z0).to(self.L.device)
        (value,), (g,) = self.loss_grad(z[None])
        for _ in range(NEWTON_ITERS):
            if float(torch.linalg.vector_norm(g)) <= tol * max(1.0, abs(float(value))):
                break
            R, _ = cholesky(self.hessian(z), jitter=0.0)
            dz = torch.cholesky_solve(g[:, None], R)[:, 0]
            step = 1.0
            for _ in range(30):
                (v_new,), (g_new,) = self.loss_grad((z - step * dz)[None])
                if float(v_new) <= float(value):
                    break
                step *= 0.5
            else:
                break
            z, value, g = z - step * dz, v_new, g_new
        return z

    def log_density(self, z):
        """f = L z + μ at the cells."""
        return self.ar.mm(self.L, self.ar.cast(z).to(self.L.device)[:, None])[:, 0] + self.mu

    def predict(self, xq, z, block=BLOCK):
        """The predictor's mean μ + k(xq, xu) Lp⁻ᵀ z at the rows of xq."""
        w = torch.linalg.solve_triangular(self.Lp.T, self.ar.cast(z).to(self.Lp.device)[:, None],
                                          upper=True)
        xq = self.ar.cast(xq).to(self.Lp.device)
        return torch.cat([self.ar.mm(matern52(xq[s : s + block], self.xu, self.ls, self.ar), w)[:, 0]
                          for s in range(0, xq.shape[0], block)]) + self.mu
