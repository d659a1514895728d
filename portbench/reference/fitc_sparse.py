"""Plain reference of the sparse FITC regressor (configuration ``fitc50k``).

The model is that of ``dense_exact.py`` (one ExpQuad ARD term, Gaussian
noise σ², ℓ_d ~ InverseGamma(α_d, β_d), η ~ Gamma(2, 1), σ ~ Exponential(1),
all three log-transformed, with the log-Jacobian) under the FITC
approximation with inducing inputs Z (M of them): Q = K_xu K_uu⁻¹ K_ux and

    y ~ N(0, Q + Λ),   Λ = diag(clamp(diag K_xx − diag Q, 0)) + σ² I.

The evidence is PyMC's: with A = L_uu⁻¹ K_ux, W = A Λ^(−1/2) and the
factor L_B of B = I + W Wᵀ, c = L_B⁻¹ W Λ^(−1/2) y and

    yᵀ(Q + Λ)⁻¹y = yᵀΛ⁻¹y − cᵀc,   log|Q + Λ| = log|B| + Σ log λ_i;

the prediction at X* (noise included), with a* = L_uu⁻¹ K_u*, is mean
a*ᵀ L_B⁻ᵀ c and variance k** − a*ᵀa* + |L_B⁻¹ a*|² (clamped at 0) + σ².

Departures from PyMC's ``MarginalApprox(approx="FITC")``:

* K_uu's jitter is the port's relative floor at the configuration's
  float32, max(1e-6, M·2⁻²³) times the mean of diag K_uu, not PyMC's
  absolute 1e-6 (the configuration's ``assumed`` lists it);
* the squared distances are summed coordinate differences, not the matmul
  identity of ``common.se_gram``: the same number in float64, but under the
  control's TF32 products the identity's rounding makes K_uu indefinite
  at its relative jitter, and the control would read nothing;
* the triangular solves are blocked (``BLOCK`` rows): each block's update
  is a product, which the control rounds to TF32 like every other product,
  as a blocked solve's updates run on the tensor cores;
* the products over the N rows (W Wᵀ and W Λ^(−1/2) y) are summed ``CHUNK``
  rows at a time: on an H100 the tensor cores' float32 accumulation of
  50,000 TF32 terms at once leaves B indefinite, and the control would
  read nothing;
* the inducing inputs are not a free input: :func:`centres` makes them
  from the table's k-means rows, as the configuration states (PyMC takes
  them from the caller).

:func:`lloyd` is plain Lloyd's k-means in float64: the initial centres are
the rows ``np.random.default_rng(seed).choice(n, k, replace=False)``, each
iteration assigns every row to its nearest centre (squared distance,
lowest index on a tie) and moves each centre to its rows' mean; a centre
with no rows keeps its place.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .common import chol_or_none, logp_exponential, logp_gamma, logp_invgamma, mm

# The rows; the k-means rows; the k-means' (centres, iterations, seed).
INPUTS = ("X", "km_rows", "kmeans")
TARGET = "y"
SHAPES = {"ls_total": (2,), "η_total": (), "σ": ()}
KUU_FLOOR, KUU_EPS = 1e-6, 2.0**-23  # the port's relative jitter at float32
BLOCK = 128
CHUNK = 4096


def lloyd(rows, k, n_iter, seed=0):
    """Lloyd's k-means centres (k, d) of ``rows`` (n, d), float64 numpy."""
    X = np.asarray(rows, dtype=np.float64)
    n = X.shape[0]
    if k >= n:
        return X.copy()
    centres = X[np.random.default_rng(seed).choice(n, k, replace=False)]
    for _ in range(n_iter):
        d2 = np.zeros((n, k))
        for j in range(X.shape[1]):
            d2 += (X[:, j, None] - centres[None, :, j]) ** 2
        assign = d2.argmin(1)
        counts = np.bincount(assign, minlength=k)
        sums = np.stack([np.bincount(assign, weights=X[:, j], minlength=k) for j in range(X.shape[1])], 1)
        hit = counts > 0
        centres[hit] = sums[hit] / counts[hit, None]
    return centres


@functools.lru_cache(maxsize=16)
def _lloyd_of(data, shape, k, n_iter, seed):
    return lloyd(np.frombuffer(data).reshape(shape), k, n_iter, seed)


def centres(km_rows, kmeans):
    """The inducing inputs: :func:`lloyd` over ``km_rows`` with ``kmeans`` =
    (centres, iterations, seed), in ``km_rows``' dtype and device. Each
    table's k-means runs once, when a check first reads it."""
    rows = km_rows.double().cpu().numpy()
    k, n_iter, seed = (int(v) for v in kmeans.tolist())
    Z = _lloyd_of(rows.tobytes(), rows.shape, k, n_iter, seed)
    return torch.as_tensor(Z, dtype=km_rows.dtype, device=km_rows.device)


def _natural(u):
    return torch.exp(u["ls_total"]), torch.exp(u["η_total"]), torch.exp(u["σ"])


def se_gram(x1, x2, ls, eta):
    """η²·exp(−½ Σ_d ((x1_d − x2_d) / ℓ_d)²)."""
    r2 = sum(((x1[:, d, None] - x2[None, :, d]) / ls[d]) ** 2 for d in range(x1.shape[1]))
    return eta**2 * torch.exp(-0.5 * r2)


def whiten(L, B, products):
    """L⁻¹B for lower-triangular L, ``BLOCK`` rows at a time."""
    out = []
    for i in range(0, L.shape[0], BLOCK):
        rhs = B[i : i + BLOCK]
        if i:
            rhs = rhs - mm(L[i : i + BLOCK, :i], torch.cat(out), products)
        out.append(torch.linalg.solve_triangular(L[i : i + BLOCK, i : i + BLOCK], rhs, upper=False))
    return torch.cat(out)


def outer(W, V, products):
    """W Vᵀ, ``CHUNK`` columns at a time."""
    return sum(mm(W[:, i : i + CHUNK], V[:, i : i + CHUNK].T, products) for i in range(0, W.shape[1], CHUNK))


def kuu(Z, ls, eta):
    """K_uu plus its relative jitter."""
    K = se_gram(Z, Z, ls, eta)
    rel = max(KUU_FLOOR, Z.shape[0] * KUU_EPS)
    return K + rel * K.diagonal().mean() * torch.eye(Z.shape[0], dtype=K.dtype, device=K.device)


class _Factors:
    """L_uu, λ, L_B and c at ``u``, or ``ok`` False where a factor fails."""

    def __init__(self, X, Z, y, u, products):
        ls, eta, sigma = _natural(u)
        self.Luu = chol_or_none(kuu(Z, ls, eta))
        self.ok = self.Luu is not None
        if not self.ok:
            return
        A = whiten(self.Luu, se_gram(Z, X, ls, eta), products)
        self.lam = (eta**2 - (A * A).sum(0)).clamp(min=0.0) + sigma**2
        root = self.lam.sqrt()
        W = A / root
        del A
        self.LB = chol_or_none(torch.eye(Z.shape[0], dtype=X.dtype, device=X.device) + outer(W, W, products))
        self.ok = self.LB is not None
        if self.ok:
            b = outer(W, (y / root)[None, :], products)
            self.c = torch.linalg.solve_triangular(self.LB, b, upper=False)[:, 0]


def neg_logp_at(X, Z, y, u, la, lb, products="exact"):
    """−[log N(y | 0, Q + Λ) + log prior] at unconstrained ``u`` and inducing
    inputs ``Z``; +inf where a factor fails."""
    ls, eta, sigma = _natural(u)
    f = _Factors(X, Z, y, u, products)
    if not f.ok:
        return torch.tensor(float("inf"), dtype=X.dtype, device=X.device)
    quad = (y * y / f.lam).sum() - (f.c * f.c).sum()
    logdet = 2.0 * torch.log(torch.diagonal(f.LB)).sum() + torch.log(f.lam).sum()
    nll = 0.5 * (quad + logdet + y.shape[0] * np.log(2.0 * np.pi))
    lp = logp_invgamma(ls, la, lb).sum() + logp_gamma(eta, 2.0, 1.0) + logp_exponential(sigma, 1.0)
    jac = sum(u[k].sum() for k in SHAPES)
    return nll - lp - jac


class PosteriorAt:
    """The factors at ``u`` and inducing inputs ``Z``, then predictive mean
    and variance (noise included) at any points; NaN where a factor failed."""

    def __init__(self, X, Z, y, u, products="exact"):
        self.Z, self.u, self.products = Z, u, products
        self.f = _Factors(X, Z, y, u, products)
        if self.f.ok:
            self.w = torch.linalg.solve_triangular(self.f.LB.T, self.f.c[:, None], upper=True)  # L_B⁻ᵀ c

    def predict(self, Xs):
        ls, eta, sigma = _natural(self.u)
        if not self.f.ok:
            nan = torch.full((Xs.shape[0],), float("nan"), dtype=Xs.dtype, device=Xs.device)
            return nan, nan
        a = whiten(self.f.Luu, se_gram(self.Z, Xs, ls, eta), self.products)  # (M, M*)
        mean = mm(a.T, self.w, self.products)[:, 0]
        s = whiten(self.f.LB, a, self.products)
        var = (eta**2 - (a * a).sum(0) + (s * s).sum(0)).clamp(min=0.0) + sigma**2
        return mean, var


def neg_logp(X, km_rows, kmeans, y, u, la, lb, products="exact"):
    """:func:`neg_logp_at` at the table's own :func:`centres`."""
    return neg_logp_at(X, centres(km_rows, kmeans), y, u, la, lb, products)


def Posterior(X, km_rows, kmeans, y, u, products="exact"):  # noqa: N802 (the references' common name)
    """:class:`PosteriorAt` the table's own :func:`centres`."""
    return PosteriorAt(X, centres(km_rows, kmeans), y, u, products)


def rows(X, km_rows, kmeans):
    """Rows of the table, the unit the objective's gap is read per."""
    return X.shape[0]
