"""Plain reference of the exact dense GP (configuration ``se2``).

One ExpQuad ARD term over the continuous dims, homoskedastic Gaussian noise
σ², hyperpriors ℓ_d ~ InverseGamma(α_d, β_d), η ~ Gamma(2, 1),
σ ~ Exponential(1), all three log-transformed. Parameters are read by the
names the configuration gives them: ``ls_total``, ``η_total``, ``σ``.
"""

from __future__ import annotations

import torch

from .common import JITTER, chol_or_none, gaussian_nll, logp_exponential, logp_gamma, logp_invgamma, mm, \
    se_gram, whitened

TARGET = "y"  # the table's outputs
SHAPES = {"ls_total": (2,), "η_total": (), "σ": ()}


def _natural(u):
    return torch.exp(u["ls_total"]), torch.exp(u["η_total"]), torch.exp(u["σ"])


def neg_logp(X, y, u, la, lb, products="exact"):
    """−[log N(y | 0, K + (σ² + jitter)I) + log prior] at unconstrained ``u``."""
    ls, eta, sigma = _natural(u)
    K = se_gram(X, X, ls, eta, products)
    K.diagonal().add_(sigma**2 + JITTER)
    nll = gaussian_nll(K, y, products)
    del K
    lp = logp_invgamma(ls, la, lb).sum() + logp_gamma(eta, 2.0, 1.0) + logp_exponential(sigma, 1.0)
    jac = sum(u[k].sum() for k in SHAPES)
    return nll - lp - jac


class Posterior:
    """The training factor at ``u``, then predictive mean and variance
    (noise included) at any points; ``None`` L where K is not PD."""

    def __init__(self, X, y, u, products="exact"):
        self.X, self.u, self.products = X, u, products
        ls, eta, sigma = _natural(u)
        K = se_gram(X, X, ls, eta, products)
        K.diagonal().add_(sigma**2 + JITTER)
        self.L = chol_or_none(K)
        del K
        if self.L is not None:
            w = torch.linalg.solve_triangular(self.L, y[:, None], upper=False)
            self.alpha = torch.linalg.solve_triangular(self.L.T, w, upper=True)[:, 0]

    def predict(self, Xs, block=4096):
        ls, eta, sigma = _natural(self.u)
        if self.L is None:
            nan = torch.full((Xs.shape[0],), float("nan"), dtype=Xs.dtype, device=Xs.device)
            return nan, nan
        means, vars_ = [], []
        for i in range(0, Xs.shape[0], block):
            Ks = se_gram(self.X, Xs[i : i + block], ls, eta, self.products)  # (n, m)
            means.append(mm(Ks.T, self.alpha[:, None], self.products)[:, 0])
            V = whitened(self.L, Ks)
            vars_.append((eta**2 - (V * V).sum(0)).clamp(min=0.0) + sigma**2)
        return torch.cat(means), torch.cat(vars_)


def rows(X):
    """Rows of the table, the unit the objective's gap is read per."""
    return X.shape[0]
