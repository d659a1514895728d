"""Plain reference of the 2-output LMC with heteroskedastic output noise
(configuration ``lmc2``), on the dense tall covariance.

Outputs i, j at locations a, b covary as B_ij·k(a, b), with k the ExpQuad
ARD Gram (η² included) and B = W Wᵀ + diag(κ); output i's noise variance is
σ²·Bn_ii with Bn = Wn Wnᵀ + diag(κn), plus the 1e-6 jitter on the training
diagonal. Tall vectors stack output-major. The (2n)² Gram is formed and
factored whole: no Kronecker algebra. Hyperpriors: ℓ_d ~ InverseGamma,
η ~ Gamma(2, 1), W, Wn ~ Normal(0, 3), κ, κn ~ Gamma(1.5, 1),
σ ~ Exponential(1); ℓ, η, κ, κn and σ log-transformed.
"""

from __future__ import annotations

import torch

from .common import JITTER, chol_or_none, gaussian_nll, logp_exponential, logp_gamma, logp_invgamma, \
    logp_normal, mm, se_gram, whitened

TARGET = "Y"  # the table's outputs
SHAPES = {"ls_total": (2,), "η_total": (), "W_Parameter": (2, 2), "κ_Parameter": (2,), "σ": (),
          "W_Output_noise": (2, 2), "κ_Output_noise": (2,)}
POSITIVE = ("ls_total", "η_total", "κ_Parameter", "σ", "κ_Output_noise")


def _natural(u):
    return {k: torch.exp(v) if k in POSITIVE else v for k, v in u.items()}


def _parts(p, products):
    B = mm(p["W_Parameter"], p["W_Parameter"].T, products) + torch.diag(p["κ_Parameter"])
    Bn = mm(p["W_Output_noise"], p["W_Output_noise"].T, products) + torch.diag(p["κ_Output_noise"])
    return B, p["σ"] ** 2 * torch.diagonal(Bn)


def _train_gram(X, p, products):
    n = X.shape[0]
    B, noise = _parts(p, products)
    K = torch.kron(B, se_gram(X, X, p["ls_total"], p["η_total"], products))
    K.diagonal().add_(torch.repeat_interleave(noise + JITTER, n))
    return K


def neg_logp(X, Y, u, la, lb, products="exact"):
    """−[log N(vec(Y) | 0, K_tall) + log prior] at unconstrained ``u``."""
    p = _natural(u)
    nll = gaussian_nll(_train_gram(X, p, products), Y.T.reshape(-1), products)
    lp = (logp_invgamma(p["ls_total"], la, lb).sum() + logp_gamma(p["η_total"], 2.0, 1.0)
          + logp_normal(p["W_Parameter"], 0.0, 3.0).sum() + logp_gamma(p["κ_Parameter"], 1.5, 1.0).sum()
          + logp_exponential(p["σ"], 1.0) + logp_normal(p["W_Output_noise"], 0.0, 3.0).sum()
          + logp_gamma(p["κ_Output_noise"], 1.5, 1.0).sum())
    jac = sum(u[k].sum() for k in POSITIVE)
    return nll - lp - jac


class Posterior:
    """The tall training factor at ``u``; then each output's predictive mean
    and variance (its noise included), (2, M), at any locations."""

    def __init__(self, X, Y, u, products="exact"):
        self.X, self.products = X, products
        self.p = _natural(u)
        self.L = chol_or_none(_train_gram(X, self.p, products))
        if self.L is not None:
            w = torch.linalg.solve_triangular(self.L, Y.T.reshape(-1, 1), upper=False)
            self.alpha = torch.linalg.solve_triangular(self.L.T, w, upper=True)[:, 0]

    def predict(self, Xs, block=4096):
        p, products = self.p, self.products
        if self.L is None:
            nan = torch.full((2, Xs.shape[0]), float("nan"), dtype=Xs.dtype, device=Xs.device)
            return nan, nan
        B, noise = _parts(p, products)
        means, vars_ = [], []
        for i in range(0, Xs.shape[0], block):
            Ks = se_gram(self.X, Xs[i : i + block], p["ls_total"], p["η_total"], products)  # (n, m)
            m_out, v_out = [], []
            for o in range(2):
                k_star = torch.kron(B[:, o : o + 1], Ks)  # (2n, m)
                m_out.append(mm(k_star.T, self.alpha[:, None], products)[:, 0])
                V = whitened(self.L, k_star)
                v_out.append((B[o, o] * p["η_total"] ** 2 - (V * V).sum(0)).clamp(min=0.0) + noise[o])
            means.append(torch.stack(m_out))
            vars_.append(torch.stack(v_out))
        return torch.cat(means, dim=1), torch.cat(vars_, dim=1)


def rows(X):
    """Rows of the table, the unit the objective's gap is read per."""
    return 2 * X.shape[0]
