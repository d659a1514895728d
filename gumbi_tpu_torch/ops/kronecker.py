"""Kronecker-structured multi-output GP algebra.

Port of ``gumbi_tpu/ops/kronecker.py``. When every output is observed at
the same input locations the tall covariance factors exactly:

    K_full = B ⊗ Kx + Σn ⊗ I_N,   B = W Wᵀ + diag(κ),  Σn = diag(s²)

Whitening by Σn^{-1/2} and eigendecomposing the D×D task matrix turns the
(ND)³ Cholesky into a batched (D, N, N) Cholesky of (ωᵢ·Kx + I).

Layout conventions: Y is (N, D) column-per-output; tall vectors stack
output-major.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.profiling import span
from .kernels import GPSpec, _term_cont, coreg_matrix
from . import linalg
from .linalg import cho_solve, quad_and_logdet
from .mll import DEFAULT_JITTER, _finite_or_inf
from .priors import constrain, log_prior

__all__ = ["kron_parts", "kron_mll", "kron_neg_logp", "kron_cache", "kron_predict_diag", "KronCache"]


def _continuous_gram(spec: GPSpec, params, xc1, xc2):
    """Continuous (+linear) part of the single term, no coregion factors."""
    return _term_cont(spec, spec.terms[0], params, xc1, xc2)


def _continuous_diag(spec: GPSpec, params, xc):
    term = spec.terms[0]
    s = term.suffix
    η = params[f"η_{s}"]
    d = η**2 * torch.ones(xc.shape[0], dtype=xc.dtype, device=xc.device)
    if term.linear_idx:
        c = params[f"c_{s}"]
        τ = params[f"τ_{s}"]
        d = d + τ * ((xc[:, list(term.linear_idx)] - c) ** 2).sum(-1)
    return d


def kron_parts(spec: GPSpec, params, jitter=DEFAULT_JITTER):
    """(B, s2) task matrix and per-output noise variance (jitter folded in)."""
    (term,) = spec.terms
    (out_cg,) = term.coregs
    B = coreg_matrix(params[f"W_{out_cg.name}"], params[f"κ_{out_cg.name}"])
    σ2 = params["σ"] ** 2
    if spec.noise_coreg is not None:
        cg = spec.noise_coreg
        Bn = coreg_matrix(params[f"W_{cg.name}"], params[f"κ_{cg.name}"])
        s2 = σ2 * torch.diagonal(Bn) + jitter
    else:
        s2 = σ2 * torch.ones(out_cg.d_out, dtype=B.dtype, device=B.device) + jitter
    return B, s2


def _eigh_2x2(M):
    """Closed-form symmetric 2×2 eigendecomposition (ascending eigenvalues).

    The reference computes this on every backend for D=2: it is exact, needs
    no solver call, and its gradient is guarded at degeneracy.
    """
    a, b, c = M[0, 0], M[0, 1], M[1, 1]
    half_tr = 0.5 * (a + c)
    # Guard the sqrt at exact degeneracy (b=0, a=c) for stable gradients
    rad = torch.sqrt(0.25 * (a - c) ** 2 + b**2 + 1e-30)
    w = torch.stack([half_tr - rad, half_tr + rad])
    # Eigenvector for λ: [b, λ-a] (falls back to axis vectors when b≈0)
    use_axis = torch.abs(b) < 1e-12
    e0 = torch.tensor([1.0, 0.0], dtype=M.dtype, device=M.device)
    e1 = torch.tensor([0.0, 1.0], dtype=M.dtype, device=M.device)
    v0 = torch.where(use_axis, torch.where(a <= c, e0, e1), torch.stack([b, w[0] - a]))
    v1 = torch.where(use_axis, torch.where(a <= c, e1, e0), torch.stack([b, w[1] - a]))
    v0 = v0 / torch.linalg.norm(v0)
    v1 = v1 / torch.linalg.norm(v1)
    U = torch.stack([v0, v1], dim=1)  # columns are eigenvectors
    return w, U


def _whitened_eig(B, s2):
    s = torch.sqrt(s2)
    Bt = B / (s[:, None] * s[None, :])
    Bt = 0.5 * (Bt + Bt.T)
    if Bt.shape[0] == 2:
        ω, U = _eigh_2x2(Bt)
    else:
        ω, U = torch.linalg.eigh(Bt)
    return s, ω, U


def _whitened_systems(Kx, ω):
    """(D, N, N) stack of ωᵢ·Kx + I."""
    eye = torch.eye(Kx.shape[0], dtype=Kx.dtype, device=Kx.device)
    return ω[:, None, None] * Kx[None, :, :] + eye[None, :, :]


def kron_mll(spec: GPSpec, params, xc_locs, Y, jitter=DEFAULT_JITTER):
    """Exact MLL of the LMC model via the Kronecker factorization.

    ``xc_locs``: (N, d) shared locations; ``Y``: (N, D) outputs. The D
    whitened systems factorize as one batched (D, N, N) Cholesky inside the
    analytic-backward quad/logdet primitive.
    """
    n, d_out = Y.shape
    with span("objective.gram"):
        Kx = _continuous_gram(spec, params, xc_locs, xc_locs)
    with span("objective.linalg"):
        B, s2 = kron_parts(spec, params, jitter)
        s, ω, U = _whitened_eig(B, s2)

        Z = (Y / s[None, :]) @ U  # (N, D)
        quad, logdet = quad_and_logdet(_whitened_systems(Kx, ω), Z.T)
        total_logdet = n * torch.log(s2).sum() + logdet.sum()
        return -0.5 * (quad.sum() + total_logdet + n * d_out * math.log(2.0 * math.pi))


def kron_neg_logp(spec: GPSpec, uparams, xc_locs, Y, ls_alpha, ls_beta, jitter=DEFAULT_JITTER):
    """Negative (Kronecker MLL + hyperprior) in unconstrained space."""
    with span("objective.gram"):
        params = constrain(uparams)
    mll = kron_mll(spec, params, xc_locs, Y, jitter)
    with span("objective.prior"):
        prior = log_prior(spec, uparams, ls_alpha, ls_beta)
    return _finite_or_inf(mll + prior)


class KronCache(NamedTuple):
    L: torch.Tensor  # (D, N, N) batched chol(ωᵢKx + I)
    alpha: torch.Tensor  # (D, N) tall-basis representer weights
    C: torch.Tensor  # (D, D) = Uᵀ diag(1/s) B  (for variance back-transform)
    B: torch.Tensor
    s2: torch.Tensor
    xc_locs: torch.Tensor


def kron_cache(spec: GPSpec, params, xc_locs, Y, jitter=DEFAULT_JITTER) -> KronCache:
    """Factorize the training systems once for :func:`kron_predict_diag`."""
    Kx = _continuous_gram(spec, params, xc_locs, xc_locs)
    B, s2 = kron_parts(spec, params, jitter)
    s, ω, U = _whitened_eig(B, s2)

    Z = (Y / s[None, :]) @ U
    L = linalg.safe_cholesky(_whitened_systems(Kx, ω))
    Wsol = cho_solve(L, Z.T[:, :, None])[:, :, 0]  # (D, N)
    # α_{i,·} = (1/s_i) Σ_k U_{ik} w_k
    alpha = (U @ Wsol) / s[:, None]
    C = U.T @ (B / s[:, None])  # C_{kj} = Σ_i U_{ik} B_{ij} / s_i
    return KronCache(L=L, alpha=alpha, C=C, B=B, s2=s2, xc_locs=xc_locs)


def kron_predict_diag(spec: GPSpec, params, cache: KronCache, xc_new, with_noise=True,
                      jitter=DEFAULT_JITTER):
    """Posterior mean/variance for every output at new locations.

    Returns mean, var of shape (D, M).
    """
    Kxs = _continuous_gram(spec, params, cache.xc_locs, xc_new)  # (N, M)
    mean = cache.B @ (cache.alpha @ Kxs)  # (D, M)

    # t_k[m] = Kxs[:,m]ᵀ (ω_k Kx + I)⁻¹ Kxs[:,m], one solve per output
    t = torch.stack(
        [
            (torch.linalg.solve_triangular(cache.L[i], Kxs, upper=False) ** 2).sum(0)
            for i in range(cache.L.shape[0])
        ]
    )  # (D, M)

    kss = _continuous_diag(spec, params, xc_new)  # (M,)
    var = torch.diagonal(cache.B)[:, None] * kss[None, :] - (cache.C**2).T @ t
    var = torch.clamp(var, min=0.0)
    if with_noise:
        var = var + (cache.s2 - jitter)[:, None]
    return mean, var
