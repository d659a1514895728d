"""Marginal log-likelihood and MAP objective.

Port of ``gumbi_tpu/ops/mll.py`` (dense path). The N×N Gram is assembled by
:mod:`.kernels` and factorized once; gradients flow through the analytic
backward of :func:`.linalg.quad_and_logdet` (∂logp/∂K = ½(ααᵀ − K⁻¹)), so
the Cholesky itself is never differentiated.
"""

from __future__ import annotations

import math

import torch

from .kernels import GPSpec, gram, noise_diag
from .linalg import quad_and_logdet, safe_cholesky
from .priors import constrain, log_prior

__all__ = ["mll", "map_neg_logp", "cholesky_factor", "DEFAULT_JITTER"]

# PyMC stabilizes marginal covariances with an implicit 1e-6 jitter; we match it.
DEFAULT_JITTER = 1e-6


def _noisy_gram(spec: GPSpec, params, xc, xk, jitter=DEFAULT_JITTER, mask=None, noise_mult=None):
    """K(X, X) + noise·I (+ jitter), with masked rows as identity rows.

    ``mask`` (0/1 per row) supports bucket-padded data: masked-out rows
    become unit-diagonal identity rows, contributing exactly zero to the
    quadratic form and log-determinant. ``noise_mult`` (positive per-row
    factor) scales the observation noise variance per point.
    """
    K = gram(spec, params, xc, xk, xc, xk)
    d = noise_diag(spec, params, xk, dtype=K.dtype)
    if noise_mult is not None:
        d = d * noise_mult
    d = d + jitter
    if mask is not None:
        K = K * (mask[:, None] * mask[None, :])
        d = mask * d + (1.0 - mask)
    return K + torch.diag(d)


def cholesky_factor(
    spec: GPSpec, params, xc, xk, y_dtype=None, jitter=DEFAULT_JITTER, mask=None, noise_mult=None
):
    """Cholesky of K(X, X) + noise·I (+ jitter); NaN where not PD."""
    return safe_cholesky(_noisy_gram(spec, params, xc, xk, jitter, mask, noise_mult))


def _gaussian_logp_from_K(Kn, y, mask=None):
    """log N(y | 0, Kn) through the analytic-backward quad/logdet primitive."""
    if mask is not None:
        y = y * mask
        n = mask.sum()
    else:
        n = y.shape[0]
    quad, logdet = quad_and_logdet(Kn, y)
    return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))


def mll(spec: GPSpec, params, xc, xk, y, jitter=DEFAULT_JITTER, mask=None, noise_mult=None):
    """Gaussian marginal log-likelihood log p(y | X, θ)."""
    Kn = _noisy_gram(spec, params, xc, xk, jitter, mask, noise_mult)
    return _gaussian_logp_from_K(Kn, y, mask)


def _finite_or_inf(total):
    """−total where finite, +inf elsewhere (line searches back off)."""
    return torch.where(torch.isfinite(total), -total, torch.inf)


def map_neg_logp(
    spec: GPSpec, uparams, xc, xk, y, ls_alpha, ls_beta, jitter=DEFAULT_JITTER, mask=None,
    noise_mult=None,
):
    """Negative joint log-density −[log p(y|θ) + log p(θ)] in unconstrained space.

    NaN/Inf Cholesky failures surface as +inf.
    """
    params = constrain(uparams)
    Kn = _noisy_gram(spec, params, xc, xk, jitter, mask, noise_mult)
    total = _gaussian_logp_from_K(Kn, y, mask) + log_prior(spec, uparams, ls_alpha, ls_beta)
    return _finite_or_inf(total)
