"""Laplace approximation for the latent-GP Bernoulli classifier.

Port of ``gumbi_tpu/ops/laplace.py``. The latent posterior mode is found by
a fixed number of Newton iterations (GPML Algorithm 3.1), a Python loop with
no host sync, and the hyperparameters are learned by maximizing the
Laplace-approximate marginal likelihood with the same multi-restart L-BFGS
as the regressor.

The gradient of :func:`laplace_mll` comes from a ``torch.autograd.Function``
whose forward runs the Newton loop under ``torch.no_grad()`` and whose
backward is the reference's analytic one (GPML §5.5.1, explicit and
implicit mode-shift terms): autograd never records the loop.

Every factor here is :func:`.linalg.cholesky_nan` (NaN where not PD, as
``jnp.linalg.cholesky``); a swap of the ``linalg.safe_cholesky`` seam does
not reach it, as the reference's ``_chol_and_alpha`` swap does not.
"""

from __future__ import annotations

import math

import torch

from .kernels import GPSpec, gram, gram_diag
from .linalg import cho_solve, cholesky_nan
from .mll import DEFAULT_JITTER, _finite_or_inf
from .posterior import joint_draws
from .priors import constrain, log_prior

__all__ = ["laplace_mode", "laplace_mll", "laplace_neg_logp", "laplace_predict", "laplace_draw_latent"]


def _ones_or(mask, y):
    return torch.ones_like(y) if mask is None else torch.as_tensor(mask, dtype=y.dtype, device=y.device)


def laplace_mode(K, y, n_iter=30, mask=None):
    """Newton iterations to the mode of p(f | y) for logistic-Bernoulli y ∈ {0, 1}.

    Returns (f_hat, a, L, sqrtW) with a = K⁻¹ f_hat and
    L = chol(I + √W K √W) (L and √W of the last step's start, as the
    reference's loop state). ``mask`` (0/1 per row) excludes bucket-padded
    rows exactly: a masked row has zero likelihood, so its W and its row
    and column of B vanish. Differentiable when called with grad enabled
    (the tests' oracle); :func:`laplace_mll` calls it under ``no_grad``.
    """
    n = y.shape[0]
    m = torch.ones_like(y) if mask is None else mask
    f = torch.zeros(n, dtype=K.dtype, device=K.device)
    a, L, sqrtW = f, None, torch.ones(n, dtype=K.dtype, device=K.device)
    for _ in range(n_iter):
        pi = torch.sigmoid(f)
        W = m * pi * (1.0 - pi)
        sqrtW = torch.sqrt(torch.clamp(W, min=1e-12)) * m
        B = sqrtW[:, None] * K * sqrtW[None, :]
        B.diagonal().add_(1.0)  # I + S K S without an (N, N) identity
        L = cholesky_nan(B)
        del B
        b = W * f + m * (y - pi)
        Kb = K @ b
        a = b - sqrtW * cho_solve(L, (sqrtW * Kb)[:, None])[:, 0]
        f = K @ a
    if L is None:
        L = torch.eye(n, dtype=K.dtype, device=K.device)
    return f, a, L, sqrtW


def _laplace_Z(f, a, L, y, m):
    # log p(y|f) for y ∈ {0, 1}: Σ [y·f − log(1 + e^f)] over REAL rows
    log_lik = (m * (y * f - torch.logaddexp(torch.zeros_like(f), f))).sum()
    return -0.5 * (a * f).sum() + log_lik - torch.log(torch.diagonal(L)).sum()


class _LaplaceMll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, y, m, n_iter):
        with torch.no_grad():
            f, a, L, sqrtW = laplace_mode(K, y, n_iter, mask=m)
            Z = _laplace_Z(f, a, L, y, m)
        ctx.save_for_backward(K, y, m, f, a, L, sqrtW)
        return Z

    @staticmethod
    def backward(ctx, gZ):
        """GPML §5.5.1: ∂Z/∂K = ½(a aᵀ − R) + u (y−π)ᵀ with
        R = S B⁻¹ S, u = (I + W K)⁻¹ s2, s2 the implicit mode-shift term."""
        K, y, m, f, a, L, sqrtW = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        pi = torch.sigmoid(f)
        W = m * pi * (1.0 - pi)
        g = m * (y - pi)  # ∇ log p(y|f̂); equals a at the converged mode

        # R = S B⁻¹ S  (B = I + S K S, L = chol(B))
        S = sqrtW
        K_bar = S[:, None] * cho_solve(L, torch.diag(S))  # R
        K_bar.mul_(-1.0).add_(a[:, None] * a[None, :]).mul_(0.5)  # explicit = ½(a aᵀ − R)

        # diag((K⁻¹ + W)⁻¹) = diag(K) − Σ_r C_ri²,  C = L⁻¹ S K
        C = torch.linalg.solve_triangular(L, S[:, None] * K, upper=False)
        d = torch.diagonal(K) - (C * C).sum(0)
        del C
        # At the mode, ∂Z/∂f̂_i = −½ d_i W_i (1 − 2π_i)
        s2 = -0.5 * d * W * (1.0 - 2.0 * pi)

        # u = (I + W K)⁻¹ s2 = s2 − S B⁻¹ S (K s2)
        u = s2 - S * cho_solve(L, (S * (K @ s2))[:, None])[:, 0]
        K_bar.add_(u[:, None] * g[None, :])  # + implicit
        return K_bar.mul_(gZ), None, None, None


def laplace_mll(K, y, n_iter=30, mask=None):
    """Laplace-approximate log marginal likelihood (GPML eq. 3.32).

    The gradient w.r.t. ``K`` is the analytic one (GPML eqs. 5.21-5.24),
    from :class:`_LaplaceMll`'s backward: the Newton loop is never
    differentiated. ``mask`` excludes bucket-padded rows exactly (see
    :func:`laplace_mode`).
    """
    return _LaplaceMll.apply(K, y, _ones_or(mask, y), int(n_iter))


def _jittered_gram(spec, params, xc, xk, jitter):
    K = gram(spec, params, xc, xk, xc, xk)
    return K.diagonal_scatter(K.diagonal() + jitter)  # K + jitter·I, one (N, N) copy


def laplace_neg_logp(
    spec: GPSpec, uparams, xc, xk, y, ls_alpha, ls_beta, jitter=DEFAULT_JITTER, n_iter=30, mask=None,
):
    """Negative (Laplace marginal likelihood + hyperprior) in unconstrained
    space; +inf where a factorization failed."""
    params = constrain(uparams)
    K = _jittered_gram(spec, params, xc, xk, jitter)
    total = laplace_mll(K, y, n_iter, mask=mask) + log_prior(spec, uparams, ls_alpha, ls_beta)
    return _finite_or_inf(total)


def _latent_at(spec, params, xc, xk, y, xc_new, xk_new, jitter, n_iter, mask):
    """Latent mean at new points and V = L⁻¹ √W Ksᵀ (N, M*)."""
    K = _jittered_gram(spec, params, xc, xk, jitter)
    m = _ones_or(mask, y)
    f, _, L, sqrtW = laplace_mode(K, y, n_iter, mask=m)
    del K
    Ks = gram(spec, params, xc_new, xk_new, xc, xk)  # (M*, N)
    mean = Ks @ (m * (y - torch.sigmoid(f)))
    V = torch.linalg.solve_triangular(L, sqrtW[:, None] * Ks.T, upper=False)
    return mean, V


def laplace_predict(
    spec: GPSpec, params, xc, xk, y, xc_new, xk_new, jitter=DEFAULT_JITTER, n_iter=30, mask=None,
):
    """Latent posterior mean/variance and class probability at new points.

    Probability uses the probit ("MacKay") approximation
    σ(μ/√(1 + πσ²/8)) to the logistic-Gaussian integral.
    """
    mean, V = _latent_at(spec, params, xc, xk, y, xc_new, xk_new, jitter, n_iter, mask)
    var = torch.clamp(gram_diag(spec, params, xc_new, xk_new) - (V * V).sum(0), min=1e-12)
    prob = torch.sigmoid(mean / torch.sqrt(1.0 + math.pi * var / 8.0))
    return mean, var, prob


def laplace_draw_latent(
    spec: GPSpec, params, xc, xk, y, xc_new, xk_new,
    generator=None, n_samples=1, jitter=DEFAULT_JITTER, n_iter=30, mask=None, eps=None,
):
    """Joint draws of the latent function at new points under the Laplace
    posterior, shape (n_samples, M*). The standard-normal block comes from
    ``generator`` or is passed in as ``eps`` (the reference draws it from a
    JAX key); the factor's floor: :func:`.posterior.joint_draws`."""
    mean, V = _latent_at(spec, params, xc, xk, y, xc_new, xk_new, jitter, n_iter, mask)
    cov = gram(spec, params, xc_new, xk_new, xc_new, xk_new) - V.T @ V
    prior = gram_diag(spec, params, xc_new, xk_new)
    return joint_draws(mean, cov, prior, jitter, generator, n_samples, eps)
