"""FITC sparse Laplace approximation for the latent Bernoulli classifier.

Port of ``gumbi_tpu/ops/fitc_laplace.py``. The FITC prior K ≈ ΦΦᵀ + D
(Φ = K_fu L_uu⁻ᵀ the whitened cross-Gram, D the exact-diagonal correction)
drops every O(N²) object from GPML Algorithm 3.1: the Newton algebra runs
through the Woodbury identity on B = diag(A) + (SΦ)(SΦ)ᵀ with A = 1 + W·D
and S = √W, so one iteration costs O(N·m² + m³).

Gradients differentiate straight through the fixed-iteration Newton loop
with autograd, as the reference's do: the only factorization inside is the
m×m chol(M). Autograd keeps one (N, m) tensor per step (Φ·W/A: about
3.2 GB at N = 50,000, m = 512, f32, over 31 factor sets).

Every factor here is :func:`.linalg.cholesky_nan` (NaN where not PD, as
``jnp.linalg.cholesky``); a swap of the ``linalg.safe_cholesky`` seam does
not reach it, as the reference's ``_chol_and_alpha`` swap does not.

Five named divergences; at f64 the port gives the reference's numbers:
- the inducing Gram's floor clears the dtype's rounding
  (:func:`_whitened_features`), equal to the reference's at f64;
- the Newton step computes the reference's iterate without forming K·b
  (:func:`_newton_step`): at f32 the reference's form loses every digit at
  N = 50,000;
- U = √W·Φ is never formed (:func:`_woodbury_pieces`): the reference's
  ``jnp.sqrt(jnp.maximum(W, 0))`` gives NaN gradients for any masked
  design, where W = 0. The value is the same;
- the test-point covariance Φ* G Φ*ᵀ is formed as Φ*Φ*ᵀ − (Lm⁻¹Φ*ᵀ)ᵀ(Lm⁻¹Φ*ᵀ)
  (:func:`_test_features`), without the reference's P − P M⁻¹ P;
- the predictor's features, Newton mode and mean are computed in f64 from
  the model's Grams (:func:`_test_features`); the evidence stays in the
  model dtype.
"""

from __future__ import annotations

import math

import torch

from .kernels import GPSpec, gram, gram_diag
from .laplace import _ones_or
from .linalg import cho_solve, cholesky_nan
from .mll import DEFAULT_JITTER, _finite_or_inf
from .posterior import joint_draws
from .priors import constrain, log_prior

__all__ = [
    "fitc_laplace_mll",
    "fitc_laplace_neg_logp",
    "fitc_laplace_predict",
    "fitc_laplace_draw_latent",
]


def _whitened_features(spec: GPSpec, params, xc, xk, xu_c, xu_k, jitter, work=None):
    """Φ = K_fu L_uu⁻ᵀ (N, m), the FITC diagonal correction D (N,) and L_uu.

    The inducing Gram's floor is max(100·jitter, m·eps·mean diag Kuu): the
    reference's absolute 100·jitter wherever it clears the dtype's rounding
    (always at f64), else :func:`.fitc._stabilized_kuu`'s relative rule. A
    named divergence: at f32, m = 512 and a prior variance above ~1.6 the
    reference's 1e-4 lies under Kuu's rounding floor and its factor fails
    or loses every digit. ``work`` (a dtype) takes the Grams there before
    the factor and the solve; the floor stays the Grams' own dtype's.
    """
    Kuu = gram(spec, params, xu_c, xu_k, xu_c, xu_k)
    m_u = Kuu.shape[0]
    floor = torch.clamp(m_u * torch.finfo(Kuu.dtype).eps * torch.diagonal(Kuu).mean(), min=100.0 * jitter)
    work = Kuu.dtype if work is None else work
    Kuu = Kuu.to(work)
    Luu = cholesky_nan(Kuu + floor.to(work) * torch.eye(m_u, dtype=work, device=Kuu.device))
    Kfu = gram(spec, params, xc, xk, xu_c, xu_k).to(work)  # (N, m)
    Phi = torch.linalg.solve_triangular(Luu, Kfu.T, upper=False).T  # (N, m)
    D = gram_diag(spec, params, xc, xk).to(work) - (Phi * Phi).sum(1)
    D = torch.clamp(D, min=0.0) + jitter
    return Phi, D, Luu


def _woodbury_pieces(Phi, D, W):
    """Factor B = diag(A) + UUᵀ (A = 1 + W·D, U = √W·Φ) in whitened terms.

    Returns (A, P, Lm) with P = Uᵀ A⁻¹ U = Φᵀ diag(W/A) Φ and
    Lm = chol(I_m + P); solves and logdet of B come from the
    Woodbury/determinant-lemma identities. P is formed as Φᵀ(Φ·W/A), with
    no √W: a masked row (W = 0) adds nothing and has no NaN gradient.
    """
    A = 1.0 + W * D
    P = Phi.T @ (Phi * (W / A)[:, None])
    Lm = cholesky_nan(torch.eye(Phi.shape[1], dtype=Phi.dtype, device=Phi.device) + P)
    return A, P, Lm


def _newton_step(f, Phi, D, y, m):
    """One GPML Alg. 3.1 step from f: (a, f_new, factor set at f).

    The reference's iterate, a = (I + WK)⁻¹b and f_new = K a, computed in
    the inducing coordinates: z = Φᵀ(b/A), v = (I + P)⁻¹z = Φᵀa, then
    a = (b − W·Φv)/A and f_new = Φv + D·a. The reference forms
    a = b − √W B⁻¹ √W (K b) and then K a, each a difference of terms of
    size ‖K‖; at f32 and N = 50,000 that loop diverges (a named
    divergence: the same iterate in exact arithmetic).
    """
    pi = torch.sigmoid(f)
    W = m * pi * (1.0 - pi)
    A, P, Lm = _woodbury_pieces(Phi, D, W)
    b = W * f + m * (y - pi)
    v = cho_solve(Lm, (Phi.T @ (b / A))[:, None])[:, 0]
    Phi_v = Phi @ v
    a = (b - W * Phi_v) / A
    return a, Phi_v + D * a, (A, P, Lm)


def fitc_laplace_mode(Phi, D, y, n_iter=30, mask=None):
    """Newton iterations to the latent mode under the FITC prior.

    The recurrence of :func:`.laplace.laplace_mode` with K = ΦΦᵀ + diag(D)
    never formed (see :func:`_newton_step`). Masked rows carry zero
    likelihood → W = 0 → unit rows of A and no share of P, so the evidence
    reduces exactly to the unpadded one. Returns (f, a, (A, P, Lm)): the
    final f, and a and the factor set of one more step from it.
    """
    m = torch.ones_like(y) if mask is None else mask
    f = torch.zeros(y.shape[0], dtype=Phi.dtype, device=Phi.device)
    for _ in range(n_iter):
        _, f, _ = _newton_step(f, Phi, D, y, m)
    # final factor set at the converged mode (for Z and prediction)
    a, _, pieces = _newton_step(f, Phi, D, y, m)
    return f, a, pieces


def fitc_laplace_mll(spec, params, xc, xk, xu_c, xu_k, y, jitter=DEFAULT_JITTER, n_iter=30, mask=None):
    """Laplace-approximate log marginal likelihood under the FITC prior.

    log Z = −½ aᵀf̂ + log p(y|f̂) − ½ log|B|, with
    log|B| = Σ log A + log|I_m + Uᵀ A⁻¹ U| (determinant lemma).
    """
    m = _ones_or(mask, y)
    Phi, D, _ = _whitened_features(spec, params, xc, xk, xu_c, xu_k, jitter)
    f, a, (A, _, Lm) = fitc_laplace_mode(Phi, D, y, n_iter, mask=m)
    log_lik = (m * (y * f - torch.logaddexp(torch.zeros_like(f), f))).sum()
    logdet_B = torch.log(A).sum() + 2.0 * torch.log(torch.diagonal(Lm)).sum()
    return -0.5 * (a * f).sum() + log_lik - 0.5 * logdet_B


def fitc_laplace_neg_logp(
    spec: GPSpec, uparams, xc, xk, xu_c, xu_k, y, ls_alpha, ls_beta,
    jitter=DEFAULT_JITTER, n_iter=30, mask=None,
):
    """Negative (FITC-Laplace evidence + hyperprior) in unconstrained space;
    +inf where a factorization failed."""
    params = constrain(uparams)
    total = fitc_laplace_mll(
        spec, params, xc, xk, xu_c, xu_k, y, jitter, n_iter, mask=mask
    ) + log_prior(spec, uparams, ls_alpha, ls_beta)
    return _finite_or_inf(total)


def _test_features(spec, params, xc, xk, xu_c, xu_k, y, xc_new, xk_new, jitter, n_iter, mask):
    """(mean, Φ*, Lm⁻¹Φ*ᵀ) at new points: mean* = Φ* Φᵀ (y − π̂), in the
    Grams' dtype.

    The reference's Φ* G Φ*ᵀ with G = Uᵀ B⁻¹ U = P − P M⁻¹ P is, in exact
    arithmetic, Φ*Φ*ᵀ − (Lm⁻¹Φ*ᵀ)ᵀ(Lm⁻¹Φ*ᵀ), as G = I − M⁻¹. A named
    divergence: P − P M⁻¹ P is a difference of terms of size ‖P‖ (which
    grows with N), and at f32 it pushes the latent covariance's smallest
    eigenvalues far below zero; this form has no such difference
    (``tools/probe_laplace_precision.py`` measures both).

    A second one, as :func:`.laplace._latent_at`'s: Φ, the Newton mode, the
    weights and the mean's sums are computed in f64 from the model's Grams
    (with the Grams' own floor). At f32 (N = 20,000, m = 128, η = 7.8:
    ``tests/test_torch_gpc.py``) the f32 features and mode put the latent
    mean 6.2e-3 from an f64 evaluation with the same floor; in f64 from the
    f32 Grams, 5.9e-4. At f64 this is the reference's computation, number
    for number.
    """
    y = y.double()
    m = _ones_or(mask, y)
    Phi, D, Luu = _whitened_features(spec, params, xc, xk, xu_c, xu_k, jitter, work=torch.float64)
    f, _, (_, _, Lm) = fitc_laplace_mode(Phi, D, y, n_iter, mask=m)
    Ksu = gram(spec, params, xc_new, xk_new, xu_c, xu_k)  # (M*, m)
    dtype, Ksu = Ksu.dtype, Ksu.double()
    Phi_s = torch.linalg.solve_triangular(Luu, Ksu.T, upper=False).T  # (M*, m)
    mean = Phi_s @ (Phi.T @ (m * (y - torch.sigmoid(f))))
    S = torch.linalg.solve_triangular(Lm, Phi_s.T, upper=False)
    return mean.to(dtype), Phi_s.to(dtype), S.to(dtype)


def fitc_laplace_predict(
    spec: GPSpec, params, xc, xk, xu_c, xu_k, y, xc_new, xk_new,
    jitter=DEFAULT_JITTER, n_iter=30, mask=None,
):
    """Latent posterior (mean, var) and class probability at new points.

    Under FITC the test/train cross covariance is Q* = Φ* Φᵀ, so
    mean* = Φ* Φᵀ (y − π̂) and var* = k** − diag(Φ* G Φ*ᵀ), G = Uᵀ B⁻¹ U
    (the (K + W⁻¹)⁻¹ quadratic form in whitened coordinates; formed as in
    :func:`_test_features`); the probability is the probit approximation
    σ(μ/√(1 + πσ²/8)).
    """
    mean, Phi_s, S = _test_features(spec, params, xc, xk, xu_c, xu_k, y, xc_new, xk_new, jitter, n_iter, mask)
    var = gram_diag(spec, params, xc_new, xk_new) - (Phi_s * Phi_s).sum(1) + (S * S).sum(0)
    var = torch.clamp(var, min=1e-12)
    prob = torch.sigmoid(mean / torch.sqrt(1.0 + math.pi * var / 8.0))
    return mean, var, prob


def fitc_laplace_draw_latent(
    spec: GPSpec, params, xc, xk, xu_c, xu_k, y, xc_new, xk_new,
    generator=None, n_samples=1, jitter=DEFAULT_JITTER, n_iter=30, mask=None, eps=None,
):
    """Joint draws of the latent field from the FITC-Laplace posterior,
    shape (n_samples, M*): cov = K** − Φ* G Φ*ᵀ (formed as in
    :func:`_test_features`), factored with the reference's floor
    max(jitter, 1e-6) where it clears the dtype's rounding
    (:func:`.posterior.joint_draws`). The standard-normal block comes from
    ``generator`` or is passed in as ``eps`` (the reference draws it from a
    JAX key)."""
    mean, Phi_s, S = _test_features(spec, params, xc, xk, xu_c, xu_k, y, xc_new, xk_new, jitter, n_iter, mask)
    cov = gram(spec, params, xc_new, xk_new, xc_new, xk_new) - Phi_s @ Phi_s.T + S.T @ S
    prior = gram_diag(spec, params, xc_new, xk_new)
    return joint_draws(mean, cov, prior, max(jitter, 1e-6), generator, n_samples, eps)
