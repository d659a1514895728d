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

The mode, the evidence and its backward also take a leading chain axis:
``K`` of shape (C, N, N) with ``y`` and the mask shared runs C Newton loops
on one batched factor a step. :func:`laplace_neg_logp_chains` is the
samplers' counterpart of the reference's ``vmap`` of
:func:`laplace_neg_logp` over chains, as ``mll.map_neg_logp_chains`` is the
regressor's: all chains' value+grad in one call. A chain whose factor fails
is NaN (+inf after :func:`laplace_neg_logp_chains`) in its own entry only.

The predictor (:func:`laplace_predict`, :func:`laplace_draw_latent`)
finds its mode in f64 from the model's Grams, a named divergence at f32
(:func:`_latent_at`).

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
from .priors import constrain, log_prior, log_prior_chains

__all__ = [
    "laplace_mode",
    "laplace_mll",
    "laplace_neg_logp",
    "laplace_neg_logp_chains",
    "laplace_predict",
    "laplace_draw_latent",
]


def _ones_or(mask, y):
    return torch.ones_like(y) if mask is None else torch.as_tensor(mask, dtype=y.dtype, device=y.device)


def _mv(K, v):
    """K v for K (..., N, N) and v (..., N): a matvec, batched over chains."""
    return K @ v if v.dim() == 1 else (K @ v[..., None])[..., 0]


def _solve_B(L, sqrtW, v):
    """√W B⁻¹ √W v with L = chol(B), batched over chains."""
    return sqrtW * cho_solve(L, (sqrtW * v)[..., None])[..., 0]


def laplace_mode(K, y, n_iter=30, mask=None):
    """Newton iterations to the mode of p(f | y) for logistic-Bernoulli y ∈ {0, 1}.

    Returns (f_hat, a, L, sqrtW) with a = K⁻¹ f_hat and
    L = chol(I + √W K √W) (L and √W of the last step's start, as the
    reference's loop state). ``K`` is (N, N) or (C, N, N), C chains against
    the shared ``y`` (N,); the results then carry the chain axis.
    ``mask`` (0/1 per row) excludes bucket-padded rows exactly: a masked
    row has zero likelihood, so its W and its row and column of B vanish.
    Differentiable when called with grad enabled (the tests' oracle);
    :func:`laplace_mll` calls it under ``no_grad``.
    """
    shape = (*K.shape[:-2], y.shape[0])
    m = torch.ones_like(y) if mask is None else mask
    f = torch.zeros(shape, dtype=K.dtype, device=K.device)
    a, L, sqrtW = f, None, torch.ones(shape, dtype=K.dtype, device=K.device)
    for _ in range(n_iter):
        pi = torch.sigmoid(f)
        W = m * pi * (1.0 - pi)
        sqrtW = torch.sqrt(torch.clamp(W, min=1e-12)) * m
        B = sqrtW[..., :, None] * K * sqrtW[..., None, :]
        B.diagonal(dim1=-2, dim2=-1).add_(1.0)  # I + S K S without an (N, N) identity
        L = cholesky_nan(B)
        del B
        b = W * f + m * (y - pi)
        a = b - _solve_B(L, sqrtW, _mv(K, b))
        f = _mv(K, a)
    if L is None:
        L = torch.eye(shape[-1], dtype=K.dtype, device=K.device).expand(K.shape)
    return f, a, L, sqrtW


def _laplace_Z(f, a, L, y, m):
    # log p(y|f) for y ∈ {0, 1}: Σ [y·f − log(1 + e^f)] over REAL rows
    log_lik = (m * (y * f - torch.logaddexp(torch.zeros_like(f), f))).sum(-1)
    return -0.5 * (a * f).sum(-1) + log_lik - torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


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
        R = S B⁻¹ S, u = (I + W K)⁻¹ s2, s2 the implicit mode-shift term;
        each chain's from its own factor."""
        K, y, m, f, a, L, sqrtW = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        pi = torch.sigmoid(f)
        W = m * pi * (1.0 - pi)
        g = m * (y - pi)  # ∇ log p(y|f̂); equals a at the converged mode

        # R = S B⁻¹ S  (B = I + S K S, L = chol(B))
        S = sqrtW
        K_bar = S[..., :, None] * cho_solve(L, torch.diag_embed(S))  # R
        K_bar.mul_(-1.0).add_(a[..., :, None] * a[..., None, :]).mul_(0.5)  # explicit = ½(a aᵀ − R)

        # diag((K⁻¹ + W)⁻¹) = diag(K) − Σ_r C_ri²,  C = L⁻¹ S K
        C = torch.linalg.solve_triangular(L, S[..., :, None] * K, upper=False)
        d = torch.diagonal(K, dim1=-2, dim2=-1) - (C * C).sum(-2)
        del C
        # At the mode, ∂Z/∂f̂_i = −½ d_i W_i (1 − 2π_i)
        s2 = -0.5 * d * W * (1.0 - 2.0 * pi)

        # u = (I + W K)⁻¹ s2 = s2 − S B⁻¹ S (K s2)
        u = s2 - _solve_B(L, S, _mv(K, s2))
        K_bar.add_(u[..., :, None] * g[..., None, :])  # + implicit
        return K_bar.mul_(gZ[..., None, None]), None, None, None


def laplace_mll(K, y, n_iter=30, mask=None):
    """Laplace-approximate log marginal likelihood (GPML eq. 3.32).

    The gradient w.r.t. ``K`` is the analytic one (GPML eqs. 5.21-5.24),
    from :class:`_LaplaceMll`'s backward: the Newton loop is never
    differentiated. ``mask`` excludes bucket-padded rows exactly (see
    :func:`laplace_mode`). ``K`` of shape (C, N, N) gives (C,) evidences,
    one per chain, from one batched Newton loop.
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


def laplace_neg_logp_chains(
    spec: GPSpec, uparams, xc, xk, y, ls_alpha, ls_beta, jitter=DEFAULT_JITTER, n_iter=30, mask=None,
):
    """:func:`laplace_neg_logp` at C points at once: every tensor of
    ``uparams`` carries a leading chain axis; returns (C,), +inf in the
    entries whose factorization failed.

    Each chain's Gram is its own :func:`.kernels.gram` call (one
    ``rbf_gram`` launch each on the card); the C jittered Grams are stacked
    into one (C, N, N) batch for one batched Newton loop and one batched
    analytic backward, so a value+grad of all chains is one call.
    """
    c = next(iter(uparams.values())).shape[0]
    params = constrain(uparams)
    K = torch.stack([_jittered_gram(spec, {k: v[i] for k, v in params.items()}, xc, xk, jitter) for i in range(c)])
    total = laplace_mll(K, y, n_iter, mask=mask) + log_prior_chains(spec, uparams, ls_alpha, ls_beta)
    return _finite_or_inf(total)


def _latent_at(spec, params, xc, xk, y, xc_new, xk_new, jitter, n_iter, mask):
    """Latent mean at new points and V = L⁻¹ √W Ksᵀ (N, M*), in the Grams' dtype.

    A named divergence: the Newton mode, the weights y − π(f̂), the mean's
    sum and V are computed in f64 from the model's Grams. In f32 the
    reference's Newton step carries its K·b cancellation into the mode
    (max |Δf̂| 8.9e-3 at ``chip_smoke.py`` phase 19 (a)'s MAP on an H100,
    η² = 61, N = 2,048), and the mean Ks·(y − π(f̂)) sums those weights
    against entries up to η²: the grid mean sat 0.78 from f64 and the
    probabilities 0.19. With the mode in f64 the mean is 6.0e-5 from f64
    (the f32 Grams' own rounding; phase 19 prints both). The evidence keeps
    the f32 Newton loop (1.5e-6 nats/point from f64 there). At f64 this is
    the reference's computation, number for number.
    """
    K = _jittered_gram(spec, params, xc, xk, jitter)
    dtype = K.dtype
    y = y.double()
    m = _ones_or(mask, y)
    f, _, L, sqrtW = laplace_mode(K.double(), y, n_iter, mask=m)
    del K
    Ks = gram(spec, params, xc_new, xk_new, xc, xk).double()  # (M*, N)
    mean = Ks @ (m * (y - torch.sigmoid(f)))
    V = torch.linalg.solve_triangular(L, sqrtW[:, None] * Ks.T, upper=False)
    return mean.to(dtype), V.to(dtype)


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
