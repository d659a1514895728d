"""GP posterior prediction: mean/variance solves over point sets.

Port of ``gumbi_tpu/ops/posterior.py``. The training-set Cholesky is
computed once and cached on the device; prediction is then one (M, N)
cross-Gram, one matmul and one triangular solve per chunk. The ``*_level``
functions predict one additive component against the total-kernel cache,
``predict_cov`` returns the joint covariance and ``draw_samples`` draws
from it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import linalg
from .kernels import GPSpec, _term_diag, _term_gram, gram, gram_diag, noise_diag
from .linalg import cho_solve
from .mll import DEFAULT_JITTER, cholesky_factor

__all__ = [
    "PosteriorCache",
    "posterior_cache",
    "predict_diag",
    "predict_diag_chunked",
    "predict_diag_level",
    "predict_cov",
    "predict_cov_level",
    "draw_samples",
    "draw_floor",
    "joint_draws",
]


class PosteriorCache(NamedTuple):
    """Training-set factorization reused across predictions."""

    L: torch.Tensor  # chol(Kxx + noise)
    alpha: torch.Tensor  # (Kxx + noise)⁻¹ y
    xc: torch.Tensor
    xk: torch.Tensor
    mask: Optional[torch.Tensor] = None  # 0/1 row validity for bucket-padded data


def posterior_cache(
    spec: GPSpec, params, xc, xk, y, jitter=DEFAULT_JITTER, mask=None, noise_mult=None
) -> PosteriorCache:
    L = cholesky_factor(spec, params, xc, xk, y.dtype, jitter, mask, noise_mult)
    y_eff = y if mask is None else y * mask
    alpha = cho_solve(L, y_eff[:, None])[:, 0]
    return PosteriorCache(L=L, alpha=alpha, xc=xc, xk=xk, mask=mask)


def _mean_and_whitened(cache: PosteriorCache, Ks):
    """(Ks·α, L⁻¹Ksᵀ) for a cross-covariance ``Ks`` (M, N) against the cache."""
    if cache.mask is not None:
        Ks = Ks * cache.mask[None, :]
    return Ks @ cache.alpha, torch.linalg.solve_triangular(cache.L, Ks.T, upper=False)  # (M,), (N, M)


def _term(spec: GPSpec, level):
    return {t.suffix: t for t in spec.terms}[level]


def predict_diag(spec: GPSpec, params, cache: PosteriorCache, xc_new, xk_new, with_noise=True):
    """Posterior mean and per-point variance at new points."""
    mean, V = _mean_and_whitened(cache, gram(spec, params, xc_new, xk_new, cache.xc, cache.xk))
    var = gram_diag(spec, params, xc_new, xk_new) - (V * V).sum(0)
    var = torch.clamp(var, min=0.0)
    if with_noise:
        var = var + noise_diag(spec, params, xk_new, dtype=var.dtype)
    return mean, var


def predict_diag_level(spec: GPSpec, params, cache: PosteriorCache, xc_new, xk_new, level):
    """Posterior mean/variance of ONE additive component at new points.

    For an additive model K = Σ_t K_t, the component-t posterior given the
    total-kernel factorization is

        mean_t = K_t(X*, X) α,      α = (K + noise)⁻¹ y
        var_t  = diag K_t(X*, X*) − diag(K_t(X*, X) (K + noise)⁻¹ K_t(X, X*))

    (solves stay against the TOTAL cache; only the cross/prior covariances
    restrict to the term). ``level`` is the term suffix. Observation noise
    never applies to a component.
    """
    term = _term(spec, level)
    mean, V = _mean_and_whitened(cache, _term_gram(spec, term, params, xc_new, xk_new, cache.xc, cache.xk))
    var = _term_diag(spec, term, params, xc_new, xk_new) - (V * V).sum(0)
    return mean, torch.clamp(var, min=0.0)


def predict_diag_chunked(
    spec: GPSpec, params, cache: PosteriorCache, xc_new, xk_new, with_noise=True, chunk=4096
):
    """Chunked grid prediction: bounds peak memory to chunk×N cross-Grams."""
    if xc_new.shape[0] <= chunk:
        return predict_diag(spec, params, cache, xc_new, xk_new, with_noise=with_noise)
    means, vars_ = [], []
    for start in range(0, xc_new.shape[0], chunk):
        mu, v = predict_diag(
            spec, params, cache,
            xc_new[start : start + chunk], xk_new[start : start + chunk],
            with_noise=with_noise,
        )
        means.append(mu)
        vars_.append(v)
    return torch.cat(means), torch.cat(vars_)


def predict_cov_level(spec: GPSpec, params, cache: PosteriorCache, xc_new, xk_new, level):
    """Posterior mean and FULL covariance of one additive component: the
    decomposition of :func:`predict_diag_level` with the joint covariance,
    so sublevel function draws are exact."""
    term = _term(spec, level)
    mean, V = _mean_and_whitened(cache, _term_gram(spec, term, params, xc_new, xk_new, cache.xc, cache.xk))
    Kss = _term_gram(spec, term, params, xc_new, xk_new, xc_new, xk_new)
    return mean, Kss - V.T @ V


def predict_cov(spec: GPSpec, params, cache: PosteriorCache, xc_new, xk_new, with_noise=False):
    """Posterior mean and full covariance at new points (for joint sampling)."""
    mean, V = _mean_and_whitened(cache, gram(spec, params, xc_new, xk_new, cache.xc, cache.xk))
    cov = gram(spec, params, xc_new, xk_new, xc_new, xk_new) - V.T @ V
    if with_noise:
        cov = cov + torch.diag(noise_diag(spec, params, xk_new, dtype=cov.dtype))
    return mean, cov


def draw_samples(
    spec: GPSpec,
    params,
    cache: PosteriorCache,
    xc_new,
    xk_new,
    generator=None,
    n_samples=1,
    with_noise=False,
    jitter=DEFAULT_JITTER,
    level=None,
    eps=None,
):
    """Joint posterior draws at new points, shape (n_samples, M). ``level``
    draws from one additive component's conditional; components carry no
    observation noise.

    The covariance is factored with :func:`draw_floor` on its diagonal: the
    reference's ``jitter`` at f64 (so the draws are the reference's), and
    at f32 the floor that keeps a noise-free joint covariance of thousands
    of grid points factorable (a named divergence: the reference's bare
    jitter gives NaN draws there). The standard-normal block comes from
    ``generator`` (a ``torch.Generator`` on the points' device), or is
    passed in as ``eps`` (n_samples, M). The reference draws it from a JAX
    key, which torch cannot reproduce: with the same ``eps`` the two
    packages give the same draws, with a generator the same distribution.
    """
    if level is not None:
        mean, cov = predict_cov_level(spec, params, cache, xc_new, xk_new, level=level)
        prior = _term_diag(spec, _term(spec, level), params, xc_new, xk_new)
    else:
        mean, cov = predict_cov(spec, params, cache, xc_new, xk_new, with_noise=with_noise)
        prior = gram_diag(spec, params, xc_new, xk_new)
    cov.diagonal().add_(draw_floor(cov, prior, jitter))
    Lss = linalg.safe_cholesky(cov)
    if eps is None:
        eps = torch.randn((n_samples, mean.shape[0]), dtype=mean.dtype, device=mean.device, generator=generator)
    return mean[None, :] + eps @ Lss.T


def draw_floor(cov, prior_diag, jitter):
    """The diagonal floor of a joint covariance before its factor:
    max(jitter, M·eps_dtype·mean(prior_diag)) for ``cov`` (..., M, M), one
    per batch entry; the relative rule of ``fitc._stabilized_kuu``.

    The reference's jitter wherever it clears the dtype's rounding of
    ``cov`` (always at f64 below M·mean prior variance ≈ 4.5e9). At f32 the
    rounding of a covariance whose prior variance is O(1) over thousands of
    points takes its smallest eigenvalues below −1e-6, and the bare jitter
    factors none of them.
    """
    return torch.clamp(cov.shape[-1] * torch.finfo(cov.dtype).eps * prior_diag.mean(-1), min=jitter)


def joint_draws(mean, cov, prior_diag, jitter, generator=None, n_samples=1, eps=None):
    """``mean + eps·Lᵀ`` with L = chol(cov + floor·I), shape (n_samples, M):
    the draws of the sparse and Laplace posteriors, and the acquisitions'
    joint samples. Leading batch axes of ``mean`` (..., M), ``cov``
    (..., M, M) and ``prior_diag`` (..., M) give (..., n_samples, M), each
    batch entry with its own :func:`draw_floor`: the reference's jitter at
    f64, so the draws are the reference's. A named divergence: at f32 a
    latent covariance whose prior variance is tens of units loses more than
    1e-6 of its smallest eigenvalue to rounding, and the reference's floor
    gives NaN draws (``tools/probe_laplace_precision.py`` measures the
    sparse one). ``eps`` (n_samples, M) is the standard-normal block, or it
    comes from ``generator`` (the reference draws it from a JAX key).
    """
    m = cov.shape[-1]
    floor = draw_floor(cov, prior_diag, jitter)
    L = linalg.cholesky_nan(cov + floor[..., None, None] * torch.eye(m, dtype=cov.dtype, device=cov.device))
    if eps is None:
        eps = torch.randn((n_samples, m), dtype=mean.dtype, device=mean.device, generator=generator)
    return mean[..., None, :] + eps @ L.mT
