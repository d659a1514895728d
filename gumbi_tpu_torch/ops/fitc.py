"""FITC sparse GP approximation with k-means inducing points.

Port of ``gumbi_tpu/ops/fitc.py``. All device math goes through the
inducing-point Woodbury identity, so a value costs O(N·M²) instead of
O(N³); the (M, N) cross-Gram is one ``gram`` call (the hand ``rbf_gram``
at f32 on CUDA) and the N-long products are plain matmuls.

:func:`fitc_mll` factorizes its M×M system through
:func:`.linalg.quad_and_logdet`, whose backward is written by hand, so a
swap of the ``linalg.safe_cholesky`` seam reaches that factor. Every other
factor (Kuu's, and those of :func:`_fitc_common` and
:func:`fitc_draw_samples`) is :func:`.linalg.cholesky_nan` (NaN where not
PD, as ``jnp.linalg.cholesky``), which the seam does not reach, as the
reference's ``_chol_and_alpha`` swap does not reach its direct factors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.profiling import count, span
from ..utils.torch_utils import resolve_device
from .kernels import GPSpec, gram, gram_diag, noise_diag
from .linalg import cholesky_nan, quad_and_logdet
from .mll import DEFAULT_JITTER, _finite_or_inf
from .posterior import joint_draws
from .priors import constrain, log_prior

__all__ = [
    "kmeans_inducing",
    "select_inducing",
    "fitc_mll",
    "fitc_neg_logp",
    "fitc_predict",
    "fitc_predict_cov",
    "fitc_draw_samples",
]


def kmeans_inducing(X: np.ndarray, n_u: int, seed: int = 0, n_iter: int = 25) -> np.ndarray:
    """Lloyd's k-means centers over the (host) input matrix.

    Runs once on the host with numpy, the reference's algorithm and draws:
    the same ``X`` and seed give the same centers bit for bit. While tracing
    is on, counts the rows clustered (``kmeans.rows``) and the Lloyd
    iterations run (``kmeans.iters``).
    """
    X = np.asarray(X, dtype=float)
    n = X.shape[0]
    rng = np.random.default_rng(seed)
    if n_u >= n:
        return X.copy()
    count("kmeans.rows", n)
    centers = X[rng.choice(n, n_u, replace=False)]
    for _ in range(n_iter):
        count("kmeans.iters")
        d2 = ((X[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        assign = d2.argmin(1)
        for j in range(n_u):
            pts = X[assign == j]
            if len(pts):
                centers[j] = pts.mean(0)
    return centers


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def select_inducing(xc, xk, n_u, d_cont, seed, dtype, mask=None, *, device=None, n_iter=25):
    """k-means inducing inputs over the REAL rows of a (possibly padded) design.

    ``mask`` slices bucket-padded tail rows off before clustering, so they
    cannot pull centers toward the origin. Categorical columns are clustered
    as floats, then snapped back to valid level indices. Returns
    ``(xu_c, xu_k)``: ``dtype`` coordinates and long level indices on
    ``device`` (default: ``xc``'s device if it is a tensor, else the CUDA
    card, :func:`resolve_device`). ``n_iter`` Lloyd iterations (25, the
    reference's, by default).
    """
    device = resolve_device(device, xc)
    xc = _host(xc).astype(float)
    xk = _host(xk)
    if mask is not None:
        n_real = int(_host(mask).sum())
        xc, xk = xc[:n_real], xk[:n_real]
    full = np.column_stack([xc, xk.astype(float)])
    centers = kmeans_inducing(full, n_u, seed=seed, n_iter=n_iter)
    xu_c = torch.as_tensor(centers[:, :d_cont], dtype=dtype, device=device)
    if xk.shape[1]:
        k_cols = np.clip(np.round(centers[:, d_cont:]), 0, None).astype(np.int64)
        xu_k = torch.as_tensor(np.minimum(k_cols, xk.max(axis=0)), dtype=torch.long, device=device)
    else:
        xu_k = torch.zeros((centers.shape[0], 0), dtype=torch.long, device=device)
    return xu_c, xu_k


def _stabilized_kuu(spec: GPSpec, params, xu_c, xu_k, dtype, jitter):
    """Kuu with a dtype-aware relative jitter: max(jitter, M·eps) times the
    mean prior variance (512·eps ≈ 6.1e-5 at f32 and M = 512, not 1e-6)."""
    m = xu_c.shape[0]
    Kuu = gram(spec, params, xu_c, xu_k, xu_c, xu_k)
    rel = max(float(jitter), m * torch.finfo(dtype).eps)
    return Kuu + rel * torch.diagonal(Kuu).mean() * torch.eye(m, dtype=dtype, device=Kuu.device)


def _fitc_grams(spec: GPSpec, params, xc, xk, xu_c, xu_k, jitter):
    """The Grams of the evidence: stabilized Kuu, Kux (M, N), diag Kxx and
    the noise's diagonal."""
    Kuu = _stabilized_kuu(spec, params, xu_c, xu_k, xc.dtype, jitter)
    Kux = gram(spec, params, xu_c, xu_k, xc, xk)  # (M, N)
    return Kuu, Kux, gram_diag(spec, params, xc, xk), noise_diag(spec, params, xk, dtype=xc.dtype)


def _fitc_whiten(Kuu, Kux, kxx_diag, noise):
    """Luu (Kuu's factor), A = Luu⁻¹Kux (M, N) and Λ's diagonal λ."""
    Luu = cholesky_nan(Kuu)
    A = torch.linalg.solve_triangular(Luu, Kux, upper=False)  # (M, N)
    lam = torch.clamp(kxx_diag - (A * A).sum(0), min=0.0) + noise
    return Luu, A, lam


def _fitc_whitened(spec: GPSpec, params, xc, xk, xu_c, xu_k, jitter):
    """Luu, A = Luu⁻¹Kux and λ: the pieces that the evidence and the
    forward-only paths share."""
    return _fitc_whiten(*_fitc_grams(spec, params, xc, xk, xu_c, xu_k, jitter))


def _fitc_common(spec: GPSpec, params, xc, xk, xu_c, xu_k, y, jitter, mask=None):
    """Shared FITC factorizations: Luu, A, Λ, LB, c (forward-only paths).

    ``mask`` (1 = real row, 0 = bucket padding) zeroes a padded row's weight
    1/λᵢ everywhere it enters: exactly the row's deletion.
    """
    m = xu_c.shape[0]
    Luu, A, lam = _fitc_whitened(spec, params, xc, xk, xu_c, xu_k, jitter)
    w = 1.0 / lam if mask is None else mask / lam
    A_l = A * w[None, :]
    B = torch.eye(m, dtype=xc.dtype, device=xc.device) + A_l @ A.T
    LB = cholesky_nan(B)
    c = torch.linalg.solve_triangular(LB, (A_l @ y)[:, None], upper=False)[:, 0]  # (M,)
    return Luu, A, lam, LB, c


def fitc_mll(spec: GPSpec, params, xc, xk, xu_c, xu_k, y, jitter=DEFAULT_JITTER, mask=None):
    """FITC approximate marginal log-likelihood (Snelson & Ghahramani).

    The reference's Woodbury identity on ``Kuu + G``, G = KuxΛ⁻¹Kxu, taken
    in the inducing points' whitened coordinates (A = Luu⁻¹Kux, B = I +
    AΛ⁻¹Aᵀ = Luu⁻¹(Kuu + G)Luu⁻ᵀ):

        quad   = yᵀΛ⁻¹y − (AΛ⁻¹y)ᵀ B⁻¹ (AΛ⁻¹y)
        logdet = log|B| + Σ log λ      (= log|Kuu+G| − log|Kuu| + Σ log λ)

    The same evidence; B's eigenvalues are ≥ 1, where Kuu + G spans Kuu's
    jitter floor to G's largest eigenvalue and at f32 does not factor (a
    named divergence: the reference's f32 value is NaN at every start of
    ``bench_fitc50k.py``'s problem). B goes through
    :func:`.linalg.quad_and_logdet` and its hand-written backward; the
    M×M factor of Kuu and the solve for A through autograd. ``mask`` (1 =
    real, 0 = bucket padding) makes the evidence exact for padded designs:
    a padded row's weight 1/λᵢ is zeroed wherever it enters, its log λ term
    is dropped and n counts real rows.
    """
    _, A, lam = _fitc_whitened(spec, params, xc, xk, xu_c, xu_k, jitter)
    return _fitc_evidence(A, lam, y, mask)


def _fitc_evidence(A, lam, y, mask=None):
    """:func:`fitc_mll` from A and λ: B = I + AΛ⁻¹Aᵀ through
    :func:`.linalg.quad_and_logdet`."""
    m = A.shape[0]
    if mask is None:
        n = y.shape[0]
        w = 1.0 / lam
        logdet_lam = torch.log(lam).sum()
    else:
        n = mask.sum()
        w = mask / lam
        logdet_lam = (mask * torch.log(lam)).sum()
    y_l = y * w
    B = torch.eye(m, dtype=A.dtype, device=A.device) + (A * w[None, :]) @ A.T
    quad_w, logdet_b = quad_and_logdet(B, A @ y_l)
    quad = (y * y_l).sum() - quad_w
    return -0.5 * (quad + logdet_b + logdet_lam + n * math.log(2.0 * math.pi))


def fitc_neg_logp(
    spec: GPSpec, uparams, xc, xk, xu_c, xu_k, y, ls_alpha, ls_beta,
    jitter=DEFAULT_JITTER, mask=None,
):
    """Negative (FITC MLL + hyperprior) in unconstrained space; +inf where
    a factorization failed. :func:`fitc_mll`'s steps, in the program spans
    that :func:`.mll.map_neg_logp` records."""
    with span("objective.gram"):
        params = constrain(uparams)
        grams = _fitc_grams(spec, params, xc, xk, xu_c, xu_k, jitter)
    with span("objective.linalg"):
        _, A, lam = _fitc_whiten(*grams)
        logp = _fitc_evidence(A, lam, y, mask)
    with span("objective.prior"):
        prior = log_prior(spec, uparams, ls_alpha, ls_beta)
    return _finite_or_inf(logp + prior)


def _test_whitened(spec, params, xc, xk, xu_c, xu_k, y, xc_new, xk_new, jitter, mask):
    """(mean, w, wb) at new points: w = Luu⁻¹Kus, wb = LB⁻¹w, mean = wbᵀc."""
    Luu, _, _, LB, c = _fitc_common(spec, params, xc, xk, xu_c, xu_k, y, jitter, mask=mask)
    Kus = gram(spec, params, xu_c, xu_k, xc_new, xk_new)  # (M, M*)
    w = torch.linalg.solve_triangular(Luu, Kus, upper=False)
    wb = torch.linalg.solve_triangular(LB, w, upper=False)
    return wb.T @ c, w, wb


def fitc_predict(
    spec: GPSpec, params, xc, xk, xu_c, xu_k, y, xc_new, xk_new,
    with_noise=True, jitter=DEFAULT_JITTER, mask=None,
):
    """FITC posterior mean/variance at new points (mask: see _fitc_common)."""
    mean, w, wb = _test_whitened(spec, params, xc, xk, xu_c, xu_k, y, xc_new, xk_new, jitter, mask)
    var = gram_diag(spec, params, xc_new, xk_new) - (w * w).sum(0) + (wb * wb).sum(0)
    var = torch.clamp(var, min=0.0)
    if with_noise:
        var = var + noise_diag(spec, params, xk_new, dtype=var.dtype)
    return mean, var


def fitc_predict_cov(
    spec: GPSpec, params, xc, xk, xu_c, xu_k, y, xc_new, xk_new,
    with_noise=False, jitter=DEFAULT_JITTER, mask=None,
):
    """FITC posterior mean and FULL covariance at new points:
    cov = K(X*,X*) − wᵀw + wbᵀwb (the factorizations of :func:`fitc_predict`)."""
    mean, w, wb = _test_whitened(spec, params, xc, xk, xu_c, xu_k, y, xc_new, xk_new, jitter, mask)
    Kss = gram(spec, params, xc_new, xk_new, xc_new, xk_new)
    cov = Kss - w.T @ w + wb.T @ wb
    if with_noise:
        cov = cov + torch.diag(noise_diag(spec, params, xk_new, dtype=cov.dtype))
    return mean, cov


def fitc_draw_samples(
    spec: GPSpec, params, xc, xk, xu_c, xu_k, y, xc_new, xk_new,
    generator=None, n_samples=1, with_noise=False, jitter=DEFAULT_JITTER, mask=None, eps=None,
):
    """Joint FITC posterior draws at new points, shape (n_samples, M*).

    The standard-normal block comes from ``generator`` (a
    ``torch.Generator`` on the points' device) or is passed in as ``eps``
    (n_samples, M*); the reference draws it from a JAX key, which torch
    cannot reproduce. The factor's floor: :func:`.posterior.joint_draws`.
    """
    mean, cov = fitc_predict_cov(
        spec, params, xc, xk, xu_c, xu_k, y, xc_new, xk_new,
        with_noise=with_noise, jitter=jitter, mask=mask,
    )
    prior = gram_diag(spec, params, xc_new, xk_new)
    return joint_draws(mean, cov, prior, jitter, generator, n_samples, eps)
