"""Marginal log-likelihood and MAP objective.

Port of ``gumbi_tpu/ops/mll.py`` (dense path). The N×N Gram is assembled by
:mod:`.kernels` and factorized once; gradients flow through the analytic
backward of :func:`.linalg.quad_and_logdet` (∂logp/∂K = ½(ααᵀ − K⁻¹)), so
the Cholesky itself is never differentiated.

:func:`blocked_gaussian_logp` / :func:`map_neg_logp_blocked` are the same
likelihood with a panel-wise backward: the Gram cotangent is rebuilt one
column panel at a time and pushed through the Gram's backward at once, so
the backward holds L, α and O(N·panel) temporaries instead of several
(N, N) buffers.
"""

from __future__ import annotations

import math

import torch

from ..utils.profiling import span
from . import linalg
from .kernels import GPSpec, gram, noise_diag
from .linalg import cho_solve, quad_and_logdet
from .priors import constrain, log_prior, log_prior_chains

__all__ = [
    "mll",
    "map_neg_logp",
    "map_neg_logp_chains",
    "map_neg_logp_blocked",
    "blocked_gaussian_logp",
    "cholesky_factor",
    "DEFAULT_JITTER",
]

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
    return linalg.safe_cholesky(_noisy_gram(spec, params, xc, xk, jitter, mask, noise_mult))


def _gaussian_logp_from_K(Kn, y, mask=None):
    """log N(y | 0, Kn) through the analytic-backward quad/logdet primitive."""
    if mask is not None:
        y = y * mask
        n = mask.sum()
    else:
        n = y.shape[-1]
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
    with span("objective.gram"):
        params = constrain(uparams)
        Kn = _noisy_gram(spec, params, xc, xk, jitter, mask, noise_mult)
    with span("objective.linalg"):
        logp = _gaussian_logp_from_K(Kn, y, mask)
    with span("objective.prior"):
        prior = log_prior(spec, uparams, ls_alpha, ls_beta)
    return _finite_or_inf(logp + prior)


def map_neg_logp_chains(
    spec: GPSpec, uparams, xc, xk, y, ls_alpha, ls_beta, jitter=DEFAULT_JITTER, mask=None,
    noise_mult=None,
):
    """:func:`map_neg_logp` at C points at once: every tensor of ``uparams``
    carries a leading chain axis; returns (C,).

    The samplers' counterpart of the reference's ``vmap`` over chains. Each
    chain's Gram is its own :func:`.kernels.gram` call (the hand ``rbf_gram``
    is an autograd ``Function`` launching a CUDA kernel, which
    ``torch.func.vmap`` cannot batch); the C Grams are stacked into one
    (C, N, N) batch for one batched factorization (at the
    ``linalg.safe_cholesky`` seam) and batched solves, so a value+grad of all
    chains is one call.
    """
    c = next(iter(uparams.values())).shape[0]
    params = constrain(uparams)
    Kn = torch.stack(
        [_noisy_gram(spec, {k: v[i] for k, v in params.items()}, xc, xk, jitter, mask, noise_mult) for i in range(c)]
    )
    total = _gaussian_logp_from_K(Kn, y.expand(c, -1), mask) + log_prior_chains(spec, uparams, ls_alpha, ls_beta)
    return _finite_or_inf(total)


# ------------------------------------------------------------------
# Blocked backward: no (N, N) cotangent is ever alive
# ------------------------------------------------------------------


def _pick_panel(n: int) -> int:
    for b in (2048, 1024, 512, 256, 128):
        if n % b == 0:
            return b
    return 0  # no clean divisor: the caller takes the dense backward


class _BlockedGaussianLogp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, panel, keys, xc, xk, y, jitter, *values):
        params = dict(zip(keys, values))
        Kn = gram(spec, params, xc, xk, xc, xk)
        Kn.diagonal().add_(noise_diag(spec, params, xk, dtype=Kn.dtype) + jitter)
        L = linalg.safe_cholesky(Kn)
        del Kn
        n = y.shape[0]
        logdet = 2.0 * torch.log(torch.diagonal(L)).sum()
        if not any(ctx.needs_input_grad):
            w = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
            return -0.5 * ((w * w).sum() + logdet + n * math.log(2.0 * math.pi))
        alpha = cho_solve(L, y[:, None])[:, 0]
        ctx.spec, ctx.panel, ctx.keys = spec, panel, keys
        ctx.save_for_backward(xc, xk, L, alpha, *values)
        return -0.5 * ((y * alpha).sum() + logdet + n * math.log(2.0 * math.pi))

    @staticmethod
    def backward(ctx, g):
        xc, xk, L, alpha, *values = ctx.saved_tensors
        spec, b = ctx.spec, ctx.panel
        n = xc.shape[0]
        need_xc, need_y = ctx.needs_input_grad[3], ctx.needs_input_grad[5]
        need_p = ctx.needs_input_grad[7:]
        y_bar = -g * alpha if need_y else None
        if not (need_xc or any(need_p)):
            return (None, None, None, None, None, y_bar, None, *([None] * len(values)))

        leaves = [v.detach().requires_grad_(True) for v in values]
        xc_r = xc.detach().requires_grad_(True)
        params = dict(zip(ctx.keys, leaves))
        wrt = [*leaves, xc_r]
        total = [torch.zeros_like(t) for t in wrt]

        def add_grads(out, cot):
            for t, gr in zip(total, torch.autograd.grad(out, wrt, cot, allow_unused=True)):
                if gr is not None:
                    t.add_(gr)

        cols = torch.arange(b, device=L.device)
        diag_bar = torch.empty(n, dtype=L.dtype, device=L.device)
        for s in range(0, n, b):
            # E_J = I[:, J] without an (N, N) identity; A⁻¹E_J by two solves
            E = torch.zeros((n, b), dtype=L.dtype, device=L.device)
            E[s + cols, cols] = 1.0
            AinvJ = cho_solve(L, E)
            Kbar_J = (0.5 * g) * (alpha[:, None] * alpha[None, s : s + b] - AinvJ)
            del E, AinvJ
            diag_bar[s : s + b] = Kbar_J[s + cols, cols]
            with torch.enable_grad():
                K_J = gram(spec, params, xc_r, xk, xc_r[s : s + b], xk[s : s + b])
            add_grads(K_J, Kbar_J)
            del K_J, Kbar_J
        # the diagonal of K̄ is the noise variance's cotangent
        with torch.enable_grad():
            d = noise_diag(spec, params, xk, dtype=L.dtype)
        add_grads(d, diag_bar)

        *p_bar, xc_bar = (t if nd else None for t, nd in zip(total, (*need_p, need_xc)))
        return (None, None, None, xc_bar, None, y_bar, None, *p_bar)


def blocked_gaussian_logp(spec: GPSpec, panel: int, params, xc, xk, y, jitter=DEFAULT_JITTER):
    """log N(y | 0, K + σ²I + jitter·I) with a panel-wise backward.

    Same value as :func:`mll` (mask-free, homoskedastic case); the backward
    takes one ``torch.autograd.grad`` per (N, panel) column panel of the
    Gram and never materializes an (N, N) cotangent. ``panel`` must divide N.
    """
    n = int(y.shape[0])
    if panel <= 0 or n % panel != 0:
        raise ValueError(f"blocked_gaussian_logp: panel {panel} must divide N = {n}")
    keys = tuple(params)
    return _BlockedGaussianLogp.apply(spec, int(panel), keys, xc, xk, y, jitter, *(params[k] for k in keys))


def map_neg_logp_blocked(
    spec: GPSpec, uparams, xc, xk, y, ls_alpha, ls_beta, jitter=DEFAULT_JITTER, panel=None
):
    """:func:`map_neg_logp` with the panel-wise backward.

    Same value as the dense objective (mask-free homoskedastic case); the
    gradient flows through :func:`blocked_gaussian_logp`. ``panel`` must
    divide N; by default the largest clean divisor ≤ 2048 is picked, and the
    dense backward is taken when none exists.
    """
    if panel is None:
        panel = _pick_panel(int(y.shape[0]))
    if panel <= 0:
        return map_neg_logp(spec, uparams, xc, xk, y, ls_alpha, ls_beta, jitter)
    params = constrain(uparams)
    total = blocked_gaussian_logp(spec, int(panel), params, xc, xk, y, jitter) + log_prior(
        spec, uparams, ls_alpha, ls_beta
    )
    return _finite_or_inf(total)
