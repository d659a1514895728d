"""Distributed iterative exact-GP inference: mBCG with the matvec sharded
over the mesh's 'data' axis.

Port of ``gumbi_tpu/parallel/iterative.py``. The engine is the single-device
one (``ops.iterative._iter_forward``, ``iter_posterior_cache``) with one
primitive distributed: each rank multiplies its row block K[local, :] by the
replicated V and an all_gather reassembles A·V. The row block goes through
the single-device dispatch: the general fused Gram-matvec kernel
(``fused_stationary_matvec``, K(x_local, x_all)·V) for a single stationary
term at f32 on CUDA with ``block > 0``, else (block, N) Gram blocks times V,
or with ``block <= 0`` the rank's (N/P, N) rows formed once. The Krylov
loop's O(N·R) work, the pivoted-Cholesky preconditioner and the two-regime
gate (``_woodbury_gate``, ``POSTERIOR_TOL``) stay replicated; every host
decision among them (PCG's exit test, the regime) reads the value of the
axis's first rank, so the ranks make the same collective calls.

Gradients follow the engine's surrogate: the backward evaluates the
bilinear form ½αᵀ(dA)α − 1/(2R)·Σᵢ sᵢᵀ(dA)wᵢ over each rank's Gram rows and
all-reduces its gradient; the noise diagonal's term is replicated.

The reference's mesh path has no staged fit and no recovery ladder
(``gumbi_tpu/models/gp.py:1003-1021``), and neither has this one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.hopper_kernels import fused_stationary_matvec
from ..ops.iterative import (
    IterConfig,
    _bilinear_sum,
    _fused_active,
    _fused_matvec_args,
    _iter_forward,
    iter_posterior_cache,
)
from ..ops.kernels import GPSpec, gram
from ..ops.optimize import lbfgs_backtracking_minimize
from ..ops.priors import constrain, log_prior
from .mesh import Axis, as_mesh

__all__ = [
    "pad_for_dist_iter",
    "dist_iter_gaussian_logp",
    "dist_iter_map_neg_logp",
    "dist_iter_fit_gp_map",
    "dist_iter_posterior_cache",
]


def pad_for_dist_iter(mesh, cfg: IterConfig, xc, xk, y, mask=None):
    """Pad the N axis so row blocks split evenly: N % (P·block) == 0.

    Pad rows are identity rows of A (the engine's masking), so the padded
    log-density equals the unpadded one. Returns ``(xc, xk, y, mask)`` with
    the mask always materialized.
    """
    ax = Axis(mesh, "data")
    n = int(xc.shape[0])
    pad = (-n) % (ax.size * max(int(cfg.block), 1))
    base = mask if mask is not None else y.new_ones(n)
    if pad:
        xc = torch.cat([xc, xc.new_zeros((pad, xc.shape[1]))])
        xk = torch.cat([xk, xk.new_zeros((pad, xk.shape[1]))])
        y = torch.cat([y, y.new_zeros(pad)])
        base = torch.cat([base, y.new_zeros(pad)])
    return xc, xk, y, base


def _row_product(spec, cfg, params, xc, xk, mask, rows):
    """V ↦ (m mᵀ ∘ K)[rows, :] V, by the single-device dispatch."""
    s, e = rows.start, rows.stop
    if cfg.block > 0:
        term = _fused_active(spec, xc)
        if term is not None:
            ls, eta2 = _fused_matvec_args(spec, params, term)
            x_rows, x_all = xc[rows].contiguous(), xc.contiguous()

            def product(V):
                return eta2 * fused_stationary_matvec(x_rows, x_all, V * mask[:, None], ls, term.kernel) \
                    * mask[rows, None]

            return product

        b = cfg.block

        def product(V):
            out = V.new_empty((e - s, V.shape[1]))
            for i in range(s, e, b):
                Kb = gram(spec, params, xc[i : i + b], xk[i : i + b], xc, xk)
                out[i - s : i - s + b] = (Kb * (mask[i : i + b, None] * mask[None, :])) @ V
            return out

        return product

    Kr = gram(spec, params, xc[rows], xk[rows], xc, xk) * (mask[rows, None] * mask[None, :])
    return lambda V: Kr @ V


def _dist_make_matvec(ax: Axis):
    """A ``make_matvec`` for the engine: this rank's rows of A·V, gathered."""

    def make_matvec(spec, cfg, params, xc, xk, d, mask):
        product = _row_product(spec, cfg, params, xc, xk, mask, ax.block(xc.shape[0]))

        def matvec(V):
            return ax.gather_rows(product(V)) + d[:, None] * V

        return matvec

    return make_matvec


def _check(ax, cfg, n):
    if n % (ax.size * max(int(cfg.block), 1)):
        raise ValueError(f"N = {n} must divide by P·block = {ax.size * max(int(cfg.block), 1)}; "
                         "pad with pad_for_dist_iter")


class _DistIterGaussianLogp(torch.autograd.Function):
    """log N(y | 0, K + D) by mBCG + SLQ with the matvec over the mesh; the
    backward all-reduces the surrogate's Gram-row gradients."""

    @staticmethod
    def forward(ctx, ax, spec, cfg, keys, xc, xk, y, probe_n, probe_k, mask, info, *values):
        params = dict(zip(keys, values))
        device = y.device
        logp, (alpha, S, W, stats) = _iter_forward(
            spec, cfg, params, xc, xk, y, probe_n, probe_k, mask, None,
            make_matvec=_dist_make_matvec(ax), agree=ax.agreement(device),
        )
        if info is not None:
            info.update(stats)
        ctx.ax, ctx.spec, ctx.cfg, ctx.keys = ax, spec, cfg, keys
        ctx.save_for_backward(xc, xk, mask, alpha, S, W, *values)
        return logp

    @staticmethod
    def backward(ctx, g):
        ax = ctx.ax
        xc, xk, mask, alpha, S, W, *values = ctx.saved_tensors
        r = S.shape[1]
        U = torch.cat([alpha[:, None], S], dim=1)
        V = torch.cat([alpha[:, None], W], dim=1)
        wts = torch.cat([
            torch.full((1,), 0.5, dtype=alpha.dtype, device=alpha.device),
            torch.full((r,), -0.5 / r, dtype=alpha.dtype, device=alpha.device),
        ])

        def reduce(parts):
            flat = torch.cat([p.reshape(-1) for p in parts])
            ax.all_reduce(flat)
            return [c.view_as(p) for c, p in zip(torch.split(flat, [p.numel() for p in parts]), parts)]

        rows = ax.block(xc.shape[0])
        with torch.enable_grad():
            leaves = [v.detach().requires_grad_(True) for v in values]
            params = dict(zip(ctx.keys, leaves))
            grads = _bilinear_sum(ctx.spec, ctx.cfg, params, xc, xk, U, V, wts, mask, None, alpha.dtype,
                                  wrt=leaves, rows=(rows.start, rows.stop), reduce=reduce)
        needs = ctx.needs_input_grad[11:]
        p_bar = [g * gr if nd else None for gr, nd in zip(grads, needs)]
        y_bar = -g * alpha if ctx.needs_input_grad[6] else None
        return (None, None, None, None, None, None, y_bar, None, None, None, None, *p_bar)


def dist_iter_gaussian_logp(mesh, spec: GPSpec, cfg: IterConfig, params, xc, xk, y, probe_n, probe_k, mask,
                            info=None):
    """log N(y | 0, K + D) by mBCG + SLQ with the matvec sharded over 'data':
    the distributed twin of ``ops.iterative.iter_gaussian_logp`` (the same
    algorithm and probes). ``mask`` is required; pad with
    :func:`pad_for_dist_iter`. ``info`` as in the single-device function."""
    ax = Axis(mesh, "data")
    _check(ax, cfg, xc.shape[0])
    keys = tuple(params)
    return _DistIterGaussianLogp.apply(ax, spec, cfg, keys, xc, xk, y, probe_n, probe_k, mask, info,
                                       *(params[k] for k in keys))


def dist_iter_map_neg_logp(mesh, spec: GPSpec, uparams, xc, xk, y, ls_alpha, ls_beta, probe_n, probe_k,
                           cfg: IterConfig, mask, info=None):
    """−[log p(y|θ) + log p(θ)] with the distributed iterative likelihood;
    non-finite values become +inf."""
    params = constrain(uparams)
    data_logp = dist_iter_gaussian_logp(mesh, spec, cfg, params, xc, xk, y, probe_n, probe_k, mask, info=info)
    total = data_logp + log_prior(spec, uparams, ls_alpha, ls_beta)
    return torch.where(torch.isfinite(total), -total, torch.inf)


def dist_iter_fit_gp_map(mesh, spec: GPSpec, cfg: IterConfig, xc, xk, y, ls_alpha, ls_beta, u0s, probe_n, probe_k,
                         mask, maxiter=120, tol=1e-5):
    """Multi-restart MAP fit through the distributed iterative MLL: a host
    loop of ``lbfgs_backtracking_minimize`` over the restarts, the line
    search reading the 'data' axis's first rank's numbers. Returns
    ``(params, neg_logp, aux)``."""
    mesh = as_mesh(mesh)
    ax = Axis(mesh, "data")

    n_evals = [0]

    def objective(u):
        n_evals[0] += 1
        return dist_iter_map_neg_logp(mesh, spec, u, xc, xk, y, ls_alpha, ls_beta, probe_n, probe_k, cfg, mask)

    sync = ax.agreement(y.device)
    R = next(iter(u0s.values())).shape[0]
    best = (None, math.inf)
    all_vals, all_iters, all_evals = [], [], []
    for r in range(R):
        before = n_evals[0]
        x_r, f_r, it_r = lbfgs_backtracking_minimize(objective, {k: v[r] for k, v in u0s.items()},
                                                     maxiter=maxiter, ftol=tol, sync=sync)
        all_vals.append(float(f_r))
        all_iters.append(int(it_r))
        all_evals.append(n_evals[0] - before)
        if best[0] is None or float(f_r) < best[1]:
            best = (x_r, float(f_r))
    aux = {"all_values": np.asarray(all_vals), "iters": np.asarray(all_iters), "evals": np.asarray(all_evals),
           "best_restart": int(np.argmin(all_vals))}
    return constrain(best[0]), torch.tensor(best[1], dtype=torch.float64), aux


def dist_iter_posterior_cache(mesh, spec: GPSpec, cfg: IterConfig, params, xc, xk, y, mask, omega=None, info=None):
    """Posterior state {alpha, L, d[, W]} with the solves' matvecs sharded
    over 'data': ``ops.iterative.iter_posterior_cache``'s contents (α to
    ``POSTERIOR_TOL`` behind the Woodbury gate, the preconditioner factor,
    the LOVE factor), so ``iter_predict_diag`` consumes it unchanged."""
    ax = Axis(mesh, "data")
    _check(ax, cfg, xc.shape[0])
    return iter_posterior_cache(spec, cfg, params, xc, xk, y, mask=mask, omega=omega, info=info,
                                make_matvec=_dist_make_matvec(ax), agree=ax.agreement(y.device))
