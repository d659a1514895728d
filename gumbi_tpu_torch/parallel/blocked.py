"""Data-sharded blocked Cholesky and the distributed Gaussian quad/logdet.

Port of ``gumbi_tpu/parallel/blocked.py``. Every rank of the mesh's 'data'
axis owns an (N/P, N) row block, and a right-looking blocked Cholesky walks
the P diagonal panels:

    step k:  broadcast A_kk from its owner → every rank factors the (nb, nb)
             panel → local triangular solve L_ik = A_ik L_kk⁻ᵀ → all_gather
             the column-k panel → local GEMM trailing update

so per-rank memory is O(N²/P) and per-rank compute O(N³/P). The panel
factors stay on every rank, so the substitutions need no second broadcast of
them. The panel factorization goes through ``ops.linalg.safe_cholesky``, the
seam every dense objective factors through (NaN where not positive
definite).

:func:`dist_quad_and_logdet` is the sharded twin of
``ops.linalg.quad_and_logdet``, with the same analytic backward
(∂quad/∂K = −ααᵀ, ∂logdet/∂K = K⁻¹) evaluated blockwise: K⁻¹'s row block i
is Σ_p L⁻¹_p[:, i]ᵀ L⁻¹_p, reduced onto rank i one panel at a time, so no rank
holds more than its row block. A value-only call skips the backward
substitution (quad = |L⁻¹y|²).
"""

from __future__ import annotations

import math

import torch

from ..ops import linalg
from .mesh import Axis, ReplicatedIn

__all__ = ["blocked_cholesky", "dist_quad_and_logdet", "dist_gaussian_logp"]

AXIS = "data"


def _cols(k, nb):
    return slice(k * nb, (k + 1) * nb)


def local_blocked_cholesky(ax: Axis, Arows):
    """This rank's (nb, N) rows of L and the P (nb, nb) panel factors."""
    nb, n = Arows.shape
    p, P = ax.rank, ax.size
    A = Arows.clone()
    Lrows = torch.zeros_like(A)
    panels = []
    for k in range(P):
        c = _cols(k, nb)
        Akk = A[:, c].contiguous() if p == k else A.new_empty((nb, nb))
        Lkk = linalg.safe_cholesky(ax.broadcast(Akk, k))
        panels.append(Lkk)
        if p == k:
            Lik = Lkk
        elif p > k:
            Lik = torch.linalg.solve_triangular(Lkk, A[:, c].T, upper=False).T
        else:
            Lik = torch.zeros_like(Lkk)
        Lrows[:, c] = Lik
        if k + 1 < P:
            panel = ax.gather_rows(Lik)  # (N, nb)
            if p > k:
                # trailing update of the columns this rank's lower part reads
                e = (p + 1) * nb
                A[:, (k + 1) * nb : e] -= Lik @ panel[(k + 1) * nb : e].T
    return Lrows, panels


def local_forward_solve(ax: Axis, Lrows, panels, B):
    """Rows of L⁻¹B by blocked forward substitution; ``B`` is this rank's
    (nb, r) block. Rank k solves its block and broadcasts it."""
    nb = Lrows.shape[0]
    p = ax.rank
    acc = torch.zeros_like(B)
    out = torch.zeros_like(B)
    for k in range(ax.size):
        if p == k:
            wk = torch.linalg.solve_triangular(panels[k], B - acc, upper=False).contiguous()
        else:
            wk = torch.empty_like(B)
        ax.broadcast(wk, k)
        if p == k:
            out = wk
        elif p > k:
            acc = acc + Lrows[:, _cols(k, nb)] @ wk
    return out


def local_backward_solve(ax: Axis, Lrows, panels, W):
    """Rows of L⁻ᵀW by blocked backward substitution (local L rows only:
    rank j holds L_jk, so Σ_{j>k} L_jkᵀ α_j is reduced onto rank k)."""
    nb = Lrows.shape[0]
    p = ax.rank
    out = torch.zeros_like(W)
    for k in reversed(range(ax.size)):
        if p > k:
            contrib = (Lrows[:, _cols(k, nb)].T @ out).contiguous()
        else:
            contrib = torch.zeros_like(W)
        ax.reduce_to(contrib, k)
        if p == k:
            out = torch.linalg.solve_triangular(panels[k].T, W - contrib, upper=True)
    return out


def local_tri_inverse(ax: Axis, Lrows, panels):
    """This rank's (nb, N) rows of L⁻¹: forward substitution against the
    identity's row block."""
    nb, n = Lrows.shape
    eye_rows = torch.zeros_like(Lrows)
    eye_rows[:, _cols(ax.rank, nb)] = torch.eye(nb, dtype=Lrows.dtype, device=Lrows.device)
    return local_forward_solve(ax, Lrows, panels, eye_rows)


def _local_logdet(ax: Axis, Lrows):
    nb = Lrows.shape[0]
    part = torch.log(torch.diagonal(Lrows[:, _cols(ax.rank, nb)])).sum().reshape(1)
    return 2.0 * ax.all_reduce(part)[0]


class DistQuadLogdet(torch.autograd.Function):
    """(yᵀK⁻¹y, log|K|) from this rank's rows of K and y; the backward gives
    this rank's rows of K̄ = ḡ_logdet·K⁻¹ − ḡ_quad·ααᵀ and ȳ = 2ḡ_quad·α."""

    @staticmethod
    def forward(ctx, ax, Krows, y_local, differentiable):
        Lrows, panels = local_blocked_cholesky(ax, Krows)
        w = local_forward_solve(ax, Lrows, panels, y_local[:, None])
        quad = ax.all_reduce((w * w).sum().reshape(1))[0]
        logdet = _local_logdet(ax, Lrows)
        ctx.ax = ax
        if differentiable:
            alpha = local_backward_solve(ax, Lrows, panels, w)[:, 0]
            ctx.save_for_backward(Lrows, alpha, *panels)
        return quad, logdet

    @staticmethod
    def backward(ctx, g_quad, g_logdet):
        ax = ctx.ax
        Lrows, alpha, *panels = ctx.saved_tensors
        nb = Lrows.shape[0]
        p = ax.rank
        Linv = local_tri_inverse(ax, Lrows, panels)
        Kinv = None
        for i in range(ax.size):
            # L⁻¹ is lower triangular: rank p's rows have no column block i > p
            contrib = Linv[:, _cols(i, nb)].T @ Linv if p >= i else torch.zeros_like(Linv)
            ax.reduce_to(contrib, i)
            if p == i:
                Kinv = contrib
        a_full = ax.gather_rows(alpha)
        K_bar = g_logdet * Kinv - g_quad * (alpha[:, None] * a_full[None, :])
        return None, K_bar, 2.0 * g_quad * alpha, None


def _local_rows(ax: Axis, t):
    """This rank's row block of a replicated global tensor; its gradient is
    summed over the axis, so it reaches every rank whole."""
    if torch.is_grad_enabled() and t.requires_grad:
        (t,) = ReplicatedIn.apply(ax.group, t)
    return t[ax.block(t.shape[0])]


def _check_rows(ax, n):
    if n % ax.size:
        raise ValueError(f"N = {n} must divide by the 'data' extent {ax.size}; pad with identity rows first")


def blocked_cholesky(mesh, K):
    """Lower Cholesky factor of SPD ``K`` (N, N), rows sharded over 'data'.

    N must divide by the 'data' extent (``sharded_gram_mll`` pads with
    identity rows). Each rank factors its row block; the factor is
    all-gathered, so every rank returns the whole L.
    """
    ax = Axis(mesh, AXIS)
    _check_rows(ax, K.shape[0])
    Lrows, _ = local_blocked_cholesky(ax, K[ax.block(K.shape[0])])
    return ax.gather_rows(Lrows)


def dist_quad_and_logdet(mesh, K, y):
    """(yᵀK⁻¹y, log|K|) for an SPD ``K`` factored with its rows sharded over
    'data': the distributed twin of ``ops.linalg.quad_and_logdet``.

    ``K`` (N, N) and ``y`` (N,) are the same on every rank; each rank uses its
    row block. Gradients with respect to ``K`` and ``y`` are whole on every
    rank. The Cholesky is never differentiated.
    """
    ax = Axis(mesh, AXIS)
    _check_rows(ax, K.shape[0])
    differentiable = torch.is_grad_enabled() and (K.requires_grad or y.requires_grad)
    return DistQuadLogdet.apply(ax, _local_rows(ax, K), _local_rows(ax, y), differentiable)


def dist_gaussian_logp(mesh, Kn, y):
    """log N(y | 0, Kn) for a noisy Gram factored over 'data'; differentiable."""
    n = y.shape[0]
    quad, logdet = dist_quad_and_logdet(mesh, Kn, y)
    return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))
