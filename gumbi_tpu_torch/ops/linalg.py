"""Cholesky-backed quadratic form + log-determinant with a hand-derived backward.

Port of ``gumbi_tpu/ops/linalg.py``. Every Gaussian (marginal) likelihood
reduces to

    quad   = zᵀ A⁻¹ z
    logdet = log |A|

for an SPD matrix ``A``, whose analytic gradients

    ∂quad/∂A   = −α αᵀ,   α = A⁻¹ z
    ∂quad/∂z   = 2 α
    ∂logdet/∂A = A⁻¹

never differentiate the factorization: the backward reuses the forward
factor. Solves against a factor are two triangular solves, and A⁻¹ is
(L⁻¹)ᵀL⁻¹ with L⁻¹ from one triangular solve, as the reference's
``_qld_bwd`` forms it. On an NVIDIA H100 80GB HBM3 (700 W power limit;
f32, batch 2, N=5120) the Kronecker objective's value+grad takes 54 ms
this way and 156 ms through ``torch.cholesky_solve`` and
``torch.cholesky_inverse`` (PERF.md).

A non-PD ``A`` yields NaN values (not an exception): the factorization uses
``torch.linalg.cholesky_ex`` and masks failed batch entries to NaN without
reading ``info`` on the host, as ``jnp.linalg.cholesky`` does. Objectives
turn the NaN into +inf so line searches back off.
"""

from __future__ import annotations

import torch

__all__ = ["quad_and_logdet", "spd_solve", "safe_cholesky", "cholesky_nan", "cho_solve", "cho_inverse"]


def cholesky_nan(A):
    """The library's lower Cholesky factor of ``A`` (..., N, N); NaN where
    ``A`` is not PD, as ``jnp.linalg.cholesky`` returns. Differentiable.

    Not the seam: the Laplace and FITC modules call it where the reference
    calls ``jnp.linalg.cholesky`` itself, so a swap of :func:`safe_cholesky`
    does not reach those factors (nor does the reference's
    ``_chol_and_alpha`` swap reach them).
    """
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def safe_cholesky(A):
    """Lower Cholesky factor of ``A`` (..., N, N); NaN where ``A`` is not PD.

    The one seam of the dense path: :func:`quad_and_logdet`,
    :func:`spd_solve`, ``mll.cholesky_factor`` (and with it
    ``posterior.posterior_cache``), ``posterior.draw_samples`` and
    ``kronecker.kron_cache`` all factorize through this module attribute,
    looked up at call time. Replacing it (the counterpart of swapping the
    reference's ``linalg._chol_and_alpha``) puts another factorization, such
    as :func:`.hopper_chol.seam_cholesky`, under all of them.
    """
    return cholesky_nan(A)


def cho_solve(L, B):
    """A⁻¹B from the lower factor L of A: two triangular solves."""
    w = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), w, upper=True)


def cho_inverse(L):
    """A⁻¹ = (L⁻¹)ᵀ L⁻¹ from the lower factor L of A."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv.transpose(-1, -2) @ Linv


def _logdet(L):
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


class _QuadAndLogdet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, z, differentiable):
        L = safe_cholesky(A)
        logdet = _logdet(L)
        if not differentiable:
            # Value-only evaluations (line-search trials): |L⁻¹z|², one solve.
            w = torch.linalg.solve_triangular(L, z[..., :, None], upper=False)[..., 0]
            return (w * w).sum(-1), logdet
        α = cho_solve(L, z[..., :, None])[..., 0]
        ctx.save_for_backward(L, α)
        return (z * α).sum(-1), logdet

    @staticmethod
    def backward(ctx, g_quad, g_logdet):
        L, α = ctx.saved_tensors
        A_bar = z_bar = None
        if ctx.needs_input_grad[0]:
            Ainv = cho_inverse(L)
            outer = α[..., :, None] * α[..., None, :]
            A_bar = g_logdet[..., None, None] * Ainv - g_quad[..., None, None] * outer
        if ctx.needs_input_grad[1]:
            z_bar = 2.0 * g_quad[..., None] * α
        return A_bar, z_bar, None


def quad_and_logdet(A, z):
    """(zᵀA⁻¹z, log|A|) for SPD ``A`` — Cholesky is never differentiated.

    Shapes: ``A`` (..., N, N), ``z`` (..., N); returns two (...,) tensors.
    Leading batch dimensions map onto batched factorizations and solves.
    """
    differentiable = torch.is_grad_enabled() and (A.requires_grad or z.requires_grad)
    return _QuadAndLogdet.apply(A, z, differentiable)


class _SpdSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, B):
        L = safe_cholesky(A)
        X = cho_solve(L, B)
        ctx.save_for_backward(L, X)
        return X

    @staticmethod
    def backward(ctx, G):
        L, X = ctx.saved_tensors
        B_bar = cho_solve(L, G)
        A_bar = -B_bar @ X.transpose(-1, -2)
        return A_bar, B_bar


def spd_solve(A, B):
    """A⁻¹B for SPD ``A`` (..., N, N) and ``B`` (..., N, K).

    The backward solves against the forward Cholesky factor (B̄ = A⁻¹Ḡ,
    Ā = −B̄Xᵀ for symmetric A) instead of differentiating the factorization.
    """
    return _SpdSolve.apply(A, B)
