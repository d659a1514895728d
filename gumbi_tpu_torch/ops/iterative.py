"""Iterative exact-GP marginal likelihood: batched PCG + stochastic Lanczos.

Port of ``gumbi_tpu/ops/iterative.py``, the large-N engine behind
``GP.find_MAP(engine='iterative')``: modified batched conjugate gradients
(mBCG, Gardner et al., NeurIPS 2018) with a rank-k pivoted-Cholesky
preconditioner applied by Woodbury, stochastic Lanczos quadrature for the
log-determinant, LOVE (Pleiss et al., ICML 2018) for predictive variances,
and a Hutchinson surrogate backward that never differentiates the Krylov
loop. Masked rows are identity rows of A, so bucket padding is exact.

The reference's ``lax`` loops are host loops here. ``pcg`` syncs once per
iteration for its exit test; converged columns freeze on the device.
``pivoted_cholesky`` keeps its pivot index and guards on the device (no
sync in its ``rank`` steps). The two-regime gate (:func:`exhausted_factorization`,
then :func:`_woodbury_gate`) is read once per evaluation, and CG is skipped
on the host when the Woodbury solve is exact.

The matvec dispatches as the reference does, by device and dtype only:
a single stationary term at f32 on CUDA with ``block > 0`` goes to the hand
kernels (:mod:`.hopper_kernels`: the symmetric self-Gram kernel while its
scratch fits and ``sym_matvec`` is not False, else the general one); every
other blocked case builds Gram row blocks (``rbf_gram`` for ExpQuad at f32
on CUDA) and multiplies them with ``torch.matmul``; ``block <= 0`` forms the
dense matrix once.

Named divergences: LOVE's random start block Ω comes from a
``torch.Generator`` seeded with 7, not the reference's
``jax.random.PRNGKey(7)``; :func:`_love_factor`, :func:`iter_posterior_cache`
and callers take ``omega=`` so a test can pass the reference's draw. The
regime gate: the reference takes the Woodbury solve P⁻¹B and log|P| as exact
whenever :func:`exhausted_factorization` reads true; the port also asks
that the solve's residual meet the solve's tol (:func:`_woodbury_gate`),
which at f32 and large N it need not, and otherwise runs PCG + SLQ from P.
And the posterior's α is solved to ``min(tol, POSTERIOR_TOL)``, not tol.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.torch_utils import resolve_device
from .hopper_kernels import (
    FUSABLE_KERNELS,
    fused_stationary_matvec,
    fused_stationary_matvec_sym,
    sym_matvec_fits,
)
from .kernels import gram, gram_diag, noise_diag
from .linalg import cho_solve, safe_cholesky
from .mll import DEFAULT_JITTER
from .optimize import multi_restart_minimize
from .priors import constrain, log_prior

__all__ = [
    "IterConfig",
    "draw_probes",
    "pivoted_cholesky",
    "exhausted_factorization",
    "lanczos",
    "block_lanczos_basis",
    "pcg",
    "iter_gaussian_logp",
    "iter_map_neg_logp",
    "iter_map_value_and_grad",
    "iter_map_value",
    "fit_iter_map",
    "iter_posterior_cache",
    "iter_predict_diag",
    "iter_predict_mean",
]


@dataclass(frozen=True)
class IterConfig:
    """Static configuration for the iterative MLL (the reference's fields).

    maxiter        CG iteration cap (the loop exits early on tol).
    tol            relative residual stop: ‖r‖ ≤ tol·‖b‖ per column.
    n_probes       Hutchinson/SLQ probe vectors R.
    precond_rank   pivoted-Cholesky rank k of the preconditioner (0 = off).
    block          0 → the dense (N, N) matrix once per evaluation;
                   B > 0 → matrix-free: fused kernels or (B, N) Gram blocks.
    quad_steps     Lanczos steps kept for the logdet quadrature.
    jitter         diagonal stabilization added to the noise (PyMC-matched).
    love_rank      Lanczos rank of the LOVE variance factor (0 → the
                   preconditioner's Nyström surrogate).
    sym_matvec     None or True: the symmetric self-Gram kernel where its
                   scratch fits; False: always the general kernel.
    """

    maxiter: int = 256
    tol: float = 1e-2
    n_probes: int = 8
    precond_rank: int = 32
    block: int = 0
    quad_steps: int = 32
    jitter: float = DEFAULT_JITTER
    love_rank: int = 64
    sym_matvec: bool | None = None


def draw_probes(seed: int, n: int, cfg: IterConfig, dtype=torch.float32, device=None):
    """Deterministic probe draws, the reference's numpy stream bit for bit.

    Returns ``(probe_n, probe_k)``: (n, R) and (rank, R). Without a
    preconditioner the (n, R) block is Rademacher; with one both blocks are
    standard normal (z = L a + √D b ~ N(0, P)).
    """
    rng = np.random.default_rng(seed)
    r = cfg.n_probes
    if cfg.precond_rank > 0:
        pn = rng.standard_normal((n, r))
        pk = rng.standard_normal((cfg.precond_rank, r))
    else:
        pn = rng.choice(np.asarray([-1.0, 1.0]), size=(n, r))
        pk = np.zeros((0, r))
    device = resolve_device(device)
    return (torch.as_tensor(pn, dtype=dtype, device=device),
            torch.as_tensor(pk, dtype=dtype, device=device))


# ------------------------------------------------------------------
# Matvec builders
# ------------------------------------------------------------------


def _fused_term(spec):
    """The single stationary term eligible for the fused matvec, or None
    (one additive term, no linear part, no coregions; a mask is folded
    outside the kernel as (m mᵀ ∘ K) V = m ∘ K (m ∘ V))."""
    if len(spec.terms) != 1:
        return None
    t = spec.terms[0]
    if t.kernel in FUSABLE_KERNELS and not t.linear_idx and not t.coregs:
        return t
    return None


def _fused_matvec_args(spec, params, term):
    """(ls, η²) for the fused kernel from the parameter dict."""
    ls = params[f"ls_{term.suffix}"]
    if not spec.ard:
        ls = ls.expand(spec.d_cont)
    return ls, params[f"η_{term.suffix}"] ** 2


def _fused_active(spec, x):
    """The fused term when the hand kernels carry this call, else None."""
    term = _fused_term(spec)
    if term is not None and x.dtype == torch.float32 and x.is_cuda:
        return term
    return None


def _masked_gram(spec, params, xc, xk, mask):
    K = gram(spec, params, xc, xk, xc, xk)
    if mask is not None:
        K = K * (mask[:, None] * mask[None, :])
    return K


def _noise_vec(spec, params, xk, jitter, mask, noise_mult, dtype):
    """Full diagonal d with masked rows pinned to 1 (identity rows of A)."""
    d = noise_diag(spec, params, xk, dtype=dtype)
    if noise_mult is not None:
        d = d * noise_mult
    d = d + jitter
    if mask is not None:
        d = mask * d + (1.0 - mask)
    return d


def _make_matvec(spec, cfg, params, xc, xk, d, mask):
    """A·V for A = K_masked + diag(d): fused hand kernel, dense, or Gram
    row blocks × ``torch.matmul``."""
    n = xc.shape[0]
    if cfg.block > 0:
        term = _fused_active(spec, xc)
        if term is not None:
            ls, eta2 = _fused_matvec_args(spec, params, term)
            sym_on = cfg.sym_matvec is not False
            xcc = xc.contiguous()

            def matvec(V):
                Vm = V * mask[:, None] if mask is not None else V
                if sym_on and sym_matvec_fits(n, V.shape[1]):
                    out = eta2 * fused_stationary_matvec_sym(xcc, Vm, ls, term.kernel)
                else:
                    out = eta2 * fused_stationary_matvec(xcc, xcc, Vm, ls, term.kernel)
                if mask is not None:
                    out = out * mask[:, None]
                return out + d[:, None] * V

            return matvec

    if cfg.block <= 0:
        Kn = _masked_gram(spec, params, xc, xk, mask)

        def matvec(V):
            return Kn @ V + d[:, None] * V

        return matvec

    b = cfg.block
    if n % b != 0:
        raise ValueError(
            f"blocked matvec needs N ({n}) divisible by block ({b}); "
            "bucket-pad the data (mask handles the padding exactly)"
        )

    def matvec(V):
        out = torch.empty_like(V)
        for s in range(0, n, b):
            Kb = gram(spec, params, xc[s : s + b], xk[s : s + b], xc, xk)
            if mask is not None:
                Kb = Kb * (mask[s : s + b, None] * mask[None, :])
            out[s : s + b] = Kb @ V
        return out + d[:, None] * V

    return matvec


# ------------------------------------------------------------------
# Preconditioner: rank-k pivoted Cholesky of the kernel + exact noise diag
# ------------------------------------------------------------------


def pivoted_cholesky(row_fn, diag, rank, return_resid=False):
    """Rank-``rank`` greedy pivoted Cholesky of an SPD matrix.

    ``row_fn(i)`` takes a one-element index tensor and returns that row (n,)
    of the matrix; ``diag`` is its exact diagonal. Returns L (n, rank) and,
    with ``return_resid``, the final residual diagonal. Columns stop once
    the residual falls below 100·eps·max(diag), the reference's relative
    working-precision guard. Pivot, row index and guards stay on the device.
    """
    n = diag.shape[0]
    L = torch.zeros((n, rank), dtype=diag.dtype, device=diag.device)
    eps = torch.finfo(diag.dtype).eps
    thresh = torch.clamp_min(100.0 * eps * diag.max(), 1e-30)
    dres = diag.clone()
    for k in range(rank):
        i = torch.argmax(dres).reshape(1)
        di = dres.index_select(0, i)
        pii = torch.sqrt(torch.clamp_min(di, 1e-30))
        row = row_fn(i)
        li = (row - L @ L.index_select(0, i)[0]) / pii
        li = li.scatter(0, i, pii)
        good = di > thresh
        li = torch.where(good, li, torch.zeros_like(li))
        dres = torch.clamp_min(dres - li * li, 0.0).scatter(0, i, torch.where(good, torch.zeros_like(di), di))
        L[:, k] = li
    return (L, dres) if return_resid else L


def exhausted_factorization(dres, kdiag, d, mask, n_eff):
    """The two-regime gate: is P = LLᵀ + D an (f32-)exact factorization of A?

    True when the pivoted Cholesky hit the working-precision floor inside
    its rank budget AND the residual trace bounds the log-density error
    (tr(A−P)/2λ_min ≤ 1e-3·n_eff nats). A device bool tensor.
    """
    d_real = d if mask is None else torch.where(mask > 0, d, torch.inf)
    eps = torch.finfo(d.dtype).eps
    return torch.logical_and(
        dres.max() <= 100.0 * eps * torch.clamp_min(kdiag.max(), 1e-30),
        dres.sum() <= 2e-3 * n_eff * d_real.min(),
    )


def _make_precond(L, d):
    """Woodbury apply + logdet for P = L Lᵀ + diag(d).

    P⁻¹v = D⁻¹v − D⁻¹L (I + LᵀD⁻¹L)⁻¹ LᵀD⁻¹v
    log|P| = Σ log d + 2 Σ log diag chol(I + LᵀD⁻¹L)
    """
    k = L.shape[1]
    dinv = 1.0 / d
    DL = L * dinv[:, None]
    M = torch.eye(k, dtype=L.dtype, device=L.device) + L.T @ DL
    C = safe_cholesky(M)
    logdet_p = torch.log(d).sum() + 2.0 * torch.log(torch.diagonal(C)).sum()

    def psolve(V):
        t = cho_solve(C, DL.T @ V)
        return dinv[:, None] * V - DL @ t

    return psolve, logdet_p


def _row_fn(spec, params, xc, xk, mask):
    """Row i of the masked kernel matrix (one (1, N) Gram strip)."""

    def row_fn(i):
        row = gram(spec, params, xc.index_select(0, i), xk.index_select(0, i), xc, xk)[0]
        if mask is not None:
            row = row * mask.index_select(0, i) * mask
        return row

    return row_fn


def _agreed(value, agree):
    """A host reading of a device scalar: its own value, or with ``agree``
    (several ranks computing together, ``parallel``) the value every rank
    reads."""
    return float(value) if agree is None else float(agree([float(value)])[0])


def _preconditioner(spec, cfg, params, xc, xk, d, mask, n_eff, agree=None):
    """(L, psolve, logdet_p, exhausted) of the rank-``precond_rank``
    preconditioner; ``exhausted`` is read on the host, once (through
    ``agree`` where given, see :func:`_agreed`)."""
    kdiag = gram_diag(spec, params, xc, xk)
    if mask is not None:
        kdiag = kdiag * mask
    L, dres = pivoted_cholesky(_row_fn(spec, params, xc, xk, mask), kdiag, cfg.precond_rank,
                               return_resid=True)
    psolve, logdet_p = _make_precond(L, d)
    exhausted = bool(_agreed(exhausted_factorization(dres, kdiag, d, mask, n_eff), agree))
    return L, psolve, logdet_p, exhausted


def _woodbury_gate(exhausted, matvec, psolve, B, tol, agree=None):
    """The regime gate's second half: ``(exhausted, rel)``, with ``rel`` the
    Woodbury solve's worst column residual ‖B − A·P⁻¹B‖ / ‖B‖ (one matvec;
    NaN, and no matvec, where :func:`exhausted_factorization` read False).

    :func:`exhausted_factorization` bounds the pivoted Cholesky's residual
    diagonal, not the Woodbury solve's error, and at f32 and large N the
    two part: at bench_iterative50k's MAP (N = 50,000, rank 512) the gate
    reads exhausted while P⁻¹y misses y by a tenth of ‖y‖ or more
    (``chip_smoke.py`` phases 6 and 17 print it). So P⁻¹B
    stands in for A⁻¹B, and log|P| for log|A|, only where ``rel`` meets
    ``tol``; elsewhere the caller runs PCG (and SLQ) from P, under the
    unconverged-solve guard. Where P = A to working precision (every f64 case)
    ``rel`` is at rounding and the reference's regime stands.
    """
    if not exhausted:
        return False, math.nan
    bnorm = torch.clamp_min(torch.linalg.norm(B, dim=0), 1e-30)
    rel = _agreed((torch.linalg.norm(B - matvec(psolve(B)), dim=0) / bnorm).max(), agree)
    return rel <= tol, rel


# ------------------------------------------------------------------
# LOVE predictive variances: rank-k Lanczos factor of A
# ------------------------------------------------------------------


def lanczos(matvec, b, k):
    """k-step Lanczos of the SPD operator behind ``matvec``, fully
    reorthogonalized (two Gram-Schmidt passes per step).

    Returns ``(Q, diag, off)``: Q (n, k) with orthonormal live columns and
    zero columns after a breakdown, and T's coefficients; dead steps pad T
    with diag=1/off=0.
    """
    n = b.shape[0]
    dt = b.dtype
    bnorm = torch.sqrt((b * b).sum())
    Q = torch.zeros((n, k), dtype=dt, device=b.device)
    Q[:, 0] = b / torch.clamp_min(bnorm, 1e-30)
    diag = torch.zeros((k,), dtype=dt, device=b.device)
    off = torch.zeros((k,), dtype=dt, device=b.device)
    tiny = 1e-7 if dt == torch.float32 else 1e-12
    for j in range(k):
        q = Q[:, j]
        live = (q * q).sum() > 0.5  # columns are unit-norm or exactly zero
        w = matvec(q[:, None])[:, 0]
        a = q @ w
        diag[j] = torch.where(live, a, torch.ones_like(a))
        w = w - Q @ (Q.T @ w)
        w = w - Q @ (Q.T @ w)
        bnext = torch.sqrt((w * w).sum())
        good = torch.logical_and(live, bnext > tiny * torch.abs(a))
        off[j] = torch.where(good, bnext, torch.zeros_like(bnext))
        if j + 1 < k:
            Q[:, j + 1] = torch.where(good, w / torch.clamp_min(bnext, 1e-30), torch.zeros_like(w))
    return Q, diag, off[: k - 1]


def _cholqr2(W, eps_scale):
    """Orthonormalize the tall block W (n, b) by two rounds of Cholesky-QR,
    with a trace-scaled jitter that keeps a rank-deficient block factorizable.

    Where the jittered Gram is still not positive definite at the working
    precision (a Krylov block that closed early: at f32 the Gram's rounding
    error can exceed the 1e-6 jitter), the round whitens by the Gram's
    eigenvectors instead, with the eigenvalues floored at the jitter. Both
    give a basis of the same span; the Cholesky round, which is the
    reference's, is kept wherever it succeeds. One host sync per round."""

    def one_pass(V):
        G = V.T @ V
        jit_ = eps_scale * (torch.trace(G) / G.shape[0] + 1e-30)
        C = safe_cholesky(G + jit_ * torch.eye(G.shape[0], dtype=V.dtype, device=V.device))
        if bool(torch.isfinite(C).all()):
            return torch.linalg.solve_triangular(C, V.T, upper=False).T
        lam, U = torch.linalg.eigh(G)
        return V @ (U * torch.rsqrt(torch.clamp_min(lam, jit_)))

    return one_pass(one_pass(W))


def block_lanczos_basis(matvec, B0, k, block):
    """Orthonormal basis Q (n, k) of the block-Krylov space K(A, B0) and AQ,
    by ``k // block`` matvec sweeps with two-pass full reorthogonalization."""
    n = B0.shape[0]
    dt = B0.dtype
    nb = k // block
    eps = 1e-6 if dt == torch.float32 else 1e-12
    Q = torch.zeros((n, k), dtype=dt, device=B0.device)
    AQ = torch.zeros((n, k), dtype=dt, device=B0.device)
    Q[:, :block] = _cholqr2(B0, eps)
    for j in range(nb):
        Wj = matvec(Q[:, j * block : (j + 1) * block])
        AQ[:, j * block : (j + 1) * block] = Wj
        # not-yet-written columns of Q are zero and inert
        W = Wj - Q @ (Q.T @ Wj)
        W = W - Q @ (Q.T @ W)
        if j + 1 < nb:
            Q[:, (j + 1) * block : (j + 2) * block] = _cholqr2(W, eps)
    return Q, AQ


def _love_omega(n, block, like):
    """LOVE's start block Ω (n, block − 1): standard normals from a
    ``torch.Generator`` seeded with 7 on ``like``'s device (the reference
    draws it from ``jax.random.PRNGKey(7)``, which torch cannot reproduce)."""
    g = torch.Generator(device=like.device).manual_seed(7)
    return torch.randn((n, block - 1), generator=g, dtype=like.dtype, device=like.device)


def _love_factor(matvec, b, k, block=64, omega=None):
    """W (n, k) with W Wᵀ = Q T⁻¹ Qᵀ ≈ A⁻¹, the LOVE root decomposition.

    Variances from W are conservative for every test point (projection
    bound). For k ≥ 4·block the basis is block-Krylov K(A, [b | Ω]), k/block
    sweeps; ``omega`` overrides Ω (see :func:`_love_omega`). Smaller k keeps
    the scalar Lanczos.
    """
    n = b.shape[0]
    if k >= 4 * block and k % block == 0 and n >= k:
        om = _love_omega(n, block, b) if omega is None else omega.to(dtype=b.dtype, device=b.device)
        B0 = torch.cat([b[:, None], om], dim=1)
        Q, AQ = block_lanczos_basis(matvec, B0, k, block)
        T = Q.T @ AQ
        T = 0.5 * (T + T.T)
        eps = 1e-6 if b.dtype == torch.float32 else 1e-12
        T = T + (eps * torch.trace(T) / k) * torch.eye(k, dtype=b.dtype, device=b.device)
        C = safe_cholesky(T)
        return torch.linalg.solve_triangular(C, Q.T, upper=False).T
    Q, diag, off = lanczos(matvec, b, k)
    T = torch.diag(diag) + torch.diag(off, 1) + torch.diag(off, -1)
    C = safe_cholesky(T)
    return torch.linalg.solve_triangular(C, Q.T, upper=False).T


# ------------------------------------------------------------------
# Batched preconditioned CG with Lanczos-coefficient tracking (mBCG)
# ------------------------------------------------------------------


def pcg(matvec, psolve, B, maxiter, tol, track=0, skip=False, agree=None):
    """Solve A X = B for SPD A, all RHS columns simultaneously.

    Returns ``(X, alphas, betas, valid, iters, rel_res)``: the CG step
    scalars of the first ``track`` iterations with their validity mask (the
    Lanczos tridiagonals of P⁻¹A), the iteration count (int) and the worst
    column's final relative residual (device scalar). Converged columns
    freeze on the device (α forced to 0, excluded from ``valid``); the loop
    exits when every column is converged (one host sync per iteration) or
    at ``maxiter``. ``skip`` (host bool) returns X = 0 without iterating.
    The exit test reads through ``agree`` where given (:func:`_agreed`).
    """
    r_cols = B.shape[1]
    track = int(track) if track else 0
    bnorm = torch.sqrt((B * B).sum(0))
    stop = tol * torch.clamp_min(bnorm, 1e-30)
    X = torch.zeros_like(B)
    R = B
    Z = psolve(R)
    P = Z
    rz = (R * Z).sum(0)
    t = max(track, 1)
    al = torch.zeros((t, r_cols), dtype=B.dtype, device=B.device)
    be = torch.zeros((t, r_cols), dtype=B.dtype, device=B.device)
    va = torch.zeros((t, r_cols), dtype=torch.bool, device=B.device)
    i = 0
    while not skip and i < maxiter:
        live = torch.sqrt((R * R).sum(0)) > stop
        if not _agreed(live.any(), agree):
            break
        Ap = matvec(P)
        pAp = (P * Ap).sum(0)
        safe = torch.logical_and(live, pAp > 0.0)
        alpha = torch.where(safe, rz / torch.where(pAp > 0.0, pAp, 1.0), 0.0)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * Ap
        Z = psolve(R)
        rz_new = (R * Z).sum(0)
        beta = torch.where(safe, rz_new / torch.where(rz > 0.0, rz, 1.0), 0.0)
        P = Z + beta[None, :] * P
        if i < track:
            al[i], be[i], va[i] = alpha, beta, safe
        rz = rz_new
        i += 1
    rel_res = (torch.sqrt((R * R).sum(0)) / torch.clamp_min(bnorm, 1e-30)).max()
    return X, al, be, va, i, rel_res


def _tridiag_from_cg(alphas, betas, valid):
    """(t, R) CG scalars → (R, t, t) symmetric Lanczos tridiagonals; steps a
    column never ran pad with an identity block (invisible to e₁ quadrature)."""
    t, r = alphas.shape
    a = torch.where(valid, alphas, 1.0)
    b = torch.where(valid, betas, 0.0)
    inv_a = 1.0 / a
    prev = torch.cat([torch.zeros((1, r), dtype=a.dtype, device=a.device), (b * inv_a)[:-1]], dim=0)
    diag = torch.where(valid, inv_a + prev, 1.0).T  # (R, t)
    off = torch.where(valid, torch.sqrt(torch.clamp_min(b, 0.0)) * inv_a, 0.0).T
    nxt = torch.cat([valid[1:], torch.zeros((1, r), dtype=torch.bool, device=a.device)], dim=0).T
    off = torch.where(nxt, off, 0.0)[:, :-1]  # (R, t-1)
    return torch.diag_embed(diag) + torch.diag_embed(off, 1) + torch.diag_embed(off, -1)


def _slq_logdet(alphas, betas, valid, znorm2):
    """mean_i (zᵢᵀP⁻¹zᵢ) · e₁ᵀ log(Tᵢ) e₁ (Gauss quadrature).

    A non-finite T (a line search's garbage trial point) gives NaN, as the
    reference's eigh does, where ``torch.linalg.eigh`` would raise; the
    objective turns it into +inf.
    """
    T = _tridiag_from_cg(alphas, betas, valid)
    if not bool(torch.isfinite(T).all()):
        return torch.full((), torch.nan, dtype=T.dtype, device=T.device)
    lam, Q = torch.linalg.eigh(T)
    w = Q[:, 0, :] ** 2
    quad = (w * torch.log(torch.clamp_min(lam, 1e-30))).sum(-1)
    return (znorm2 * quad).mean()


# ------------------------------------------------------------------
# The Gaussian log-density with the surrogate backward
# ------------------------------------------------------------------


def _n_eff(y, mask):
    if mask is not None:
        return mask.sum()
    return torch.tensor(float(y.shape[0]), dtype=y.dtype, device=y.device)


def _iter_forward(spec, cfg, params, xc, xk, y, probe_n, probe_k, mask, noise_mult, make_matvec=None,
                  agree=None):
    """log p(y) and ``(alpha, S, W, info)``; ``info`` holds the CG
    iterations, the final relative residual and the regime.

    ``make_matvec`` (same arguments as :func:`_make_matvec`) builds A·V
    (``parallel.iterative``: row blocks over a mesh); ``agree`` is passed to
    every host decision (:func:`_agreed`)."""
    d = _noise_vec(spec, params, xk, cfg.jitter, mask, noise_mult, y.dtype)
    matvec = (make_matvec or _make_matvec)(spec, cfg, params, xc, xk, d, mask)
    n_eff = _n_eff(y, mask)
    if cfg.precond_rank > 0:
        L, psolve, logdet_p, exhausted = _preconditioner(spec, cfg, params, xc, xk, d, mask, n_eff, agree)
        Z = L @ probe_k + torch.sqrt(d)[:, None] * probe_n  # z ~ N(0, P)
    else:
        psolve = lambda V: V  # noqa: E731
        logdet_p = torch.zeros((), dtype=y.dtype, device=y.device)
        Z = probe_n
        exhausted = False

    ym = y * mask if mask is not None else y
    B = torch.cat([ym[:, None], Z], dim=1)
    # Exhausted regime: P⁻¹B meets tol, so the Woodbury solve and log|P| are
    # the answer and CG (which cannot certify convergence there) is skipped.
    exhausted, woodbury_rel = _woodbury_gate(exhausted, matvec, psolve, B, cfg.tol, agree)
    X, al, be, va, iters, rel_res = pcg(matvec, psolve, B, cfg.maxiter, cfg.tol,
                                        track=cfg.quad_steps, skip=exhausted, agree=agree)
    if exhausted:
        X = psolve(B)
    alpha, S = X[:, 0], X[:, 1:]
    quad = (ym * alpha).sum()
    W = psolve(Z)
    znorm2 = (Z * W).sum(0)
    logdet = logdet_p if exhausted else logdet_p + _slq_logdet(al[:, 1:], be[:, 1:], va[:, 1:], znorm2)
    logp = -0.5 * (quad + logdet + n_eff * math.log(2.0 * math.pi))
    # An unconverged solve makes the value arbitrarily wrong: distrust it
    # (−inf, which the objective turns into +inf); the exhausted regime is
    # exact and bypasses the guard.
    if not exhausted:
        logp = torch.where(rel_res <= 10.0 * cfg.tol, logp, -torch.inf)
    info = {"iters": iters, "rel_res": rel_res, "exhausted": exhausted, "woodbury_rel": woodbury_rel}
    return logp, (alpha, S, W, info)


def _bilinear_sum(spec, cfg, params, xc, xk, U, V, wts, mask, noise_mult, dtype, wrt=None, rows=None,
                  reduce=None):
    """Σ_j wts_j · u_jᵀ A(params) v_j, the only θ-differentiated computation.

    With ``wrt`` (a sequence of parameter tensors requiring grad) returns
    the gradient of that sum with respect to them instead. Blocked mode
    takes one ``torch.autograd.grad`` per (block, N) Gram block and adds
    them up, so at most one block's graph is alive at a time. ``rows``
    ((start, stop)) limits the Gram term to those rows, and ``reduce`` (a
    list of tensors → the list summed over ranks) adds up the Gram term's
    gradients (or value) of several ranks' rows before the noise diagonal's.
    """
    Vw = V * wts[None, :]

    def diag_term():
        d = _noise_vec(spec, params, xk, cfg.jitter, mask, noise_mult, dtype)
        return (d * (U * Vw).sum(1)).sum()

    def block_term(s, e):
        Kb = gram(spec, params, xc[s:e], xk[s:e], xc, xk)
        if mask is not None:
            Kb = Kb * (mask[s:e, None] * mask[None, :])
        return (U[s:e] * (Kb @ Vw)).sum()

    start, stop = rows if rows is not None else (0, xc.shape[0])
    b = cfg.block if cfg.block > 0 else stop - start
    starts = range(start, stop, b)
    if wrt is None:
        gram_part = sum(block_term(s, s + b) for s in starts)
        if reduce is not None:
            gram_part = reduce([gram_part.reshape(1)])[0][0]
        return diag_term() + gram_part
    wrt = list(wrt)

    def grads(value):
        gs = torch.autograd.grad(value, wrt, allow_unused=True)
        return [torch.zeros_like(w) if g is None else g for w, g in zip(wrt, gs)]

    if reduce is None:
        total = grads(diag_term())
        for s in starts:
            total = [t + g for t, g in zip(total, grads(block_term(s, s + b)))]
        return total
    total = [torch.zeros_like(w) for w in wrt]
    for s in starts:
        total = [t + g for t, g in zip(total, grads(block_term(s, s + b)))]
    return [g + t for g, t in zip(grads(diag_term()), reduce(total))]


class _IterGaussianLogp(torch.autograd.Function):
    """log N(y | 0, K + D) by mBCG + SLQ; backward is the Hutchinson surrogate
    d logp = ½ αᵀ(dA)α − 1/(2R) Σᵢ sᵢᵀ(dA)wᵢ and ȳ = −α."""

    @staticmethod
    def forward(ctx, spec, cfg, keys, xc, xk, y, probe_n, probe_k, mask, noise_mult, info, *values):
        params = dict(zip(keys, values))
        logp, (alpha, S, W, stats) = _iter_forward(
            spec, cfg, params, xc, xk, y, probe_n, probe_k, mask, noise_mult
        )
        if info is not None:
            info.update(stats)
        ctx.spec, ctx.cfg, ctx.keys = spec, cfg, keys
        ctx.save_for_backward(xc, xk, mask, noise_mult, alpha, S, W, *values)
        return logp

    @staticmethod
    def backward(ctx, g):
        xc, xk, mask, noise_mult, alpha, S, W, *values = ctx.saved_tensors
        r = S.shape[1]
        U = torch.cat([alpha[:, None], S], dim=1)
        V = torch.cat([alpha[:, None], W], dim=1)
        wts = torch.cat([
            torch.full((1,), 0.5, dtype=alpha.dtype, device=alpha.device),
            torch.full((r,), -0.5 / r, dtype=alpha.dtype, device=alpha.device),
        ])
        needs = ctx.needs_input_grad[11:]
        p_bar = [None] * len(values)
        if any(needs):
            with torch.enable_grad():
                leaves = [v.detach().requires_grad_(True) for v in values]
                params = dict(zip(ctx.keys, leaves))
                grads = _bilinear_sum(ctx.spec, ctx.cfg, params, xc, xk, U, V, wts, mask, noise_mult,
                                      alpha.dtype, wrt=leaves)
            p_bar = [g * gr if nd else None for gr, nd in zip(grads, needs)]
        y_bar = -g * alpha if ctx.needs_input_grad[5] else None
        return (None, None, None, None, None, y_bar, None, None, None, None, None, *p_bar)


def iter_gaussian_logp(spec, cfg, params, xc, xk, y, probe_n, probe_k, mask=None, noise_mult=None,
                       info=None):
    """log N(y | 0, K + D) by preconditioned mBCG + SLQ.

    Deterministic given the probe arrays (draw once per fit with
    :func:`draw_probes`). Gradients with respect to ``params`` and ``y`` are
    the Hutchinson surrogate; the Krylov loop is never differentiated. A
    dict passed as ``info`` receives the evaluation's CG iterations,
    relative residual and regime (``exhausted``).
    """
    keys = tuple(params)
    return _IterGaussianLogp.apply(spec, cfg, keys, xc, xk, y, probe_n, probe_k, mask, noise_mult,
                                   info, *(params[k] for k in keys))


def iter_map_neg_logp(
    spec, uparams, xc, xk, y, ls_alpha, ls_beta, probe_n, probe_k,
    cfg: IterConfig, mask=None, noise_mult=None, info=None,
):
    """−[log p(y|θ) + log p(θ)] with the iterative likelihood (MAP objective);
    non-finite values become +inf so line searches back off."""
    params = constrain(uparams)
    data_logp = iter_gaussian_logp(spec, cfg, params, xc, xk, y, probe_n, probe_k, mask, noise_mult,
                                   info=info)
    total = data_logp + log_prior(spec, uparams, ls_alpha, ls_beta)
    return torch.where(torch.isfinite(total), -total, torch.inf)


def iter_map_value_and_grad(spec, cfg, uparams, xc, xk, y, ls_alpha, ls_beta, probe_n, probe_k,
                            mask=None, info=None):
    """(value, gradient dict) of :func:`iter_map_neg_logp` at ``uparams``."""
    u = {k: v.detach().requires_grad_(True) for k, v in uparams.items()}
    value = iter_map_neg_logp(spec, u, xc, xk, y, ls_alpha, ls_beta, probe_n, probe_k, cfg,
                              mask=mask, info=info)
    grads = torch.autograd.grad(value, list(u.values()))
    return value.detach(), dict(zip(u, grads))


@torch.no_grad()
def iter_map_value(spec, cfg, uparams, xc, xk, y, ls_alpha, ls_beta, probe_n, probe_k, mask=None,
                   info=None):
    """Value of :func:`iter_map_neg_logp` (no gradient)."""
    return iter_map_neg_logp(spec, uparams, xc, xk, y, ls_alpha, ls_beta, probe_n, probe_k, cfg,
                             mask=mask, info=info)


def fit_iter_map(spec, cfg, xc, xk, y, ls_alpha, ls_beta, probe_n, probe_k, u0s, mask=None,
                 maxiter=250, tol=1e-6):
    """Multi-restart MAP fit on the iterative objective (the non-staged path)."""

    def objective(u):
        return iter_map_neg_logp(spec, u, xc, xk, y, ls_alpha, ls_beta, probe_n, probe_k, cfg,
                                 mask=mask)

    return multi_restart_minimize(objective, u0s, maxiter=maxiter, tol=tol)


# ------------------------------------------------------------------
# Posterior
# ------------------------------------------------------------------

# The posterior solve's relative-residual target, at most the config's tol:
# one solve a fit, and every predicted mean's error scales with it (at
# bench_iterative50k's MAP, tol 1e-2 left the grid means ~8e-3 off the exact
# posterior; ``chip_smoke.py`` phase 17 prints both).
POSTERIOR_TOL = 1e-4


def _posterior_solve(matvec, psolve, ym, cfg, exhausted, agree=None):
    """α = A⁻¹y to ``min(cfg.tol, POSTERIOR_TOL)``: ``(alpha, CG iterations,
    its relative residual, exhausted, Woodbury residual)``, the Woodbury
    solve where :func:`_woodbury_gate` passes, else PCG from P."""
    tol = min(float(cfg.tol), POSTERIOR_TOL)
    b = ym[:, None]
    exhausted, woodbury_rel = _woodbury_gate(exhausted, matvec, psolve, b, tol, agree)
    X, *_, iters, rel_res = pcg(matvec, psolve, b, cfg.maxiter, tol, skip=exhausted, agree=agree)
    if exhausted:
        X, rel_res = psolve(b), woodbury_rel
    return X[:, 0], iters, float(rel_res), exhausted, woodbury_rel


@torch.no_grad()
def iter_posterior_cache(spec, cfg, params, xc, xk, y, mask=None, noise_mult=None, omega=None,
                         info=None, make_matvec=None, agree=None):
    """Posterior state for iterative prediction: {alpha, L, d[, W]}.

    One solve for α = A⁻¹y (:func:`_posterior_solve`; ``info`` gets its CG
    iterations, residual, regime and Woodbury residual), the preconditioner
    factor L, and, when ``cfg.love_rank > 0``, the LOVE factor W with
    W Wᵀ ≈ A⁻¹ (``omega`` as in :func:`_love_factor`).
    Requires ``cfg.precond_rank > 0``. ``make_matvec`` and ``agree`` as in
    :func:`_iter_forward`.
    """
    if cfg.precond_rank <= 0:
        raise ValueError("iter_posterior_cache needs precond_rank > 0")
    d = _noise_vec(spec, params, xk, cfg.jitter, mask, noise_mult, y.dtype)
    matvec = (make_matvec or _make_matvec)(spec, cfg, params, xc, xk, d, mask)
    L, psolve, _, exhausted = _preconditioner(spec, cfg, params, xc, xk, d, mask, _n_eff(y, mask), agree)
    ym = y * mask if mask is not None else y
    alpha, iters, rel_res, exhausted, woodbury_rel = _posterior_solve(matvec, psolve, ym, cfg, exhausted, agree)
    if mask is not None:
        alpha = alpha * mask
    if info is not None:
        info.update(iters=iters, rel_res=rel_res, exhausted=exhausted, woodbury_rel=woodbury_rel)
    cache = {"alpha": alpha, "L": L, "d": d}
    if cfg.love_rank > 0:
        # Krylov(A, y): masked rows of ym are zero and A acts as identity
        # on them, so every basis vector stays in the unmasked subspace.
        k = min(int(cfg.love_rank), int(xc.shape[0]))
        cache["W"] = _love_factor(matvec, ym, k, omega=omega)
    return cache


@torch.no_grad()
def iter_predict_diag(spec, cfg, params, cache, xc, xk, xc_star, xk_star, with_noise=True, mask=None,
                      chunk=2048):
    """(mean, var) at test points from an :func:`iter_posterior_cache`.

    mean = K(*,X) α; var = k** − ‖Wᵀ k*‖² with the LOVE factor (conservative
    for every test point), or k** − k*ᵀ P⁻¹ k* with the preconditioner when
    the cache has no W. With a fusable term at f32 on CUDA and a LOVE
    factor, one fused cross-Gram matvec against [α | W] does it all.
    """
    alpha, L, d = cache["alpha"], cache["L"], cache["d"]
    W_love = cache.get("W")
    term = _fused_active(spec, alpha)
    if term is not None and W_love is not None:
        ls, eta2 = _fused_matvec_args(spec, params, term)
        am = alpha * mask if mask is not None else alpha
        Wm = W_love * mask[:, None] if mask is not None else W_love
        V = torch.cat([am[:, None], Wm], dim=1)
        out = eta2 * fused_stationary_matvec(xc_star.contiguous(), xc.contiguous(), V, ls, term.kernel)
        mean = out[:, 0]
        qform = (out[:, 1:] * out[:, 1:]).sum(1)
        var = torch.clamp_min(gram_diag(spec, params, xc_star, xk_star) - qform, 0.0)
    else:
        psolve = _make_precond(L, d)[0] if W_love is None else None
        means, vars_ = [], []
        for s in range(0, xc_star.shape[0], chunk):
            xcb, xkb = xc_star[s : s + chunk], xk_star[s : s + chunk]
            Ks = gram(spec, params, xcb, xkb, xc, xk)
            if mask is not None:
                Ks = Ks * mask[None, :]
            if W_love is not None:
                proj = Ks @ W_love
                qform = (proj * proj).sum(1)
            else:
                qform = (Ks * psolve(Ks.T).T).sum(1)
            means.append(Ks @ alpha)
            vars_.append(torch.clamp_min(gram_diag(spec, params, xcb, xkb) - qform, 0.0))
        mean, var = torch.cat(means), torch.cat(vars_)
    if with_noise:
        var = var + noise_diag(spec, params, xk_star, n=xc_star.shape[0], dtype=alpha.dtype)
    return mean, var


@torch.no_grad()
def iter_predict_mean(spec, cfg, params, xc, xk, y, xc_star, xk_star, mask=None, noise_mult=None,
                      star_block=4096):
    """Posterior mean at test points, K(*,X) A⁻¹y, with one solve
    (:func:`_posterior_solve`); the cross-Gram is the fused kernel at f32
    on CUDA, else streamed in test-point blocks."""
    d = _noise_vec(spec, params, xk, cfg.jitter, mask, noise_mult, y.dtype)
    matvec = _make_matvec(spec, cfg, params, xc, xk, d, mask)
    if cfg.precond_rank > 0:
        _, psolve, _, exhausted = _preconditioner(spec, cfg, params, xc, xk, d, mask, _n_eff(y, mask))
    else:
        psolve = lambda V: V  # noqa: E731
        exhausted = False
    ym = y * mask if mask is not None else y
    alpha = _posterior_solve(matvec, psolve, ym, cfg, exhausted)[0]
    if mask is not None:
        alpha = alpha * mask

    term = _fused_active(spec, alpha)
    if term is not None:
        ls, eta2 = _fused_matvec_args(spec, params, term)
        out = eta2 * fused_stationary_matvec(xc_star.contiguous(), xc.contiguous(), alpha[:, None], ls,
                                             term.kernel)
        return out[:, 0]
    means = []
    for s in range(0, xc_star.shape[0], star_block):
        Kb = gram(spec, params, xc_star[s : s + star_block], xk_star[s : s + star_block], xc, xk)
        if mask is not None:
            Kb = Kb * mask[None, :]
        means.append(Kb @ alpha)
    return torch.cat(means)
