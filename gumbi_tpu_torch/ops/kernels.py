"""GP kernel library: pure functions over a static spec + parameter dict.

Port of ``gumbi_tpu/ops/kernels.py``. The covariance structure is

    K_total = Σ_terms [ η²·K_cont(ls) (+ τ·K_lin(c)) ] · Π_coregs B[i, j]

with ``B = W Wᵀ + diag(κ)`` the ICM coregionalization matrix per categorical
dimension. ``GPSpec`` and its terms are frozen dataclasses with the
reference's fields; all numerics flow through the ``params`` dict of
tensors, keyed as in the reference (``ls_total``, ``η_total``, ``σ``,
``W_Parameter``, ``κ_Parameter``, ...).

Inputs are split by type: ``Xc`` (N, d_cont) float coordinates and ``Xk``
(N, n_cat) integer level indices.

The ExpQuad/RBF Gram at f32 on a CUDA tensor goes to the hand-written
Hopper kernel (:func:`gumbi_tpu_torch.ops.hopper_kernels.rbf_gram`),
exactly where the reference goes to its Pallas kernel. Everything else
(CPU, f64, other kernels) uses the reference's matmul-identity formula.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .hopper_kernels import rbf_gram

__all__ = [
    "CoregTerm",
    "GPTerm",
    "GPSpec",
    "CONTINUOUS_KERNELS",
    "gram",
    "gram_diag",
    "noise_diag",
    "coreg_matrix",
    "output_correlation",
]

CONTINUOUS_KERNELS = [
    "ExpQuad",
    "RBF",
    "Matern12",
    "Matern32",
    "Matern52",
    "Exponential",
    "Periodic",
]
CONTINUOUS_KERNELS += [k + "+Periodic" for k in CONTINUOUS_KERNELS if "Periodic" not in k]


@dataclass(frozen=True)
class CoregTerm:
    """One coregionalization factor: B = W Wᵀ + diag(κ) indexed by a cat column."""

    name: str  # parameter suffix, e.g. "Parameter" or "Code"
    col: int  # column into Xk holding this dimension's level indices
    d_out: int  # number of levels
    rank: int = 2  # columns of W


@dataclass(frozen=True)
class GPTerm:
    """One additive GP component: continuous (+linear) kernel × coregions."""

    suffix: str  # parameter suffix: "total" for the global term, dim name otherwise
    kernel: str  # continuous kernel name (may end in '+Periodic')
    linear_idx: Tuple[int, ...] = ()  # continuous-dim indices with a linear kernel
    coregs: Tuple[CoregTerm, ...] = ()  # all coregion factors multiplied into this term


@dataclass(frozen=True)
class GPSpec:
    """Static description of the full covariance structure."""

    terms: Tuple[GPTerm, ...]
    d_cont: int
    ard: bool = True
    noise_coreg: Optional[CoregTerm] = None  # heteroskedastic output noise factor
    period: Optional[Tuple[float, ...]] = None  # z-space period per continuous dim
    likelihood: str = "gaussian"  # 'bernoulli' (GPC) has no Gaussian noise σ

    @property
    def n_ls(self) -> int:
        return self.d_cont if self.ard else 1


# ------------------------------------------------------------------
# Distance helpers
# ------------------------------------------------------------------


def _scaled_sqdist(x1, x2, ls):
    """Σ_d ((x1_d - x2_d)/ls_d)² as an (n, m) matrix via the matmul identity."""
    a = x1 / ls
    b = x2 / ls
    sq = (a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :] - 2.0 * a @ b.T
    return torch.clamp(sq, min=0.0)


def _stationary(kernel, r2):
    """Stationary kernel value from the scaled squared distance matrix.

    Conventions follow pm.gp.cov: ExpQuad = exp(-r²/2), Matern12 = exp(-r),
    Exponential = exp(-r/2), Matern32/52 standard.
    """
    if kernel in ("ExpQuad", "RBF"):
        return torch.exp(-0.5 * r2)
    r = torch.sqrt(r2 + 1e-36)
    if kernel == "Matern12":
        return torch.exp(-r)
    if kernel == "Exponential":
        return torch.exp(-0.5 * r)
    if kernel == "Matern32":
        c = math.sqrt(3.0) * r
        return (1.0 + c) * torch.exp(-c)
    if kernel == "Matern52":
        c = math.sqrt(5.0) * r
        return (1.0 + c + c * c / 3.0) * torch.exp(-c)
    raise ValueError(f"Unknown stationary kernel {kernel!r}")


def _period(spec: GPSpec, like):
    return torch.as_tensor(spec.period, dtype=like.dtype, device=like.device)


def _periodic(x1, x2, ls, period):
    """pm.gp.cov.Periodic: exp(-0.5 Σ_d (2 sin(π Δ_d / T_d) / ls_d)²)."""
    diff = x1[:, None, :] - x2[None, :, :]  # (n, m, d)
    s = torch.sin(math.pi * diff / period) * (2.0 / ls)
    return torch.exp(-0.5 * (s * s).sum(-1))


def _warp_periodic(x, period):
    """sin/cos feature map used by the '+Periodic' warped kernels."""
    c = 2.0 * math.pi / period
    return torch.cat([torch.sin(c * x), torch.cos(c * x)], dim=-1)


def _linear(x1, x2, c, idx):
    """pm.gp.cov.Linear over the selected dims: Σ_d (x_d - c_d)(x'_d - c_d)."""
    idx = list(idx)
    a = x1[:, idx] - c
    b = x2[:, idx] - c
    return a @ b.T


def coreg_matrix(W, κ):
    """ICM coregionalization matrix B = W Wᵀ + diag(κ)."""
    return W @ W.T + torch.diag(κ)


def output_correlation(W, κ):
    """Correlation matrix implied by a coregion factor."""
    B = coreg_matrix(W, κ)
    D = torch.sqrt(torch.diagonal(B))[None, :]
    return B / (D.T @ D)


# ------------------------------------------------------------------
# Gram assembly
# ------------------------------------------------------------------


def _ls_vector(spec: GPSpec, ls):
    """Broadcast a possibly-shared lengthscale to one entry per continuous dim."""
    return ls if spec.ard else ls.expand(spec.d_cont)


def _term_cont(spec: GPSpec, term: GPTerm, params, xc1, xc2):
    s = term.suffix
    ls = _ls_vector(spec, params[f"ls_{s}"])
    η = params[f"η_{s}"]
    kernel = term.kernel

    if kernel == "Periodic":
        K = η**2 * _periodic(xc1, xc2, ls, _period(spec, xc1))
    elif kernel.endswith("+Periodic"):
        base = kernel[: -len("+Periodic")]
        u1 = _warp_periodic(xc1, _period(spec, xc1))
        u2 = _warp_periodic(xc2, _period(spec, xc1))
        ls2 = torch.cat([ls, ls])
        K = η**2 * _stationary(base, _scaled_sqdist(u1, u2, ls2))
    elif kernel in ("ExpQuad", "RBF") and xc1.dtype == torch.float32 and xc1.is_cuda:
        K = rbf_gram(xc1.contiguous(), xc2.contiguous(), ls, η)  # η² folded into the hand kernel
    else:
        K = η**2 * _stationary(kernel, _scaled_sqdist(xc1, xc2, ls))

    if term.linear_idx:
        c = params[f"c_{s}"]
        τ = params[f"τ_{s}"]
        K = K + τ * _linear(xc1, xc2, c, term.linear_idx)
    return K


def _coreg_lookup(params, cg: CoregTerm, xk1, xk2):
    B = coreg_matrix(params[f"W_{cg.name}"], params[f"κ_{cg.name}"])
    return B[xk1[:, cg.col].long()][:, xk2[:, cg.col].long()]


def _term_gram(spec: GPSpec, term: GPTerm, params, xc1, xk1, xc2, xk2):
    K = _term_cont(spec, term, params, xc1, xc2)
    for cg in term.coregs:
        K = K * _coreg_lookup(params, cg, xk1, xk2)
    return K


def gram(spec: GPSpec, params, xc1, xk1, xc2, xk2):
    """Full cross-covariance matrix between two point sets."""
    K = _term_gram(spec, spec.terms[0], params, xc1, xk1, xc2, xk2)
    for term in spec.terms[1:]:
        K = K + _term_gram(spec, term, params, xc1, xk1, xc2, xk2)
    return K


def _coreg_diag(params, cg: CoregTerm, xk):
    B = coreg_matrix(params[f"W_{cg.name}"], params[f"κ_{cg.name}"])
    i = xk[:, cg.col].long()
    return B[i, i]


def _term_diag(spec: GPSpec, term: GPTerm, params, xc, xk):
    s = term.suffix
    η = params[f"η_{s}"]
    d = η**2 * torch.ones(xc.shape[0], dtype=xc.dtype, device=xc.device)
    if term.linear_idx:
        c = params[f"c_{s}"]
        τ = params[f"τ_{s}"]
        d = d + τ * ((xc[:, list(term.linear_idx)] - c) ** 2).sum(-1)
    for cg in term.coregs:
        d = d * _coreg_diag(params, cg, xk)
    return d


def gram_diag(spec: GPSpec, params, xc, xk):
    """Diagonal of the prior covariance at the given points (no noise)."""
    d = _term_diag(spec, spec.terms[0], params, xc, xk)
    for term in spec.terms[1:]:
        d = d + _term_diag(spec, term, params, xc, xk)
    return d


def noise_diag(spec: GPSpec, params, xk, n=None, dtype=None):
    """Observation-noise variance at each point.

    σ ~ WhiteNoise std; with heteroskedastic outputs the white noise is
    multiplied by an output coregion's diagonal.
    """
    σ = params["σ"]
    n = xk.shape[0] if n is None else n
    d = σ**2 * torch.ones(n, dtype=σ.dtype if dtype is None else dtype, device=σ.device)
    if spec.noise_coreg is not None:
        d = d * _coreg_diag(params, spec.noise_coreg, xk)
    return d
