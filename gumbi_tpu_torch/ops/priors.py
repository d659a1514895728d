"""Hyperparameter priors, unconstrained transforms, and initial points.

Port of ``gumbi_tpu/ops/priors.py``; the prior structure is the reference
model's:

* ls  ~ InverseGamma(α, β) per continuous dim (constrained-mass fit)
* η   ~ Gamma(2, 1)
* c   ~ Normal(0, 10), τ ~ HalfNormal(10)
* W   ~ Normal(0, 3) (D_out, 2), κ ~ Gamma(1.5, 1)
* σ   ~ Exponential(1)

MAP optimization runs in unconstrained space: positive parameters are
log-transformed and the log-Jacobian is included. ``initial_params``,
``fit_inverse_gamma`` and ``ls_prior_params`` are numpy/scipy and give the
reference's arrays for the same inputs and seed.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
from scipy import optimize as sopt
from scipy import stats as sstats

from ..utils.torch_utils import resolve_device
from .kernels import GPSpec

__all__ = [
    "ParamInfo",
    "param_info",
    "constrain",
    "unconstrain",
    "log_prior",
    "log_prior_chains",
    "initial_params",
    "fit_inverse_gamma",
    "ls_prior_params",
]

_POSITIVE_PREFIXES = ("ls_", "η_", "τ_", "κ_", "σ")


def _is_positive(name: str) -> bool:
    return name.startswith(_POSITIVE_PREFIXES) or name == "σ"


@dataclass(frozen=True)
class ParamInfo:
    """Shape and prior family of one hyperparameter tensor."""

    shape: Tuple[int, ...]
    prior: str  # 'invgamma' | 'gamma' | 'halfnormal' | 'normal' | 'exponential'
    positive: bool


def param_info(spec: GPSpec) -> Dict[str, ParamInfo]:
    """Parameter metadata derived from the covariance structure."""
    info: Dict[str, ParamInfo] = {}
    seen_coregs = set()
    for term in spec.terms:
        s = term.suffix
        info[f"ls_{s}"] = ParamInfo((spec.n_ls,), "invgamma", True)
        info[f"η_{s}"] = ParamInfo((), "gamma_2_1", True)
        if term.linear_idx:
            info[f"c_{s}"] = ParamInfo((len(term.linear_idx),), "normal_0_10", False)
            info[f"τ_{s}"] = ParamInfo((), "halfnormal_10", True)
        for cg in term.coregs:
            if cg.name in seen_coregs:
                continue
            seen_coregs.add(cg.name)
            info[f"W_{cg.name}"] = ParamInfo((cg.d_out, cg.rank), "normal_0_3", False)
            info[f"κ_{cg.name}"] = ParamInfo((cg.d_out,), "gamma_1.5_1", True)
    # Non-Gaussian likelihoods carry no observation noise.
    if getattr(spec, "likelihood", "gaussian") == "gaussian":
        info["σ"] = ParamInfo((), "exponential_1", True)
        if spec.noise_coreg is not None:
            cg = spec.noise_coreg
            info[f"W_{cg.name}"] = ParamInfo((cg.d_out, cg.rank), "normal_0_3", False)
            info[f"κ_{cg.name}"] = ParamInfo((cg.d_out,), "gamma_1.5_1", True)
    return info


def constrain(uparams: dict) -> dict:
    """Unconstrained → natural space (exp for positive parameters)."""
    return {k: (torch.exp(v) if _is_positive(k) else v) for k, v in uparams.items()}


def unconstrain(params: dict) -> dict:
    """Natural → unconstrained space (log for positive parameters)."""
    return {k: (torch.log(v) if _is_positive(k) else v) for k, v in params.items()}


# ------------------------------------------------------------------
# Log-density of each prior family (normalizing constants kept, so values
# are comparable to PyMC's logp). Shape parameters are cast to x's dtype
# and device, so an f32 objective stays f32.
# ------------------------------------------------------------------


def _t(v, x):
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


def _logp_invgamma(x, α, β):
    α, β = _t(α, x), _t(β, x)
    return α * torch.log(β) - torch.lgamma(α) - (α + 1.0) * torch.log(x) - β / x


def _logp_gamma(x, α, β):
    return α * math.log(β) + (α - 1.0) * torch.log(x) - β * x - math.lgamma(α)


def _logp_halfnormal(x, σ):
    return 0.5 * math.log(2.0 / math.pi) - math.log(σ) - x**2 / (2.0 * σ**2)


def _logp_normal(x, μ, σ):
    return -0.5 * math.log(2.0 * math.pi) - math.log(σ) - (x - μ) ** 2 / (2.0 * σ**2)


def _logp_exponential(x, lam):
    return math.log(lam) - lam * x


def _log_prior_terms(spec: GPSpec, uparams: dict, ls_alpha, ls_beta):
    """(log-density, unconstrained value, positive) of each hyperparameter,
    elementwise over its entries."""
    for name, meta in param_info(spec).items():
        u = uparams[name]
        x = torch.exp(u) if meta.positive else u
        if meta.prior == "invgamma":
            lp = _logp_invgamma(x, ls_alpha, ls_beta)
        elif meta.prior == "gamma_2_1":
            lp = _logp_gamma(x, 2.0, 1.0)
        elif meta.prior == "gamma_1.5_1":
            lp = _logp_gamma(x, 1.5, 1.0)
        elif meta.prior == "halfnormal_10":
            lp = _logp_halfnormal(x, 10.0)
        elif meta.prior == "normal_0_10":
            lp = _logp_normal(x, 0.0, 10.0)
        elif meta.prior == "normal_0_3":
            lp = _logp_normal(x, 0.0, 3.0)
        elif meta.prior == "exponential_1":
            lp = _logp_exponential(x, 1.0)
        else:  # pragma: no cover
            raise ValueError(f"Unknown prior {meta.prior}")
        yield lp, u, meta.positive


def log_prior(spec: GPSpec, uparams: dict, ls_alpha, ls_beta) -> torch.Tensor:
    """Total prior log-density in unconstrained space (Jacobians included).

    ``ls_alpha``/``ls_beta`` are per-lengthscale InverseGamma parameters
    (shape (n_ls,)), produced by :func:`ls_prior_params`.
    """
    total = 0.0
    for lp, u, positive in _log_prior_terms(spec, uparams, ls_alpha, ls_beta):
        total = total + lp.sum()
        if positive:
            total = total + u.sum()  # log|dx/du| for x = exp(u)
    return total


def log_prior_chains(spec: GPSpec, uparams: dict, ls_alpha, ls_beta) -> torch.Tensor:
    """:func:`log_prior` of C points at once: every tensor of ``uparams``
    carries a leading chain axis; returns (C,), each entry summed as
    :func:`log_prior` sums one point."""
    total = 0.0
    for lp, u, positive in _log_prior_terms(spec, uparams, ls_alpha, ls_beta):
        c = u.shape[0]
        total = total + lp.reshape(c, -1).sum(1)
        if positive:
            total = total + u.reshape(c, -1).sum(1)
    return total


# ------------------------------------------------------------------
# Initial points: prior "moments" for restart 0, jittered for the rest.
# ------------------------------------------------------------------


def _moment(meta: ParamInfo, ls_alpha, ls_beta):
    if meta.prior == "invgamma":
        α = np.asarray(ls_alpha, dtype=float)
        β = np.asarray(ls_beta, dtype=float)
        return np.where(α > 1, β / (α - 1), β)
    if meta.prior == "gamma_2_1":
        return np.full(meta.shape, 2.0)
    if meta.prior == "gamma_1.5_1":
        return np.full(meta.shape, 1.5)
    if meta.prior == "halfnormal_10":
        return np.full(meta.shape, 10.0 * np.sqrt(2.0 / np.pi))
    if meta.prior == "normal_0_10":
        return np.zeros(meta.shape)
    if meta.prior == "normal_0_3":
        return np.zeros(meta.shape)
    if meta.prior == "exponential_1":
        return np.full(meta.shape, 1.0)
    raise ValueError(meta.prior)


def initial_params(
    spec: GPSpec, ls_alpha, ls_beta, n_restarts: int, seed: int,
    dtype=torch.float64, device=None,
) -> dict:
    """Stacked unconstrained initial points, shape (n_restarts, *param_shape).

    The tensors go to ``device``: the CUDA card unless the caller passes
    ``device="cpu"`` (:func:`resolve_device`; no CUDA there raises).

    Restart 0 sits at the prior moments; W always starts from a seeded
    standard normal and the other restarts jitter the moments in
    unconstrained space. The numpy draws are the reference's, in its order.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    info = param_info(spec)
    stacked = {}
    for name, meta in info.items():
        base = np.asarray(_moment(meta, ls_alpha, ls_beta), dtype=float)
        base = np.broadcast_to(base, meta.shape) if meta.shape else np.asarray(base).reshape(())
        if name.startswith("W_"):
            draws = rng.standard_normal((n_restarts,) + meta.shape)
            stacked[name] = torch.as_tensor(draws, dtype=dtype, device=device)
            continue
        u0 = np.log(np.maximum(base, 1e-10)) if meta.positive else base
        jit = rng.normal(0.0, 0.5, size=(n_restarts,) + meta.shape)
        jit[0] = 0.0  # restart 0 = exact moments
        stacked[name] = torch.as_tensor(u0[None] + jit, dtype=dtype, device=device)
    return stacked


# ------------------------------------------------------------------
# Constrained InverseGamma fit (host-side scipy, as in the reference).
# ------------------------------------------------------------------


def fit_inverse_gamma(lower: float, upper: float, mass: float = 0.98):
    """Solve for InverseGamma(α, β) putting ``mass`` between the bounds.

    Tail masses are equal: cdf(lower) = (1-mass)/2, cdf(upper) = 1-(1-mass)/2.
    Raises ValueError when optimization fails, so the caller's retry loop
    can engage.
    """
    tail = (1.0 - mass) / 2.0

    def residuals(logab):
        α, β = np.exp(logab)
        dist = sstats.invgamma(α, scale=β)
        return [dist.cdf(lower) - tail, dist.cdf(upper) - (1.0 - tail)]

    x0 = np.log([max(lower, 1e-3), max(upper, 1e-3)])
    sol = sopt.least_squares(residuals, x0, method="lm", xtol=1e-14, ftol=1e-14)
    resid = np.max(np.abs(sol.fun))
    if not sol.success or resid > 1e-6:
        raise ValueError(
            f"Optimization of parameters failed (residual {resid:.2e} for bounds "
            f"[{lower}, {upper}], mass {mass})"
        )
    α, β = np.exp(sol.x)
    return {"alpha": float(α), "beta": float(β)}


def ls_prior_params(lowers, uppers, mass: float = 0.98):
    """Per-dimension InverseGamma(α, β) arrays with the mass-decrement retry.

    On failure the requested probability mass is reduced by 0.01 and the
    fit is retried, warning when the mass had to be relaxed.
    """
    alphas, betas = [], []
    for i, (lo, hi) in enumerate(zip(lowers, uppers)):
        mass_ = mass
        while True:
            try:
                p = fit_inverse_gamma(lo, hi, mass_)
            except ValueError as e:
                if "Optimization of parameters failed" in str(e) and mass_ > 0.5:
                    mass_ -= 0.01
                    continue
                raise
            if mass_ != mass:
                warnings.warn(
                    "Mass of constrained lengthscale prior was reduced from "
                    f"{mass:.3f} to {mass_:.3f} to enable convergence for dimension {i}."
                )
            break
        alphas.append(p["alpha"])
        betas.append(p["beta"])
    return np.asarray(alphas), np.asarray(betas)
