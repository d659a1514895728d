"""GP posterior prediction: mean/variance solves over point sets.

Port of ``gumbi_tpu/ops/posterior.py`` (``PosteriorCache``,
``posterior_cache``, ``predict_diag``, ``predict_diag_chunked``). The
training-set Cholesky is computed once and cached on the device; prediction
is then one (M, N) cross-Gram, one matmul and one triangular solve per chunk.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .kernels import GPSpec, gram, gram_diag, noise_diag
from .linalg import cho_solve
from .mll import DEFAULT_JITTER, cholesky_factor

__all__ = ["PosteriorCache", "posterior_cache", "predict_diag", "predict_diag_chunked"]


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


def predict_diag(spec: GPSpec, params, cache: PosteriorCache, xc_new, xk_new, with_noise=True):
    """Posterior mean and per-point variance at new points."""
    Ks = gram(spec, params, xc_new, xk_new, cache.xc, cache.xk)  # (M, N)
    if cache.mask is not None:
        Ks = Ks * cache.mask[None, :]
    mean = Ks @ cache.alpha
    V = torch.linalg.solve_triangular(cache.L, Ks.T, upper=False)  # (N, M)
    var = gram_diag(spec, params, xc_new, xk_new) - (V * V).sum(0)
    var = torch.clamp(var, min=0.0)
    if with_noise:
        var = var + noise_diag(spec, params, xk_new, dtype=var.dtype)
    return mean, var


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
