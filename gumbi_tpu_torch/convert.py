"""Carry parameters and specs across from the JAX reference package.

The reference keeps hyperparameters as a dict of arrays keyed by name
(``ls_total``, ``η_total``, ``σ``, ``W_Parameter``, ...) and the covariance
structure as frozen ``GPSpec``/``GPTerm``/``CoregTerm`` dataclasses. These
helpers move both into the port without importing the reference: numpy
arrays on one side, tensors on the other, and specs read by attribute (or
by key, from a ``GP.save`` file's JSON).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.iterative import IterConfig
from .ops.kernels import CoregTerm, GPSpec, GPTerm
from .ops.posterior import PosteriorCache

__all__ = [
    "params_from_numpy",
    "params_to_numpy",
    "spec_from_reference",
    "iter_config_from_reference",
    "iter_cache_from_numpy",
    "iter_cache_to_numpy",
    "posterior_cache_from_numpy",
    "posterior_cache_to_numpy",
]


def params_from_numpy(params, *, device, dtype) -> dict:
    """Reference parameter dict (arrays) → the port's tensors on ``device``."""
    return {k: torch.as_tensor(np.array(v), dtype=dtype, device=device) for k, v in params.items()}


def params_to_numpy(params) -> dict:
    """The port's parameter dict → numpy arrays (for the reference package)."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def _field(obj, name, default=None):
    """``obj.name``, or ``obj[name]`` where ``obj`` is a dict: a spec as
    ``dataclasses.asdict`` gives it, as a ``GP.save`` file's JSON holds it."""
    return obj.get(name, default) if isinstance(obj, dict) else getattr(obj, name, default)


def _coreg(cg):
    if cg is None:
        return None
    return CoregTerm(name=_field(cg, "name"), col=int(_field(cg, "col")), d_out=int(_field(cg, "d_out")),
                     rank=int(_field(cg, "rank")))


def spec_from_reference(spec) -> GPSpec:
    """The port's ``GPSpec`` from any object with the reference's fields, or
    from ``dataclasses.asdict`` of one (a ``GP.save`` file's ``spec``)."""
    terms = tuple(
        GPTerm(
            suffix=_field(t, "suffix"),
            kernel=_field(t, "kernel"),
            linear_idx=tuple(int(i) for i in _field(t, "linear_idx")),
            coregs=tuple(_coreg(c) for c in _field(t, "coregs")),
        )
        for t in _field(spec, "terms")
    )
    period = _field(spec, "period")
    return GPSpec(
        terms=terms,
        d_cont=int(_field(spec, "d_cont")),
        ard=bool(_field(spec, "ard")),
        noise_coreg=_coreg(_field(spec, "noise_coreg")),
        period=None if period is None else tuple(float(p) for p in period),
        likelihood=_field(spec, "likelihood", "gaussian"),
    )


def iter_config_from_reference(cfg) -> IterConfig:
    """The port's ``IterConfig`` from any object with the reference's fields."""
    return IterConfig(
        maxiter=int(cfg.maxiter),
        tol=float(cfg.tol),
        n_probes=int(cfg.n_probes),
        precond_rank=int(cfg.precond_rank),
        block=int(cfg.block),
        quad_steps=int(cfg.quad_steps),
        jitter=float(cfg.jitter),
        love_rank=int(cfg.love_rank),
        sym_matvec=None if cfg.sym_matvec is None else bool(cfg.sym_matvec),
    )


def iter_cache_from_numpy(cache, *, device, dtype) -> dict:
    """A reference ``iter_posterior_cache`` dict ({alpha, L, d[, W]}, arrays)
    → the port's tensors on ``device``."""
    return {k: torch.as_tensor(np.array(v), dtype=dtype, device=device) for k, v in cache.items()}


def iter_cache_to_numpy(cache) -> dict:
    """The port's iterative posterior cache → numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in cache.items()}


def posterior_cache_from_numpy(cache, *, device, dtype) -> PosteriorCache:
    """A reference ``PosteriorCache`` (any object with ``L``, ``alpha``,
    ``xc``, ``xk`` and ``mask`` arrays) → the port's, on ``device``. The
    level indices ``xk`` become integers, whatever dtype they arrive in."""
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device=device)  # noqa: E731
    return PosteriorCache(
        L=t(cache.L),
        alpha=t(cache.alpha),
        xc=t(cache.xc),
        xk=torch.as_tensor(np.array(cache.xk), device=device).long(),
        mask=None if cache.mask is None else t(cache.mask),
    )


def posterior_cache_to_numpy(cache: PosteriorCache) -> dict:
    """The port's ``PosteriorCache`` → a dict of numpy arrays with the
    reference's field names (``mask`` stays None when there is none); build
    the reference's cache with ``PosteriorCache(**d)``."""
    return {k: None if v is None else v.detach().cpu().numpy() for k, v in cache._asdict().items()}
