"""Lengthscale-prior utilities.

A copy of ``gumbi_tpu/utils/gp_utils.py`` over the port's priors
(:mod:`gumbi_tpu_torch.ops.priors`): ``parse_ls_limits`` and
``get_ls_prior`` keep the reference's signatures and bound logic.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.distance import pdist

from ..ops.priors import fit_inverse_gamma, ls_prior_params
from .misc import listify

__all__ = ["parse_ls_limits", "get_ls_prior", "fit_inverse_gamma"]


def _distance_extrema(points):
    """(min, max) nonzero pairwise Euclidean distance, scalable in N.

    1-D columns (the ARD default) are exact at O(N log N): after sorting,
    the smallest nonzero pairwise |Δ| is the smallest positive consecutive
    gap and the largest is ``max − min``. Multi-column sets (``ARD=False``)
    keep scipy's ``pdist`` up to 4,096 rows and bound it with a
    deterministic subsample beyond that — the O(N²) distance matrix at
    N = 50k is 10 GB of host memory for two numbers whose subsample
    estimate is within the prior's own slack.
    """
    if points.shape[1] == 1:
        v = np.sort(points[:, 0])
        gaps = np.diff(v)
        gaps = gaps[gaps > 0]
        if gaps.size == 0:
            return None, None
        return float(gaps.min()), float(v[-1] - v[0])
    if len(points) > 4096:
        rng = np.random.default_rng(0)
        points = points[rng.choice(len(points), 4096, replace=False)]
    distances = pdist(points)
    distances = distances[distances != 0]
    if distances.size == 0:
        return None, None
    return float(distances.min()), float(distances.max())


def parse_ls_limits(X, *, ARD, lower=None, upper=None):
    """Per-dimension (lower, upper) lengthscale bounds from pairwise distances.

    Defaults: smallest/largest nonzero pairwise distance per dimension (or of
    the full input matrix when ``ARD=False``), floored at 0.01.
    """
    X = np.asarray(X, dtype=float)
    col_sets = [X[:, [j]] for j in range(X.shape[1])] if ARD else [X]

    lowers = listify(lower) if lower is not None else [None]
    uppers = listify(upper) if upper is not None else [None]
    if len(lowers) == 1:
        lowers = lowers * len(col_sets)
    if len(uppers) == 1:
        uppers = uppers * len(col_sets)
    if len(lowers) != len(col_sets) or len(uppers) != len(col_sets):
        raise ValueError("Number of bounds must match number of dimensions")

    out_lo, out_hi = [], []
    for points, lo, hi in zip(col_sets, lowers, uppers):
        d_min, d_max = _distance_extrema(points)
        default_lower = 0.01 if d_min is None else d_min
        default_upper = 1.0 if d_max is None else d_max
        lo = default_lower if lo is None else lo
        lo = max(lo, default_lower, 0.01)
        hi = default_upper if hi is None else hi
        out_lo.append(lo)
        out_hi.append(hi)
    return out_lo, out_hi


def get_ls_prior(X, *, ARD, lower=None, upper=None, mass=0.98):
    """InverseGamma(α, β) lengthscale-prior parameters per dimension.

    Returns ``{'alpha': [...], 'beta': [...]}`` with ``mass`` probability
    between the per-dimension bounds (equal tails), retrying with decreasing
    mass on convergence failure — reference utils/gp_utils.py:51-87 semantics.
    """
    lowers, uppers = parse_ls_limits(X, ARD=ARD, lower=lower, upper=upper)
    alpha, beta = ls_prior_params(lowers, uppers, mass=mass)
    return {"alpha": alpha.tolist(), "beta": beta.tolist()}
