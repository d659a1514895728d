"""Frozen copies of the problem generators the benchmark's traffic draws from.

Copied at commit 47d6025 so that later changes to the port's tools leave
the yardstick alone:

* ``fit_inverse_gamma``, ``ls_prior_params``: ``gumbi_tpu_torch/ops/priors.py``
  (the lengthscale prior is part of the problem handed to the program and
  to the reference alike, so the benchmark computes it itself);
* ``ls_prior_from_subsample``: ``gumbi_tpu_torch/tools/fitc_problem.py``;
* ``bench_truth``: ``chip_smoke.py:819``;
* ``dense_table``: ``gumbi_tpu_torch/tools/fitc_problem.py`` ``make_dense_problem``
  and the coarse subsample of ``chip_smoke.py`` ``run_dense_campaign``;
* ``lmc_table``: ``chip_smoke.py`` ``make_problem`` and ``run_slice``'s
  stage subsamples;
* ``grid_points``: ``run_dense_campaign``'s grid.

One change from the originals: every draw comes from the generator the
caller passes (the run's seed and the job's index), not from seed 0.
"""

from __future__ import annotations

import warnings

import numpy as np
from scipy import optimize as sopt
from scipy import stats as sstats


def fit_inverse_gamma(lower, upper, mass=0.98):
    """InverseGamma(α, β) with ``mass`` between the bounds, equal tails."""
    tail = (1.0 - mass) / 2.0

    def residuals(logab):
        a, b = np.exp(logab)
        dist = sstats.invgamma(a, scale=b)
        return [dist.cdf(lower) - tail, dist.cdf(upper) - (1.0 - tail)]

    x0 = np.log([max(lower, 1e-3), max(upper, 1e-3)])
    sol = sopt.least_squares(residuals, x0, method="lm", xtol=1e-14, ftol=1e-14)
    resid = np.max(np.abs(sol.fun))
    if not sol.success or resid > 1e-6:
        raise ValueError(f"Optimization of parameters failed (residual {resid:.2e} for bounds "
                         f"[{lower}, {upper}], mass {mass})")
    a, b = np.exp(sol.x)
    return float(a), float(b)


def ls_prior_params(lowers, uppers, mass=0.98):
    """Per-dimension InverseGamma (α, β) arrays, relaxing the mass by 0.01
    while the fit fails."""
    alphas, betas = [], []
    for lo, hi in zip(lowers, uppers):
        m = mass
        while True:
            try:
                a, b = fit_inverse_gamma(lo, hi, m)
            except ValueError:
                if m > 0.5:
                    m -= 0.01
                    continue
                raise
            if m != mass:
                warnings.warn(f"lengthscale prior mass relaxed from {mass:.3f} to {m:.3f}")
            break
        alphas.append(a)
        betas.append(b)
    return np.asarray(alphas), np.asarray(betas)


def ls_prior_from_subsample(sub):
    """The benches' lengthscale prior from each dimension's smallest (at
    least 0.01) and largest pairwise distance within ``sub``."""
    lowers, uppers = [], []
    for j in range(sub.shape[1]):
        dd = np.abs(sub[:, j : j + 1] - sub[:, j : j + 1].T)[np.triu_indices(len(sub), 1)]
        dd = dd[dd > 0]
        lowers.append(max(float(dd.min()), 0.01))
        uppers.append(float(dd.max()))
    return ls_prior_params(lowers, uppers)


def bench_truth(X):
    """bench.py's noise-free outputs (f1, f2) at locations X (n, 2)."""
    f1 = np.sin(1.3 * X[:, 0]) * np.cos(0.9 * X[:, 1])
    return f1, 0.7 * f1 + 0.3 * np.cos(1.1 * X[:, 0])


def dense_table(rng, n, coarse_n, prior_rows=512, noise=0.1):
    """bench_dense50k.py's table: X ~ U(−2, 2)^(n×2), y = sin(1.3x₀)cos(0.9x₁)
    + N(0, noise²), the prior from ``prior_rows`` rows, then the sorted
    ``coarse_n``-row subsample of the coarse stage. f32 numpy."""
    X = rng.uniform(-2, 2, size=(n, 2)).astype(np.float32)
    y = (np.sin(1.3 * X[:, 0]) * np.cos(0.9 * X[:, 1]) + rng.normal(0, noise, n)).astype(np.float32)
    la, lb = ls_prior_from_subsample(X[rng.choice(n, min(prior_rows, n), replace=False)])
    sub = np.sort(rng.choice(n, min(coarse_n, n), replace=False))
    return dict(X=X, y=y, la=la, lb=lb, sub=sub)


def lmc_table(rng, n_locs, coarse_n, mid_n, prior_rows=512, noise=(0.1, 0.15)):
    """bench.py's table: locations X ~ U(−2, 2)^(n×2), outputs
    Y = (f1 + N(0, 0.1²), f2 + N(0, 0.15²)), the prior from ``prior_rows``
    locations, then the sorted coarse and mid stage subsamples. f32 numpy."""
    X = rng.uniform(-2, 2, size=(n_locs, 2)).astype(np.float32)
    f1, f2 = bench_truth(X)
    Y = np.stack([f1 + rng.normal(0, noise[0], n_locs), f2 + rng.normal(0, noise[1], n_locs)],
                 axis=1).astype(np.float32)
    la, lb = ls_prior_from_subsample(X[rng.choice(n_locs, min(prior_rows, n_locs), replace=False)])
    sub_c = np.sort(rng.choice(n_locs, min(coarse_n, n_locs), replace=False))
    sub_m = np.sort(rng.choice(n_locs, min(mid_n, n_locs), replace=False))
    return dict(X=X, Y=Y, la=la, lb=lb, sub_c=sub_c, sub_m=sub_m)


def grid_points(m, lo=(-2.0, -2.0), hi=(2.0, 2.0)):
    """The m×m grid over the box [lo, hi], row-major as ``run_dense_campaign``
    builds it (f32 numpy, (m², 2))."""
    g1 = np.linspace(lo[0], hi[0], m).astype(np.float32)
    g2 = np.linspace(lo[1], hi[1], m).astype(np.float32)
    G1, G2 = np.meshgrid(g1, g2, indexing="ij")
    return np.column_stack([G1.ravel(), G2.ravel()])
