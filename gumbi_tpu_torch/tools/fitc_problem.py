"""The problems of ``benchmarks/bench_fitc50k.py`` and
``benchmarks/bench_dense50k.py``, rebuilt with numpy.

Shared by ``chip_smoke.py`` (phases 8-14), ``probe_laplace_precision.py``,
``probe_sampler_precision.py`` and the port's tests: the same seed gives the
same rows, labels, inducing points and lengthscale prior on any device and
at any dtype.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import GPSpec, GPTerm, kmeans_inducing, ls_prior_params

FITC_N, FITC_NU, FITC_KMEANS_ROWS, FITC_KMEANS_ITERS = 50_000, 512, 8192, 10
FITC_LINE = 200  # bench_fitc50k.py's predict line


def ls_prior_from_subsample(sub):
    """The benches' lengthscale prior: ``ls_prior_params`` of each dimension's
    smallest (at least 0.01) and largest pairwise distance within ``sub``."""
    lowers, uppers = [], []
    for j in range(sub.shape[1]):
        dd = np.abs(sub[:, j : j + 1] - sub[:, j : j + 1].T)[np.triu_indices(len(sub), 1)]
        dd = dd[dd > 0]
        lowers.append(max(float(dd.min()), 0.01))
        uppers.append(float(dd.max()))
    return ls_prior_params(lowers, uppers)


def fitc_spec(likelihood="gaussian"):
    """bench_fitc50k.py's spec: one ExpQuad ARD term over 2 dims."""
    return GPSpec(terms=(GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2, ard=True, likelihood=likelihood)


def make_fitc_problem(n, device, dtype, seed=0, n_u=FITC_NU, kmeans_rows=FITC_KMEANS_ROWS, kmeans=True):
    """bench_fitc50k.py's problem from ``default_rng(seed)`` in the bench's
    order: X ~ U(−2, 2)^(n×2), y = sin(1.3·x₀)·cos(0.9·x₁) + N(0, 0.1), the
    k-means rows (``n_u`` centers, seed 0, 10 iterations; skipped with
    ``kmeans=False``, the draw kept), then the 512-row subsample of the
    lengthscale prior (``la``, ``lb``: numpy). Labels ``yb`` = 1[y > 0] for the
    classifiers; the line is the bench's 200 points (x₀ from −2 to 2, x₁ = 0)."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(n, 2)).astype(np_dtype)
    y = (np.sin(1.3 * X[:, 0]) * np.cos(0.9 * X[:, 1]) + rng.normal(0, 0.1, n)).astype(np_dtype)
    rows = X[rng.choice(n, min(kmeans_rows, n), replace=False)]
    t0 = time.perf_counter()
    Xu = kmeans_inducing(rows, n_u, seed=0, n_iter=FITC_KMEANS_ITERS) if kmeans else np.zeros((0, 2))
    kmeans_s = time.perf_counter() - t0
    la, lb = ls_prior_from_subsample(X[rng.choice(n, min(512, n), replace=False)])
    g = np.linspace(-2, 2, FITC_LINE).astype(np_dtype)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    zeros = lambda k: torch.zeros((k, 0), dtype=torch.long, device=device)  # noqa: E731
    return dict(xc=t(X), xk=zeros(n), y=t(y), yb=t((y > 0).astype(np_dtype)), xu_c=t(Xu), xu_k=zeros(len(Xu)),
                la=la, lb=lb, line=t(np.column_stack([g, np.zeros_like(g)])), line_k=zeros(FITC_LINE),
                g=g, kmeans_s=kmeans_s)


def make_dense_problem(n, np_dtype):
    """bench_dense50k.py's problem, rebuilt with numpy: same seed, same draws
    in the same order. Returns the generator too: the coarse subsample is
    its next draw."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, size=(n, 2)).astype(np_dtype)
    y = (np.sin(1.3 * X[:, 0]) * np.cos(0.9 * X[:, 1]) + rng.normal(0, 0.1, n)).astype(np_dtype)
    spec = GPSpec(terms=(GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2, ard=True)
    sub = X[rng.choice(n, min(512, n), replace=False)]
    la, lb = ls_prior_from_subsample(sub)
    return spec, X, y, la, lb, rng


def problem_at(p, dtype):
    """The problem's tensors cast to ``dtype`` (level indices untouched)."""
    return {k: (v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point() else v) for k, v in p.items()}
