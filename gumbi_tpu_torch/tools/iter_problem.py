"""The problem of ``benchmarks/bench_iterative50k.py``, rebuilt with numpy,
and the exact dense posterior that the iterative engine is held against.

Shared by ``chip_smoke.py`` (phases 5-6 and 17) and the port's tests: the
same seed gives the same rows on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import gram, gram_diag, log_prior, noise_diag, unconstrain
from ..ops.mll import DEFAULT_JITTER


def make_iter_data(n, seed=0):
    """bench_iterative50k.py's make_data: same seed, same draws."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(n, 2)).astype(np.float32)
    y = (np.sin(1.3 * X[:, 0]) * np.cos(0.9 * X[:, 1]) + rng.normal(0, 0.1, n)).astype(np.float32)
    return X, y


@torch.no_grad()
def exact_f64_posterior(spec, params, xc, xk, y, ls_alpha, ls_beta, xs, xks, row_block=2048):
    """The dense Cholesky MAP objective (``map_neg_logp``'s value) at
    ``params`` and the exact posterior mean and latent variance at ``xs``,
    all in f64 on the plain path. The Gram is assembled in row blocks into
    one N×N buffer and the noise added on its diagonal in place, so the peak
    is the Gram and its factor (``map_neg_logp`` itself would also hold the
    distance temporaries and a dense diagonal: ~4 N×N arrays). Returns
    ``(value, mean, var, alpha)``, α = A⁻¹y."""
    p64 = {k: v.double() for k, v in params.items()}
    x64, y64, xs64 = xc.double(), y.double(), xs.double()
    n = x64.shape[0]
    A = torch.empty((n, n), dtype=torch.float64, device=x64.device)
    for s in range(0, n, row_block):
        A[s : s + row_block] = gram(spec, p64, x64[s : s + row_block], xk[s : s + row_block], x64, xk)
    A.diagonal().add_(noise_diag(spec, p64, xk, dtype=torch.float64) + DEFAULT_JITTER)
    L = torch.linalg.cholesky(A)
    del A
    z = torch.linalg.solve_triangular(L, y64[:, None], upper=False)
    mll = -0.5 * ((z * z).sum() + 2.0 * torch.log(torch.diagonal(L)).sum() + n * np.log(2.0 * np.pi))
    la, lb = (torch.as_tensor(a, dtype=torch.float64, device=x64.device) for a in (ls_alpha, ls_beta))
    f = -(mll + log_prior(spec, unconstrain(p64), la, lb))
    W = torch.linalg.solve_triangular(L, gram(spec, p64, x64, xk, xs64, xks), upper=False)  # (N, m)
    alpha = torch.linalg.solve_triangular(L.T, z, upper=True)[:, 0]
    del L
    mean = W.T @ z[:, 0]
    var = gram_diag(spec, p64, xs64, xks) - (W * W).sum(0)
    return float(f), mean, var, alpha
