"""Run the reference's f32 factorizations of the BO and ESS paths on one CUDA card.

    python3 -m gumbi_tpu_torch.tools.probe_sampler_precision [--device cuda] [--bo-n 512] [--ess-n 2048]

At the inputs of ``chip_smoke.py`` phases 12 and 14 it forms, at f32, the
matrices the reference factors with a bare 1e-6 jitter and factors each
both ways: with the reference's jitter and with the port's floor.

* BO (phase 12a): ``fit_gp_map`` (8 restarts) on ``make_dense_problem`` at
  ``--bo-n`` rows, then the noise-free joint posterior covariance of each of
  the 512 raw q-batches (q = 4 Sobol candidates + 64 training rows, as
  ``GP.propose`` builds them): as the reference's ``_joint_samples`` forms
  it (Kss − VᵀV at the model dtype) and as the port does (VᵀV and the
  subtraction in f64), each factored with the 1e-6 jitter.
  Then ``optimize_qlog_nei`` at f32 at ``GP.propose``'s defaults (10
  restarts, 256 Sobol normals, maxiter 100) and, at its candidate, qLogNEI
  at f32 against f64 with one piece of the joint posterior at a time taken
  at the other precision: the mean's product Ks·α accumulated in f32 (the
  reference's form), then α, the triangular solve, the training factor L
  and the cross-Gram Ks in f64.
* ESS (phase 14): ``fit_laplace_map`` (8 restarts, maxiter 60) on
  ``make_fitc_problem(--ess-n, seed=1)``'s labels, then the prior K + 1e-6·I
  at the fit (reference ``_chol_K``; ``latent_conditional_proba`` factors the
  same matrix per draw).

For each it prints how many factors are NaN with the reference's jitter and
with the port's floor (the ESS prior's), and the smallest eigenvalue of the
matrix (f64 ``eigvalsh``), at f32 and at f64.
``--device cpu --bo-n 128 --ess-n 300`` rehearses it here.
"""

from __future__ import annotations

import argparse
import contextlib
import math

import numpy as np
import torch

from gumbi_tpu_torch.ops import acquisition, ess, linalg
from gumbi_tpu_torch.ops import constrain, fit_gp_map, fit_laplace_map, gram, initial_params, posterior_cache
from gumbi_tpu_torch.tools.fitc_problem import fitc_spec, make_dense_problem, make_fitc_problem, problem_at

JITTER = 1e-6


def _report(label, mats, floor_fn):
    """NaN factors of ``mats`` (B, P, P) with the reference's jitter and with
    ``floor_fn(mats)`` (B,), and the smallest eigenvalue of each (f64 eigvalsh)."""
    eye = torch.eye(mats.shape[-1], dtype=mats.dtype, device=mats.device)
    ref_nan = int(torch.isnan(linalg.cholesky_nan(mats + JITTER * eye)).flatten(1).any(1).sum())
    floor = floor_fn(mats)
    port_nan = int(torch.isnan(linalg.cholesky_nan(mats + floor[:, None, None] * eye)).flatten(1).any(1).sum())
    eig = torch.linalg.eigvalsh(mats.double()).min(-1).values
    print(f"[probe] {label}: {mats.shape[0]} matrices of {mats.shape[-1]}² at {mats.dtype} | NaN factors: reference "
          f"(jitter {JITTER:g}) {ref_nan}, port (floor {float(floor.min()):.3e}-{float(floor.max()):.3e}) {port_nan} | "
          f"smallest eigenvalue {float(eig.min()):.3e} to {float(eig.max()):.3e}", flush=True)
    return ref_nan, port_nan


def probe_bo(n, device):
    spec, X, y, la, lb, _ = make_dense_problem(n, np.float32)
    xk = np.zeros((n, 0), dtype=np.int64)
    u0s = initial_params(spec, la, lb, n_restarts=8, seed=0, dtype=torch.float32, device=device)
    params, _, _ = fit_gp_map(spec, X, xk, y, la, lb, u0s, device=device)
    print(f"[probe] BO fit at N={n}: { {k: v.tolist() for k, v in params.items()} }", flush=True)
    base = X[np.random.default_rng(0).choice(n, 64, replace=False)]
    lo, hi = X.min(0), X.max(0)
    raw = acquisition.sobol_uniform(512 * 4, 2, seed=0).reshape(512, 4, 2) * (hi - lo) + lo
    zk = torch.zeros((512 * 68, 0), dtype=torch.long, device=device)
    for dtype in (torch.float32, torch.float64):
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
        p = {k: v.to(dtype) for k, v in params.items()}
        with torch.no_grad():
            cache = posterior_cache(spec, p, t(X), zk[:n], t(y))
            joint = torch.cat([t(raw), t(base).expand(512, 64, 2)], dim=1)
            # the reference's form: Kss − VᵀV at the model dtype
            pts = joint.reshape(-1, 2)
            V = torch.linalg.solve_triangular(cache.L, gram(spec, p, pts, zk, cache.xc, cache.xk).T, upper=False)
            V = V.reshape(n, 512, 68)
            Kss = torch.stack([gram(spec, p, b, zk[:68], b, zk[:68]) for b in joint])
            ref_cov = Kss - torch.einsum("nbi,nbj->bij", V, V)
            # the port's: the same with VᵀV and the subtraction in f64
            _, cov, _ = acquisition._joint_mean_cov(spec, p, cache, joint, zk.reshape(512, 68, 0))
        jit = lambda m: torch.full(m.shape[:1], JITTER, dtype=m.dtype, device=device)  # noqa: E731
        _report(f"BO joint covariance (q 4 + baseline 64), N={n}, reference form", ref_cov, jit)
        _report(f"BO joint covariance (q 4 + baseline 64), N={n}, port form (f64 cancellation)", cov, jit)
    probe_bo_candidate(spec, X, y, params, base, device)


@contextlib.contextmanager
def _mixed_joint_mean_cov(states, f64_parts, prod32):
    """``acquisition._joint_mean_cov`` with the pieces named in ``f64_parts``
    ("alpha", "solve", "L", "Ks") taken from the f64 state, the solve in f64
    for "solve" or "L", and with ``prod32`` the product Ks·α accumulated in
    f32; Kss, VᵀV and the subtraction in f64 as in the port."""
    (p32, c32), (p64, c64) = states[torch.float32], states[torch.float64]
    orig = acquisition._joint_mean_cov

    def mixed(spec, params, cache, xc, xk):
        lead, (P, d), k = xc.shape[:-2], xc.shape[-2:], xk.shape[-1]
        B = math.prod(lead)
        xcf, xkf = xc.reshape(B * P, d), xk.reshape(B * P, k)
        if "Ks" in f64_parts:
            Ks = gram(spec, p64, xcf.double(), xkf, c64.xc, c64.xk)
        else:
            Ks = gram(spec, p32, xcf.float(), xkf, c32.xc, c32.xk)
        alpha = c64.alpha if "alpha" in f64_parts else c32.alpha
        mean = (Ks.float() @ alpha.float()).double() if prod32 else Ks.double() @ alpha.double()
        if "L" in f64_parts or "solve" in f64_parts or "Ks" in f64_parts:
            L = c64.L if "L" in f64_parts else c32.L.double()
            V = torch.linalg.solve_triangular(L, Ks.double().T, upper=False)
        else:
            V = torch.linalg.solve_triangular(c32.L, Ks.T, upper=False).double()
        V = V.reshape(-1, B, P)
        x64 = xcf.double()
        Kss = gram(spec, p64, x64, xkf, x64, xkf).reshape(B, P, B, P).diagonal(dim1=0, dim2=2).permute(2, 0, 1)
        cov = Kss - torch.einsum("nbi,nbj->bij", V, V)
        prior = acquisition.gram_diag(spec, p64, x64, xkf)
        return mean.reshape(*lead, P), cov.reshape(*lead, P, P), prior.reshape(*lead, P)

    acquisition._joint_mean_cov = mixed
    try:
        yield
    finally:
        acquisition._joint_mean_cov = orig


def probe_bo_candidate(spec, X, y, params, base, device):
    """qLogNEI at f32 against f64 at the f32 optimum, piece by piece."""
    n = X.shape[0]
    zk = lambda m: torch.zeros((m, 0), dtype=torch.long, device=device)  # noqa: E731
    states, args = {}, {}
    for dtype in (torch.float32, torch.float64):
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
        p = {k: v.to(dtype) for k, v in params.items()}
        with torch.no_grad():
            states[dtype] = (p, posterior_cache(spec, p, t(X), zk(n), t(y)))
        args[dtype] = (zk(4), t(base), zk(64), t(acquisition.sobol_normal(256, 68, seed=0)))
    lo, hi = (torch.as_tensor(v, dtype=torch.float32, device=device) for v in (X.min(0), X.max(0)))
    raw = torch.as_tensor(acquisition.sobol_uniform(512 * 4, 2, seed=0).reshape(512, 4, 2), dtype=torch.float32,
                          device=device) * (hi - lo) + lo
    x, _ = acquisition.optimize_qlog_nei(spec, *states[torch.float32], *args[torch.float32], raw, lo, hi)

    def value(dtype):
        with torch.no_grad():
            return float(acquisition.qlog_nei(spec, *states[dtype], x.to(dtype), *args[dtype]))

    v64 = value(torch.float64)
    print(f"[probe] qLogNEI at the f32 optimum (q 4, N={n}): f64 {v64:.6f} | f32 as shipped |diff| "
          f"{abs(value(torch.float32) - v64):.3e}", flush=True)
    for f64_parts, prod32 in (((), True), (("alpha",), True), (("alpha",), False), (("alpha", "solve"), False),
                              (("alpha", "L"), False), (("alpha", "L", "Ks"), False)):
        with _mixed_joint_mean_cov(states, f64_parts, prod32):
            v = value(torch.float32)
        print(f"[probe]   product Ks·alpha in {'f32' if prod32 else 'f64'} | from the f64 state: "
              f"{', '.join(f64_parts) or 'none'} |diff| {abs(v - v64):.3e}", flush=True)


def probe_ess(n, device):
    p = make_fitc_problem(n, device, torch.float32, seed=1, kmeans=False)
    spec = fitc_spec("bernoulli")
    u0s = initial_params(spec, p["la"], p["lb"], n_restarts=8, seed=0, dtype=torch.float32, device=device)
    u, _, _ = fit_laplace_map(spec, p["xc"], p["xk"], p["yb"], p["la"], p["lb"], u0s, maxiter=60, device=device)
    params = constrain(u)
    print(f"[probe] ESS start (the Laplace fit) at N={n}: { {k: v.tolist() for k, v in params.items()} }", flush=True)
    for dtype in (torch.float32, torch.float64):
        q = problem_at(p, dtype)
        with torch.no_grad():
            K = gram(spec, {k: v.to(dtype) for k, v in params.items()}, q["xc"], q["xk"], q["xc"], q["xk"])
        eps = torch.finfo(dtype).eps
        _report(f"ESS prior K (reference _chol_K), N={n}", K[None],
                lambda m: torch.clamp(n * eps * torch.diagonal(m, dim1=-2, dim2=-1).mean(-1), min=JITTER))
    # the floor the port uses, as the sampler forms it
    Lp = ess._chol_K(spec, {k: v[None] for k, v in u.items()}, p["xc"], p["xk"], JITTER)
    print(f"[probe] port _chol_K at f32 finite: {bool(torch.isfinite(Lp).all())}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bo-n", type=int, default=512)
    ap.add_argument("--ess-n", type=int, default=2048)
    a = ap.parse_args()
    probe_bo(a.bo_n, a.device)
    probe_ess(a.ess_n, a.device)


if __name__ == "__main__":
    main()
