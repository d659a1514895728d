"""Print the sparse and Laplace objectives at f32 and at f64 on one CUDA card.

    python3 -m gumbi_tpu_torch.tools.probe_laplace_precision [--n 50000] [--dense-n 2048] [--n-u 512]

At the 8 ``initial_params`` starts of ``chip_smoke.py`` phases 9-11 (the
problem of ``benchmarks/bench_fitc50k.py``: N rows, 512 k-means inducing
points; the dense classifier on ``--dense-n`` rows) it evaluates
``fitc_neg_logp``, ``fitc_laplace_neg_logp`` and ``laplace_neg_logp`` three
ways: all at f32 (the hand ``rbf_gram``), all at f64, and with the Grams at
f32 but everything after them at f64 ("mixed": each Gram computed by the
f32 kernel, then cast). It prints the per-point gap of each to f64, so the
f32 rounding of the Grams and of the algebra after them can be told apart.
Value only; no fit. Then, at the sparse classifier's fit on the card
(``LATENT_AT``), the smallest eigenvalue of its latent covariance on the
200-point line at f32 and f64, formed as the reference forms it (G = P −
P M⁻¹ P) and as the port does (G = I − M⁻¹), and whether the draws'
factor succeeds with the reference's 1e-6 floor and with the port's.
``--device cpu`` rehearses it at small sizes.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import torch

from gumbi_tpu_torch.ops import fitc_laplace, kernels
from gumbi_tpu_torch.ops import fitc_laplace_neg_logp, fitc_neg_logp, initial_params, laplace_neg_logp
from gumbi_tpu_torch.tools.fitc_problem import FITC_N, FITC_NU, fitc_spec, make_fitc_problem, problem_at

DENSE_N = 2048  # chip_smoke.py phase 11's campaign size


@contextlib.contextmanager
def f32_grams():
    """Every Gram term computed at f32 (the hand ``rbf_gram`` on CUDA) and
    returned at f64: ``kernels.gram`` looks its term builder up at call time,
    so this one swap reaches every ``gram`` of the three objectives."""
    orig = kernels._term_cont

    def term32(spec, term, params, xc1, xc2):
        p32 = {k: v.float() for k, v in params.items()}
        return orig(spec, term, p32, xc1.float(), xc2.float()).double()

    kernels._term_cont = term32
    try:
        yield
    finally:
        kernels._term_cont = orig


# chip_smoke.py phase 10's fitted point on one H100 at f32: ls and η
LATENT_AT = {"ls_total": [1.183519721031189, 1.2024213075637817], "η_total": 7.4971}


def latent_covariance(p, dtype):
    """The sparse classifier's latent covariance on the line, both forms, at
    ``LATENT_AT``: (reference form, port form, prior variances)."""
    spec = fitc_spec("bernoulli")
    q = problem_at(p, dtype)
    params = {k: torch.as_tensor(v, dtype=dtype, device=q["xc"].device) for k, v in LATENT_AT.items()}
    args = (spec, params, q["xc"], q["xk"], q["xu_c"], q["xu_k"], q["yb"], q["line"], q["line_k"])
    _, Phi_s, S = fitc_laplace._test_features(*args, 1e-6, 30, None)
    Phi, D, _ = fitc_laplace._whitened_features(*args[:6], 1e-6)
    _, _, (_, P, Lm) = fitc_laplace.fitc_laplace_mode(Phi, D, q["yb"])
    Kss = kernels.gram(spec, params, q["line"], q["line_k"], q["line"], q["line_k"])
    G = P - P @ fitc_laplace.cho_solve(Lm, P)
    prior = kernels.gram_diag(spec, params, q["line"], q["line_k"])
    return Kss - (Phi_s @ G) @ Phi_s.T, Kss - Phi_s @ Phi_s.T + S.T @ S, prior


def _prior(p):
    """The lengthscale prior's (alpha, beta) at the problem's dtype and device."""
    return (torch.as_tensor(p[k], dtype=p["xc"].dtype, device=p["xc"].device) for k in ("la", "lb"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=FITC_N)
    ap.add_argument("--dense-n", type=int, default=DENSE_N)
    ap.add_argument("--n-u", type=int, default=FITC_NU)
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal at small sizes, no device numbers")
    args = ap.parse_args()
    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        sys.exit("probe_laplace_precision: needs a CUDA card")
    prob = make_fitc_problem(args.n, dev, torch.float64, n_u=args.n_u)
    dense = make_fitc_problem(args.dense_n, dev, torch.float64, seed=1, kmeans=False)
    cases = (
        ("fitc", prob, "gaussian", lambda s, u, p: fitc_neg_logp(
            s, u, p["xc"], p["xk"], p["xu_c"], p["xu_k"], p["y"], *_prior(p))),
        ("fitc_laplace", prob, "bernoulli", lambda s, u, p: fitc_laplace_neg_logp(
            s, u, p["xc"], p["xk"], p["xu_c"], p["xu_k"], p["yb"], *_prior(p))),
        ("laplace", dense, "bernoulli", lambda s, u, p: laplace_neg_logp(
            s, u, p["xc"], p["xk"], p["yb"], *_prior(p))),
    )
    for name, p, lik, fn in cases:
        spec = fitc_spec(lik)
        u0s = initial_params(spec, p["la"], p["lb"], n_restarts=8, seed=0, dtype=torch.float64, device=dev)
        p32 = problem_at(p, torch.float32)
        n = p["xc"].shape[0]
        for r in range(8):
            u = {k: v[r] for k, v in u0s.items()}
            with torch.no_grad():
                v64 = float(fn(spec, u, p))
                v32 = float(fn(spec, {k: v.float() for k, v in u.items()}, p32))
                with f32_grams():
                    vmix = float(fn(spec, u, p))
            ls = torch.exp(u["ls_total"]).tolist()
            eta2 = float(torch.exp(2 * u["η_total"]))
            print(f"[precision] {name} N={n} start {r} ls {[round(x, 3) for x in ls]} eta2 {eta2:.3f}: f64 {v64:.6f} | "
                  f"f32 {v32:.6f} ({abs(v32 - v64) / n:.3e} /pt) | mixed {vmix:.6f} ({abs(vmix - v64) / n:.3e} /pt)",
                  flush=True)
    with torch.no_grad():
        for dtype in (torch.float64, torch.float32):
            ref, port, prior = latent_covariance(prob, dtype)
            m = ref.shape[0]
            floors = {"1e-6": 1e-6, "port": max(1e-6, m * torch.finfo(dtype).eps * float(prior.mean()))}
            parts = []
            for label, cov in (("reference form", ref), ("port form", port)):
                low = float(torch.linalg.eigvalsh(cov.double()).min())
                ok = {f: bool(torch.linalg.cholesky_ex(cov + v * torch.eye(m, dtype=dtype, device=dev))[1] == 0)
                      for f, v in floors.items()}
                parts.append(f"{label}: min eigenvalue {low:.3e}, factor with floor 1e-6 {ok['1e-6']}, with the "
                             f"port's {floors['port']:.2e} {ok['port']}")
            print(f"[precision] latent covariance at {LATENT_AT} on the line, {str(dtype)[6:]}: " + " | ".join(parts),
                  flush=True)


if __name__ == "__main__":
    main()
