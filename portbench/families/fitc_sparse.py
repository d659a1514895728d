"""Sparse FITC regressor jobs through the port's public ops (configuration
``fitc50k``).

Each job is a frozen copy of ``chip_smoke.py`` ``run_fitc_campaign``
(commit 176c56d), bench_fitc50k.py's single-device run, with the bench's
k-means step in front of it:

* ``inducing``: ``fitc.select_inducing`` on the table's ``kmeans_rows``
  rows, which are on the device, for ``inducing`` centres (seed 0,
  ``kmeans_iters`` Lloyd iterations), which come back on the device;
* ``coarse``: ``restarts`` L-BFGS restarts of ``fitc.fitc_neg_logp`` from
  ``initial_params`` (seed 0), one after another
  (``optimize.multi_restart_minimize``, whose runner calls
  ``optimize.lbfgs_backtracking_minimize``). It is the bench's only fit
  stage and runs at full N; it is named ``coarse`` so that the stage
  readers of the other job cells read it;
* ``predict``: ``fitc.fitc_predict`` (noise included) on the ``line``-point
  line x₀ from −2 to 2, x₁ = 0.

The copy takes its tables from the traffic, counts value+grad and
value-only evaluations, and ends each stage with a device sync inside a
span. It calls the port's functions through their modules, so that a check
can plant a fault beneath them. A job returns the port's centres (``z``)
beside its answer. The reference's inducing inputs come from the
reference's own Lloyd (``reference/fitc_sparse.py`` ``centres``) on the
same rows, never from the port's, and only for the tables a check judges.

Operation counts are of work the inputs need, from shapes, at N rows, M
inducing inputs and d dims; nothing is measured. A value is the Grams
(M² and M·N entries of 3d + 2 operations), the two M³/3 factors (K_uu's
and B's), M²·N for the triangular solve A = L_uu⁻¹K_ux and M²·N for
A·Λ⁻¹·Aᵀ. A value+grad is taken as three values (an assumption, not a
count of the backward). The prediction is a value's work, the cross-Gram
and two M²·M* solves. The host's k-means is left out.
"""

from __future__ import annotations

import collections
import importlib

import numpy as np
import torch

from ..harness import frozen

REFERENCE = "fitc_sparse"
STAGES = ("inducing", "coarse", "predict")
D = 2


def half_rows(orig):
    """``fitc_neg_logp`` over every other row of the data, doubled (the
    inducing inputs kept)."""
    def fitc_neg_logp(spec, u, xc, xk, xu_c, xu_k, y, *args, **kwargs):
        return 2.0 * orig(spec, u, xc[::2], xk[::2], xu_c, xu_k, y[::2], *args, **kwargs)

    return fitc_neg_logp


# Where harness/faults.py plants its faults beneath this family's timed path.
FAULT_SITES = dict(objectives=(("gumbi_tpu_torch.ops.fitc", "fitc_neg_logp", half_rows),),
                   predictors=(("gumbi_tpu_torch.ops.fitc", "fitc_predict"),))
# The configuration's sizes that the CPU tests shrink; iterations stay as
# the configuration states them, so that fits converge as at full size.
TINY = dict(rows=600, inducing=24, kmeans_rows=200, prior_rows=96, line=24)


def gram_flops(n, m, d=D):
    return n * m * (3.0 * d + 2.0)


def value_flops(n, m):
    return gram_flops(m, m) + gram_flops(m, n) + 2.0 * m**3 / 3.0 + 2.0 * m * m * n


def predict_flops(n, m, ms):
    return value_flops(n, m) + gram_flops(m, ms) + 2.0 * m * m * ms


def job_flops(cfg, evals):
    n, m = cfg["rows"], cfg["inducing"]
    total = sum(c * value_flops(n, m) * (3.0 if k.endswith(".vg") else 1.0) for k, c in evals.items())
    return total + predict_flops(n, m, cfg["line"])


def fitc_table(rng, n, kmeans_rows, prior_rows=512, noise=0.1):
    """bench_fitc50k.py's table, in the bench's order of draws: X ~
    U(−2, 2)^(n×2), y = sin(1.3x₀)cos(0.9x₁) + N(0, noise²), the indices of
    the k-means rows, then the prior from ``prior_rows`` rows. f32 numpy."""
    X = rng.uniform(-2, 2, size=(n, 2)).astype(np.float32)
    y = (np.sin(1.3 * X[:, 0]) * np.cos(0.9 * X[:, 1]) + rng.normal(0, noise, n)).astype(np.float32)
    km = rng.choice(n, min(kmeans_rows, n), replace=False)
    la, lb = frozen.ls_prior_from_subsample(X[rng.choice(n, min(prior_rows, n), replace=False)])
    return dict(X=X, y=y, km=km, la=la, lb=lb)


def spec():
    from gumbi_tpu_torch.ops import GPSpec, GPTerm

    return GPSpec(terms=(GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=D, ard=True)


def prepare(cfg, device, dtype=torch.float32):
    """The job-independent state: spec, placement, the prediction line."""
    g = np.linspace(-2, 2, cfg["line"]).astype(np.float32)
    line = np.column_stack([g, np.zeros_like(g)])
    return dict(cfg=cfg, spec=spec(), device=device, dtype=dtype, line_np=line,
                line=torch.as_tensor(line, dtype=dtype, device=device),
                line_k=torch.zeros((cfg["line"], 0), dtype=torch.long, device=device))


def make_table(state, rng):
    """One table drawn from ``rng``: the benchmark's inputs (numpy, handed
    to the reference with the k-means rows and the k-means' (centres,
    iterations, seed), from which it makes its own inducing inputs) and
    their tensors with the port's starting points."""
    from gumbi_tpu_torch.ops import initial_params

    cfg, device, dtype = state["cfg"], state["device"], state["dtype"]
    tab = fitc_table(rng, cfg["rows"], cfg["kmeans_rows"], cfg["prior_rows"], cfg["noise"])
    kmeans = np.array([cfg["inducing"], cfg["kmeans_iters"], cfg["kmeans_seed"]], dtype=np.float64)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    xc, y = t(tab["X"]), t(tab["y"])
    xk = torch.zeros((cfg["rows"], 0), dtype=torch.long, device=device)
    km = torch.as_tensor(tab["km"], device=device)
    u0s = initial_params(state["spec"], tab["la"], tab["lb"], n_restarts=cfg["restarts"], seed=0, dtype=dtype,
                         device=device)
    ref = dict(X=tab["X"], km_rows=tab["X"][tab["km"]], kmeans=kmeans, y=tab["y"], la=tab["la"], lb=tab["lb"])
    return dict(ref=ref, xc=xc, xk=xk, y=y,
                la=t(tab["la"]), lb=t(tab["lb"]), xc_km=xc[km], xk_km=xk[km], u0s=u0s)


def _fitc():
    return importlib.import_module("gumbi_tpu_torch.ops.fitc")


def inducing(state, tab, n_rows=None):
    """The port's k-means centres over the table's k-means rows (the first
    ``n_rows`` of them if given), on the device."""
    cfg = state["cfg"]
    return _fitc().select_inducing(tab["xc_km"][:n_rows], tab["xk_km"][:n_rows], cfg["inducing"], D,
                                   seed=cfg["kmeans_seed"], dtype=state["dtype"], device=state["device"],
                                   n_iter=cfg["kmeans_iters"])


def _objective(state, tab, xu, evals):
    fitc = _fitc()

    def objective(u):
        evals[f"coarse.{'vg' if torch.is_grad_enabled() else 'v'}"] += 1
        return fitc.fitc_neg_logp(state["spec"], u, tab["xc"], tab["xk"], *xu, tab["y"], tab["la"], tab["lb"])

    return objective


def predict(state, tab, xu, params):
    return _fitc().fitc_predict(state["spec"], params, tab["xc"], tab["xk"], *xu, tab["y"], state["line"],
                                state["line_k"])


def run_job(state, tab, spans):
    """One fit-to-prediction job; returns its outputs (on the host) and counts."""
    from gumbi_tpu_torch.ops import constrain, optimize

    cfg, evals = state["cfg"], collections.Counter()
    with spans("inducing"):
        xu = inducing(state, tab)
    with spans("coarse"):
        u_best, f_best, _ = optimize.multi_restart_minimize(_objective(state, tab, xu, evals), tab["u0s"],
                                                            maxiter=cfg["maxiter"], tol=cfg["ftol"])
    params = constrain(u_best)
    with torch.no_grad(), spans("predict"):
        mean, var = predict(state, tab, xu, params)
        mean, var = mean.cpu().numpy(), var.cpu().numpy()
    return dict(u={k: v.detach().cpu().numpy() for k, v in u_best.items()}, f=float(f_best), mean=mean, var=var,
                grid=state["line_np"], z=xu[0].cpu().numpy(), evals=dict(evals), flops=job_flops(cfg, evals))


def warm(state, tab):
    """The k-means on twice as many rows as centres (an eighth of its work at
    the configuration's sizes), one value+grad and one value at full N and
    one line prediction: every step a job runs, and no whole job."""
    from gumbi_tpu_torch.ops import constrain

    xu = inducing(state, tab, 2 * state["cfg"]["inducing"])
    u = {k: v[0] for k, v in tab["u0s"].items()}
    f = _objective(state, tab, xu, collections.Counter())
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in u.items()}
    torch.autograd.grad(f(leaves), list(leaves.values()))
    with torch.no_grad():
        f(u)
        mean, _ = predict(state, tab, xu, constrain(u))
        mean.cpu()
