"""Exact dense GP jobs through the port's public ops (configuration ``se2``).

The stage driver is a frozen copy of ``chip_smoke.py`` ``run_dense_campaign``
(commit 47d6025), bench_dense50k.py's single-device run: ``restarts``
L-BFGS restarts of ``map_neg_logp`` on the coarse subsample, one after
another (``multi_restart_minimize``), a full-N polish from the coarse
winner (``lbfgs_backtracking_minimize``), ``posterior_cache``, then
``predict_diag_chunked`` on the grid. The copy takes its tables from the
traffic, counts value+grad and value-only evaluations by stage, and ends
each stage with a device sync inside a span. It calls the port's functions
through their modules, so that a check can plant a fault beneath them.

Operation counts are of work the inputs need, from shapes: a value at n
rows is the n³/3 factor plus the Gram; a value+grad adds the 2n³/3 inverse
and the Gram's backward; the O(n²) solves are left out.
"""

from __future__ import annotations

import collections
import importlib

import torch

from ..harness import faults, frozen

REFERENCE = "dense_exact"
STAGES = ("coarse", "polish", "cache", "predict")
# Where harness/faults.py plants its faults beneath this family's timed path.
FAULT_SITES = dict(objectives=(("gumbi_tpu_torch.ops.mll", "map_neg_logp", faults.half_rows),),
                   predictors=(("gumbi_tpu_torch.ops.posterior", "predict_diag_chunked"),))
# The configuration's sizes that the CPU tests shrink; iterations stay as
# the configuration states them, so that fits converge as at full size.
TINY = dict(rows=384, coarse_rows=96, prior_rows=96, grid=12, chunk=96)


def gram_flops(n, m, d=2):
    return n * m * (3.0 * d + 2.0)


def eval_flops(n, grad):
    return n**3 + 2.0 * gram_flops(n, n) if grad else n**3 / 3.0 + gram_flops(n, n)


def predict_flops(n, m):
    """Cross-Gram, the n²·m triangular solve, the mean and the variance."""
    return gram_flops(n, m) + n * n * m + 4.0 * n * m


def cache_flops(n):
    return n**3 / 3.0 + gram_flops(n, n) + 2.0 * n * n


def job_flops(cfg, evals):
    n, nc = cfg["rows"], cfg["coarse_rows"]
    size = {"coarse": nc, "polish": n}
    total = sum(c * eval_flops(size[k.split(".")[0]], k.endswith(".vg")) for k, c in evals.items())
    return total + cache_flops(n) + predict_flops(n, cfg["grid"] ** 2)


def spec():
    from gumbi_tpu_torch.ops import GPSpec, GPTerm

    return GPSpec(terms=(GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2, ard=True)


def prepare(cfg, device, dtype=torch.float32):
    """The job-independent state: spec, placement, grid."""
    g = frozen.grid_points(cfg["grid"])
    return dict(cfg=cfg, spec=spec(), device=device, dtype=dtype, grid_np=g,
                xg=torch.as_tensor(g, dtype=dtype, device=device),
                xkg=torch.zeros((g.shape[0], 0), dtype=torch.long, device=device))


def make_table(state, rng):
    """One table drawn from ``rng``: the benchmark's inputs (numpy, handed
    to the reference too) and their tensors with the port's starting points."""
    from gumbi_tpu_torch.ops import initial_params

    cfg, device, dtype = state["cfg"], state["device"], state["dtype"]
    tab = frozen.dense_table(rng, cfg["rows"], cfg["coarse_rows"], cfg["prior_rows"], cfg["noise"])
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    xc, y = t(tab["X"]), t(tab["y"])
    xk = torch.zeros((cfg["rows"], 0), dtype=torch.long, device=device)
    sub = torch.as_tensor(tab["sub"], device=device)
    u0s = initial_params(state["spec"], tab["la"], tab["lb"], n_restarts=cfg["restarts"], seed=0, dtype=dtype,
                         device=device)
    return dict(ref=dict(X=tab["X"], y=tab["y"], la=tab["la"], lb=tab["lb"]), xc=xc, xk=xk, y=y,
                la=t(tab["la"]), lb=t(tab["lb"]), xc_c=xc[sub], xk_c=xk[sub], y_c=y[sub], u0s=u0s)


def _objective(state, tab, stage, evals):
    mll = importlib.import_module("gumbi_tpu_torch.ops.mll")  # the package exports a function ``mll``

    x, k, y = (tab["xc_c"], tab["xk_c"], tab["y_c"]) if stage == "coarse" else (tab["xc"], tab["xk"], tab["y"])

    def objective(u):
        evals[f"{stage}.{'vg' if torch.is_grad_enabled() else 'v'}"] += 1
        return mll.map_neg_logp(state["spec"], u, x, k, y, tab["la"], tab["lb"])

    return objective


def coarse(state, tab, evals):
    from gumbi_tpu_torch.ops import optimize

    cfg = state["cfg"]
    u_c, _, _ = optimize.multi_restart_minimize(_objective(state, tab, "coarse", evals), tab["u0s"],
                                                maxiter=cfg["coarse_iters"], tol=cfg["coarse_tol"])
    return u_c


def predict(state, params, cache, xg, xkg):
    from gumbi_tpu_torch.ops import posterior

    return posterior.predict_diag_chunked(state["spec"], params, cache, xg, xkg, chunk=state["cfg"]["chunk"])


def run_job(state, tab, spans):
    """One fit-to-prediction job; returns its outputs (on the host) and counts."""
    from gumbi_tpu_torch.ops import constrain, optimize, posterior

    cfg, evals = state["cfg"], collections.Counter()
    with spans("coarse"):
        u_c = coarse(state, tab, evals)
    with spans("polish"):
        u_best, f_best, _ = optimize.lbfgs_backtracking_minimize(_objective(state, tab, "polish", evals), u_c,
                                                                 maxiter=cfg["polish_iters"])
    params = constrain(u_best)
    with torch.no_grad():
        with spans("cache"):
            cache = posterior.posterior_cache(state["spec"], params, tab["xc"], tab["xk"], tab["y"])
        with spans("predict"):
            mean, var = predict(state, params, cache, state["xg"], state["xkg"])
            mean, var = mean.cpu().numpy(), var.cpu().numpy()
    return dict(u={k: v.detach().cpu().numpy() for k, v in u_best.items()}, f=float(f_best), mean=mean, var=var,
                grid=state["grid_np"], evals=dict(evals), flops=job_flops(cfg, evals))


def warm(state, tab):
    """One value+grad and one value at each stage's size, the cache and one
    grid prediction: every shape a job runs, and no whole job."""
    from gumbi_tpu_torch.ops import constrain, posterior

    u = {k: v[0] for k, v in tab["u0s"].items()}
    for stage in ("coarse", "polish"):
        f = _objective(state, tab, stage, collections.Counter())
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in u.items()}
        torch.autograd.grad(f(leaves), list(leaves.values()))
        with torch.no_grad():
            f(u)
    with torch.no_grad():
        params = constrain(u)
        cache = posterior.posterior_cache(state["spec"], params, tab["xc"], tab["xk"], tab["y"])
        mean, _ = predict(state, params, cache, state["xg"], state["xkg"])
        mean.cpu()


def fit_model(state, tab, spans):
    """The query cells' model: the coarse stage only, then the full-N cache."""
    from gumbi_tpu_torch.ops import constrain, posterior

    with spans("coarse"):
        u_c = coarse(state, tab, collections.Counter())
    params = constrain(u_c)
    with torch.no_grad(), spans("cache"):
        cache = posterior.posterior_cache(state["spec"], params, tab["xc"], tab["xk"], tab["y"])
    return dict(params=params, cache=cache, u={k: v.detach().cpu().numpy() for k, v in u_c.items()})


def query(state, model, xq):
    """Predictive mean and variance at the points ``xq``, on the host."""
    xkq = torch.zeros((xq.shape[0], 0), dtype=torch.long, device=xq.device)
    with torch.no_grad():
        mean, var = predict(state, model["params"], model["cache"], xq, xkq)
        return mean.cpu().numpy(), var.cpu().numpy()


def query_flops(cfg, m):
    return predict_flops(cfg["rows"], m)
