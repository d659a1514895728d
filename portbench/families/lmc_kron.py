"""Kronecker LMC jobs through the port's public ops (configuration ``lmc2``).

The stage driver is a frozen copy of ``chip_smoke.py`` ``run_slice``
(commit 47d6025), bench.py's workload: ``fit_kron_map`` on the coarse
subsample from ``restarts`` starts, then on the mid subsample and at full N,
each from the previous winner; then ``kron_cache`` and
``kron_predict_diag`` on the grid. The copy takes its tables from the
traffic, counts the Kronecker objective's value+grad and value-only
evaluations by stage (by wrapping ``kronecker.kron_neg_logp``, which
``fit_kron_map`` looks up at each call), and ends each stage with a device
sync inside a span.

Operation counts are of work the inputs need, from shapes: at n locations
and D outputs a value is D factors of n³/3 plus the location Gram; a
value+grad adds the D inverses of 2n³/3 and the Gram's backward.
"""

from __future__ import annotations

import collections
import contextlib

import torch

from ..harness import frozen

REFERENCE = "lmc_kron"
STAGES = ("coarse", "mid", "polish", "cache", "predict")
D_OUT = 2


def gram_flops(n, m, d=2):
    return n * m * (3.0 * d + 2.0)


def eval_flops(n, grad):
    cubic = D_OUT * n**3 * (1.0 if grad else 1.0 / 3.0)
    return cubic + (2.0 if grad else 1.0) * gram_flops(n, n)


def predict_flops(n, m):
    """Cross-Gram, each output's n²·m triangular solve, means and variances."""
    return gram_flops(n, m) + D_OUT * (n * n * m + 4.0 * n * m)


def job_flops(cfg, evals):
    size = {"coarse": cfg["coarse_locs"], "mid": cfg["mid_locs"], "polish": cfg["locs"]}
    total = sum(c * eval_flops(size[k.split(".")[0]], k.endswith(".vg")) for k, c in evals.items())
    n = cfg["locs"]
    return total + D_OUT * n**3 / 3.0 + gram_flops(n, n) + predict_flops(n, cfg["grid"] ** 2)


def spec():
    from gumbi_tpu_torch.ops import CoregTerm, GPSpec, GPTerm

    out_cg = CoregTerm(name="Parameter", col=0, d_out=D_OUT)
    return GPSpec(terms=(GPTerm(suffix="total", kernel="ExpQuad", coregs=(out_cg,)),), d_cont=2, ard=True,
                  noise_coreg=CoregTerm(name="Output_noise", col=0, d_out=D_OUT))


def prepare(cfg, device, dtype=torch.float32):
    g = frozen.grid_points(cfg["grid"])
    return dict(cfg=cfg, spec=spec(), device=device, dtype=dtype, grid_np=g,
                xg=torch.as_tensor(g, dtype=dtype, device=device))


def make_table(state, rng):
    from gumbi_tpu_torch.ops import initial_params

    cfg, device, dtype = state["cfg"], state["device"], state["dtype"]
    tab = frozen.lmc_table(rng, cfg["locs"], cfg["coarse_locs"], cfg["mid_locs"], cfg["prior_rows"],
                           tuple(cfg["noise"]))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    xc, Y = t(tab["X"]), t(tab["Y"])
    sub_c, sub_m = (torch.as_tensor(tab[k], device=device) for k in ("sub_c", "sub_m"))
    u0s = initial_params(state["spec"], tab["la"], tab["lb"], n_restarts=cfg["restarts"], seed=0, dtype=dtype,
                         device=device)
    return dict(ref=dict(X=tab["X"], Y=tab["Y"], la=tab["la"], lb=tab["lb"]), xc=xc, Y=Y, la=t(tab["la"]),
                lb=t(tab["lb"]), sub={"coarse": sub_c, "mid": sub_m}, u0s=u0s)


@contextlib.contextmanager
def _counting(evals, stage):
    """Count ``kron_neg_logp`` calls as ``<stage>.vg`` or ``<stage>.v``."""
    from gumbi_tpu_torch.ops import kronecker

    orig = kronecker.kron_neg_logp

    def counted(*args, **kwargs):
        evals[f"{stage}.{'vg' if torch.is_grad_enabled() else 'v'}"] += 1
        return orig(*args, **kwargs)

    kronecker.kron_neg_logp = counted
    try:
        yield
    finally:
        kronecker.kron_neg_logp = orig


def _fit(state, tab, stage, u0s, evals):
    from gumbi_tpu_torch.ops import optimize

    cfg = state["cfg"]
    iters, tol = cfg[f"{stage}_iters"], cfg[f"{stage}_tol"]
    idx = tab["sub"].get(stage)
    xc, Y = (tab["xc"], tab["Y"]) if idx is None else (tab["xc"][idx], tab["Y"][idx])
    with _counting(evals, stage):
        u, f, _ = optimize.fit_kron_map(state["spec"], xc, Y, tab["la"], tab["lb"], u0s, maxiter=iters, tol=tol)
    return u, f


def _one(u):
    return {k: v[None] for k, v in u.items()}


def run_job(state, tab, spans):
    from gumbi_tpu_torch.ops import constrain, kronecker

    evals = collections.Counter()
    with spans("coarse"):
        u_c, _ = _fit(state, tab, "coarse", tab["u0s"], evals)
    with spans("mid"):
        u_m, _ = _fit(state, tab, "mid", _one(u_c), evals)
    with spans("polish"):
        u_best, f_best = _fit(state, tab, "polish", _one(u_m), evals)
    params = constrain(u_best)
    with torch.no_grad():
        with spans("cache"):
            kc = kronecker.kron_cache(state["spec"], params, tab["xc"], tab["Y"])
        with spans("predict"):
            mean, var = kronecker.kron_predict_diag(state["spec"], params, kc, state["xg"], with_noise=True)
            mean, var = mean.cpu().numpy(), var.cpu().numpy()
    return dict(u={k: v.detach().cpu().numpy() for k, v in u_best.items()}, f=float(f_best), mean=mean, var=var,
                grid=state["grid_np"], evals=dict(evals), flops=job_flops(state["cfg"], evals))


def warm(state, tab):
    """One value+grad and one value at each stage's size, the cache and one
    grid prediction."""
    from gumbi_tpu_torch.ops import constrain, kronecker

    u = {k: v[0] for k, v in tab["u0s"].items()}
    for stage in ("coarse", "mid", "polish"):
        idx = tab["sub"].get(stage)
        xc, Y = (tab["xc"], tab["Y"]) if idx is None else (tab["xc"][idx], tab["Y"][idx])
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in u.items()}
        value = kronecker.kron_neg_logp(state["spec"], leaves, xc, Y, tab["la"], tab["lb"])
        torch.autograd.grad(value, list(leaves.values()))
        with torch.no_grad():
            kronecker.kron_neg_logp(state["spec"], u, xc, Y, tab["la"], tab["lb"])
    with torch.no_grad():
        params = constrain(u)
        kc = kronecker.kron_cache(state["spec"], params, tab["xc"], tab["Y"])
        mean, _ = kronecker.kron_predict_diag(state["spec"], params, kc, state["xg"], with_noise=True)
        mean.cpu()
