"""L-BFGS with multi-restart — the MAP workhorse.

Port of ``gumbi_tpu/ops/optimize.py``. PyTorch runs eagerly, so the
optimizer is the algorithm the reference spells out in host numpy
(``lbfgs_host_minimize``, the same algorithm as its compiled
``lbfgs_backtracking_minimize``): two-loop-recursion direction, the full
step tried with value+grad, then Armijo halving with value-only trials,
best finite iterate kept, relative-decrease stop. The L-BFGS state lives in
f64 numpy on the host; each objective evaluation runs on the device through
``torch.autograd.grad`` on one flat parameter vector. Restarts run one after
another; the best is chosen by a NaN-robust argmin.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import count, span
from ..utils.torch_utils import default_model_dtype, resolve_device
from .kernels import GPSpec
from .mll import DEFAULT_JITTER, map_neg_logp
from .priors import constrain

__all__ = [
    "lbfgs_backtracking_minimize",
    "multi_restart_minimize",
    "coarse_restart_map",
    "fit_gp_map",
    "fit_kron_map",
    "fit_laplace_map",
    "fit_fitc_laplace_map",
]


class _FlatParams:
    """Maps a parameter dict to one flat vector and back (keys in sorted order)."""

    def __init__(self, tree):
        self.names = sorted(tree)
        self.shapes = [tuple(tree[k].shape) for k in self.names]
        self.sizes = [int(np.prod(s)) for s in self.shapes]
        first = tree[self.names[0]]
        self.dtype, self.device = first.dtype, first.device

    def pack(self, tree) -> np.ndarray:
        return np.concatenate(
            [tree[k].detach().cpu().numpy().astype(np.float64).ravel() for k in self.names]
        )

    def to_device(self, vec: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(vec, dtype=self.dtype, device=self.device)

    def tree(self, flat: torch.Tensor) -> dict:
        parts = torch.split(flat, self.sizes)
        return {k: p.reshape(s) for k, p, s in zip(self.names, parts, self.shapes)}


def lbfgs_backtracking_minimize(
    fun, x0, maxiter=100, ftol=1e-6, memory_size=16, max_backtracking=20, sync=None
):
    """Minimize ``fun`` (dict of tensors → scalar tensor) from ``x0``.

    Returns ``(x_best, f_best, n_iters)``: the best finite iterate seen (a
    dict of tensors), its value (f64 tensor, +inf if none was finite) and
    the number of iterations run. A non-finite objective at ``x0`` returns
    ``(x0, inf, 0)`` after one evaluation. ``sync`` (float64 vector →
    float64 vector), where given, maps every value and value+gradient the
    search reads, so that several processes searching together take the
    same steps (``parallel``: the first rank's numbers on every rank).
    """
    flat = _FlatParams(x0)

    def vg(vec):
        count("lbfgs.vg")
        with span("lbfgs.vg"):
            theta = flat.to_device(vec).requires_grad_(True)
            tree = flat.tree(theta)
            with span("objective"):
                value = fun(tree)
            with span("objective.grad"):
                (grad,) = torch.autograd.grad(value, theta)
            with span("lbfgs.read"):
                f, g = float(value.detach()), grad.detach().cpu().numpy().astype(np.float64)
            if sync is not None:
                fg = sync(np.concatenate([[f], g]))
                f, g = float(fg[0]), fg[1:]
            return f, g

    def v_only(vec):
        count("lbfgs.v")
        with span("lbfgs.v"), torch.no_grad():
            tree = flat.tree(flat.to_device(vec))
            with span("objective"):
                value = fun(tree)
            with span("lbfgs.read"):
                f = float(value)
            return f if sync is None else float(sync([f])[0])

    with span("lbfgs.run"):
        x = flat.pack(x0)
        f, g = vg(x)
        best_x, best_f = x.copy(), f if np.isfinite(f) else np.inf
        mem_s, mem_y, mem_rho = [], [], []
        n_iters = 0
        f_prev = np.inf

        for _ in range(maxiter):
            if not np.isfinite(f):
                break
            # two-loop recursion
            q = g.copy()
            alphas = []
            for s, y_, rho in zip(reversed(mem_s), reversed(mem_y), reversed(mem_rho)):
                a = rho * (s @ q)
                alphas.append(a)
                q -= a * y_
            if mem_s:
                ys = mem_y[-1] @ mem_s[-1]
                yy = mem_y[-1] @ mem_y[-1]
                q *= ys / yy if yy > 0 else 1.0
            for (s, y_, rho), a in zip(zip(mem_s, mem_y, mem_rho), reversed(alphas)):
                q += (a - rho * (y_ @ q)) * s
            p = -q
            gTp = g @ p
            if not np.isfinite(gTp) or gTp >= 0:  # not a descent direction: restart
                p, gTp = -g, -(g @ g)

            # Full step with value+grad (the common accept near convergence);
            # on rejection, value-only Armijo halving and one value+grad at the
            # accepted point.
            f_new, x_new, g_new = np.inf, x, g
            x_try = x + p
            f_try, g_try = vg(x_try)
            if np.isfinite(f_try) and f_try <= f + 1e-4 * gTp:
                f_new, x_new, g_new = f_try, x_try, g_try
            else:
                step = 0.5
                for _bt in range(max_backtracking - 1):
                    x_try = x + step * p
                    f_try = v_only(x_try)
                    if np.isfinite(f_try) and f_try <= f + 1e-4 * step * gTp:
                        f_new, x_new = f_try, x_try
                        break
                    step *= 0.5
            n_iters += 1
            count("lbfgs.iters")
            if not np.isfinite(f_new):  # line search failed everywhere
                break
            if g_new is g:  # accepted a backtracked point: fetch its gradient
                _, g_new = vg(x_new)
            s_vec, y_vec = x_new - x, g_new - g
            sy = s_vec @ y_vec
            if np.isfinite(sy) and sy > 1e-10:
                mem_s.append(s_vec)
                mem_y.append(y_vec)
                mem_rho.append(1.0 / sy)
                if len(mem_s) > memory_size:
                    mem_s.pop(0)
                    mem_y.pop(0)
                    mem_rho.pop(0)
            x, f_prev, f, g = x_new, f, f_new, g_new
            if f < best_f:
                best_x, best_f = x.copy(), f
            if abs(f_prev - f) < ftol * (1.0 + abs(f)):
                break

        x_best = {k: v.detach() for k, v in flat.tree(flat.to_device(best_x)).items()}
        return x_best, torch.tensor(best_f, dtype=torch.float64), n_iters


def multi_restart_minimize(fun, x0s, maxiter=250, tol=1e-6, runner=None):
    """Multi-restart L-BFGS over stacked starting points; best optimum wins.

    ``x0s`` is a dict whose tensors carry a leading restart axis. Restarts
    run one after another, each through ``runner(x0) -> (x, f, iters)``
    (default: :func:`lbfgs_backtracking_minimize` on ``fun``); those that
    diverge contribute +inf and are ignored in the argmin. ``aux`` carries
    the per-restart values and iterations, with the default runner the
    per-restart evaluations of ``fun`` as ``evals`` (None with another
    runner), and, as ``all_xs``, the stacked per-restart optima (the staged
    large-N fit falls back to runner-up candidates from them).
    """
    n_evals, counting = [0], runner is None
    if counting:
        def counted(x):
            n_evals[0] += 1
            return fun(x)

        def runner(x0):
            return lbfgs_backtracking_minimize(counted, x0, maxiter=maxiter, ftol=tol)

    R = next(iter(x0s.values())).shape[0]
    xs, fs, its, evs = [], [], [], []
    for i in range(R):
        before = n_evals[0]
        x, f, it = runner({k: v[i] for k, v in x0s.items()})
        xs.append(x)
        fs.append(float(f))
        its.append(int(it))
        evs.append(n_evals[0] - before)
    fs = np.asarray(fs)
    fs_safe = np.where(np.isfinite(fs), fs, np.inf)
    best = int(np.argmin(fs_safe))
    aux = {
        "all_values": fs,
        "iters": np.asarray(its),
        "evals": np.asarray(evs) if counting else None,
        "best_restart": best,
        "all_xs": {k: torch.stack([x[k] for x in xs]) for k in xs[0]},
    }
    return xs[best], torch.tensor(fs_safe[best], dtype=torch.float64), aux


def coarse_restart_map(spec: GPSpec, xc, xk, y, ls_alpha, ls_beta, u0, maxiter=40, tol=1e-5):
    """ONE L-BFGS restart of the dense-Cholesky MAP objective, the runner of
    the staged large-N fit's coarse triage (pass it to
    :func:`multi_restart_minimize` as ``runner``). Returns (u, f, iters)."""

    def objective(u):
        return map_neg_logp(spec, u, xc, xk, y, ls_alpha, ls_beta)

    return lbfgs_backtracking_minimize(objective, u0, maxiter=maxiter, ftol=tol)


def _model_placement(ref, device):
    """(device, dtype) of a fit: ``device``, else ``ref``'s if it is a
    tensor, else the CUDA card (:func:`resolve_device`); and its model dtype."""
    device = resolve_device(device, ref)
    return device, default_model_dtype(device)


def _on(x, device, dtype):
    return None if x is None else torch.as_tensor(x, dtype=dtype, device=device)


def fit_kron_map(
    spec: GPSpec, xc_locs, Y, ls_alpha, ls_beta, u0s, maxiter=250, tol=1e-6, *, device=None
):
    """MAP-fit the Kronecker-structured LMC by multi-restart L-BFGS.

    Every array input (numpy or tensor) is cast to the model dtype
    (:func:`default_model_dtype`: f32 on CUDA, f64 on CPU) on ``device``
    (default: ``xc_locs``'s device if it is a tensor, else CUDA), so the
    objective never promotes. Returns
    ``(u_best, f_best, aux)`` with ``u_best`` unconstrained, as the reference.
    """
    from .kronecker import kron_neg_logp

    device, dtype = _model_placement(xc_locs, device)
    xc_locs, Y, ls_alpha, ls_beta = (_on(a, device, dtype) for a in (xc_locs, Y, ls_alpha, ls_beta))
    u0s = {k: _on(v, device, dtype) for k, v in u0s.items()}

    def objective(uparams):
        return kron_neg_logp(spec, uparams, xc_locs, Y, ls_alpha, ls_beta)

    return multi_restart_minimize(objective, u0s, maxiter=maxiter, tol=tol)


def fit_gp_map(
    spec: GPSpec,
    xc,
    xk,
    y,
    ls_alpha,
    ls_beta,
    u0s,
    maxiter=250,
    tol=1e-6,
    jitter=DEFAULT_JITTER,
    restart_chunk=None,
    mask=None,
    noise_mult=None,
    *,
    device=None,
):
    """MAP-fit the GP hyperparameters by multi-restart L-BFGS.

    Parameters are optimized in unconstrained space against
    :func:`.mll.map_neg_logp`. Returns (params_natural, neg_logp_best, aux).
    ``mask`` marks valid rows of bucket-padded data; ``noise_mult`` fixes a
    per-row relative noise variance. ``restart_chunk`` bounds concurrent
    restarts in the reference; here restarts run one at a time, which meets
    any bound. Inputs are placed as in :func:`fit_kron_map`.
    """
    device, dtype = _model_placement(xc, device)
    xc, y, ls_alpha, ls_beta, mask, noise_mult = (
        _on(a, device, dtype) for a in (xc, y, ls_alpha, ls_beta, mask, noise_mult)
    )
    xk = torch.as_tensor(xk, dtype=torch.long, device=device)
    u0s = {k: _on(v, device, dtype) for k, v in u0s.items()}

    def objective(uparams):
        return map_neg_logp(spec, uparams, xc, xk, y, ls_alpha, ls_beta, jitter, mask, noise_mult)

    u_best, f_best, aux = multi_restart_minimize(objective, u0s, maxiter=maxiter, tol=tol)
    return constrain(u_best), f_best, aux


def fit_laplace_map(
    spec: GPSpec, xc, xk, y, ls_alpha, ls_beta, u0s, maxiter=300, tol=1e-6, mask=None, *, device=None
):
    """MAP-fit classifier hyperparameters on the Laplace marginal likelihood.

    The gradient never differentiates the inner Newton loop
    (:func:`.laplace.laplace_mll`'s analytic backward). ``mask`` marks real
    rows of bucket-padded data. Inputs are placed as in :func:`fit_kron_map`.
    Returns ``(u_best, f_best, aux)`` with ``u_best`` unconstrained, as the
    reference.
    """
    from .laplace import laplace_neg_logp

    device, dtype = _model_placement(xc, device)
    xc, y, ls_alpha, ls_beta, mask = (_on(a, device, dtype) for a in (xc, y, ls_alpha, ls_beta, mask))
    xk = torch.as_tensor(xk, dtype=torch.long, device=device)
    u0s = {k: _on(v, device, dtype) for k, v in u0s.items()}

    def objective(uparams):
        return laplace_neg_logp(spec, uparams, xc, xk, y, ls_alpha, ls_beta, mask=mask)

    return multi_restart_minimize(objective, u0s, maxiter=maxiter, tol=tol)


def fit_fitc_laplace_map(
    spec: GPSpec, xc, xk, xu_c, xu_k, y, ls_alpha, ls_beta, u0s,
    maxiter=300, tol=1e-6, mask=None, *, device=None,
):
    """MAP-fit sparse-classifier hyperparameters on the FITC-Laplace evidence.

    Gradients differentiate through the O(N·m²) Newton loop with autograd,
    as the reference's do. Inputs (inducing points included) are placed as
    in :func:`fit_kron_map`. Returns ``(u_best, f_best, aux)`` with
    ``u_best`` unconstrained, as the reference.
    """
    from .fitc_laplace import fitc_laplace_neg_logp

    device, dtype = _model_placement(xc, device)
    xc, xu_c, y, ls_alpha, ls_beta, mask = (
        _on(a, device, dtype) for a in (xc, xu_c, y, ls_alpha, ls_beta, mask)
    )
    xk, xu_k = (torch.as_tensor(a, dtype=torch.long, device=device) for a in (xk, xu_k))
    u0s = {k: _on(v, device, dtype) for k, v in u0s.items()}

    def objective(uparams):
        return fitc_laplace_neg_logp(spec, uparams, xc, xk, xu_c, xu_k, y, ls_alpha, ls_beta, mask=mask)

    return multi_restart_minimize(objective, u0s, maxiter=maxiter, tol=tol)
