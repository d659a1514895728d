"""Sharded GP computations over a device mesh.

Port of ``gumbi_tpu/parallel/sharded.py``, SPMD on ``torch.distributed``
(one process per device; see :mod:`.mesh`). Three patterns:

* **Restart parallelism** (the whole mesh): the restart batch is padded to
  the world size with copies of restart 0 and split over the ranks; each
  rank runs its slice through ``multi_restart_minimize`` on the replicated
  data, the values and optima are all-gathered, and every rank takes the
  same argmin. One rank runs every start in the single-device order, so
  its result is the single-device fit's.
* **Data-sharded Gram** ('data' axis): each rank builds its row block
  K[local, :] of the N×N Gram and the blocked Cholesky of :mod:`.blocked`
  factors it in place: O(N²/P) memory and O(N³/P) compute a rank.
* **Sharded grid prediction** ('data' axis): each rank predicts its block
  of the grid against the replicated posterior cache, with no communication
  until the blocks are gathered.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.kernels import GPSpec, gram, noise_diag
from ..ops.mll import DEFAULT_JITTER, map_neg_logp
from ..ops.optimize import lbfgs_backtracking_minimize, multi_restart_minimize
from ..ops.posterior import predict_diag_chunked
from ..ops.priors import constrain, log_prior
from ..utils.torch_utils import default_model_dtype
from .blocked import DistQuadLogdet
from .mesh import AXES, Axis, ReplicatedIn, as_mesh, mesh_device

__all__ = [
    "sharded_fit_gp_map",
    "sharded_fit_kron_map",
    "sharded_fit_laplace_map",
    "sharded_fit_fitc_map",
    "sharded_fit_fitc_laplace_map",
    "sharded_gram_mll",
    "sharded_predict_diag",
    "data_sharded_fit_gp_map",
    "train_step",
]


def _pad_restarts(u0s, n_dev):
    """Pad the restart batch to a multiple of the rank count with copies of
    restart 0 (harmless: the argmin takes the first of equal values)."""
    R = next(iter(u0s.values())).shape[0]
    pad = (-R) % n_dev
    if pad:
        u0s = {k: torch.cat([v] + [v[:1]] * pad) for k, v in u0s.items()}
    return u0s


def _placed(mesh, ref):
    """(device, dtype) of a sharded call: ``ref``'s where it is a tensor, else
    this rank's device in its model dtype."""
    if isinstance(ref, torch.Tensor):
        return ref.device, ref.dtype
    device = mesh_device(mesh)
    return device, default_model_dtype(device)


def _arrays(mesh, arrays, int_idx=()):
    """The data arrays as tensors on this rank's device (integer category
    indices where listed)."""
    device, dtype = _placed(mesh, arrays[0])
    return tuple(
        None if a is None
        else torch.as_tensor(a, dtype=torch.long if i in int_idx else dtype, device=device)
        for i, a in enumerate(arrays)
    ), device, dtype


class _MeshOrder:
    """This rank's place in the flattened mesh (restart-major) and a gather
    over the whole mesh in that order."""

    def __init__(self, mesh):
        self.restart, self.data = Axis(mesh, AXES[0]), Axis(mesh, AXES[1])
        self.size = self.restart.size * self.data.size
        self.rank = self.restart.rank * self.data.size + self.data.rank

    def gather(self, t):
        return self.restart.gather_rows(self.data.gather_rows(t))


def _restart_sharded_fit(mesh, objective, u0s, maxiter, tol):
    """Split the (padded) restart batch over the mesh, fit each rank's slice,
    gather, and take the argmin on every rank."""
    order = _MeshOrder(mesh)
    u0s = _pad_restarts(u0s, order.size)
    per = next(iter(u0s.values())).shape[0] // order.size
    mine = slice(order.rank * per, (order.rank + 1) * per)
    _, _, aux = multi_restart_minimize(objective, {k: v[mine] for k, v in u0s.items()}, maxiter=maxiter, tol=tol)
    device = next(iter(u0s.values())).device
    vals = order.gather(torch.as_tensor(aux["all_values"], dtype=torch.float64, device=device)).cpu().numpy()
    iters = order.gather(torch.as_tensor(aux["iters"], dtype=torch.int64, device=device)).cpu().numpy()
    xs = {k: order.gather(v.contiguous()) for k, v in aux["all_xs"].items()}
    safe = np.where(np.isfinite(vals), vals, np.inf)
    best = int(np.argmin(safe))
    u_best = {k: v[best] for k, v in xs.items()}
    aux = {"all_values": vals, "iters": iters, "best_restart": best, "n_padded": len(vals)}
    return constrain(u_best), torch.tensor(safe[best], dtype=torch.float64), aux


def _run(mesh, neg_logp, arrays, u0s, maxiter, tol, int_idx):
    mesh = as_mesh(mesh)
    arrays, device, dtype = _arrays(mesh, arrays, int_idx)
    u0s = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in u0s.items()}

    def objective(u):
        return neg_logp(u, *arrays)

    return _restart_sharded_fit(mesh, objective, u0s, maxiter, tol)


def sharded_fit_gp_map(mesh, spec: GPSpec, xc, xk, y, ls_alpha, ls_beta, u0s, maxiter=250, tol=1e-6, mask=None):
    """Multi-restart MAP fit of the dense evidence with the restarts sharded
    over the mesh; data replicated. ``mask`` (0/1 per row) carries bucket
    padding to the masked MLL, as in ``fit_gp_map``. Returns
    ``(params, neg_logp, aux)``."""

    def neg_logp(u, xc, xk, y, la, lb, mask):
        return map_neg_logp(spec, u, xc, xk, y, la, lb, mask=mask)

    return _run(mesh, neg_logp, (xc, xk, y, ls_alpha, ls_beta, mask), u0s, maxiter, tol, (1,))


def sharded_fit_kron_map(mesh, spec: GPSpec, xc_locs, Y, ls_alpha, ls_beta, u0s, maxiter=250, tol=1e-6):
    """Restart-sharded MAP fit of the Kronecker-structured LMC."""
    from ..ops.kronecker import kron_neg_logp

    def neg_logp(u, xl, Y, la, lb):
        return kron_neg_logp(spec, u, xl, Y, la, lb)

    return _run(mesh, neg_logp, (xc_locs, Y, ls_alpha, ls_beta), u0s, maxiter, tol, ())


def sharded_fit_laplace_map(mesh, spec: GPSpec, xc, xk, y, ls_alpha, ls_beta, u0s, maxiter=300, tol=1e-6,
                            mask=None):
    """Restart-sharded MAP fit of the classifier's Laplace evidence
    (``GPC.find_MAP(mesh=)``)."""
    from ..ops.laplace import laplace_neg_logp

    def neg_logp(u, xc, xk, y, la, lb, mask):
        return laplace_neg_logp(spec, u, xc, xk, y, la, lb, mask=mask)

    return _run(mesh, neg_logp, (xc, xk, y, ls_alpha, ls_beta, mask), u0s, maxiter, tol, (1,))


def sharded_fit_fitc_map(mesh, spec: GPSpec, xc, xk, xu_c, xu_k, y, ls_alpha, ls_beta, u0s, maxiter=250,
                         tol=1e-6, mask=None):
    """Restart-sharded MAP fit of the sparse (FITC) regressor's evidence."""
    from ..ops.fitc import fitc_neg_logp

    def neg_logp(u, xc, xk, xu_c, xu_k, y, la, lb, mask):
        return fitc_neg_logp(spec, u, xc, xk, xu_c, xu_k, y, la, lb, mask=mask)

    return _run(mesh, neg_logp, (xc, xk, xu_c, xu_k, y, ls_alpha, ls_beta, mask), u0s, maxiter, tol, (1, 3))


def sharded_fit_fitc_laplace_map(mesh, spec: GPSpec, xc, xk, xu_c, xu_k, y, ls_alpha, ls_beta, u0s, maxiter=300,
                                 tol=1e-6, mask=None):
    """Restart-sharded MAP fit of the sparse classifier (FITC-Laplace)."""
    from ..ops.fitc_laplace import fitc_laplace_neg_logp

    def neg_logp(u, xc, xk, xu_c, xu_k, y, la, lb, mask):
        return fitc_laplace_neg_logp(spec, u, xc, xk, xu_c, xu_k, y, la, lb, mask=mask)

    return _run(mesh, neg_logp, (xc, xk, xu_c, xu_k, y, ls_alpha, ls_beta, mask), u0s, maxiter, tol, (1, 3))


def _sharded_noisy_gram(ax: Axis, spec: GPSpec, params, xc, xk, jitter, n):
    """This rank's (N/P, N) rows of K + noise·I (+ jitter) over the data
    padded to a multiple of P, pad rows as identity rows (zero to the
    quadratic form and the log-determinant), and the padded row mask."""
    pad = (-n) % ax.size
    xc_p = torch.cat([xc, xc.new_zeros((pad, xc.shape[1]))])
    xk_p = torch.cat([xk, xk.new_zeros((pad, xk.shape[1]))])
    mask = torch.cat([xc.new_ones(n), xc.new_zeros(pad)])
    rows = ax.block(n + pad)
    K = gram(spec, params, xc_p[rows], xk_p[rows], xc_p, xk_p)
    m_rows = mask[rows]
    K = K * (m_rows[:, None] * mask[None, :])
    d = noise_diag(spec, params, xk_p[rows], dtype=K.dtype) + jitter
    d = m_rows * d + (1.0 - m_rows)
    K = torch.cat([K[:, : rows.start], K[:, rows] + torch.diag(d), K[:, rows.stop :]], dim=1)
    return K, mask


def sharded_gram_mll(mesh, spec: GPSpec, params, xc, xk, y, jitter=DEFAULT_JITTER):
    """Gaussian MLL with the Gram's assembly and its factorization sharded
    over 'data': each rank builds its K[local, :] rows (``rbf_gram`` for
    ExpQuad at f32 on CUDA) and the blocked Cholesky factors them in place.
    Differentiable in ``params``: each rank's share of the gradient flows
    through its own rows and is summed over the axis."""
    ax = Axis(mesh, "data")
    n = y.shape[0]
    keys = tuple(params)
    values = tuple(params[k] for k in keys)
    differentiable = torch.is_grad_enabled() and any(v.requires_grad for v in values)
    if differentiable:
        values = ReplicatedIn.apply(ax.group, *values)
    K, _ = _sharded_noisy_gram(ax, spec, dict(zip(keys, values)), xc, xk, jitter, n)
    y_p = torch.cat([y, y.new_zeros(K.shape[1] - n)])
    quad, logdet = DistQuadLogdet.apply(ax, K, y_p[ax.block(K.shape[1])], differentiable)
    return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))


def data_sharded_fit_gp_map(mesh, spec: GPSpec, xc, xk, y, ls_alpha, ls_beta, u0s, maxiter=250, tol=1e-6,
                            jitter=DEFAULT_JITTER):
    """MAP fit where the N axis (Gram and Cholesky) shards over 'data': every
    evaluation runs :func:`sharded_gram_mll`; restarts run one after another
    (a host loop of ``lbfgs_backtracking_minimize`` with ``ftol=tol``).
    The line search reads the value and gradient the 'data' axis's first rank
    computed, so every rank takes the same steps. Returns
    ``(params, neg_logp, aux)``."""
    mesh = as_mesh(mesh)
    ax = Axis(mesh, "data")
    (xc, xk, y, la, lb), device, dtype = _arrays(mesh, (xc, xk, y, ls_alpha, ls_beta), (1,))
    u0s = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in u0s.items()}

    n_evals = [0]

    def objective(u):
        n_evals[0] += 1
        total = sharded_gram_mll(mesh, spec, constrain(u), xc, xk, y, jitter) + log_prior(spec, u, la, lb)
        return torch.where(torch.isfinite(total), -total, torch.inf)

    sync = ax.agreement(device)
    R = next(iter(u0s.values())).shape[0]
    best = (None, math.inf)
    all_vals, all_iters, all_evals = [], [], []
    for r in range(R):
        before = n_evals[0]
        x_r, f_r, it_r = lbfgs_backtracking_minimize(objective, {k: v[r] for k, v in u0s.items()},
                                                     maxiter=maxiter, ftol=tol, sync=sync)
        all_vals.append(float(f_r))
        all_iters.append(int(it_r))
        all_evals.append(n_evals[0] - before)
        # first restart kept even when every value is +inf (the argmin over inf)
        if best[0] is None or float(f_r) < best[1]:
            best = (x_r, float(f_r))
    aux = {"all_values": np.asarray(all_vals), "iters": np.asarray(all_iters), "evals": np.asarray(all_evals),
           "best_restart": int(np.argmin(all_vals))}
    return constrain(best[0]), torch.tensor(best[1], dtype=torch.float64), aux


# Points a rank predicts at once: ``GP.predict``'s chunk without a mesh, so
# one rank's prediction is the single-device one
PREDICT_CHUNK = 8192


@torch.no_grad()
def sharded_predict_diag(mesh, spec: GPSpec, params, cache, xc_new, xk_new, with_noise=True):
    """Grid prediction with the points sharded over 'data': each rank solves
    its block against the replicated cache (a bucket-padded cache's masked
    columns zeroed, as in ``predict_diag``) in ``PREDICT_CHUNK``-point
    pieces, then the blocks are gathered."""
    ax = Axis(mesh, "data")
    m = xc_new.shape[0]
    pad = (-m) % ax.size
    xc_p = torch.cat([xc_new, xc_new.new_zeros((pad, xc_new.shape[1]))])
    xk_p = torch.cat([xk_new, xk_new.new_zeros((pad, xk_new.shape[1]))])
    blk = ax.block(m + pad)
    mean, var = predict_diag_chunked(spec, params, cache, xc_p[blk], xk_p[blk], with_noise=with_noise,
                                     chunk=PREDICT_CHUNK)
    return ax.gather_rows(mean)[:m], ax.gather_rows(var)[:m]


def train_step(spec: GPSpec, uparams, opt_state, xc, xk, y, ls_alpha, ls_beta, lr=1e-2):
    """One gradient step on the MAP objective: ``(new_uparams, opt_state,
    value)``."""
    u = {k: v.detach().requires_grad_(True) for k, v in uparams.items()}
    val = map_neg_logp(spec, u, xc, xk, y, ls_alpha, ls_beta)
    grads = torch.autograd.grad(val, list(u.values()))
    new_u = {k: (v - lr * g).detach() for (k, v), g in zip(u.items(), grads)}
    return new_u, opt_state, val.detach()
