"""Plain Gaussian-process algebra shared by the references.

The model is gumbi's (PyMC's) as the configurations state it: an ExpQuad
Gram η²·exp(−½ Σ_d (Δx_d / ℓ_d)²), its squared distances by the matmul
identity as PyMC forms them, Gaussian noise plus PyMC's implicit 1e-6
jitter on the training diagonal, and the hyperpriors below, with the
log-Jacobian of the log transform of each positive parameter.

``products`` selects how every matrix product is taken: ``"exact"`` in the
tensors' own dtype (float64 for the reference), or ``"tf32"``, each operand
rounded to TF32's 10-bit mantissa as the tensor cores round it and the sum
kept in float32: the control's precision. Under ``"tf32"`` the library's
own products (factor, solves) run with TF32 allowed as well.
"""

from __future__ import annotations

import contextlib
import math

import torch

JITTER = 1e-6
LOG_2PI = math.log(2.0 * math.pi)


def tf32_round(x):
    """``x`` (float32) rounded to nearest on TF32's 10-bit mantissa."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a, b, products):
    if products == "tf32":
        return tf32_round(a) @ tf32_round(b)
    return a @ b


@contextlib.contextmanager
def precision(products):
    """Allow the library's TF32 products for the block under ``"tf32"``."""
    if products != "tf32":
        yield
        return
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def se_gram(x1, x2, ls, eta, products="exact"):
    """η²·exp(−½ r²), r² by the matmul identity on x/ℓ, clamped at 0."""
    a, b = x1 / ls, x2 / ls
    r2 = (a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :] - 2.0 * mm(a, b.T, products)
    return eta**2 * torch.exp(-0.5 * r2.clamp(min=0.0))


def logp_invgamma(x, a, b):
    return a * torch.log(b) - torch.lgamma(a) - (a + 1.0) * torch.log(x) - b / x


def logp_gamma(x, a, b):
    return a * math.log(b) + (a - 1.0) * torch.log(x) - b * x - math.lgamma(a)


def logp_normal(x, mu, sd):
    return -0.5 * LOG_2PI - math.log(sd) - (x - mu) ** 2 / (2.0 * sd**2)


def logp_exponential(x, lam):
    return math.log(lam) - lam * x


def gaussian_nll(K, y, products="exact"):
    """−log N(y | 0, K) by the library Cholesky; +inf where K is not PD."""
    L, info = torch.linalg.cholesky_ex(K)
    if int(info) != 0:
        return torch.tensor(math.inf, dtype=K.dtype, device=K.device)
    w = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    quad = (w * w).sum()
    return 0.5 * (quad + 2.0 * torch.log(torch.diagonal(L)).sum() + y.shape[0] * LOG_2PI)


def chol_or_none(K):
    L, info = torch.linalg.cholesky_ex(K)
    return None if int(info) != 0 else L


def whitened(L, B, block=4096):
    """L⁻¹B, ``block`` columns of B at a time."""
    return torch.cat([torch.linalg.solve_triangular(L, B[:, i : i + block], upper=False)
                      for i in range(0, B.shape[1], block)], dim=1)


def _tensors(table, dtype, keys):
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=table["device"])  # noqa: E731
    return [t(table[k]) for k in keys], t


def _dtype(products):
    return torch.float64 if products == "exact" else torch.float32


def flat(model, u):
    return torch.cat([u[k].reshape(-1) for k in model.SHAPES])


def unflat(model, x):
    out, i = {}, 0
    for k, s in model.SHAPES.items():
        n = int(torch.Size(s).numel())
        out[k] = x[i : i + n].reshape(s)
        i += n
    return out


def inputs(model):
    """The table keys ``model`` takes before its target, in order: its
    ``INPUTS`` (say the inducing inputs beside ``X``), or ``("X",)``."""
    return tuple(getattr(model, "INPUTS", ("X",)))


def readings(model, table, out, products="exact"):
    """``model``'s objective (where ``out`` carries one) and grid prediction
    at the port's MAP ``out['u']`` on the job's table: float64, or float32
    with TF32 products for the control. ``model`` is a reference module:
    ``SHAPES``, ``TARGET``, ``neg_logp``, ``Posterior``, ``rows``, and
    optionally ``INPUTS``: ``neg_logp`` and ``Posterior`` take the inputs,
    then the target; ``rows`` the inputs."""
    tensors, t = _tensors(table, _dtype(products), (*inputs(model), model.TARGET, "la", "lb"))
    *xs, y, la, lb = tensors
    u = {k: t(out["u"][k]) for k in model.SHAPES}
    with precision(products):
        f = float(model.neg_logp(*xs, y, u, la, lb, products)) if out.get("f") is not None else None
        mean, var = model.Posterior(*xs, y, u, products).predict(t(out["grid"]))
    return dict(f=f, mean=mean.double(), var=var.double(), rows=model.rows(*xs))


def posterior(model, table, u, products="exact"):
    """``model``'s posterior at ``u`` (a dict of arrays), for many queries."""
    tensors, t = _tensors(table, _dtype(products), (*inputs(model), model.TARGET))
    with precision(products):
        return model.Posterior(*tensors, {k: t(u[k]) for k in model.SHAPES}, products)


def map_gap(model, table, out, max_iter=6, max_eval=10):
    """f(u) − the least f that float64 L-BFGS finds from the port's MAP, per row."""
    tensors, t = _tensors(table, torch.float64, (*inputs(model), model.TARGET, "la", "lb"))
    *xs, y, la, lb = tensors
    u = flat(model, {k: t(out["u"][k]) for k in model.SHAPES})
    gap = refine_gap(lambda x: model.neg_logp(*xs, y, unflat(model, x), la, lb), u, max_iter, max_eval)
    return gap / model.rows(*xs)


def refine_gap(neg_logp, u, max_iter, max_eval):
    """How far plain float64 L-BFGS (strong Wolfe) lowers ``neg_logp`` from
    the flat point ``u`` in ``max_eval`` evaluations: f(u) − min f."""
    x = u.detach().clone().requires_grad_(True)
    with torch.no_grad():
        f0 = float(neg_logp(x))
    if not math.isfinite(f0):
        return math.inf
    best = [f0]

    def closure():
        opt.zero_grad()
        f = neg_logp(x)
        if torch.isfinite(f):
            best[0] = min(best[0], float(f.detach()))
            f.backward()
        return f

    opt = torch.optim.LBFGS([x], lr=1.0, max_iter=max_iter, max_eval=max_eval, history_size=max_iter,
                            tolerance_grad=0.0, tolerance_change=0.0, line_search_fn="strong_wolfe")
    opt.step(closure)
    return f0 - best[0]
