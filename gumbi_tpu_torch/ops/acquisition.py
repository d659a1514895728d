"""Bayesian-optimization acquisitions and their multi-restart maximization.

Port of ``gumbi_tpu/ops/acquisition.py``: Sobol QMC base samples (scipy,
bit-equal to the reference's), closed-form EI/UCB, smoothed qLogNEI over the
joint posterior of candidates and baseline, the exact 2-D and the QMC-box
hypervolume improvements, and acquisition maximization by Sobol raw starts →
top-k → sigmoid-reparameterized multi-restart L-BFGS.

Where the reference maps one (q, d) candidate block at a time over the 512
raw starts (``jax.lax.map``), every acquisition here also takes a leading
batch axis on its candidate block, (..., q, d) → (...): the raw sweep
evaluates ``RAW_CHUNK`` blocks per call, each a few dozen launches, instead
of one host-paced posterior and factorization per block. A single (q, d)
block (the L-BFGS restarts' argument) is the batch-free case of the same
code. The restarts run one after another through the port's host-loop
L-BFGS (:func:`.optimize.multi_restart_minimize`), where the reference
vmaps them.

The joint covariance's cancellation step, Kss − VᵀV with V = L⁻¹Ksᵀ, the
prior block Kss it starts from, and its P×P factor run in f64 whatever the
model dtype (a named divergence). The covariance of candidates with
training rows as the baseline is numerically low rank, and at f32 the
accumulation of VᵀV alone takes its smallest eigenvalues to about −2e-6,
so the reference's jitter of 1e-6 factors none of the 512 raw q-batches of
``GP.propose``'s defaults at N = 512 (``tools/probe_sampler_precision.py``).
Kss's own f32 rounding (~eps·η² an entry) then still moves the factor's
near-null directions by about its square root: ~6e-4 in the draws at
N = 256, against ~8e-5 with Kss in f64. So Kss is the plain f64 Gram. The
mean Ks·α is a sum of N terms of up to |α|·η² into an O(1) value, and its
f32 accumulation cost qLogNEI 1.9e-3 log units at phase 12a's candidate on
the card: the product is formed in f64 from the f32 factors. The
cross-Gram Ks (the kernel's, O(B·P·N)), the triangular solve (the
O(N²·B·P) part) and everything after the draws stay at the model dtype. At
f64 nothing changes.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.stats import norm as _scipy_norm
from scipy.stats import qmc as _scipy_qmc

from ..utils.torch_utils import default_model_dtype, resolve_device
from .kernels import GPSpec, gram, gram_diag
from .kronecker import KronCache
from .kronecker import _continuous_diag as kron_continuous_diag
from .kronecker import _continuous_gram as kron_continuous_gram
from .mll import DEFAULT_JITTER
from .optimize import multi_restart_minimize
from .posterior import PosteriorCache, joint_draws

__all__ = [
    "sobol_normal",
    "sobol_uniform",
    "expected_improvement",
    "upper_confidence_bound",
    "qlog_nei",
    "qlog_nehvi_2d",
    "qlog_nehvi_mc",
    "hv_dominated_mc",
    "make_indep_sample_fn",
    "make_kron_sample_fn",
    "optimize_acqf",
    "optimize_qlog_nei",
]


def sobol_uniform(n: int, d: int, seed: int = 0) -> np.ndarray:
    """Scrambled Sobol points in [0, 1)^d (host-side QMC generation)."""
    eng = _scipy_qmc.Sobol(d=d, scramble=True, seed=seed)
    return eng.random(n)


def sobol_normal(n: int, d: int, seed: int = 0) -> np.ndarray:
    """Quasi-random standard-normal base samples via inverse-CDF of Sobol."""
    u = sobol_uniform(n, d, seed)
    return _scipy_norm.ppf(np.clip(u, 1e-12, 1 - 1e-12))


# ------------------------------------------------------------------
# Closed-form single-point acquisitions
# ------------------------------------------------------------------


def expected_improvement(mean, var, best, maximize=True, xi=0.0):
    """Analytic EI of a Gaussian posterior over the incumbent ``best``."""
    sd = torch.sqrt(torch.clamp(var, min=1e-18))
    improve = (mean - best - xi) if maximize else (best - mean - xi)
    z = improve / sd
    pdf = torch.exp(-0.5 * z**2) / math.sqrt(2 * math.pi)
    cdf = 0.5 * (1 + torch.erf(z / math.sqrt(2.0)))
    return improve * cdf + sd * pdf


def upper_confidence_bound(mean, var, beta=2.0, maximize=True):
    """UCB (or LCB when minimizing)."""
    sd = torch.sqrt(torch.clamp(var, min=1e-18))
    return mean + beta * sd if maximize else -(mean - beta * sd)


# ------------------------------------------------------------------
# Monte-Carlo batch acquisitions over the joint posterior
# ------------------------------------------------------------------


def _joint_mean_cov(spec: GPSpec, params, cache: PosteriorCache, xc, xk):
    """Noise-free posterior mean (..., P), covariance (..., P, P) and prior
    variance (..., P) at point sets ``xc`` (..., P, d), ``xk`` (..., P, k).

    ``predict_cov`` for a batch of B point sets in one pass: one cross-Gram
    of all B·P points against the training rows, one triangular solve, and
    one (B·P)² Gram whose diagonal blocks are the B prior covariances. The
    mean and the covariance are returned in f64: the product Ks·α, Kss, VᵀV
    and Kss − VᵀV are formed there.
    """
    lead, (P, d), k = xc.shape[:-2], xc.shape[-2:], xk.shape[-1]
    B = math.prod(lead)
    xcf, xkf = xc.reshape(B * P, d), xk.reshape(B * P, k)
    Ks = gram(spec, params, xcf, xkf, cache.xc, cache.xk)
    if cache.mask is not None:
        Ks = Ks * cache.mask[None, :]
    mean = (Ks.double() @ cache.alpha.double()).reshape(*lead, P)
    V = torch.linalg.solve_triangular(cache.L, Ks.T, upper=False).double().reshape(-1, B, P)
    p64, x64 = {name: v.double() for name, v in params.items()}, xcf.double()
    Kss = gram(spec, p64, x64, xkf, x64, xkf).reshape(B, P, B, P).diagonal(dim1=0, dim2=2).permute(2, 0, 1)
    cov = Kss - torch.einsum("nbi,nbj->bij", V, V)
    prior = gram_diag(spec, params, xcf, xkf)
    return mean, cov.reshape(*lead, P, P), prior.reshape(*lead, P)


def _joint_samples(spec, params, cache, xc_joint, xk_joint, base_samples, jitter=DEFAULT_JITTER):
    """Posterior draws at the stacked candidate+baseline points.

    base_samples: (S, P) standard normals (Sobol), P = number of joint points;
    ``xc_joint`` (..., P, d) gives (..., S, P) at the model dtype. The draws
    are mean + base_samples·Lᵀ with L the f64 factor of the covariance plus
    ``jitter`` (:func:`.posterior.joint_draws`, whose floor is the jitter at
    f64).
    """
    mean, cov, prior = _joint_mean_cov(spec, params, cache, xc_joint, xk_joint)
    ys = joint_draws(mean, cov, prior.double(), jitter, eps=base_samples.double())
    return ys.to(xc_joint.dtype)


def make_indep_sample_fn(spec, params_list, cache_list, out_col_idx, jitter=DEFAULT_JITTER):
    """Joint-posterior sampler for a model list (Independent structure).

    The joint covariance across outputs is block-diagonal — each output's
    rows are sampled from its own sub-model posterior with the cross-output
    blocks exactly zero. Row layout follows the qNEHVI convention:
    candidates output-major (d_out × q rows) then baseline output-major
    (d_out × nb rows); the output column is dropped from Xk before hitting
    the sub-model. Leading batch axes of ``xc_joint`` carry through.
    """

    def sample_fn(xc_joint, xk_joint, base_samples, d_out, q, nb):
        n_cat = xk_joint.shape[-1]
        keep_cols = [c for c in range(n_cat) if c != out_col_idx]
        rows, blocks = [], []
        for j in range(d_out):
            idx = np.concatenate([np.arange(j * q, (j + 1) * q), np.arange(d_out * q + j * nb, d_out * q + (j + 1) * nb)])
            rows.append(idx)
            idx_t = torch.as_tensor(idx, device=xc_joint.device)
            xc_j = xc_joint[..., idx_t, :]
            xk_j = xk_joint[..., idx_t, :][..., keep_cols]
            blocks.append(
                _joint_samples(spec, params_list[j], cache_list[j], xc_j, xk_j, base_samples[:, idx_t], jitter)
            )
        inverse = torch.as_tensor(np.argsort(np.concatenate(rows)), device=xc_joint.device)
        return torch.cat(blocks, dim=-1)[..., inverse]

    return sample_fn


def _kron_joint_mean_cov(spec: GPSpec, params, cache: KronCache, xc, out):
    """:func:`_joint_mean_cov` for a Kronecker model, from its Kronecker
    cache: point sets ``xc`` (..., P, d) with output indices ``out``
    (..., P).

    With K = B ⊗ Kx + Σn ⊗ I factored as D whitened systems ωₖKx + I =
    LₖLₖᵀ (``kron_cache``), the posterior covariance of (o, x) and (o', x')
    is B[o, o']·Kx(x, x') − Σₖ C[k, o]·C[k, o']·(Lₖ⁻¹Kx(X, x))ᵀ(Lₖ⁻¹Kx(X, x'))
    and the mean Σᵢ B[o, i]·αᵢ·Kx(X, x): D solves against the N locations
    where the dense form takes one against all D·N rows. The same numbers
    at f64; at f32 the whitened systems keep digits the dense factor of a
    strongly correlated model loses. Products, VᵀV and the subtraction in
    f64, as there.
    """
    lead, (P, d) = xc.shape[:-2], xc.shape[-2:]
    B = math.prod(lead)
    xcf, of = xc.reshape(B * P, d), out.reshape(B * P)
    Kxs = kron_continuous_gram(spec, params, cache.xc_locs, xcf)  # (N, B·P)
    Bm, C = cache.B.double(), cache.C.double()
    mean = ((cache.alpha.double() @ Kxs.double()).T * Bm[of]).sum(-1).reshape(*lead, P)
    V = torch.linalg.solve_triangular(cache.L, Kxs.expand(cache.L.shape[0], -1, -1), upper=False).double()
    VtV = torch.einsum("knbi,knbj->kbij", V.reshape(V.shape[0], -1, B, P), V.reshape(V.shape[0], -1, B, P))
    ob = of.reshape(B, P)
    Cb = C[:, ob]  # (D, B, P)
    p64, x64 = {name: v.double() for name, v in params.items()}, xcf.double()
    Kss = kron_continuous_gram(spec, p64, x64, x64).reshape(B, P, B, P).diagonal(dim1=0, dim2=2).permute(2, 0, 1)
    cov = Bm[ob[:, :, None], ob[:, None, :]] * Kss - torch.einsum("kbi,kbj,kbij->bij", Cb, Cb, VtV)
    prior = torch.diagonal(cache.B)[of] * kron_continuous_diag(spec, params, xcf)
    return mean, cov.reshape(*lead, P, P), prior.reshape(*lead, P)


def make_kron_sample_fn(spec, params, cache: KronCache, out_col_idx, jitter=DEFAULT_JITTER):
    """Joint-posterior sampler for a Kronecker model, from its Kronecker
    cache (:func:`_kron_joint_mean_cov`), in the ``sample_fn`` form the
    multi-output acquisitions take: the output index of each row is column
    ``out_col_idx`` of ``xk_joint``. Draws as :func:`_joint_samples`."""

    def sample_fn(xc_joint, xk_joint, base_samples, d_out, q, nb):
        out = xk_joint[..., out_col_idx].expand(xc_joint.shape[:-1])
        mean, cov, prior = _kron_joint_mean_cov(spec, params, cache, xc_joint, out)
        ys = joint_draws(mean, cov, prior.double(), jitter, eps=base_samples.double())
        return ys.to(xc_joint.dtype)

    return sample_fn


def _smooth_max(v, tau=1e-2, axis=-1):
    return tau * torch.logsumexp(v / tau, dim=axis)


def _softplus(x, beta=100.0):
    # jax.nn.softplus is logaddexp(x, 0), with no threshold
    return torch.logaddexp(beta * x, torch.zeros_like(x)) / beta


def _stack_joint(cand, base):
    """Candidate rows (..., n_c, c) and shared baseline rows (n_b, c) → (..., n_c + n_b, c)."""
    return torch.cat([cand, base.expand(*cand.shape[:-2], *base.shape)], dim=-2)


def _candidate_rows(xc_cand, xk_cand):
    """``xk_cand`` broadcast to ``xc_cand``'s leading batch axes."""
    return xk_cand.expand(*xc_cand.shape[:-1], xk_cand.shape[-1])


def qlog_nei(
    spec: GPSpec,
    params,
    cache: PosteriorCache,
    xc_cand,
    xk_cand,
    xc_base,
    xk_base,
    base_samples,
    maximize=True,
):
    """Smoothed log of q-Noisy Expected Improvement.

    Jointly samples candidates and baseline (so baseline noise is integrated
    out, as in qLogNEI), smooths the max/ReLU for gradient flow, and returns
    log E_s[improvement]. ``xc_cand`` (..., q, d) gives (...).
    """
    q = xc_cand.shape[-2]
    xc_joint = _stack_joint(xc_cand, xc_base)
    xk_joint = _stack_joint(_candidate_rows(xc_cand, xk_cand), xk_base)
    ys = _joint_samples(spec, params, cache, xc_joint, xk_joint, base_samples)
    if not maximize:
        ys = -ys
    cand = ys[..., :q]
    base = ys[..., q:]
    improvement = _softplus(_smooth_max(cand) - _smooth_max(base))  # (..., S)
    return torch.log(improvement.mean(-1) + 1e-25)


def _hv2d(points, ref):
    """Hypervolume (maximization) dominated by a 2-D point set over ``ref``.

    Sort by first objective descending; accumulate rectangles of the running
    maximum of the second objective. Dominated and below-reference points
    contribute zero automatically. ``points`` (..., n, 2) gives (...).
    """
    x = torch.maximum(points[..., 0], ref[0])
    y = torch.maximum(points[..., 1], ref[1])
    order = torch.argsort(-x, dim=-1, stable=True)
    xs = torch.gather(x, -1, order)
    ys = torch.gather(y, -1, order)
    # Running max of y over prefixes strictly before i → the "covered" height
    first = ref[1].expand(*ys.shape[:-1], 1)
    prev_cover = torch.cat([first, torch.cummax(ys, dim=-1).values[..., :-1]], dim=-1)
    heights = torch.clamp(ys - prev_cover, min=0.0)
    widths = xs - ref[0]
    return (widths * heights).sum(-1)


def _joint_rows(spec, params, cache, xc_cand, xk_cand_outputs, xc_base, xk_base_outputs, base_samples, d_out,
                sample_fn):
    """Joint posterior samples (..., S, P) of the output-major candidate and
    baseline rows, from the joint cache or from ``sample_fn``."""
    q = xc_cand.shape[-2] // d_out
    nb = xc_base.shape[-2] // d_out
    xc_joint = _stack_joint(xc_cand, xc_base)
    xk_joint = _stack_joint(_candidate_rows(xc_cand, xk_cand_outputs), xk_base_outputs)
    if sample_fn is None:
        return _joint_samples(spec, params, cache, xc_joint, xk_joint, base_samples), q, nb
    return sample_fn(xc_joint, xk_joint, base_samples, d_out, q, nb), q, nb


def qlog_nehvi_2d(
    spec: GPSpec,
    params,
    cache: PosteriorCache,
    xc_cand,
    xk_cand_outputs,
    xc_base,
    xk_base_outputs,
    base_samples,
    ref_point,
    maximize=True,
    sample_fn=None,
):
    """Smoothed log of q-Noisy Expected Hypervolume Improvement (2 outputs).

    Candidate/baseline points are evaluated jointly for both outputs (the
    ``xk_*_outputs`` arrays carry the output-coregion index per row). Each MC
    sample computes HV(base ∪ cand) − HV(base) exactly in 2-D.
    ``sample_fn`` (from :func:`make_indep_sample_fn`) overrides the joint
    posterior sampler for model-list (Independent) structures.
    """
    ys, q, nb = _joint_rows(spec, params, cache, xc_cand, xk_cand_outputs, xc_base, xk_base_outputs, base_samples,
                            2, sample_fn)
    if not maximize:
        ys = -ys
    ref = torch.as_tensor(ref_point, dtype=ys.dtype, device=ys.device)
    cand = torch.stack([ys[..., :q], ys[..., q : 2 * q]], dim=-1)  # (..., S, q, 2)
    base = torch.stack([ys[..., 2 * q : 2 * q + nb], ys[..., 2 * q + nb :]], dim=-1)  # (..., S, nb, 2)
    hv_base = _hv2d(base, ref)
    hv_joint = _hv2d(torch.cat([base, cand], dim=-2), ref)
    hvi = torch.clamp(hv_joint - hv_base, min=0.0)
    return torch.log(hvi.mean(-1) + 1e-25)


def hv_dominated_mc(points, ref, u_box):
    """QMC estimate of the hypervolume dominated by ``points`` above ``ref``.

    ``u_box``: (Q, D) fixed quasi-uniform points in [0, 1)^D, scaled into the
    [ref, max(points)] box; the estimate is vol(box) × fraction of box points
    dominated. Hard indicator: use for values and tests; the differentiable
    acquisition is :func:`qlog_nehvi_mc`.
    """
    ref = torch.as_tensor(ref, dtype=points.dtype, device=points.device)
    u_box = torch.as_tensor(u_box, dtype=points.dtype, device=points.device)
    upper = torch.maximum(points.max(0).values, ref)
    width = upper - ref
    U = ref[None, :] + u_box * width[None, :]  # (Q, D)
    dominated = (points[:, None, :] >= U[None, :, :]).all(-1).any(0)
    return torch.prod(width) * dominated.to(points.dtype).mean()


def qlog_nehvi_mc(
    spec: GPSpec,
    params,
    cache: PosteriorCache,
    xc_cand,
    xk_cand_outputs,
    xc_base,
    xk_base_outputs,
    base_samples,
    ref_point,
    u_box,
    d_out,
    maximize=True,
    tau=0.02,
    sample_fn=None,
):
    """Smoothed log qNEHVI for ANY number of outputs via QMC box integration.

    Per posterior sample:

        HVI = vol(box) · E_u[ 1{u not dominated by baseline} · s(u) ]

    where u ranges over fixed QMC points in the [ref, max] box, the baseline
    indicator is hard (exact — it carries no candidate gradient anyway), and
    s(u) is a smoothed candidate-dominance (product-sigmoid per dim,
    probabilistic-OR over the q batch). Row layout matches
    :func:`qlog_nehvi_2d`: candidates output-major (D_out × q rows) then
    baseline output-major (D_out × nb rows).
    """
    ys, q, nb = _joint_rows(spec, params, cache, xc_cand, xk_cand_outputs, xc_base, xk_base_outputs, base_samples,
                            d_out, sample_fn)
    if not maximize:
        ys = -ys
    ref = torch.as_tensor(ref_point, dtype=ys.dtype, device=ys.device)
    u_box = torch.as_tensor(u_box, dtype=ys.dtype, device=ys.device)
    lead = ys.shape[:-1]
    cand = ys[..., : d_out * q].reshape(*lead, d_out, q).transpose(-1, -2)  # (..., q, D)
    base = ys[..., d_out * q :].reshape(*lead, d_out, nb).transpose(-1, -2)  # (..., nb, D)
    upper = torch.maximum(torch.cat([cand, base], dim=-2).max(-2).values, ref + 1e-9)
    width = upper - ref
    U = ref + u_box * width[..., None, :]  # (..., Q, D)
    dom_base = (base[..., :, None, :] >= U[..., None, :, :]).all(-1).any(-2)  # (..., Q)
    t = tau * width + 1e-12
    s = torch.sigmoid((cand[..., :, None, :] - U[..., None, :, :]) / t[..., None, None, :])
    p_dom = torch.prod(s, dim=-1)  # (..., q, Q)
    soft_or = 1.0 - torch.prod(1.0 - p_dom, dim=-2)  # (..., Q)
    frac = torch.where(dom_base, 0.0, soft_or).mean(-1)
    hvi = torch.prod(width, dim=-1) * frac
    return torch.log(hvi.mean(-1) + 1e-25)


# ------------------------------------------------------------------
# Acquisition maximization: Sobol seeding → top-k → sigmoid-reparameterized
# multi-restart L-BFGS.
# ------------------------------------------------------------------


def _to_box(u, lo, hi):
    return lo + (hi - lo) * torch.sigmoid(u)


def _from_box(x, lo, hi):
    p = torch.clamp((x - lo) / (hi - lo), 1e-6, 1 - 1e-6)
    return torch.log(p) - torch.log1p(-p)


RAW_CHUNK = 16  # raw q-batches a call: bounds the (chunk·P)² Gram and qLogNEHVI-MC's (chunk, S, nb, Q, D) test


def raw_sweep(acq_fn, X_raw):
    """``acq_fn`` at every raw q-batch of ``X_raw`` (R, q, d) → (R,),
    ``RAW_CHUNK`` batches per call (the acquisitions take a leading batch
    axis)."""
    with torch.no_grad():
        return torch.cat([acq_fn(X_raw[s : s + RAW_CHUNK]) for s in range(0, X_raw.shape[0], RAW_CHUNK)])


def _maximize(acq_fn, X_raw, lo, hi, num_restarts, maxiter):
    """Raw sweep, top ``num_restarts`` by value, then L-BFGS restarts in
    sigmoid space. Returns (candidates (q, d), value, aux)."""
    raw_vals = raw_sweep(acq_fn, X_raw)
    top = torch.argsort(-raw_vals, stable=True)[:num_restarts]
    u0s = _from_box(X_raw[top], lo, hi)  # (R, q, d)

    def neg_acq_u(u):
        return -acq_fn(_to_box(u["u"], lo, hi))

    u_best, f_best, aux = multi_restart_minimize(neg_acq_u, {"u": u0s}, maxiter=maxiter)
    aux.update(raw_values=raw_vals, top=top)
    return _to_box(u_best["u"], lo, hi), -f_best, aux


def optimize_acqf(
    acq_fn,
    bounds,
    q=1,
    num_restarts=10,
    raw_samples=512,
    seed=0,
    maxiter=100,
    dtype=None,
    *,
    device=None,
    return_aux=False,
):
    """Maximize ``acq_fn(X)`` (X: (..., q, d) in natural box coords → (...))
    over the box ``bounds`` = (lo, hi).

    Seeds with scrambled-Sobol raw samples, evaluates them ``RAW_CHUNK``
    q-batches per call, takes the best ``num_restarts`` q-batches, then runs
    L-BFGS in sigmoid space from each. Runs on ``device`` (default:
    ``bounds[0]``'s if it is a tensor, else CUDA) at ``dtype`` (default:
    ``bounds[0]``'s if it is a tensor, else the model dtype there). Returns (candidates (q, d), acq_value); with
    ``return_aux`` also the restarts' aux dict (``raw_values``, ``top``,
    ``iters``, ``all_values``).
    """
    device = resolve_device(device, bounds[0])
    if dtype is None:
        dtype = bounds[0].dtype if isinstance(bounds[0], torch.Tensor) else default_model_dtype(device)
    lo = torch.as_tensor(bounds[0], dtype=dtype, device=device)
    hi = torch.as_tensor(bounds[1], dtype=dtype, device=device)
    d = lo.shape[0]
    raw = sobol_uniform(raw_samples * q, d, seed=seed).reshape(raw_samples, q, d)
    X_raw = torch.as_tensor(raw, dtype=dtype, device=device) * (hi - lo) + lo
    x, value, aux = _maximize(acq_fn, X_raw, lo, hi, num_restarts, maxiter)
    return (x, value, aux) if return_aux else (x, value)


def optimize_qlog_nei(
    spec,
    params,
    cache,
    xk_cand,
    xc_base,
    xk_base,
    base_samples,
    X_raw,
    lo,
    hi,
    num_restarts=10,
    maxiter=100,
    maximize=True,
    *,
    return_aux=False,
):
    """qLogNEI maximization from given raw starts ``X_raw`` (R, q, d) — the
    lab-loop path, taking model state and the Sobol raw starts as arguments
    (``GP.propose``'s single-output route). Returns (candidates (q, d),
    acq_value), with ``return_aux`` also the aux dict of :func:`optimize_acqf`.
    """

    def acq(Xc):
        return qlog_nei(spec, params, cache, Xc, xk_cand, xc_base, xk_base, base_samples, maximize=maximize)

    x, value, aux = _maximize(acq, X_raw, lo, hi, num_restarts, maxiter)
    return (x, value, aux) if return_aux else (x, value)
