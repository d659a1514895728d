"""Full-Bayes latent GP classification: elliptical slice sampling + MH hypers.

Port of ``gumbi_tpu/ops/ess.py``: the joint (latent field, hyperparameter)
posterior of the classifier, sampled by

* **latents | hypers** — elliptical slice sampling (Murray, Adams & MacKay
  2010) on the whitened field ν (f = L ν, L = chol(K(θ))), whose
  bracket-shrink loop is one (N,) GEMV per trial;
* **hypers | latents** — random-walk Metropolis in unconstrained space on
  the whitened target log p(u) + log lik(L(u) ν), its step size adapted by
  Robbins-Monro toward the target acceptance during tuning.

How the reference's compiled program maps onto eager PyTorch:

* **Host loops for ``lax.scan``**: a Python loop of ``tune + draws``
  iterations; the chains advance together as a batch (the reference
  ``vmap``s them), with their C prior factors stacked into one batched
  factorization.
* **The shrink loop** (the reference's ``lax.while_loop``, vmapped) runs
  while any chain is unaccepted and holds the finished chains' state; it
  keeps the 200-trial cap. Each trial costs one host sync (the loop's
  condition); ``stats["host_syncs"]`` counts them, ``stats["ess_trials"]``
  the trials of every step.
* **Random streams**: a ``torch.Generator`` walked as the reference walks
  its key tree (:class:`~gumbi_tpu_torch.utils.torch_utils.TorchStream`);
  ``stream=`` replays another source of draws.
* **The prior factor's floor** (named divergence): K + floor·I with
  floor = max(jitter, N·eps·mean diag K). At f64 that is the reference's
  jitter. At f32 an ExpQuad K's spectrum falls below the rounding of its
  factorization (~N·eps·η²), so the reference's K + 1e-6·I does not factor:
  every slice trial then reads −inf until the cap, and every proposal is
  rejected. The same floor stands under :func:`latent_conditional_proba`.
"""

from __future__ import annotations

import math

import torch

from ..utils.torch_utils import TorchStream, default_model_dtype, ravel_tree, resolve_device
from .kernels import GPSpec, gram, gram_diag
from .linalg import cho_solve, cholesky_nan
from .mll import DEFAULT_JITTER
from .priors import constrain, log_prior_chains

__all__ = ["ess_gpc_sample", "bernoulli_loglik", "latent_conditional_proba"]

ESS_MAX_TRIALS = 200  # the reference's cap on one slice step's trials


def bernoulli_loglik(f, y, mask=None):
    """Σ log Bernoulli(y | sigmoid(f)) = Σ [y·f − softplus(f)] over the last
    axis (leading axes are chains).

    ``mask`` (0/1 per row) excludes bucket-padded rows: a masked row
    contributes zero likelihood, so its latent is sampled from the prior
    conditional — exactly the marginal the unpadded model would give.
    """
    ll = y * f - torch.logaddexp(f, torch.zeros_like(f))  # jax.nn.softplus: no threshold
    if mask is not None:
        ll = mask * ll
    return ll.sum(-1)


def _floored(K, jitter):
    """K + max(jitter, N·eps·mean diag K)·I over the last two axes."""
    n = K.shape[-1]
    floor = torch.clamp(n * torch.finfo(K.dtype).eps * torch.diagonal(K, dim1=-2, dim2=-1).mean(-1), min=jitter)
    return K + floor[..., None, None] * torch.eye(n, dtype=K.dtype, device=K.device)


def _chol_K(spec: GPSpec, uparams, xc, xk, jitter):
    """The prior factors chol(K(θ) + floor·I) of C points (tensors with a
    leading chain axis): one Gram call each, one batched factorization,
    (C, N, N); NaN where one does not factor."""
    params = constrain(uparams)
    c = next(iter(params.values())).shape[0]
    K = torch.stack([gram(spec, {k: v[i] for k, v in params.items()}, xc, xk, xc, xk) for i in range(c)])
    return cholesky_nan(_floored(K, jitter))


def _matvec(L, v):
    return (L @ v[..., None])[..., 0]


def _ess_step(key, nu, L, y, loglik, counts=None):
    """One elliptical-slice update of the whitened latents ν given L.

    ``nu`` (..., N) and ``L`` (..., N, N) may carry a leading chain axis,
    with ``key`` a stream of that batch shape. The ellipse
    ν' = ν cos ε + z sin ε preserves the prior exactly, so the slice
    condition involves only the likelihood. ``counts``, when given, is a
    dict whose ``trials`` receives the per-chain trial count and whose
    ``syncs`` is raised by the host syncs of the shrink loop.
    """
    k1, k2, k3, k4 = key.split(4)
    z = k1.normal(nu.shape[-1:])

    def safe_loglik(f):
        # NaN from a non-finite L (non-PD gram at this state) must read as
        # -inf: NaN comparisons are all-False, which would otherwise make
        # the shrink loop run to its cap for no reason.
        v = loglik(f, y)
        return torch.where(torch.isfinite(v), v, -torch.inf)

    log_y = safe_loglik(_matvec(L, nu)) + torch.log(k2.uniform())
    theta = k3.uniform() * (2.0 * math.pi)
    lo, hi = theta - 2.0 * math.pi, theta

    def proposal(t):
        return nu * torch.cos(t)[..., None] + z * torch.sin(t)[..., None]

    t, key = theta, k4
    accepted = torch.zeros_like(theta, dtype=torch.bool)
    trials = torch.zeros_like(theta, dtype=torch.long)
    active = torch.ones_like(accepted)
    syncs = 0
    # First trial at the initial angle, then shrink until accepted. The
    # bracket always contains t = 0, where the proposal is the current state
    # and passes the slice — except when the likelihood is -inf everywhere
    # (non-finite L): the cap then ends the loop, and t = 0 keeps the state.
    while True:
        ok = safe_loglik(_matvec(L, proposal(t))) > log_y
        # On rejection, shrink the bracket toward 0 and redraw the angle.
        lo_n = torch.where(ok | (t >= 0), lo, t)
        hi_n = torch.where(ok | (t < 0), hi, t)
        key, sub = key.split(2)
        t_new = sub.uniform() * (hi_n - lo_n) + lo_n
        # finished chains hold their state, as under the reference's vmap
        t = torch.where(active, torch.where(ok, t, t_new), t)
        lo, hi = torch.where(active, lo_n, lo), torch.where(active, hi_n, hi)
        accepted = torch.where(active, ok, accepted)
        trials = trials + active.long()
        active = ~accepted & (trials < ESS_MAX_TRIALS)
        syncs += 1
        if not bool(active.any()):
            break
    if counts is not None:
        counts["trials"] = trials
        counts["syncs"] = counts.get("syncs", 0) + syncs
    t = torch.where(accepted, t, torch.zeros_like(t))
    return proposal(t)


def ess_gpc_sample(
    spec: GPSpec,
    u0,
    xc,
    xk,
    y,
    ls_alpha,
    ls_beta,
    generator=None,
    draws=500,
    tune=500,
    chains=2,
    ess_sweeps=4,
    target_accept=0.3,
    jitter=DEFAULT_JITTER,
    mask=None,
    *,
    stream=None,
    device=None,
):
    """Sample the joint (latents, hyperparameters) posterior of the GPC.

    ``u0``: dict of unconstrained starting hyperparameters. Returns
    ``(usamples, f_samples, stats)``: unconstrained hyperparameter draws with
    leading (chains, draws) axes, latent function values at the training
    points f = L ν with shape (chains, draws, N), and diagnostics: the
    reference's ``accept_rate`` and ``step_size`` per chain, and
    ``ess_trials`` (chains, tune + draws, ess_sweeps) and ``host_syncs``.
    Runs on ``device`` (default: ``xc``'s if it is a tensor, else CUDA) at
    ``xc``'s dtype (the model dtype there for arrays); draws come from
    ``generator`` or ``stream``.
    """
    if not isinstance(u0, dict):
        raise TypeError("u0 must be a dict of arrays")
    device = resolve_device(device, xc)
    dtype = xc.dtype if isinstance(xc, torch.Tensor) else default_model_dtype(device)
    on = lambda a: None if a is None else torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    xc, y, ls_alpha, ls_beta, mask = (on(a) for a in (xc, y, ls_alpha, ls_beta, mask))
    xk = torch.as_tensor(xk, dtype=torch.long, device=device)
    u0_flat, unravel = ravel_tree({k: on(v) for k, v in u0.items()})
    n, d_hyp = y.shape[0], u0_flat.shape[0]
    key = TorchStream(generator, dtype, device) if stream is None else stream

    def loglik(f, y):
        return bernoulli_loglik(f, y, mask)

    def target_with_L(u, nu, L):
        """Whitened conditional target at an already-factorized state
        (NaN → -inf so non-PD proposals are always rejected)."""
        val = log_prior_chains(spec, unravel(u), ls_alpha, ls_beta) + loglik(_matvec(L, nu), y)
        return torch.where(torch.isfinite(val), val, -torch.inf)

    keys = key.split_chains(chains)
    u = u0_flat.expand(chains, d_hyp) + 0.05 * key.fold_in(7).normal((chains, d_hyp))
    keys, k_nu = keys.split(2)
    nu = k_nu.normal((n,))
    L = _chol_K(spec, unravel(u), xc, xk, jitter)
    log_step = torch.full((chains,), -1.0, dtype=dtype, device=device)

    us, fs, accepts, trials = [], [], [], []
    counts = {"syncs": 0}
    with torch.no_grad():
        for it in range(tune + draws):
            # --- latent sweeps (ESS, exact conditional) ---
            keys, *ks = keys.split(ess_sweeps + 1)
            step_trials = []
            for k in ks:
                nu = _ess_step(k, nu, L, y, loglik, counts)
                step_trials.append(counts["trials"])
            trials.append(torch.stack(step_trials, dim=-1))

            # --- hyper move (random-walk MH on the whitened target) ---
            # The current state's factor L is carried: only the proposal
            # pays an O(N³) factorization a step.
            t_cur = target_with_L(u, nu, L)
            keys, k_prop, k_acc = keys.split(3)
            u_prop = u + torch.exp(log_step)[:, None] * k_prop.normal((d_hyp,))
            L_prop = _chol_K(spec, unravel(u_prop), xc, xk, jitter)
            t_prop = target_with_L(u_prop, nu, L_prop)
            # -inf − -inf = NaN would poison the step size and every later
            # proposal; treat it as a rejection.
            log_alpha = t_prop - t_cur
            log_alpha = torch.where(torch.isnan(log_alpha), -torch.inf, log_alpha)
            accept_prob = torch.exp(torch.clamp(log_alpha, max=0.0))
            ok = torch.log(k_acc.uniform()) < log_alpha
            u = torch.where(ok[:, None], u_prop, u)
            L = torch.where(ok[:, None, None], L_prop, L)

            # Robbins-Monro step-size adaptation during tuning only
            if it < tune:
                log_step = log_step + (1.0 / math.sqrt(1.0 + it)) * (accept_prob - target_accept)
            else:
                us.append(u)
                fs.append(_matvec(L, nu))
                accepts.append(accept_prob)

    stack = lambda xs, shape: torch.stack(xs, dim=1) if xs else torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
    accept = stack(accepts, (chains, 0))
    stats = {
        "accept_rate": accept.mean(1),
        "step_size": torch.exp(log_step),
        "ess_trials": stack(trials, (chains, 0, ess_sweeps)),
        "host_syncs": counts["syncs"],
    }
    return unravel(stack(us, (chains, 0, d_hyp))), stack(fs, (chains, 0, n)), stats


def latent_conditional_proba(spec: GPSpec, params_stack, f_stack, xc, xk, xc_new, xk_new, jitter=DEFAULT_JITTER):
    """P(y=1 | x*) integrated over joint (θ, f) posterior draws.

    For each draw i: condition the GP at θᵢ on the sampled latent values fᵢ
    (the exact Gaussian conditional) and push the marginal (μ*, σ*²) through
    the probit approximation to the logistic-Gaussian integral; the average
    over draws is the full-Bayes class probability.

    ``params_stack``: dict of natural-space parameter tensors with a leading
    draw axis; ``f_stack``: (S, N) latent draws. Returns (M,) averaged
    probabilities. Each draw pays one N×N factorization, with the floor of
    :func:`ess_gpc_sample`, in a host loop over the draws (the reference's
    ``lax.scan``).
    """
    probs = 0.0
    S = f_stack.shape[0]
    for i in range(S):
        params = {k: v[i] for k, v in params_stack.items()}
        L = cholesky_nan(_floored(gram(spec, params, xc, xk, xc, xk), jitter))
        alpha = cho_solve(L, f_stack[i][:, None])[:, 0]
        Ks = gram(spec, params, xc_new, xk_new, xc, xk)  # (M, N)
        mean = Ks @ alpha
        V = torch.linalg.solve_triangular(L, Ks.T, upper=False)
        var = torch.clamp(gram_diag(spec, params, xc_new, xk_new) - (V * V).sum(0), min=0.0)
        # Probit approximation: E[sigmoid(f*)] ≈ sigmoid(μ/√(1 + πσ²/8))
        probs = probs + torch.sigmoid(mean / torch.sqrt(1.0 + math.pi * var / 8.0))
    return probs / S
