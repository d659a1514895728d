"""Full-Bayes hyperparameter sampling: adaptive HMC and ChEES-HMC.

Port of ``gumbi_tpu/ops/hmc.py``. Two samplers, one contract (a samples
dict with leading (chains, draws) axes and a stats dict):

* :func:`hmc_sample` — HMC with dual-averaging step size, diagonal
  (Welford) mass adaptation during warmup, a downward-jittered step size
  and a fixed ``n_leapfrog``;
* :func:`chees_sample` — ChEES-HMC (Hoffman, Radul & Sountsov, AISTATS
  2021): the trajectory length is learned during warmup by Adam on the
  cross-chain ChEES criterion; step size and mass adapt as above.

How the reference's compiled program maps onto eager PyTorch:

* **Host loops for ``lax.scan``.** A chain is a Python loop of
  ``tune + draws`` iterations, and a trajectory a loop of leapfrog steps.
  ChEES's leapfrog count is data-dependent, so each ChEES iteration reads
  it on the host once (one sync an iteration).
* **Chains in lockstep, batched.** Where the reference ``vmap``s chains,
  all chains here advance together as (chains, dim) tensors, and each
  leapfrog step makes one value+grad call for all chains. ``logp_fn`` is
  either the reference's per-point contract (dict → scalar; the chains are
  then evaluated one after another inside that call) or, with
  ``chain_batched=True``, a dict whose tensors carry a leading chain axis →
  (chains,) values (e.g. ``-mll.map_neg_logp_chains``), from which one
  autograd pass gives the (chains, dim) gradient.
* **One gradient a leapfrog step.** Each step's closing gradient opens the
  next, and the trajectory's last value and gradient are the next
  iteration's current ones, where the reference evaluates twice a step:
  the same numbers, half the evaluations.
* **Two named divergences, both where the reference breaks.** A
  non-finite proposal (a trajectory that leaves the density's finite
  region, as f32 factorizations can) is rejected in both packages; ChEES
  here also keeps it out of its cross-chain criterion, where the
  reference's 0·NaN turns log T into NaN. And HMC keeps unit mass where a
  chain's Welford variance is exactly 0, where the reference's chain stops
  for good.
* **Random streams.** Draws come from a ``torch.Generator``, through a
  :class:`~gumbi_tpu_torch.utils.torch_utils.TorchStream` that is walked as
  the reference walks its JAX key tree; ``stream=`` takes any object with
  that interface, which lets the parity tests replay JAX's own draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.torch_utils import TorchStream, ravel_tree, resolve_device

__all__ = ["hmc_sample", "chees_sample"]


class _DAState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor


def _da_update(state, accept_prob, t, target_accept):
    # Nesterov dual averaging (Hoffman & Gelman 2014, eq. 6)
    t = t + 1.0
    kappa, gamma, t0 = 0.75, 0.05, 10.0
    h_bar = (1.0 - 1.0 / (t + t0)) * state.h_bar + (target_accept - accept_prob) / (t + t0)
    log_eps = state.mu - math.sqrt(t) / gamma * h_bar
    w = t ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * state.log_eps_bar
    return _DAState(log_eps, log_eps_bar, h_bar, state.mu)


def _leapfrog(vg_fn, q, p, eps, inv_mass, n_steps, vg0=None):
    """``n_steps`` leapfrog steps from (q, p). ``vg_fn(q)`` → (value, grad)
    of the log density; ``vg0`` is its value at ``q`` when known. Returns
    (q, p, value, grad) at the end, one evaluation a step."""
    v, g = vg_fn(q) if vg0 is None else vg0
    for _ in range(int(n_steps)):
        p = p + 0.5 * eps * g
        q = q + eps * inv_mass * p
        v, g = vg_fn(q)
        p = p + 0.5 * eps * g
    return q, p, v, g


def _chain_value_and_grad(logp_fn, unravel, chain_batched):
    """(values (C,), grads (C, dim)) of the log density at flat points (C, dim)."""

    def vg(q):
        with torch.enable_grad():
            leaf = q.detach().requires_grad_(True)
            tree = unravel(leaf)
            if chain_batched:
                v = logp_fn(tree)
            else:
                v = torch.stack([logp_fn({k: t[c] for k, t in tree.items()}) for c in range(leaf.shape[0])])
            (g,) = torch.autograd.grad(v.sum(), leaf)
        return v.detach(), g

    return vg


def _setup(q0, generator, stream):
    q0_flat, unravel = ravel_tree(q0)
    q0_flat = q0_flat.detach()
    if stream is None:
        stream = TorchStream(generator, q0_flat.dtype, resolve_device(None, q0_flat))
    return q0_flat, unravel, stream


def _reject_non_finite(log_accept):
    return torch.where(torch.isfinite(log_accept), log_accept, -torch.inf)


def hmc_sample(
    logp_fn,
    q0,
    generator=None,
    draws=500,
    tune=500,
    n_leapfrog=32,
    target_accept=0.8,
    chains=2,
    jitter=0.2,
    *,
    stream=None,
    chain_batched=False,
):
    """Sample from exp(logp_fn) starting at the parameter dict ``q0``.

    Returns (samples dict with leading (chains, draws) axes, stats dict).
    Chains are independent, as in the reference; they advance together.
    Runs on ``q0``'s device. Draws come from ``generator`` (a
    ``torch.Generator`` on that device), or from ``stream``.
    """
    q0_flat, unravel, key = _setup(q0, generator, stream)
    dim, dtype, dev = q0_flat.shape[0], q0_flat.dtype, q0_flat.device
    vg = _chain_value_and_grad(logp_fn, unravel, chain_batched)

    keys = key.split_chains(chains)
    q = q0_flat.expand(chains, dim) + 0.01 * key.fold_in(1).normal((chains, dim))

    # Crude initial step size from dimension
    eps0 = torch.full((chains,), 0.1 / dim**0.25, dtype=dtype, device=dev)
    zero = torch.zeros((chains,), dtype=dtype, device=dev)
    da = _DAState(log_eps=torch.log(eps0), log_eps_bar=zero, h_bar=zero, mu=torch.log(10.0 * eps0))
    mean, m2, count = torch.zeros((chains, dim), dtype=dtype, device=dev), torch.zeros_like(q), 0.0
    cur = vg(q)
    qs, accept_probs = [], []
    t = 0.0
    for it in range(tune + draws):
        tuning = it < tune
        if it == tune:
            t = 0.0
        keys, k1, k2, k3 = keys.split(4)
        # A chain rejected on warmup steps 2 and 3 has m2 = 0 (Welford's first
        # sample sets it to 0): unit mass there, where the reference's zero
        # inverse mass makes the momentum infinite and the chain never moves
        # again (a named divergence; equal wherever the estimate is positive).
        var_est = m2 / max(count - 1.0, 1.0)
        inv_mass = torch.where(var_est > 0, var_est, 1.0) if count > 2 else torch.ones_like(q)
        mass_sqrt = 1.0 / torch.sqrt(inv_mass)

        eps = torch.exp(da.log_eps if tuning else da.log_eps_bar)
        # Downward-only jitter: decorrelates trajectory lengths without the
        # acceptance collapse a symmetric jitter causes.
        eps = eps * (1.0 - jitter * k3.uniform())

        p = k1.normal((dim,)) * mass_sqrt
        current_h = cur[0] - 0.5 * (p * p * inv_mass).sum(-1)
        q_new, p_new, v_new, g_new = _leapfrog(vg, q, p, eps[:, None], inv_mass, n_leapfrog, cur)
        new_h = v_new - 0.5 * (p_new * p_new * inv_mass).sum(-1)

        log_accept = _reject_non_finite(torch.clamp(new_h - current_h, max=0.0))
        accept = torch.log(k2.uniform()) < log_accept
        q = torch.where(accept[:, None], q_new, q)
        cur = (torch.where(accept, v_new, cur[0]), torch.where(accept[:, None], g_new, cur[1]))
        accept_prob = torch.exp(log_accept)

        if tuning:
            da = _da_update(da, accept_prob, t, target_accept)
            # Welford mass update during tuning only
            count = count + 1.0
            delta = q - mean
            mean = mean + delta / count
            m2 = m2 + delta * (q - mean)
        else:
            qs.append(q)
            accept_probs.append(accept_prob)
        t += 1.0

    accept_probs = torch.stack(accept_probs, dim=1) if draws else torch.zeros((chains, 0), dtype=dtype, device=dev)
    samples = unravel(torch.stack(qs, dim=1) if draws else q.new_zeros((chains, 0, dim)))
    return samples, {"accept_prob": accept_probs, "mean_accept": accept_probs.mean()}


def _halton2(n: int) -> np.ndarray:
    """Van der Corput base-2 sequence, entries in (0, 1): low-discrepancy
    trajectory jitter (ChEES paper §4)."""
    out = np.empty(n)
    for i in range(n):
        x, f, k = 0.0, 0.5, i + 1
        while k:
            x += f * (k & 1)
            k >>= 1
            f *= 0.5
        out[i] = x
    return out


def chees_sample(
    logp_fn,
    q0,
    generator=None,
    draws=500,
    tune=500,
    chains=16,
    target_accept=0.75,
    max_leapfrog=256,
    adam_lr=0.025,
    *,
    stream=None,
    chain_batched=False,
):
    """ChEES-HMC: HMC whose trajectory length adapts itself during warmup.

    Same contract as :func:`hmc_sample`, with no ``n_leapfrog`` knob: the
    total integration time T maximizes the ChEES criterion, the variance of
    the change in squared distance from the cross-chain mean. Per iteration
    every chain integrates for ``h_t·T`` (``h_t`` a Halton point); the
    criterion's gradient

        dChEES/dT ∝ E[ α · (‖q̃'−μ̃'‖² − ‖q̃−μ̃‖²) · (q̃'−μ̃')·ṽ' ]

    (whitened by the adapted diagonal mass, α the MH acceptance, ṽ' the
    final whitened velocity) is averaged over chains and fed to Adam on
    log T. Step size adapts by dual averaging on the cross-chain mean
    acceptance, the diagonal mass by batched Welford. All chains share ε,
    T and the leapfrog count, read on the host once an iteration.

    Stats: the reference's (``accept_prob``, ``mean_accept``,
    ``trajectory_length``, ``step_size``, ``mean_leapfrog``) and
    ``n_leapfrog``, the leapfrog count of every iteration, warmup included.
    """
    q0_flat, unravel, key = _setup(q0, generator, stream)
    dim, dtype, dev = q0_flat.shape[0], q0_flat.dtype, q0_flat.device
    vg = _chain_value_and_grad(logp_fn, unravel, chain_batched)
    scalar = lambda v: torch.tensor(v, dtype=dtype, device=dev)  # noqa: E731

    hs = torch.as_tensor(_halton2(tune + draws), dtype=dtype, device=dev)
    eps0 = 0.1 / dim**0.25
    da = _DAState(log_eps=scalar(np.log(eps0)), log_eps_bar=scalar(0.0), h_bar=scalar(0.0),
                  mu=scalar(np.log(10.0 * eps0)))
    # log T (T₀ = 1 in whitened time), Adam's m, v and step, the averaged log T
    log_T, m_adam, v_adam, t_adam, log_T_bar = (scalar(0.0) for _ in range(5))
    mean, m2, count = torch.zeros(dim, dtype=dtype, device=dev), torch.zeros(dim, dtype=dtype, device=dev), 0.0
    qs = q0_flat.expand(chains, dim) + 0.01 * key.fold_in(1).normal((chains, dim))
    cur = vg(qs)

    out_q, out_accept, n_leaps = [], [], []
    t = 0.0
    for it in range(tune + draws):
        tuning = it < tune
        if it == tune:
            # freeze: averaged step size, averaged log T, final mass
            log_T, t = log_T_bar, 0.0
        h_t = hs[it]
        key, k_mom, k_acc = key.split(3)

        inv_mass = m2 / max(count - 1.0, 1.0) if count > 2.0 else torch.ones(dim, dtype=dtype, device=dev)
        mass_sqrt = 1.0 / torch.sqrt(inv_mass)
        white = torch.sqrt(inv_mass)  # q̃ = q·s whitens by the posterior scale

        eps = torch.exp(da.log_eps if tuning else da.log_eps_bar)
        tau = h_t * torch.exp(log_T)
        n_leap = int(torch.clamp(torch.ceil(tau / eps), 1, max_leapfrog))  # the iteration's one host read
        n_leaps.append(n_leap)

        p = k_mom.normal((chains, dim)) * mass_sqrt
        h_cur = cur[0] - 0.5 * (p * p * inv_mass).sum(1)
        q_new, p_new, v_new, g_new = _leapfrog(vg, qs, p, eps, inv_mass, n_leap, cur)
        h_new = v_new - 0.5 * (p_new * p_new * inv_mass).sum(1)

        log_accept = _reject_non_finite(torch.clamp(h_new - h_cur, max=0.0))
        accept = torch.log(k_acc.uniform((chains,))) < log_accept
        accept_prob = torch.exp(log_accept)
        qs_out = torch.where(accept[:, None], q_new, qs)
        cur = (torch.where(accept, v_new, cur[0]), torch.where(accept[:, None], g_new, cur[1]))

        if tuning:
            # ChEES gradient in the whitened space, acceptance-weighted. A
            # non-finite proposal (the trajectory left the density's finite
            # region; acceptance 0) enters the statistics as the chain's
            # current state: in the reference its 0·NaN makes log T NaN.
            finite = (torch.isfinite(q_new) & torch.isfinite(p_new)).all(1, keepdim=True)
            q_new, p_new = torch.where(finite, q_new, qs), torch.where(finite, p_new, p)
            qw, qw_new = qs * white, q_new * white
            d_new, d_old = qw_new - qw_new.mean(0), qw - qw.mean(0)
            delta_sq = (d_new * d_new).sum(1) - (d_old * d_old).sum(1)
            v_white = (inv_mass * p_new) / white  # dq̃/dt = M⁻¹p · s
            proj = (d_new * v_white).sum(1)
            w_sum = torch.clamp(accept_prob.sum(), min=1e-12)
            g_chees = h_t * (accept_prob * delta_sq * proj).sum() / w_sum

            # Adam ascent on log T, plus an iterate average that smooths the
            # last noisy steps into the frozen sampling value.
            t_adam = t_adam + 1.0
            m_adam = 0.9 * m_adam + 0.1 * g_chees
            v_adam = 0.95 * v_adam + 0.05 * g_chees**2
            m_hat = m_adam / (1.0 - 0.9**t_adam)
            v_hat = v_adam / (1.0 - 0.95**t_adam)
            log_T = log_T + adam_lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
            # keep T integrable: at least one step, at most the leapfrog cap
            log_T = torch.minimum(torch.maximum(log_T, torch.log(eps)), torch.log(eps * max_leapfrog))
            w_avg = t_adam ** (-0.75)
            log_T_bar = w_avg * log_T + (1.0 - w_avg) * log_T_bar

            da = _da_update(da, accept_prob.mean(), t, target_accept)

            # Batched Welford across the chain batch (warmup only)
            b_mean = qs_out.mean(0)
            b_m2 = ((qs_out - b_mean) ** 2).sum(0)
            dlt = b_mean - mean
            tot = count + chains
            mean, m2, count = mean + dlt * chains / tot, m2 + b_m2 + dlt**2 * count * chains / tot, tot
        else:
            out_q.append(qs_out)
            out_accept.append(accept_prob)
        qs = qs_out
        t += 1.0

    qs_draws = torch.stack(out_q, dim=1) if draws else qs.new_zeros((chains, 0, dim))
    accept_probs = torch.stack(out_accept, dim=1) if draws else qs.new_zeros((chains, 0))
    drawn_leaps = torch.as_tensor(n_leaps[tune:], dtype=dtype)
    stats = {
        "accept_prob": accept_probs,
        "mean_accept": accept_probs.mean(),
        "trajectory_length": torch.exp(log_T),
        "step_size": torch.exp(da.log_eps_bar),
        "mean_leapfrog": drawn_leaps.mean(),
        "n_leapfrog": np.asarray(n_leaps),
    }
    return unravel(qs_draws), stats
