"""Faults planted beneath the timed path, for the checks' own tests and for
the readings that set each limit's upper end (``tools/readings.py``).

Each is a context manager that swaps one of the port's functions for a
broken one and puts it back on the way out:

* ``unchanged``: every L-BFGS run returns its start (a step that returns
  its state unchanged); for queries, every answer is the first one again;
* ``half_batch``: the objective sees every other row and doubles (half of
  the batch left out, the mean taken over the rest); for queries, every
  other grid point's answer is its neighbour's;
* ``altered``: one grid point's answer is altered where it is produced,
  its mean moved by 0.1 (one noise deviation) and its variance doubled.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def _swap(module, name, make):
    mod = importlib.import_module(module)
    orig = getattr(mod, name)
    setattr(mod, name, make(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def _stuck(orig):
    def lbfgs(fun, x0, *args, **kwargs):
        x = {k: v.detach() for k, v in x0.items()}
        with torch.no_grad():
            f = float(fun(x))
        return x, torch.tensor(f, dtype=torch.float64), 0

    return lbfgs


def _stale(orig):
    first = []

    def predict(*args, **kwargs):
        if not first:
            first.append(orig(*args, **kwargs))
        return first[0]

    return predict


def _half_rows(orig):
    def map_neg_logp(spec, u, xc, xk, y, *args, **kwargs):
        return 2.0 * orig(spec, u, xc[::2], xk[::2], y[::2], *args, **kwargs)

    return map_neg_logp


def _half_locs(orig):
    def kron_neg_logp(spec, u, xc, Y, *args, **kwargs):
        return 2.0 * orig(spec, u, xc[::2], Y[::2], *args, **kwargs)

    return kron_neg_logp


def _half_grid(orig):
    def predict(*args, **kwargs):
        mean, var = orig(*args, **kwargs)
        mean, var = mean.clone(), var.clone()
        mean[..., 1::2] = mean[..., 0::2][..., : mean[..., 1::2].shape[-1]]
        var[..., 1::2] = var[..., 0::2][..., : var[..., 1::2].shape[-1]]
        return mean, var

    return predict


def _altered(orig):
    def predict(*args, **kwargs):
        mean, var = orig(*args, **kwargs)
        mean, var = mean.clone(), var.clone()
        i = mean.shape[-1] // 2
        mean[..., i] += 0.1
        var[..., i] *= 2.0
        return mean, var

    return predict


@contextlib.contextmanager
def planted(fault, loop):
    """Plant ``fault`` for a run of ``loop`` ("jobs" or "queries")."""
    post, kron = "gumbi_tpu_torch.ops.posterior", "gumbi_tpu_torch.ops.kronecker"
    with contextlib.ExitStack() as stack:
        if fault == "unchanged" and loop == "jobs":
            stack.enter_context(_swap("gumbi_tpu_torch.ops.optimize", "lbfgs_backtracking_minimize", _stuck))
        elif fault == "unchanged":
            stack.enter_context(_swap(post, "predict_diag_chunked", _stale))
        elif fault == "half_batch" and loop == "jobs":
            stack.enter_context(_swap("gumbi_tpu_torch.ops.mll", "map_neg_logp", _half_rows))
            stack.enter_context(_swap(kron, "kron_neg_logp", _half_locs))
        elif fault == "half_batch":
            stack.enter_context(_swap(post, "predict_diag_chunked", _half_grid))
        elif fault == "altered":
            stack.enter_context(_swap(post, "predict_diag_chunked", _altered))
            stack.enter_context(_swap(kron, "kron_predict_diag", _altered))
        else:
            raise ValueError(f"unknown fault {fault!r}; have {FAULTS}")
        yield
