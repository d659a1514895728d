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

Where each is planted is the model family's to say, in its module's
``FAULT_SITES``: ``objectives``, each a (module, attribute, wrapper) whose
wrapper hands the objective every other row and doubles it (``half_batch``
under the job loop); ``predictors``, each a (module, attribute) returning
(mean, var) (``altered``, and under the query loop ``unchanged`` and
``half_batch``); and optionally ``optimizers``, each a (module, attribute)
whose call is (fun, x0, ...) → (x, f, n) (``unchanged`` under the job loop;
by default ``OPTIMIZERS``, the optimizer every family shares). A fault whose
sites the family leaves out raises: planting nothing would pass for a sound
run.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

FAULTS = ("unchanged", "half_batch", "altered")
OPTIMIZERS = (("gumbi_tpu_torch.ops.optimize", "lbfgs_backtracking_minimize"),)


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


def half_rows(orig):
    def map_neg_logp(spec, u, xc, xk, y, *args, **kwargs):
        return 2.0 * orig(spec, u, xc[::2], xk[::2], y[::2], *args, **kwargs)

    return map_neg_logp


def half_locs(orig):
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


# (loop, fault) -> the role of the family's sites it is planted at, and the
# wrapper (None: each objective site gives its own).
ROLES = {("jobs", "unchanged"): ("optimizers", _stuck), ("jobs", "half_batch"): ("objectives", None),
         ("jobs", "altered"): ("predictors", _altered), ("queries", "unchanged"): ("predictors", _stale),
         ("queries", "half_batch"): ("predictors", _half_grid), ("queries", "altered"): ("predictors", _altered)}


def sites(fault, loop, family):
    """[(module, attribute, make)] where ``fault`` is planted under ``loop``
    for ``family`` (a family module); raises where the family names none."""
    if (loop, fault) not in ROLES:
        raise ValueError(f"unknown fault {fault!r} under loop {loop!r}; have {sorted(ROLES)}")
    role, make = ROLES[loop, fault]
    found = getattr(family, "FAULT_SITES", {}).get(role, OPTIMIZERS if role == "optimizers" else ())
    if not found:
        raise LookupError(f"family {family.__name__} names no {role} in FAULT_SITES, where {fault!r} is planted "
                          f"under the {loop} loop")
    return [(site[0], site[1], make or site[2]) for site in found]


@contextlib.contextmanager
def planted(fault, loop, family):
    """Plant ``fault`` for a run of ``loop`` ("jobs" or "queries") at the
    sites ``family`` names (``sites``)."""
    with contextlib.ExitStack() as stack:
        for module, name, make in sites(fault, loop, family):
            stack.enter_context(_swap(module, name, make))
        yield
