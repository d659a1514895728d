"""What a configuration brings in files of its own, checked for every cell:
its family's fault sites and CPU sizes, its loop's CPU sizes, and the table
inputs its reference reads (``INPUTS``)."""

import importlib
import types

import numpy as np
import pytest
import torch

from portbench.harness import core, faults, frozen
from portbench.reference import common, dense_exact, lmc_kron

BENCH = core.load_benchmark()
CELLS = BENCH["workloads"]
IDS = [w["name"] for w in CELLS]


def family_and_loop(cell):
    cfg = core.load_config(BENCH, cell["config"])
    mix = core.load_traffic(cell["traffic"])
    return cfg, mix, core.load_family(cfg["family"]), core.load_loop(mix["loop"])


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_family_names_a_port_site_for_every_fault(cell, fault):
    _, mix, family, _ = family_and_loop(cell)
    found = faults.sites(fault, mix["loop"], family)
    assert found
    for module, name, make in found:
        assert module.split(".")[0] == "gumbi_tpu_torch", module
        assert callable(getattr(importlib.import_module(module), name)), (module, name)
        assert callable(make)


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_planted_swaps_the_family_s_sites_and_puts_them_back(cell, fault):
    _, mix, family, _ = family_and_loop(cell)
    found = faults.sites(fault, mix["loop"], family)
    before = [getattr(importlib.import_module(m), n) for m, n, _ in found]
    with faults.planted(fault, mix["loop"], family):
        assert all(getattr(importlib.import_module(m), n) is not f for (m, n, _), f in zip(found, before))
    assert [getattr(importlib.import_module(m), n) for m, n, _ in found] == before


@pytest.mark.parametrize("fault,loop,sites", [
    ("half_batch", "jobs", dict(predictors=(("gumbi_tpu_torch.ops.posterior", "predict_diag_chunked"),))),
    ("altered", "jobs", dict(objectives=(("gumbi_tpu_torch.ops.mll", "map_neg_logp", faults.half_rows),))),
    ("altered", "queries", {}),
    ("unchanged", "queries", {}),
    ("half_batch", "queries", {}),
    ("unchanged", "jobs", dict(optimizers=())),
])
def test_planted_raises_where_the_family_names_no_site(fault, loop, sites):
    family = types.SimpleNamespace(__name__="bare", FAULT_SITES=sites)
    with pytest.raises(LookupError, match="names no"):
        with faults.planted(fault, loop, family):
            pass


def test_planted_refuses_an_unknown_fault_or_loop():
    family = core.load_family("dense_exact")
    for fault, loop in (("frozen", "jobs"), ("altered", "stream")):
        with pytest.raises(ValueError, match="unknown fault"):
            with faults.planted(fault, loop, family):
                pass


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_family_and_loop_shrink_only_keys_their_files_have(cell):
    cfg, mix, family, loop = family_and_loop(cell)
    assert family.TINY and set(family.TINY) <= set(cfg), set(family.TINY) - set(cfg)
    assert loop.TINY and set(loop.TINY) <= set(mix), set(loop.TINY) - set(mix)


def dense_case(rng):
    tab = frozen.dense_table(rng, 64, 16, 32)
    return dict(X=tab["X"], y=tab["y"], la=tab["la"], lb=tab["lb"])


def lmc_case(rng):
    tab = frozen.lmc_table(rng, 48, 12, 24, 32)
    return dict(X=tab["X"], Y=tab["Y"], la=tab["la"], lb=tab["lb"])


@pytest.mark.parametrize("products", ["exact", "tf32"])
@pytest.mark.parametrize("model,case", [(dense_exact, dense_case), (lmc_kron, lmc_case)], ids=["dense", "lmc"])
def test_readings_equal_a_direct_call_with_x_then_the_target(model, case, products):
    """``common`` passes ``("X",)`` by default: its numbers are those of
    ``neg_logp(X, y, ...)`` and ``Posterior(X, y, ...)`` called directly."""
    rng = np.random.default_rng(2**31 + 17)
    table = dict(case(rng), device="cpu")
    u_np = {k: rng.normal(0.0, 0.3, s) for k, s in model.SHAPES.items()}
    out = dict(u=u_np, f=1.0, grid=frozen.grid_points(5))
    got = common.readings(model, table, out, products)

    dtype = torch.float64 if products == "exact" else torch.float32
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    X, y, la, lb = (t(table[k]) for k in ("X", model.TARGET, "la", "lb"))
    u = {k: t(v) for k, v in u_np.items()}
    with common.precision(products):
        f = float(model.neg_logp(X, y, u, la, lb, products))
        mean, var = model.Posterior(X, y, u, products).predict(t(out["grid"]))
        q_mean, q_var = common.posterior(model, table, u_np, products).predict(t(out["grid"]))
    assert got["f"] == f and got["rows"] == model.rows(X)
    assert torch.equal(got["mean"], mean.double()) and torch.equal(got["var"], var.double())
    assert torch.equal(q_mean, mean) and torch.equal(q_var, var)
    if products == "exact":
        u64 = common.flat(model, u)
        gap = common.refine_gap(lambda x: model.neg_logp(X, y, common.unflat(model, x), la, lb), u64, 6, 10)
        assert common.map_gap(model, table, out) == gap / model.rows(X)


def test_a_reference_s_inputs_come_before_its_target():
    """A reference that declares ``INPUTS`` gets those table keys, in order,
    then its target, in the objective, the posterior and ``rows``."""
    seen = []

    class Posterior:
        def __init__(self, *args):
            seen.append(("Posterior", [a.shape for a in args[:3]]))

        def predict(self, xs):
            return xs[:, 0], xs[:, 1]

    def neg_logp(X, Z, y, u, la, lb, products="exact"):
        seen.append(("neg_logp", [X.shape, Z.shape, y.shape, u["a"].shape, la.shape]))
        return (u["a"] ** 2).sum()

    def rows(*xs):
        seen.append(("rows", [x.shape for x in xs]))
        return xs[0].shape[0]

    model = types.SimpleNamespace(INPUTS=("X", "Z"), TARGET="y", SHAPES={"a": (1,)}, neg_logp=neg_logp,
                                  Posterior=Posterior, rows=rows)
    table = dict(X=np.zeros((6, 2)), Z=np.zeros((3, 2)), y=np.zeros(6), la=np.ones(2), lb=np.ones(2), device="cpu")
    out = dict(u={"a": np.ones(1)}, f=1.0, grid=np.zeros((4, 2)))
    common.readings(model, table, out)
    common.posterior(model, table, out["u"])
    common.map_gap(model, table, out)
    X, Z, y = (6, 2), (3, 2), (6,)
    assert seen[0] == ("neg_logp", [X, Z, y, (1,), (2,)]) and seen[1] == ("Posterior", [X, Z, y])
    assert seen[2] == ("rows", [X, Z]) and seen[3] == ("Posterior", [X, Z, y])
    assert all(s == ("neg_logp", [X, Z, y, (1,), (2,)]) for s in seen[4:-1]) and seen[-1] == ("rows", [X, Z])
