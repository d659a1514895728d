"""The FITC family and its plain reference (configuration ``fitc50k``): the
reference against the closed-form dense GP where FITC is exact, its own
Lloyd's k-means, and the table that hands the reference its inducing
inputs."""

import numpy as np
import pytest
import torch
from scipy import stats

from portbench.families import fitc_sparse as family
from portbench.harness import core, frozen
from portbench.reference import common, fitc_sparse as ref


def se(X1, X2, ls, eta):
    d = (X1[:, None, :] - X2[None, :, :]) / ls
    return eta**2 * np.exp(-0.5 * (d * d).sum(-1))


def t(a):
    return torch.as_tensor(a, dtype=torch.float64)


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_reference_at_z_equal_x_is_the_dense_gp_but_for_kuu_s_jitter(seed):
    """With Z = X (M = N) FITC's Q is K up to K_uu's jitter j = max(1e-6,
    N·2⁻²³)·η², so its evidence and posterior are the dense GP's
    (noise σ² + PyMC's 1e-6, closed form) within what j moves them.

    Tolerances: the objective within ½(tr C⁻¹ + ‖C⁻¹y‖²)·(2j + 1e-6), the
    first-order change of −log N(y | 0, C) under a change of C of that norm
    (FITC's covariance differs from the dense C by −jK(K + jI)⁻¹, its
    diagonal and the dense 1e-6: at most 2j + 1e-6); the means within 3√j
    and the variances within √j·η, since the jitter hides the directions of
    K below j, onto which a point's cross-covariance reaches O(√j) (the
    readings at N = 48 over 10 seeds: means up to 1.04√j, variances up to
    0.16√j·η; the objective up to 7% of its bound)."""
    n = 48
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 2))
    y = np.sin(1.3 * X[:, 0]) * np.cos(0.9 * X[:, 1]) + rng.normal(0, 0.1, n)
    la, lb = frozen.ls_prior_from_subsample(X)
    un = {"ls_total": rng.normal(-0.5, 0.3, 2), "η_total": rng.normal(0, 0.3), "σ": np.log(0.1) + rng.normal(0, 0.2)}
    ls, eta, s = np.exp(un["ls_total"]), np.exp(un["η_total"]), np.exp(un["σ"])
    C = se(X, X, ls, eta) + (s**2 + 1e-6) * np.eye(n)
    lp = (stats.invgamma.logpdf(ls, la, scale=lb).sum() + stats.gamma.logpdf(eta, 2.0) + stats.expon.logpdf(s)
          + sum(np.sum(v) for v in un.values()))
    want = -(stats.multivariate_normal(np.zeros(n), C).logpdf(y) + lp)
    u = {k: t(v) for k, v in un.items()}
    got = float(ref.neg_logp_at(t(X), t(X), t(y), u, t(la), t(lb)))
    j = max(ref.KUU_FLOOR, n * ref.KUU_EPS) * eta**2
    Ci = np.linalg.inv(C)
    alpha = Ci @ y
    assert abs(got - want) <= 0.5 * (np.trace(Ci) + alpha @ alpha) * (2 * j + 1e-6)

    Xs = rng.uniform(-2, 2, (7, 2))
    Ks = se(Xs, X, ls, eta)
    mean = Ks @ alpha
    var = eta**2 - np.einsum("ij,ji->i", Ks, Ci @ Ks.T) + s**2
    m, v = ref.PosteriorAt(t(X), t(X), t(y), u).predict(t(Xs))
    assert np.abs(m.numpy() - mean).max() <= 3 * np.sqrt(j)
    assert np.abs(v.numpy() - var).max() <= np.sqrt(j) * eta


def test_lloyd_is_plain_lloyd_and_an_empty_cluster_keeps_its_centre():
    rng = np.random.default_rng(2**31 + 3)
    X = rng.normal(size=(200, 2))
    want = X[np.random.default_rng(0).choice(200, 9, replace=False)]
    for _ in range(4):
        assign = np.argmin([[((x - c) ** 2).sum() for c in want] for x in X], axis=1)
        want = np.array([X[assign == k].mean(0) if (assign == k).any() else want[k] for k in range(9)])
    np.testing.assert_allclose(ref.lloyd(X, 9, 4), want, rtol=0, atol=1e-12)

    idx = np.random.default_rng(0).choice(200, 9, replace=False)
    X[idx[1]] = X[idx[0]]  # two equal centres: ties go to the lower index, so centre 1 gets no rows
    got = ref.lloyd(X, 9, 1)
    np.testing.assert_array_equal(got[1], X[idx[0]])
    assert not np.array_equal(got[0], X[idx[0]])
    assert ref.lloyd(X[:5], 9, 3).shape == (5, 2)


def test_table_hands_the_reference_its_own_centres_of_the_port_s_k_means_rows():
    cfg = core.load_config(core.load_benchmark(), "fitc50k")
    cfg.update(family.TINY)
    state = family.prepare(cfg, "cpu")
    tab = family.make_table(state, core.rng_for(2**31 + 5, 1, 0))
    rows = tab["xc_km"].numpy()
    assert rows.shape == (cfg["kmeans_rows"], 2) and tab["ref"]["X"].shape == (cfg["rows"], 2)
    np.testing.assert_array_equal(tab["ref"]["km_rows"], rows)
    assert {tuple(r) for r in rows} <= {tuple(r) for r in tab["ref"]["X"]}
    Z = ref.centres(t(rows), t(tab["ref"]["kmeans"]))
    assert Z.dtype == torch.float64
    np.testing.assert_array_equal(Z.numpy(), ref.lloyd(rows, cfg["inducing"], cfg["kmeans_iters"],
                                                       seed=cfg["kmeans_seed"]))
    xu_c, _ = family.inducing(state, tab)
    np.testing.assert_allclose(xu_c.double().numpy(), Z.numpy(), rtol=0, atol=1e-6)


def test_centres_run_lloyd_once_a_table_in_either_precision():
    rows = np.random.default_rng(2**31 + 4).uniform(-2, 2, (300, 2)).astype(np.float32)
    ref._lloyd_of.cache_clear()
    z64 = ref.centres(t(rows), t([24, 10, 0]))
    z32 = ref.centres(torch.as_tensor(rows), torch.tensor([24.0, 10.0, 0.0]))
    info = ref._lloyd_of.cache_info()
    assert (info.misses, info.hits) == (1, 1) and z32.dtype == torch.float32
    np.testing.assert_array_equal(z64.numpy(), ref.lloyd(rows, 24, 10))
    assert torch.equal(z32, z64.float())


def test_readings_pass_x_then_z_then_the_target():
    """The reference takes the rows, the k-means rows and the k-means'
    (centres, iterations, seed), makes Z from them, then the target; in
    TF32 its factors hold and every number is finite."""
    cfg = core.load_config(core.load_benchmark(), "fitc50k")
    cfg.update(family.TINY)
    state = family.prepare(cfg, "cpu")
    tab = family.make_table(state, core.rng_for(2**31 + 6, 1, 0))
    table = dict(tab["ref"], device="cpu")
    u_np = {k: np.random.default_rng(1).normal(0.0, 0.3, s) for k, s in ref.SHAPES.items()}
    out = dict(u=u_np, f=1.0, grid=state["line_np"])
    got = common.readings(ref, table, out)
    X, km_rows, kmeans, y, la, lb = (t(table[k]) for k in ("X", "km_rows", "kmeans", "y", "la", "lb"))
    Z = ref.centres(km_rows, kmeans)
    u = {k: t(v) for k, v in u_np.items()}
    mean, var = ref.PosteriorAt(X, Z, y, u).predict(t(out["grid"]))
    assert got["f"] == float(ref.neg_logp_at(X, Z, y, u, la, lb)) and got["rows"] == cfg["rows"]
    assert torch.equal(got["mean"], mean) and torch.equal(got["var"], var)
    control = common.readings(ref, table, out, "tf32")
    assert np.isfinite(control["f"]) and torch.isfinite(control["mean"]).all() and torch.isfinite(control["var"]).all()


@pytest.mark.parametrize("block", [128, 5])
def test_blocked_whitening_is_the_triangular_solve(block, monkeypatch):
    monkeypatch.setattr(ref, "BLOCK", block)
    rng = np.random.default_rng(2**31 + 8)
    L = np.tril(rng.normal(size=(17, 17))) + 6 * np.eye(17)
    B = rng.normal(size=(17, 9))
    np.testing.assert_allclose(ref.whiten(t(L), t(B), "exact").numpy(), np.linalg.solve(L, B), rtol=1e-12, atol=1e-13)


def test_a_job_returns_the_port_s_centres():
    cfg = core.load_config(core.load_benchmark(), "fitc50k")
    cfg.update(family.TINY, restarts=1, maxiter=2)
    state = family.prepare(cfg, "cpu")
    tab = family.make_table(state, core.rng_for(2**31 + 10, 1, 0))
    out = family.run_job(state, tab, core.Spans(lambda: None))
    xu_c, _ = family.inducing(state, tab)
    np.testing.assert_array_equal(out["z"], xu_c.numpy())


def test_job_flops_count_a_value_grad_as_three_values():
    cfg = dict(rows=50_000, inducing=512, line=200)
    value = family.value_flops(50_000, 512)
    assert value == pytest.approx(512**2 * 8 + 512 * 50_000 * 8 + 2 * 512**3 / 3 + 2 * 512**2 * 50_000)
    base = family.job_flops(cfg, {})
    assert family.job_flops(cfg, {"coarse.vg": 2, "coarse.v": 5}) == pytest.approx(base + 11 * value)


def test_program_trace_splits_a_tiny_fitc_job_by_the_program_s_spans():
    """``tools/program_trace.py`` reads the FITC job unedited: its one fit
    stage is ``coarse``, and the objective's spans and the optimizer's
    counts agree with the family's own count of evaluations."""
    from gumbi_tpu_torch.utils import profiling

    from portbench.tests.test_portbench_loops import BENCH, tiny_context
    from portbench.tools import program_trace

    cell = next(w for w in BENCH["workloads"] if w["name"] == "fitc50k.fit")
    ctx = tiny_context(cell, 2**33 + 7)
    got = program_trace.measure(ctx, 1)
    assert len(got["pairs"]) == ctx.traffic["tables"]
    for pair in got["pairs"]:
        on = pair["on"]
        assert pair["off"]["program"] is None and on["checks"]["evals_equal"], on
        assert abs(on["checks"]["parts_vs_runs"]) < 1e-9 and set(on["by_stage"]) == {"coarse"}
        assert set(on["stages"]) == set(family.STAGES) and on["program"]["objective_host_ms"] > 0
    assert got["numbers"]["evals_per_iter"] >= 1.0 and set(got["by_stage"]) == {"coarse"}
    assert profiling.collect() == {"spans": [], "counts": {}}
