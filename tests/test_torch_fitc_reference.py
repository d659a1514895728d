"""The port's FITC regressor against the benchmark's plain float64 reference
(``portbench/reference/fitc_sparse.py``), and the program spans and
counters of the FITC objective and the k-means.

CPU, float64, N = 300 rows, M = 24 inducing inputs, 2 dims, at seeded
random hyperparameters. The reference takes K_uu's jitter as the port's
relative floor at float32, max(1e-6, M·2⁻²³); the port at float64 is handed
that floor as its ``jitter`` (its own float64 floor is max(jitter, M·eps)).
"""

import numpy as np
import pytest
import torch

from gumbi_tpu_torch.ops import GPSpec, GPTerm
from gumbi_tpu_torch.ops import fitc as tf
from gumbi_tpu_torch.ops.optimize import lbfgs_backtracking_minimize
from gumbi_tpu_torch.utils import profiling
from portbench.harness import frozen
from portbench.reference import fitc_sparse as ref

N, M, N_STAR = 300, 24, 40
JITTER = max(ref.KUU_FLOOR, M * ref.KUU_EPS)
SEEDS = (0, 1, 2, 3)


def t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def spec():
    return GPSpec(terms=(GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2, ard=True)


def problem(seed):
    """Rows, targets, the reference's Lloyd centres, the prior and random
    hyperparameters (unconstrained), all float64."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (N, 2))
    y = np.sin(1.3 * X[:, 0]) * np.cos(0.9 * X[:, 1]) + rng.normal(0, 0.1, N)
    Z = ref.lloyd(X, M, 10, seed=0)
    la, lb = frozen.ls_prior_from_subsample(X[:96])
    u = {"ls_total": rng.normal(-0.4, 0.3, 2), "η_total": rng.normal(0.0, 0.3), "σ": np.log(0.1) + rng.normal(0, 0.3)}
    Xs = np.column_stack([np.linspace(-2, 2, N_STAR), rng.uniform(-2, 2, N_STAR)])
    return dict(X=X, y=y, Z=Z, la=la, lb=lb, u=u, Xs=Xs)


def zeros(n):
    return torch.zeros((n, 0), dtype=torch.long)


def leaves(u):
    return {k: t(v).requires_grad_(True) for k, v in u.items()}


def flat_grad(value, u):
    return torch.cat([g.reshape(-1) for g in torch.autograd.grad(value, list(u.values()))])


@pytest.mark.parametrize("seed", SEEDS)
def test_fitc_neg_logp_value_and_gradient_match_the_reference(seed):
    p = problem(seed)
    u_port, u_ref = leaves(p["u"]), leaves(p["u"])
    port = tf.fitc_neg_logp(spec(), u_port, t(p["X"]), zeros(N), t(p["Z"]), zeros(M), t(p["y"]), t(p["la"]),
                            t(p["lb"]), jitter=JITTER)
    want = ref.neg_logp_at(t(p["X"]), t(p["Z"]), t(p["y"]), u_ref, t(p["la"]), t(p["lb"]))
    assert float(port.detach()) == pytest.approx(float(want.detach()), rel=1e-9)
    g_port, g_ref = flat_grad(port, u_port), flat_grad(want, u_ref)
    assert float((g_port - g_ref).abs().max()) <= 1e-9 * float(g_ref.abs().max())


@pytest.mark.parametrize("seed", SEEDS)
def test_fitc_predict_matches_the_reference(seed):
    p = problem(seed)
    u = {k: t(v) for k, v in p["u"].items()}
    with torch.no_grad():
        mean, var = tf.fitc_predict(spec(), tf.constrain(u), t(p["X"]), zeros(N), t(p["Z"]), zeros(M), t(p["y"]),
                                    t(p["Xs"]), zeros(N_STAR), jitter=JITTER)
        m_ref, v_ref = ref.PosteriorAt(t(p["X"]), t(p["Z"]), t(p["y"]), u).predict(t(p["Xs"]))
    assert float((mean - m_ref).abs().max()) <= 1e-9 * float(m_ref.abs().max())
    assert float(((var - v_ref) / v_ref).abs().max()) <= 1e-9


@pytest.mark.parametrize("n_iter", [0, 1, 2, 10, 25])
def test_kmeans_equals_the_reference_lloyd(n_iter):
    """``kmeans_inducing`` and ``select_inducing(n_iter=...)`` on device-side
    rows give the reference's centres; ``select_inducing``'s default is 25
    iterations."""
    X = problem(5)["X"]
    want = ref.lloyd(X, M, n_iter, seed=0)
    np.testing.assert_allclose(tf.kmeans_inducing(X, M, seed=0, n_iter=n_iter), want, rtol=0, atol=1e-12)
    xu_c, xu_k = tf.select_inducing(t(X), zeros(N), M, 2, seed=0, dtype=torch.float64, n_iter=n_iter)
    assert xu_c.device == t(X).device and xu_k.shape == (M, 0)
    np.testing.assert_allclose(xu_c.numpy(), want, rtol=0, atol=1e-12)
    if n_iter == 25:
        default, _ = tf.select_inducing(t(X), zeros(N), M, 2, seed=0, dtype=torch.float64)
        assert torch.equal(default, xu_c)
        assert not np.allclose(ref.lloyd(X, M, 2, seed=0), want)


@pytest.mark.parametrize("case", ["evaluation", "kmeans", "kmeans_all_rows", "off"])
def test_fitc_spans_and_kmeans_counters(case):
    """Under ``profiling.tracing()`` one FITC value+grad records the
    objective's Gram, linear-algebra and prior spans inside ``objective``,
    and the k-means counts its rows and iterations; off, nothing."""
    p = problem(6)
    profiling.collect()
    with profiling.tracing(case != "off"):
        if case in ("evaluation", "off"):
            u0 = {k: t(v) for k, v in p["u"].items()}
            data = (t(p["X"]), zeros(N), t(p["Z"]), zeros(M), t(p["y"]), t(p["la"]), t(p["lb"]))
            lbfgs_backtracking_minimize(lambda u: tf.fitc_neg_logp(spec(), u, *data), u0, maxiter=0)
        if case in ("kmeans", "off"):
            tf.select_inducing(t(p["X"]), zeros(N), M, 2, seed=0, dtype=torch.float64, n_iter=3)
        if case == "kmeans_all_rows":
            tf.select_inducing(t(p["X"][:M]), zeros(M), M, 2, seed=0, dtype=torch.float64, n_iter=3)
    got = profiling.collect()
    spans, counts = got["spans"], got["counts"]
    if case == "off":
        assert spans == [] and counts == {}
    elif case == "evaluation":
        names = [s[0] for s in spans]
        for inner in ("objective.gram", "objective.linalg", "objective.prior"):
            assert names.count(inner) == 1, names
            assert spans[spans[names.index(inner)][3]][0] == "objective"
        assert counts == {"lbfgs.vg": 1}
    elif case == "kmeans":
        assert spans == [] and counts == {"kmeans.rows": N, "kmeans.iters": 3}
    else:  # as many centres as rows: the rows are the centres, nothing is clustered
        assert spans == [] and counts == {}
