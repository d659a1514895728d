"""The plain references: they import nothing of the port, and their
objectives and posteriors agree with closed forms in float64 and with the
port's own model."""

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import stats

from portbench.harness import frozen
from portbench.reference import common, dense_exact, lmc_kron

REF_DIR = Path(dense_exact.__file__).parent
BANNED = {"gumbi_tpu_torch", "gumbi_tpu", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("path", sorted(REF_DIR.glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level in (0, 1), f"{path.name}: import from outside reference/"
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not {n.split(".")[0] for n in names} & BANNED, (path.name, names)


def se(X1, X2, ls, eta):
    d = (X1[:, None, :] - X2[None, :, :]) / ls
    return eta**2 * np.exp(-0.5 * (d * d).sum(-1))


def problem(n=40, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 2))
    la, lb = frozen.ls_prior_from_subsample(X)
    return rng, X, la, lb


def test_dense_objective_and_posterior_match_closed_form():
    rng, X, la, lb = problem()
    y = np.sin(1.3 * X[:, 0]) + rng.normal(0, 0.1, len(X))
    u = {"ls_total": np.log([0.7, 0.9]), "η_total": np.log(1.2), "σ": np.log(0.15)}
    ls, eta, s = np.exp(u["ls_total"]), np.exp(u["η_total"]), np.exp(u["σ"])
    K = se(X, X, ls, eta) + (s**2 + 1e-6) * np.eye(len(X))
    lp = (stats.invgamma.logpdf(ls, la, scale=lb).sum() + stats.gamma.logpdf(eta, 2.0)
          + stats.expon.logpdf(s) + u["ls_total"].sum() + u["η_total"] + u["σ"])
    want = -(stats.multivariate_normal(np.zeros(len(X)), K).logpdf(y) + lp)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    got = dense_exact.neg_logp(t(X), t(y), {k: t(v) for k, v in u.items()}, t(la), t(lb))
    assert float(got) == pytest.approx(want, rel=1e-10)

    Xs = rng.uniform(-2, 2, (7, 2))
    Ks = se(Xs, X, ls, eta)
    mean = Ks @ np.linalg.solve(K, y)
    var = eta**2 - np.einsum("ij,ji->i", Ks, np.linalg.solve(K, Ks.T)) + s**2
    m, v = dense_exact.Posterior(t(X), t(y), {k: t(a) for k, a in u.items()}).predict(t(Xs))
    np.testing.assert_allclose(m.numpy(), mean, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(v.numpy(), var, rtol=1e-9)


def lmc_params(rng):
    return {"ls_total": np.log([0.8, 0.6]), "η_total": np.log(0.9), "W_Parameter": rng.normal(size=(2, 2)),
            "κ_Parameter": np.log([0.3, 0.5]), "σ": np.log(0.2), "W_Output_noise": rng.normal(size=(2, 2)) * 0.5,
            "κ_Output_noise": np.log([0.4, 0.7])}


def test_lmc_objective_and_posterior_match_closed_form():
    rng, X, la, lb = problem(n=30)
    Y = np.stack([np.sin(X[:, 0]), np.cos(X[:, 1])], 1) + rng.normal(0, 0.1, (len(X), 2))
    u = lmc_params(rng)
    p = {k: (np.exp(v) if k in lmc_kron.POSITIVE else v) for k, v in u.items()}
    B = p["W_Parameter"] @ p["W_Parameter"].T + np.diag(p["κ_Parameter"])
    noise = p["σ"] ** 2 * np.diag(p["W_Output_noise"] @ p["W_Output_noise"].T + np.diag(p["κ_Output_noise"]))
    n = len(X)
    Kx = se(X, X, p["ls_total"], p["η_total"])
    K = np.block([[B[i, j] * Kx + (i == j) * (noise[i] + 1e-6) * np.eye(n) for j in range(2)] for i in range(2)])
    y = np.concatenate([Y[:, 0], Y[:, 1]])
    lp = (stats.invgamma.logpdf(p["ls_total"], la, scale=lb).sum() + stats.gamma.logpdf(p["η_total"], 2.0)
          + stats.norm.logpdf(u["W_Parameter"], 0, 3).sum() + stats.gamma.logpdf(p["κ_Parameter"], 1.5).sum()
          + stats.expon.logpdf(p["σ"]) + stats.norm.logpdf(u["W_Output_noise"], 0, 3).sum()
          + stats.gamma.logpdf(p["κ_Output_noise"], 1.5).sum()
          + sum(u[k].sum() for k in lmc_kron.POSITIVE))
    want = -(stats.multivariate_normal(np.zeros(2 * n), K).logpdf(y) + lp)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    ut = {k: t(v) for k, v in u.items()}
    assert float(lmc_kron.neg_logp(t(X), t(Y), ut, t(la), t(lb))) == pytest.approx(want, rel=1e-10)

    Xs = rng.uniform(-2, 2, (5, 2))
    Kxs = se(X, Xs, p["ls_total"], p["η_total"])
    m, v = lmc_kron.Posterior(t(X), t(Y), ut).predict(t(Xs))
    for o in range(2):
        ks = np.concatenate([B[0, o] * Kxs, B[1, o] * Kxs])
        np.testing.assert_allclose(m[o].numpy(), ks.T @ np.linalg.solve(K, y), rtol=1e-8, atol=1e-12)
        var = B[o, o] * p["η_total"] ** 2 - np.einsum("ij,ji->i", ks.T, np.linalg.solve(K, ks)) + noise[o]
        np.testing.assert_allclose(v[o].numpy(), var, rtol=1e-8)


def test_references_agree_with_the_ports_objectives_in_float64():
    from gumbi_tpu_torch.ops import kron_neg_logp, map_neg_logp

    from portbench.families import dense_exact as dense_family, lmc_kron as lmc_family

    rng, X, la, lb = problem(n=48)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    y = np.sin(1.3 * X[:, 0]) + rng.normal(0, 0.1, len(X))
    u = {"ls_total": t(np.log([0.7, 0.9])), "η_total": t(0.1), "σ": t(np.log(0.15))}
    port = map_neg_logp(dense_family.spec(), u, t(X), torch.zeros((len(X), 0), dtype=torch.long), t(y), t(la), t(lb))
    assert float(dense_exact.neg_logp(t(X), t(y), u, t(la), t(lb))) == pytest.approx(float(port), rel=1e-10)

    Y = np.stack([np.sin(X[:, 0]), np.cos(X[:, 1])], 1) + rng.normal(0, 0.1, (len(X), 2))
    u = {k: t(v) for k, v in lmc_params(rng).items()}
    port = kron_neg_logp(lmc_family.spec(), u, t(X), t(Y), t(la), t(lb))
    assert float(lmc_kron.neg_logp(t(X), t(Y), u, t(la), t(lb))) == pytest.approx(float(port), rel=1e-9)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0, 1.0 + 2**-12], dtype=torch.float32)
    r = common.tf32_round(x)
    assert r.tolist() == [1.0 + 2**-10, 1.0 + 2**-10, -3.0, 1.0]
    y = torch.randn(1000)
    assert float(((common.tf32_round(y) - y).abs() / y.abs()).max()) <= 2**-11 * (1 + 1e-6)
    assert math.isinf(float(common.gaussian_nll(-torch.eye(3, dtype=torch.float64), torch.ones(3, dtype=torch.float64))))
