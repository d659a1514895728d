"""Port parity: gumbi_tpu_torch.ops.fitc vs gumbi_tpu.ops.fitc.

The same inputs, from numpy seeds, go through the JAX function and its
port counterpart at f64: k-means inducing points (bit-equal), the FITC
evidence with its gradient, the posterior mean/variance and covariance,
and the joint draws given the reference's own standard-normal block, each
with and without a bucket-padding mask; then the named f32 divergence of
the evidence, and the chain of ``chip_smoke.py`` phases 9-11 at small N.
Comparisons are at rtol 1e-9 unless a test says why not.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gumbi_tpu.ops.fitc as jf
import gumbi_tpu.ops.fitc_laplace as jfl
import gumbi_tpu.ops.kernels as jk
import gumbi_tpu.ops.laplace as jl
import gumbi_tpu.ops.priors as jp
import gumbi_tpu_torch.ops.fitc as tf
from gumbi_tpu_torch.convert import params_from_numpy, spec_from_reference
from gumbi_tpu_torch.ops import constrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-9
N, M, N_NEW = 300, 32, 40
F64 = dict(dtype=torch.float64, device="cpu")


def _problem(seed=0):
    """One ExpQuad term over 2 dims times a 3-level coregion (so inducing
    points carry a categorical column), noisy y, the last 20 rows padding."""
    rng = np.random.default_rng(seed)
    cg = jk.CoregTerm(name="Code", col=0, d_out=3)
    jspec = jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad", coregs=(cg,)),), d_cont=2)
    xc = rng.uniform(-2, 2, size=(N, 2))
    xk = rng.integers(0, 3, size=(N, 1)).astype(np.int32)
    y = np.sin(1.3 * xc[:, 0]) * np.cos(0.9 * xc[:, 1]) + 0.2 * xk[:, 0] + rng.normal(0, 0.1, N)
    mask = np.ones(N)
    mask[-20:] = 0.0
    la, lb = jp.ls_prior_params([0.1, 0.1], [4.0, 4.0])
    u = {k: np.asarray(v[1]) for k, v in jp.initial_params(jspec, la, lb, 2, seed=seed).items()}
    xu_c, xu_k = jf.select_inducing(xc, xk, M, 2, seed=0, dtype=jnp.float64)
    new_c = rng.uniform(-2, 2, size=(N_NEW, 2))
    new_k = rng.integers(0, 3, size=(N_NEW, 1)).astype(np.int32)
    return dict(jspec=jspec, spec=spec_from_reference(jspec), xc=xc, xk=xk, y=y, mask=mask, la=la, lb=lb, u=u,
                xu_c=np.asarray(xu_c), xu_k=np.asarray(xu_k), new_c=new_c, new_k=new_k)


@pytest.fixture(scope="module")
def prob():
    return _problem()


def _j(pr, masked):
    """The reference's arguments: (xc, xk, xu_c, xu_k, y) and the mask."""
    a = tuple(jnp.asarray(pr[k]) for k in ("xc", "xk", "xu_c", "xu_k", "y"))
    return a, (jnp.asarray(pr["mask"]) if masked else None)


def _t(pr, masked):
    t = lambda k: torch.as_tensor(pr[k], dtype=torch.long if k.endswith("k") else torch.float64)  # noqa: E731
    return tuple(t(k) for k in ("xc", "xk", "xu_c", "xu_k", "y")), (torch.tensor(pr["mask"]) if masked else None)


def _close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


# ------------------------------------------------------------------
# Inducing points
# ------------------------------------------------------------------


@pytest.mark.parametrize("n_u", [16, 48, 400])
def test_kmeans_inducing_bit_equal(prob, n_u):
    """Same algorithm and draws: equal bit for bit (n_u ≥ n returns X)."""
    full = np.column_stack([prob["xc"], prob["xk"]])
    np.testing.assert_array_equal(tf.kmeans_inducing(full, n_u, seed=3, n_iter=7),
                                  jf.kmeans_inducing(full, n_u, seed=3, n_iter=7))


@pytest.mark.parametrize("masked", [False, True])
def test_select_inducing_bit_equal_with_a_categorical_column(prob, masked):
    mask = prob["mask"] if masked else None
    jc, jk_ = jf.select_inducing(prob["xc"], prob["xk"], 24, 2, seed=1, dtype=jnp.float64, mask=mask)
    tc, tk = tf.select_inducing(prob["xc"], prob["xk"], 24, 2, seed=1, dtype=torch.float64, mask=mask, device="cpu")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk_))
    assert tc.dtype == torch.float64 and tk.dtype == torch.long and tk.shape == (24, 1)
    assert int(tk.max()) <= 2 and int(tk.min()) >= 0
    # tensors in give tensors on their device
    tc2, _ = tf.select_inducing(torch.tensor(prob["xc"]), prob["xk"], 24, 2, seed=1, dtype=torch.float64, mask=mask)
    assert torch.equal(tc2, tc)


def test_stabilized_kuu_floor_is_dtype_aware(prob):
    """At f32 the relative jitter is M·eps (512·eps ≈ 6.1e-5 at M = 512), at
    f64 the 1e-6 default: the port's Kuu equals the reference's at both."""
    for jdt, tdt, rtol in ((jnp.float64, torch.float64, RTOL), (jnp.float32, torch.float32, 1e-6)):
        pj = {k: jnp.asarray(v, jdt) for k, v in jp.constrain(prob["u"]).items()}
        Kj = jf._stabilized_kuu(prob["jspec"], pj, jnp.asarray(prob["xu_c"], jdt), jnp.asarray(prob["xu_k"]), jdt,
                                1e-6)
        pt = params_from_numpy(jp.constrain(prob["u"]), device="cpu", dtype=tdt)
        Kt = tf._stabilized_kuu(prob["spec"], pt, torch.as_tensor(prob["xu_c"], dtype=tdt),
                                torch.as_tensor(prob["xu_k"]).long(), tdt, 1e-6)
        _close(Kt, Kj, rtol=rtol)
    assert max(1e-6, M * torch.finfo(torch.float32).eps) == M * torch.finfo(torch.float32).eps


# ------------------------------------------------------------------
# Evidence
# ------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_fitc_mll_value_and_grad(prob, masked):
    """The port's whitened form against the reference's Woodbury form: the
    same evidence; value and gradient wrt every parameter at rtol 1e-9."""
    (xc, xk, xu_c, xu_k, y), mj = _j(prob, masked)
    params = jp.constrain(prob["u"])
    vj, gj = jax.value_and_grad(lambda p: jf.fitc_mll(prob["jspec"], p, xc, xk, xu_c, xu_k, y, mask=mj))(
        {k: jnp.asarray(v) for k, v in params.items()})
    targs, mt = _t(prob, masked)
    pt = {k: v.requires_grad_(True) for k, v in params_from_numpy(params, **F64).items()}
    vt = tf.fitc_mll(prob["spec"], pt, *targs, mask=mt)
    gt = torch.autograd.grad(vt, list(pt.values()))
    _close(vt, vj)
    for k, g in zip(pt, gt):
        _close(g, gj[k], atol=1e-9 * float(np.abs(np.asarray(gj[k])).max()))


@pytest.mark.parametrize("masked", [False, True])
def test_fitc_neg_logp_value_and_grad(prob, masked):
    (xc, xk, xu_c, xu_k, y), mj = _j(prob, masked)
    la, lb = jnp.asarray(prob["la"]), jnp.asarray(prob["lb"])
    vj, gj = jax.value_and_grad(
        lambda u: jf.fitc_neg_logp(prob["jspec"], u, xc, xk, xu_c, xu_k, y, la, lb, mask=mj))(
        {k: jnp.asarray(v) for k, v in prob["u"].items()})
    targs, mt = _t(prob, masked)
    ut = {k: v.requires_grad_(True) for k, v in params_from_numpy(prob["u"], **F64).items()}
    vt = tf.fitc_neg_logp(prob["spec"], ut, *targs, torch.tensor(prob["la"]), torch.tensor(prob["lb"]), mask=mt)
    gt = torch.autograd.grad(vt, list(ut.values()))
    _close(vt, vj)
    for k, g in zip(ut, gt):
        _close(g, gj[k], atol=1e-9 * float(np.abs(np.asarray(gj[k])).max()))


def test_fitc_mll_is_finite_at_f32_where_the_reference_is_nan():
    """Named divergence (ROADMAP queue 3): at f32 the reference factors
    Kuu + G, whose condition number passes f32's range, and returns NaN;
    the port factors I + Luu⁻¹GLuu⁻ᵀ (eigenvalues ≥ 1), the same evidence,
    and lands within 0.005 nats/point of f64. N = 400, M = 48, σ = 0.05."""
    n, m = 400, 48
    rng = np.random.default_rng(0)
    xc = rng.uniform(-2, 2, (n, 2))
    y = np.sin(1.3 * xc[:, 0]) * np.cos(0.9 * xc[:, 1]) + rng.normal(0, 0.1, n)
    xu = jf.kmeans_inducing(xc, m, seed=0)
    jspec = jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2)
    spec = spec_from_reference(jspec)
    p = {"ls_total": np.array([2.5, 2.5]), "η_total": np.array(1.0), "σ": np.array(0.05)}
    pj = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    ref32 = float(jf.fitc_mll(jspec, pj, jnp.asarray(xc, jnp.float32), jnp.zeros((n, 0), jnp.int32),
                              jnp.asarray(xu, jnp.float32), jnp.zeros((m, 0), jnp.int32), jnp.asarray(y, jnp.float32)))
    vals = {}
    for dt in (torch.float32, torch.float64):
        t = lambda a: torch.as_tensor(a, dtype=dt)  # noqa: E731
        zk = lambda k: torch.zeros((k, 0), dtype=torch.long)  # noqa: E731
        vals[dt] = float(tf.fitc_mll(spec, {k: t(v) for k, v in p.items()}, t(xc), zk(n), t(xu), zk(m), t(y)))
    assert np.isnan(ref32)
    assert abs(vals[torch.float32] - vals[torch.float64]) <= chip_smoke.BASIN_TOL * n, vals


# ------------------------------------------------------------------
# Posterior
# ------------------------------------------------------------------


def _both_params(prob):
    params = jp.constrain(prob["u"])
    return {k: jnp.asarray(v) for k, v in params.items()}, params_from_numpy(params, **F64)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_noise", [False, True])
def test_fitc_predict(prob, masked, with_noise):
    (xc, xk, xu_c, xu_k, y), mj = _j(prob, masked)
    targs, mt = _t(prob, masked)
    pj, pt = _both_params(prob)
    mj_, vj_ = jf.fitc_predict(prob["jspec"], pj, xc, xk, xu_c, xu_k, y, jnp.asarray(prob["new_c"]),
                               jnp.asarray(prob["new_k"]), with_noise=with_noise, mask=mj)
    mt_, vt_ = tf.fitc_predict(prob["spec"], pt, *targs, torch.tensor(prob["new_c"]),
                               torch.tensor(prob["new_k"]).long(), with_noise=with_noise, mask=mt)
    _close(mt_, mj_, atol=1e-12)
    _close(vt_, vj_, atol=1e-12)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_noise", [False, True])
def test_fitc_predict_cov(prob, masked, with_noise):
    (xc, xk, xu_c, xu_k, y), mj = _j(prob, masked)
    targs, mt = _t(prob, masked)
    pj, pt = _both_params(prob)
    mj_, Cj = jf.fitc_predict_cov(prob["jspec"], pj, xc, xk, xu_c, xu_k, y, jnp.asarray(prob["new_c"]),
                                  jnp.asarray(prob["new_k"]), with_noise=with_noise, mask=mj)
    mt_, Ct = tf.fitc_predict_cov(prob["spec"], pt, *targs, torch.tensor(prob["new_c"]),
                                  torch.tensor(prob["new_k"]).long(), with_noise=with_noise, mask=mt)
    _close(mt_, mj_, atol=1e-12)
    _close(Ct, Cj, atol=1e-12)


@pytest.mark.parametrize("masked", [False, True])
def test_fitc_draw_samples_with_reference_eps(prob, masked):
    """Given the reference's own standard-normal block the draws agree: at
    f64 the port's factor floor is the reference's jitter. rtol 1e-8: the
    factor of a near-singular covariance amplifies the two packages'
    different summation orders (as tests/test_torch_dense.py's draws)."""
    (xc, xk, xu_c, xu_k, y), mj = _j(prob, masked)
    targs, mt = _t(prob, masked)
    pj, pt = _both_params(prob)
    key = jax.random.PRNGKey(4)
    dj = jf.fitc_draw_samples(prob["jspec"], pj, xc, xk, xu_c, xu_k, y, jnp.asarray(prob["new_c"]),
                              jnp.asarray(prob["new_k"]), key, n_samples=3, mask=mj)
    eps = np.asarray(jax.random.normal(key, (3, N_NEW), dtype=jnp.float64))
    dt = tf.fitc_draw_samples(prob["spec"], pt, *targs, torch.tensor(prob["new_c"]),
                              torch.tensor(prob["new_k"]).long(), n_samples=3, mask=mt, eps=torch.tensor(eps))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-8, atol=1e-8)


def test_fitc_draw_samples_with_generator_by_moments(prob):
    """From a ``torch.Generator``: the same distribution (4,000 draws; mean
    within 5 standard errors, covariance within 0.1 of its scale)."""
    targs, _ = _t(prob, False)
    _, pt = _both_params(prob)
    new = (torch.tensor(prob["new_c"][:8]), torch.tensor(prob["new_k"][:8]).long())
    mean, cov = tf.fitc_predict_cov(prob["spec"], pt, *targs, *new)
    d = tf.fitc_draw_samples(prob["spec"], pt, *targs, *new, torch.Generator().manual_seed(0), n_samples=4000)
    se = torch.sqrt(torch.diagonal(cov) / 4000)
    assert d.shape == (4000, 8) and bool(((d.mean(0) - mean).abs() <= 5 * se).all())
    emp = torch.cov(d.T)
    assert float((emp - cov).abs().max()) <= 0.1 * float(torch.diagonal(cov).max())


# ------------------------------------------------------------------
# The slice: chip_smoke phases 9-11 at small N, against the reference
# ------------------------------------------------------------------

SLICE_N, SLICE_NU, SLICE_ROWS, SLICE_DENSE_N = 600, 24, 400, 200


@pytest.fixture(scope="module")
def slice_runs():
    p = chip_smoke.make_fitc_problem(SLICE_N, "cpu", torch.float64, n_u=SLICE_NU, kmeans_rows=SLICE_ROWS)
    q = chip_smoke.make_fitc_problem(SLICE_DENSE_N, "cpu", torch.float64, seed=1, kmeans=False)
    return dict(p=p, q=q,
                fitc=chip_smoke.run_fitc_campaign(p, "cpu", torch.float64, n_restarts=2, maxiter=15),
                fitc_laplace=chip_smoke.run_classifier_campaign(p, "cpu", torch.float64, True, n_restarts=2,
                                                                maxiter=10),
                laplace=chip_smoke.run_classifier_campaign(q, "cpu", torch.float64, False, n_restarts=2, maxiter=10))


def test_slice_problem_is_the_bench_problem(slice_runs):
    """make_fitc_problem draws X, y, the k-means rows and the prior's
    subsample from one default_rng(0) stream in bench_fitc50k.py's order."""
    p = slice_runs["p"]
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, size=(SLICE_N, 2))
    y = np.sin(1.3 * X[:, 0]) * np.cos(0.9 * X[:, 1]) + rng.normal(0, 0.1, SLICE_N)
    Xu = jf.kmeans_inducing(X[rng.choice(SLICE_N, SLICE_ROWS, replace=False)], SLICE_NU, seed=0, n_iter=10)
    np.testing.assert_array_equal(p["xc"].numpy(), X)
    np.testing.assert_array_equal(p["y"].numpy(), y)
    np.testing.assert_array_equal(p["xu_c"].numpy(), Xu)
    np.testing.assert_array_equal(p["yb"].numpy(), (y > 0).astype(float))


def test_slice_chain_matches_the_reference(slice_runs):
    """Each fitted optimum re-evaluates to its f_best in the reference's
    objective (rtol 1e-9), and each line prediction at it is the
    reference's (rtol 1e-8; the sparse classifier's 1e-7: at its fitted
    amplitude the reference's own Newton step cancels terms of size ‖K‖,
    which leaves ~1e-8 of rounding in its f64 mode); outputs are finite,
    draws of the right shape."""
    p, q = slice_runs["p"], slice_runs["q"]
    jspec = jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2)
    jspec_b = jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2, likelihood="bernoulli")
    J = lambda a: jnp.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)  # noqa: E731
    U = lambda r: {k: J(v) for k, v in r["u_best"].items()}  # noqa: E731
    line, line_k = J(p["line"]), jnp.zeros((chip_smoke.FITC_LINE, 0), jnp.int32)
    args = (J(p["xc"]), J(p["xk"]), J(p["xu_c"]), J(p["xu_k"]))

    r = slice_runs["fitc"]
    f = float(jf.fitc_neg_logp(jspec, U(r), *args, J(p["y"]), J(p["la"]), J(p["lb"])))
    np.testing.assert_allclose(r["f_best"], f, rtol=RTOL)
    mean, var = jf.fitc_predict(jspec, jp.constrain(U(r)), *args, J(p["y"]), line, line_k)
    _close(r["mean"], mean, rtol=1e-8)
    _close(r["var"], var, rtol=1e-8)
    assert r["rmse"] < 0.1 and len(r["evals"]) == 2

    r = slice_runs["fitc_laplace"]
    f = float(jfl.fitc_laplace_neg_logp(jspec_b, U(r), *args, J(p["yb"]), J(p["la"]), J(p["lb"])))
    np.testing.assert_allclose(r["f_best"], f, rtol=RTOL)
    mean, var, prob = jfl.fitc_laplace_predict(jspec_b, jp.constrain(U(r)), *args, J(p["yb"]), line, line_k)
    _close(r["mean"], mean, rtol=1e-7)
    _close(r["prob"], prob, rtol=1e-7)
    assert r["draws"].shape == (chip_smoke.N_LATENT_DRAWS, chip_smoke.FITC_LINE)
    assert bool(torch.isfinite(r["draws"]).all()) and r["accuracy"] > 0.9

    r = slice_runs["laplace"]
    qargs = (J(q["xc"]), J(q["xk"]), J(q["yb"]))
    f = float(jl.laplace_neg_logp(jspec_b, U(r), *qargs, J(q["la"]), J(q["lb"])))
    np.testing.assert_allclose(r["f_best"], f, rtol=RTOL)
    mean, var, prob = jl.laplace_predict(jspec_b, jp.constrain(U(r)), *qargs, J(q["line"]), line_k)
    _close(r["mean"], mean, rtol=1e-8)
    _close(r["prob"], prob, rtol=1e-8)
    assert bool(torch.isfinite(r["draws"]).all()) and r["accuracy"] > 0.9
    for name in ("fitc", "fitc_laplace", "laplace"):
        assert constrain(slice_runs[name]["u_best"]).keys() == slice_runs[name]["u0s"].keys()


def test_slice_f32_objectives_sit_in_the_f64_basin(slice_runs):
    """As chip_smoke's checks on the card: each objective at the fitted point
    at f32 (plain path on the CPU) within 0.005 nats/point of f64."""
    p, q = slice_runs["p"], slice_runs["q"]
    for name, prob_, fn in (
        ("fitc", p, lambda s, u, d: chip_smoke.fitc_neg_logp(s, u, d["xc"], d["xk"], d["xu_c"], d["xu_k"], d["y"],
                                                              *_prior(d))),
        ("fitc_laplace", p, lambda s, u, d: chip_smoke.fitc_laplace_neg_logp(
            s, u, d["xc"], d["xk"], d["xu_c"], d["xu_k"], d["yb"], *_prior(d))),
        ("laplace", q, lambda s, u, d: chip_smoke.laplace_neg_logp(s, u, d["xc"], d["xk"], d["yb"], *_prior(d))),
    ):
        r = slice_runs[name]
        gap = chip_smoke._f64_gap(
            lambda u, dt: fn(r["spec"], {k: v.to(dt) for k, v in u.items()}, chip_smoke.problem_at(prob_, dt)),
            r, prob_["xc"].shape[0])
        assert gap[2] <= chip_smoke.BASIN_TOL, (name, gap)


def _prior(d):
    return tuple(torch.as_tensor(d[k], dtype=d["xc"].dtype) for k in ("la", "lb"))
