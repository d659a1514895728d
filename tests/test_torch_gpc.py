"""The port's classifier slice against the JAX reference, at f64 on the CPU.

* The chain-batched Laplace evidence (``laplace_neg_logp_chains``): values
  and gradients against a stack of per-chain ``laplace_neg_logp`` calls
  (rtol 1e-10) and against ``jax.vmap`` of the reference's value and grad
  (rtol 1e-8), with and without a bucket mask; a chain whose factor fails
  is +inf in its own entry and leaves the others' values and gradients as
  they were.
* ``GPC``, dense and sparse, on the reference's own ``GPC`` tests
  (``tests/test_extras.py`` and ``tests/test_fitc_laplace.py``): each
  test's assertions run on the port, the port's fits are held to the
  reference's (``_neg_logp`` and the MAP at rtol 1e-6), and where a fit is
  shared (the port's save loaded by ``gumbi_tpu.GPC.load``) the
  probabilities, draws and traces are held at 1e-8.
* ``GPC.sample`` in both modes draw by draw on JAX's keys (the reference's
  key tree replayed through ``stream=``, ``test_torch_hmc.JaxStream``).
* Saves loaded across packages both ways, the ``regression`` aliases,
  ``ArrayTableGPC`` against the ``DataSet`` path, and chip_smoke's phase 19
  drivers at a small N on the CPU.
"""

import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import gumbi_tpu as gmb
import gumbi_tpu.ops.fitc_laplace as jfl
import gumbi_tpu.ops.kernels as jk
import gumbi_tpu.ops.laplace as jl
import gumbi_tpu.ops.priors as jp
import gumbi_tpu_torch as gmt
import gumbi_tpu_torch.ops.fitc_laplace as tfl
import gumbi_tpu_torch.ops.laplace as tl
from gumbi_tpu_torch.convert import spec_from_reference
from gumbi_tpu_torch.ops import unconstrain
from gumbi_tpu_torch.ops.priors import param_info
from gumbi_tpu_torch.tools.array_table import ArrayTable, ArrayTableGPC
from test_torch_hmc import JaxStream

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

CHAIN_RTOL = 1e-10  # batched against per-chain: one algorithm, batched BLAS
VMAP_RTOL = 1e-8  # against the reference's vmapped value and grad
FIT_RTOL = 1e-6  # the port's own fit against the reference's _neg_logp
# ... and its MAP. The reference's L-BFGS is optax's, the port's the host
# algorithm of ops/optimize.py: both stop on a relative decrease below tol
# (1e-6), inside a basin whose floor is flat to ~1e-13 relative, and there
# they stop up to ~1e-6 apart along the flat direction (1.29e-6 in ls on
# test_extras.py:235's problem, where the two _neg_logp agree to 2e-13).
MAP_RTOL = 1e-5
PROBA_ATOL = 1e-8  # probabilities, draws and traces on one shared MAP
# test_extras.py:380's 150 + 150 ESS iterations replayed: the slice steps'
# brackets carry each rounding difference forward, and after 300 iterations
# the chains sit 2.2e-8 (relative) apart; the 6 + 6 replay is held at 1e-8.
LONG_REPLAY_ATOL = 1e-6
BASIN_TOL = 0.005  # nats per data point, tests/test_bench_quality.py's tolerance
LABEL_KW = dict(heteroskedastic_outputs=False)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ------------------------------------------------------------------
# The chain-batched Laplace evidence
# ------------------------------------------------------------------

CHAINS, N_OPS, N_PAD = 4, 24, 5


@pytest.fixture(scope="module")
def chains_problem():
    rng = np.random.default_rng(7)
    jspec = jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2, likelihood="bernoulli")
    xc = rng.uniform(-2, 2, size=(N_OPS, 2))
    f = 2.0 * np.sin(1.3 * xc[:, 0]) * np.cos(0.9 * xc[:, 1])
    y = (rng.uniform(size=N_OPS) < 1 / (1 + np.exp(-f))).astype(float)
    mask = np.ones(N_OPS)
    mask[-N_PAD:] = 0.0
    la, lb = jp.ls_prior_params([0.1, 0.1], [4.0, 4.0])
    u = {k: np.asarray(v) for k, v in jp.initial_params(jspec, la, lb, CHAINS, seed=3).items()}
    return dict(jspec=jspec, spec=spec_from_reference(jspec), xc=xc, y=y, mask=mask, la=la, lb=lb, u=u)


def _port_args(pr, masked):
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    return (pr["spec"], t(pr["xc"]), torch.zeros((N_OPS, 0), dtype=torch.long), t(pr["y"]), t(pr["la"]), t(pr["lb"]),
            t(pr["mask"]) if masked else None)


def _chains_vg(pr, u, masked):
    spec, xc, xk, y, la, lb, mask = _port_args(pr, masked)
    leaves = {k: torch.as_tensor(v, dtype=torch.float64).requires_grad_(True) for k, v in u.items()}
    v = tl.laplace_neg_logp_chains(spec, leaves, xc, xk, y, la, lb, mask=mask)
    g = torch.autograd.grad(v.sum(), list(leaves.values()))
    return _np(v), {k: _np(gi) for k, gi in zip(leaves, g)}


def _single_vg(pr, u, masked):
    spec, xc, xk, y, la, lb, mask = _port_args(pr, masked)
    vals, grads = [], {k: [] for k in u}
    for c in range(CHAINS):
        leaves = {k: torch.as_tensor(v[c], dtype=torch.float64).requires_grad_(True) for k, v in u.items()}
        v = tl.laplace_neg_logp(spec, leaves, xc, xk, y, la, lb, mask=mask)
        g = torch.autograd.grad(v, list(leaves.values()))
        vals.append(float(v))
        for k, gi in zip(leaves, g):
            grads[k].append(_np(gi))
    return np.array(vals), {k: np.stack(v) for k, v in grads.items()}


@pytest.mark.parametrize("masked", [False, True])
def test_laplace_chains_match_per_chain_calls(chains_problem, masked):
    v, g = _chains_vg(chains_problem, chains_problem["u"], masked)
    v1, g1 = _single_vg(chains_problem, chains_problem["u"], masked)
    assert v.shape == (CHAINS,) and np.isfinite(v).all()
    np.testing.assert_allclose(v, v1, rtol=CHAIN_RTOL)
    for k in g1:
        np.testing.assert_allclose(g[k], g1[k], rtol=CHAIN_RTOL, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
def test_laplace_chains_match_the_vmapped_reference(chains_problem, masked):
    pr = chains_problem
    xc, y = jnp.asarray(pr["xc"]), jnp.asarray(pr["y"])
    mask = jnp.asarray(pr["mask"]) if masked else None

    def f(u):
        return jl.laplace_neg_logp(pr["jspec"], u, xc, jnp.zeros((N_OPS, 0), jnp.int32), y, jnp.asarray(pr["la"]),
                                   jnp.asarray(pr["lb"]), mask=mask)

    vj, gj = jax.vmap(jax.value_and_grad(f))({k: jnp.asarray(v) for k, v in pr["u"].items()})
    v, g = _chains_vg(pr, pr["u"], masked)
    np.testing.assert_allclose(v, np.asarray(vj), rtol=VMAP_RTOL)
    for k in g:
        np.testing.assert_allclose(g[k], np.asarray(gj[k]), rtol=VMAP_RTOL, atol=1e-10, err_msg=k)


def test_a_failed_chain_is_inf_in_its_own_entry_only(chains_problem):
    """Chain 1's η overflows (its Gram and factor are NaN): +inf there, and
    the other chains' values and gradients are the per-chain ones."""
    pr = chains_problem
    u = {k: v.copy() for k, v in pr["u"].items()}
    u["η_total"][1] = 800.0
    v, g = _chains_vg(pr, u, masked=True)
    v1, g1 = _single_vg(pr, u, masked=True)
    ok = np.arange(CHAINS) != 1
    assert v[1] == np.inf and v1[1] == np.inf
    np.testing.assert_allclose(v[ok], v1[ok], rtol=CHAIN_RTOL)
    for k in g1:
        assert np.isfinite(g[k][ok]).all()
        np.testing.assert_allclose(g[k][ok], g1[k][ok], rtol=CHAIN_RTOL, atol=1e-12, err_msg=k)


def test_a_non_pd_factor_is_nan_in_its_own_entry_only(chains_problem):
    """laplace_mll on a (C, N, N) stack whose chain 2 is −K (B = I − S K S is
    not PD at the first Newton step): NaN there, the single-point values
    elsewhere."""
    pr = chains_problem
    spec, xc, xk, y, _, _, mask = _port_args(pr, masked=True)
    p = tl.constrain({k: torch.as_tensor(v, dtype=torch.float64) for k, v in pr["u"].items()})
    Ks = [tl._jittered_gram(spec, {k: v[c] for k, v in p.items()}, xc, xk, 1e-6) for c in range(CHAINS)]
    Ks[2] = -Ks[2]
    z = tl.laplace_mll(torch.stack(Ks), y, mask=mask)
    assert torch.isnan(z[2])
    for c in (0, 1, 3):
        np.testing.assert_allclose(float(z[c]), float(tl.laplace_mll(Ks[c], y, mask=mask)), rtol=CHAIN_RTOL)


def test_predictor_mode_in_f64_where_the_reference_f32_mode_is_off():
    """The named divergence of ``laplace._latent_at``: at f32 (η = 12,
    N = 512) the reference's f32 Newton mode puts its probabilities 2.4e-2
    from the f64 ones (its mean 0.10); the port's mode in f64 keeps them
    within 2.4e-5. At f64 the port is the reference, within 1e-9 of each
    output's largest entry (this ill-conditioned K moves f64 means near
    zero by ~1e-10 between the two packages)."""
    rng = np.random.default_rng(1)
    n, eta, ls = 512, 12.0, 1.2
    X = rng.uniform(-2, 2, size=(n, 2))
    y = ((np.sin(1.3 * X[:, 0]) * np.cos(0.9 * X[:, 1]) + rng.normal(0, 0.1, n)) > 0).astype(float)
    g = np.stack(np.meshgrid(np.linspace(-2, 2, 30), np.linspace(-2, 2, 30)), -1).reshape(-1, 2)
    jspec = jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2, likelihood="bernoulli")
    spec = spec_from_reference(jspec)
    out = {}
    for dt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        t = lambda a: torch.as_tensor(a, dtype=dt)  # noqa: E731
        zk = lambda m: torch.zeros((m, 0), dtype=torch.long)  # noqa: E731
        jz = lambda m: jnp.zeros((m, 0), jnp.int32)  # noqa: E731
        p = {"ls_total": t([ls, ls]), "η_total": t(eta)}
        jpar = {"ls_total": jnp.asarray([ls, ls], jdt), "η_total": jnp.asarray(eta, jdt)}
        port = tl.laplace_predict(spec, p, t(X), zk(n), t(y), t(g), zk(len(g)))
        assert all(a.dtype == dt for a in port)
        out["port", dt] = [_np(a).astype(np.float64) for a in port]
        out["ref", dt] = [np.asarray(a, dtype=np.float64) for a in jl.laplace_predict(
            jspec, jpar, jnp.asarray(X, jdt), jz(n), jnp.asarray(y, jdt), jnp.asarray(g, jdt), jz(len(g)))]
    truth = out["ref", torch.float64]
    for a, b in zip(out["port", torch.float64], truth):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * np.abs(b).max())
    assert np.abs(out["port", torch.float32][2] - truth[2]).max() <= 1e-4
    assert np.abs(out["ref", torch.float32][2] - truth[2]).max() >= 1e-2


def test_sparse_predictor_features_in_f64_where_the_f32_form_is_off():
    """The named divergence of ``fitc_laplace._test_features``: at f32
    (N = 20,000, m = 128, η = 7.8) Φ, the Newton mode and the sums taken in
    f32 put the latent mean 6.2e-3 from an f64 evaluation with the same
    (f32) inducing floor; taken in f64 from the f32 Grams, 5.9e-4."""
    from gumbi_tpu_torch.ops.kernels import gram
    from gumbi_tpu_torch.tools.fitc_problem import fitc_spec, make_fitc_problem

    n, n_u = 20_000, 128
    p = make_fitc_problem(n, "cpu", torch.float32, seed=0, n_u=n_u)
    spec = fitc_spec("bernoulli")
    par = {"ls_total": torch.tensor([0.55, 0.6]), "η_total": torch.tensor(7.8)}
    args = (p["xc"], p["xk"], p["xu_c"], p["xu_k"])
    port = tfl._test_features(spec, par, *args, p["yb"], p["line"], p["line_k"], 1e-6, 30, None)
    assert all(a.dtype == torch.float32 for a in port)
    Phi, D, Luu = tfl._whitened_features(spec, par, *args, 1e-6)  # the f32 form
    f = tfl.fitc_laplace_mode(Phi, D, p["yb"])[0]
    phi_s = torch.linalg.solve_triangular(Luu, gram(spec, par, p["line"], p["line_k"], p["xu_c"], p["xu_k"]).T,
                                          upper=False).T
    f32_form = phi_s @ (Phi.T @ (p["yb"] - torch.sigmoid(f)))
    q = {k: (v.double() if isinstance(v, torch.Tensor) and v.is_floating_point() else v) for k, v in p.items()}
    p64 = {k: v.double() for k, v in par.items()}
    Kuu = gram(spec, p64, q["xu_c"], q["xu_k"], q["xu_c"], q["xu_k"])
    floor = max(1e-4, n_u * float(torch.finfo(torch.float32).eps) * float(torch.diagonal(Kuu).mean()))
    L = torch.linalg.cholesky(Kuu + floor * torch.eye(n_u, dtype=torch.float64))
    P = torch.linalg.solve_triangular(L, gram(spec, p64, q["xc"], q["xk"], q["xu_c"], q["xu_k"]).T, upper=False).T
    f64 = tfl.fitc_laplace_mode(P, torch.clamp(p64["η_total"] ** 2 - (P * P).sum(1), min=0.0) + 1e-6, q["yb"])[0]
    truth = torch.linalg.solve_triangular(L, gram(spec, p64, q["line"], q["line_k"], q["xu_c"], q["xu_k"]).T,
                                          upper=False).T @ (P.T @ (q["yb"] - torch.sigmoid(f64)))
    assert float((port[0].double() - truth).abs().max()) <= 1.5e-3
    assert float((f32_form.double() - truth).abs().max()) >= 3e-3


# ------------------------------------------------------------------
# GPC against the reference's GPC tests
# ------------------------------------------------------------------


def _frames(df, outputs):
    return gmb.DataSet(df, outputs=outputs), gmt.DataSet(df, outputs=outputs)


def _fit_both(df, outputs, fit_kw):
    ds_ref, ds_port = _frames(df, outputs)
    ref = gmb.GPC(ds_ref).fit(outputs=outputs, **fit_kw)
    port = gmt.GPC(ds_port, device="cpu").fit(outputs=outputs, **fit_kw)
    return ref, port


def _assert_fits_agree(ref, port):
    """The port's own fit against the reference's from the same starts."""
    np.testing.assert_allclose(port._neg_logp, ref._neg_logp, rtol=FIT_RTOL)
    assert set(port.MAP) == set(ref.MAP)
    for k, v in ref.MAP.items():
        np.testing.assert_allclose(port.MAP[k], np.asarray(v), rtol=MAP_RTOL, err_msg=k)


def _ref_on_port(port, df, outputs, path):
    """The reference's GPC loaded from the port's save: both hold one MAP."""
    port.save(path)
    return gmb.GPC.load(path, gmb.DataSet(df, outputs=outputs))


def _separable_df(n, seed, threshold=0.0, col="label"):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, n)
    return pd.DataFrame({"x": x, col: (x > threshold).astype(float)})


@pytest.fixture(scope="module")
def separable():
    """test_extras.py:235's problem, fitted by both packages."""
    df = _separable_df(80, 2)
    fit_kw = dict(continuous_dims=["x"], **LABEL_KW, MAP_kwargs=dict(n_restarts=2, maxiter=80))
    ref, port = _fit_both(df, ["label"], fit_kw)
    return df, ref, port


def test_gpc_separable(separable, tmp_path):
    """test_extras.py:235 on the port, held to the reference's fit."""
    df, ref, port = separable
    pts = port.parray(x=np.array([-1.5, 1.5]))
    proba = port.predict_proba(pts)
    assert proba[0] < 0.3 and proba[1] > 0.7
    assert "σ" not in port.MAP
    info = param_info(port._spec)
    assert "σ" not in info and not any("Output_noise" in k for k in info)
    assert port.latent and port._spec.likelihood == "bernoulli" and port._cache is None
    _assert_fits_agree(ref, port)
    shared = _ref_on_port(port, df, ["label"], tmp_path / "gpc.npz")
    np.testing.assert_allclose(proba, shared.predict_proba(shared.parray(x=np.array([-1.5, 1.5]))), rtol=0,
                               atol=PROBA_ATOL)
    arr, _, _ = port._prepare_points_for_prediction(pts, output=["label"])
    for a, b in zip(port.predict(arr), shared.predict(arr)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9)


def test_gpc_binary_and_structure_checks_raise():
    """The binary-target check, test_extras.py:493's non-Hadamard rejection
    and the reference's other build raises."""
    df = _separable_df(30, 2)
    ds = gmt.DataSet(df, outputs=["label"])
    kw = dict(outputs=["label"], continuous_dims=["x"], **LABEL_KW)
    with pytest.raises(NotImplementedError, match="Hadamard"):
        gmt.GPC(ds, device="cpu").fit(**kw, multitask_kernel="Kronecker")
    for bad in (dict(heteroskedastic_inputs=True), dict(sparse=True, bucket=16)):
        with pytest.raises(NotImplementedError):
            gmt.GPC(ds, device="cpu").fit(**kw, **bad)
    with pytest.raises(NotImplementedError, match="heteroskedastic outputs"):
        gmt.GPC(ds, device="cpu").fit(outputs=["label"], continuous_dims=["x"])
    df2 = df.assign(label=df["x"])
    with pytest.raises(ValueError, match="binary"):
        gmt.GPC(gmt.DataSet(df2, outputs=["label"]), device="cpu").fit(**kw)
    gpc = gmt.GPC(ds, device="cpu").fit(**kw, MAP_kwargs=dict(n_restarts=1, maxiter=3))
    with pytest.raises(TypeError, match="DeviceMesh"):
        gpc.find_MAP(mesh=object())
    with pytest.raises(ValueError, match="sampler"):
        gpc.sample(sampler="nuts", draws=1, tune=1)


@pytest.fixture(scope="module")
def latent_pair(tmp_path_factory):
    """test_extras.py:380's problem: the port's fit, and the reference
    loaded from its save."""
    df = _separable_df(60, 5)
    port = gmt.GPC(gmt.DataSet(df, outputs=["label"]), device="cpu").fit(
        outputs=["label"], continuous_dims=["x"], **LABEL_KW, MAP_kwargs=dict(n_restarts=2, maxiter=80))
    ref = _ref_on_port(port, df, ["label"], tmp_path_factory.mktemp("gpc") / "latent.npz")
    return ref, port


def _trace_close(tp, tr, atol=PROBA_ATOL):
    keys = sorted(k for k in tr if not k.startswith("_")) + (["_latent_f"] if "_latent_f" in tr else [])
    assert sorted(k for k in tp if not k.startswith("_")) == sorted(k for k in tr if not k.startswith("_"))
    for k in keys:
        a, b = np.asarray(tp[k]), np.asarray(tr[k])
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=0, atol=atol * max(1.0, float(np.abs(b).max())), err_msg=k)


def test_gpc_latent_full_bayes_matches_laplace(latent_pair):
    """test_extras.py:380 on the port, its trace replayed draw by draw on
    JAX's keys from the shared MAP: within 1e-8 of the reference's trace,
    and ESS over (latents, hypers) agrees with the Laplace surface."""
    ref, port = latent_pair
    kw = dict(latent=True, draws=150, tune=150, chains=2, seed=0)
    trace = port.sample(**kw, stream=JaxStream(jax.random.PRNGKey(0)))
    _trace_close(trace, ref.sample(**kw), atol=LONG_REPLAY_ATOL)
    assert trace["_latent_f"].shape == (2, 150, 60)
    assert 0.05 < float(trace["_stats"]["accept_rate"].mean()) < 0.95
    assert np.all(np.isfinite(trace["ls_total"])) and np.all(trace["ls_total"] > 0)
    pts = port.parray(x=np.array([-1.5, -0.5, 0.5, 1.5]))
    p_laplace = port.predict_proba(pts)
    p_ess = port.predict_proba(pts, source=trace, max_draws=64, seed=1)
    assert p_ess[0] < 0.3 and p_ess[-1] > 0.7
    assert np.all(np.diff(p_ess) > 0)
    assert np.allclose(p_ess, p_laplace, atol=0.15)


def test_gpc_latent_sample_replays_the_reference_draw_by_draw(latent_pair):
    """``sample(latent=True)`` on JAX's keys from the shared MAP: the trace
    (hyperparameters and latent draws) within 1e-8 of the reference's, and
    ``predict_proba(source=)`` on it within 1e-8 of the reference's."""
    ref, port = latent_pair
    kw = dict(latent=True, draws=6, tune=6, chains=2, seed=0)
    tr = ref.sample(**kw)
    tp = port.sample(**kw, stream=JaxStream(jax.random.PRNGKey(0)))
    assert tp["_latent_f"].shape == (2, 6, 60)
    _trace_close(tp, tr)
    np.testing.assert_allclose(tp["_stats"]["accept_rate"], np.asarray(tr["_stats"]["accept_rate"]), atol=PROBA_ATOL)
    pts = port.parray(x=np.array([-1.5, -0.5, 0.5, 1.5]))
    for source in (tr, tp):
        np.testing.assert_allclose(port.predict_proba(pts, source=source, max_draws=8, seed=1),
                                   ref.predict_proba(pts, source=tr, max_draws=8, seed=1), rtol=0, atol=PROBA_ATOL)
    with pytest.raises(ValueError, match="_latent_f"):
        port.predict_proba(pts, source={"ls_total": tr["ls_total"]})


@pytest.mark.parametrize("sampler", ["chees", "hmc"])
def test_gpc_hyper_sample_replays_the_reference_draw_by_draw(latent_pair, sampler):
    """``sample(latent=False)`` (the default chains: 16 for ChEES on the
    chain-batched evidence, 2 for HMC at 8 leapfrog steps) on JAX's keys,
    tune/draws 3/3."""
    ref, port = latent_pair
    kw = dict(draws=3, tune=3, seed=4, sampler=sampler, n_leapfrog=8)
    tr = ref.sample(**kw)
    tp = port.sample(**kw, stream=JaxStream(jax.random.PRNGKey(4)))
    assert np.asarray(tp["ls_total"]).shape[:2] == ((16 if sampler == "chees" else 2), 3)
    _trace_close(tp, tr)
    np.testing.assert_allclose(tp["_stats"]["mean_accept"], tr["_stats"]["mean_accept"], rtol=0, atol=PROBA_ATOL)
    assert port.trace is tp


def test_gpc_draws_replay_the_reference(latent_pair):
    """``draw_point_samples``/``draw_grid_samples`` given the reference's key
    (its normal block through ``stream=``): probabilities within 1e-8, the
    logit-var registration and the sample_vars bookkeeping."""
    ref, port = latent_pair
    for gp in (ref, port):
        gp.sample_vars = None
        gp.prepare_grid(resolution=7)
    dr = ref.draw_grid_samples(n_samples=3, seed=2)
    dp = port.draw_grid_samples(n_samples=3, seed=2, stream=JaxStream(jax.random.PRNGKey(2)))
    assert dp.shape == dr.shape == (3, 7)
    np.testing.assert_allclose(dp["label"].values(), dr["label"].values(), rtol=0, atol=PROBA_ATOL)
    assert "label" in port.stdzr.logit_vars
    port.draw_grid_samples(n_samples=2, seed=3)
    assert list(port.sample_vars) == ["posterior_samples", "posterior_samples_"]
    np.testing.assert_allclose(port.predict_grid_proba(), ref.predict_grid_proba(), rtol=0, atol=PROBA_ATOL)


@pytest.mark.parametrize("bucket", [None, 16])
def test_gpc_save_load_roundtrip(bucket, tmp_path):
    """test_extras.py:466 on the port (its own save: bit-equal grid), and each
    package loading the other's save."""
    df = pd.DataFrame({"x": (x := np.random.default_rng(0).uniform(-2, 2, 25)), "hit": (x > 0).astype(float)})
    kw = dict(outputs=["hit"], continuous_dims=["x"], **LABEL_KW, MAP_kwargs=dict(n_restarts=2, maxiter=100),
              **({} if bucket is None else dict(bucket=bucket)))
    ds_ref, ds_port = _frames(df, ["hit"])
    gpc = gmt.GPC(ds_port, device="cpu").fit(**kw)
    gpc.prepare_grid(resolution=11)
    p1 = gpc.predict_grid_proba()
    path = tmp_path / "port.npz"
    gpc.save(path)
    for cls in (gmt.GPC, gmt.GP):
        loaded = cls.load(path, ds_port, device="cpu")
        assert type(loaded) is cls and loaded._spec.likelihood == "bernoulli" and loaded.latent
        assert loaded._cache is None
    gpc2 = gmt.GPC.load(path, ds_port, device="cpu")
    gpc2.prepare_grid(resolution=11)
    np.testing.assert_array_equal(p1, gpc2.predict_grid_proba())
    if bucket:
        assert int(_np(gpc2._mask).sum()) == 25 and gpc2._xc.shape[0] == 32

    ref = gmb.GPC.load(path, ds_ref)  # the reference loads the port's save
    ref.prepare_grid(resolution=11)
    np.testing.assert_allclose(p1, np.asarray(ref.predict_grid_proba()), rtol=0, atol=PROBA_ATOL)
    ref_own = gmb.GPC(ds_ref).fit(**kw)  # and the port loads the reference's
    np.testing.assert_allclose(gpc._neg_logp, ref_own._neg_logp, rtol=FIT_RTOL)
    ref_own.save(tmp_path / "ref.npz")
    back = gmt.GPC.load(tmp_path / "ref.npz", ds_port, device="cpu")
    for k, v in ref_own.MAP.items():
        np.testing.assert_array_equal(back.MAP[k], np.asarray(v))
    ref_own.prepare_grid(resolution=11)
    back.prepare_grid(resolution=11)
    np.testing.assert_allclose(back.predict_grid_proba(), np.asarray(ref_own.predict_grid_proba()), rtol=0,
                               atol=PROBA_ATOL)
    if bucket:
        assert int(_np(back._mask).sum()) == 25


def test_gpc_bucket_matches_unbucketed(tmp_path):
    """test_extras.py:505 on the port: the masked fit equals the unpadded
    one, held to the reference's fits; the latent sampler honors the mask."""
    df = _separable_df(29, 3, threshold=0.3)
    fit_kw = dict(continuous_dims=["x"], **LABEL_KW, MAP_kwargs=dict(n_restarts=3, maxiter=150))
    ref, gpc_ref = _fit_both(df, ["label"], fit_kw)
    ref_b, gpc_b = _fit_both(df, ["label"], dict(fit_kw, bucket=16))
    assert gpc_b._xc.shape[0] == 32 and int(_np(gpc_b._mask).sum()) == 29
    assert gpc_b._neg_logp == pytest.approx(gpc_ref._neg_logp, rel=1e-4)
    _assert_fits_agree(ref, gpc_ref)
    _assert_fits_agree(ref_b, gpc_b)

    X = gpc_ref.prepare_grid(resolution=21)
    p_ref = gpc_ref.predict_grid_proba()
    gpc_b.prepare_grid(resolution=21)
    p_b = gpc_b.predict_grid_proba()
    np.testing.assert_allclose(p_b, p_ref, atol=2e-3)

    trace = gpc_b.sample(latent=True, draws=40, tune=40, chains=1, seed=0)
    assert np.all(np.isfinite(trace["_latent_f"]))
    proba = gpc_b.predict_proba(X.ravel()[:5], source=trace, max_draws=16)
    assert np.all((proba >= 0) & (proba <= 1))


# ------------------------------------------------------------------
# The sparse classifier (tests/test_fitc_laplace.py's model-level tests)
# ------------------------------------------------------------------


def _binary_df(n=220, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, n)
    p = 1 / (1 + np.exp(-3 * x))
    return pd.DataFrame({"x": x, "hit": (rng.uniform(size=n) < p).astype(float)})


SPARSE_KW = dict(continuous_dims=["x"], **LABEL_KW)


@pytest.fixture(scope="module")
def sparse_pair(tmp_path_factory):
    """test_fitc_laplace.py:121's problem fitted sparse by both packages,
    and the reference loaded from the port's save."""
    df = _binary_df(n=120, seed=4)
    kw = dict(SPARSE_KW, sparse=True, n_u=24, MAP_kwargs=dict(n_restarts=2, maxiter=80))
    ref, port = _fit_both(df, ["hit"], kw)
    shared = _ref_on_port(port, df, ["hit"], tmp_path_factory.mktemp("gpc") / "sparse.npz")
    return df, ref, port, shared


def test_sparse_gpc_matches_dense_probability():
    """test_fitc_laplace.py:102 on the port."""
    df = _binary_df()
    ds = gmt.DataSet(df, outputs=["hit"])
    common = dict(SPARSE_KW, outputs=["hit"], MAP_kwargs=dict(n_restarts=2, maxiter=100))
    dense = gmt.GPC(ds, device="cpu").fit(**common)
    sparse = gmt.GPC(ds, device="cpu").fit(sparse=True, n_u=30, **common)
    assert sparse.sparse and sparse._xu_c.shape[0] == 30
    pts = gmt.parray(x=np.linspace(-1.8, 1.8, 13), stdzr=ds.stdzr)
    p_dense, p_sparse = dense.predict_proba(pts), sparse.predict_proba(pts)
    np.testing.assert_allclose(p_sparse, p_dense, atol=0.08)
    assert p_sparse[0] < 0.2 and p_sparse[-1] > 0.8


def test_sparse_gpc_fit_and_save_load(sparse_pair, tmp_path):
    """test_fitc_laplace.py:121 on the port, and the saves loaded across
    packages. The inducing points are the reference's. The fits are held as
    tests/test_torch_laplace.py holds fit_fitc_laplace_map: from the same
    two starts, one of the port's restarts ends at the reference's best
    value (45.6458, rtol 1e-9 here) and the other at a lower one (45.6242),
    so the port's fit is no worse than the reference's and within 0.005
    nats per row of it; the port's objective at the reference's MAP is the
    reference's value."""
    df, ref, port, shared = sparse_pair
    np.testing.assert_array_equal(_np(port._xu_c), np.asarray(ref._xu_c))
    assert port._neg_logp <= ref._neg_logp * (1 + 1e-9)
    assert abs(port._neg_logp - ref._neg_logp) <= BASIN_TOL * port._yz.shape[0]
    assert np.isclose(port._fit_aux["all_values"], ref._neg_logp, rtol=1e-9, atol=0).any()
    u_ref = unconstrain({k: torch.as_tensor(np.asarray(v), dtype=torch.float64) for k, v in ref.MAP.items()})
    la, lb = (torch.as_tensor(a, dtype=torch.float64) for a in (port._ls_alpha, port._ls_beta))
    at_ref = tfl.fitc_laplace_neg_logp(port._spec, u_ref, port._xc, port._xk, port._xu_c, port._xu_k, port._yz, la, lb)
    np.testing.assert_allclose(float(at_ref), ref._neg_logp, rtol=1e-9)
    path = tmp_path / "sparse.npz"
    port.save(path)
    ds = gmt.DataSet(df, outputs=["hit"])
    port2 = gmt.GPC.load(path, ds, device="cpu")
    assert port2.sparse and port2._xu_c.shape == (24, 1)
    pts = gmt.parray(x=np.linspace(-1.5, 1.5, 7), stdzr=ds.stdzr)
    p = port.predict_proba(pts)
    np.testing.assert_allclose(port2.predict_proba(pts), p, rtol=1e-6)
    np.testing.assert_allclose(p, shared.predict_proba(gmb.parray(x=np.linspace(-1.5, 1.5, 7), stdzr=shared.stdzr)),
                               rtol=0, atol=PROBA_ATOL)
    ref.save(tmp_path / "ref.npz")
    back = gmt.GPC.load(tmp_path / "ref.npz", ds, device="cpu")
    np.testing.assert_allclose(back.predict_proba(pts),
                               ref.predict_proba(gmb.parray(x=np.linspace(-1.5, 1.5, 7), stdzr=ref.stdzr)), rtol=0,
                               atol=PROBA_ATOL)


def test_sparse_gpc_unsupported_paths_raise(sparse_pair):
    """test_fitc_laplace.py:137 on the port."""
    df, _, port, _ = sparse_pair
    with pytest.raises(NotImplementedError):
        port.sample(latent=True, draws=2, tune=2, chains=1)
    pts = gmt.parray(x=np.array([0.0, 0.5]), stdzr=port.stdzr)
    with pytest.raises(NotImplementedError):
        port.draw_point_samples(pts, n_samples=2, additive_level="global")
    d = port.draw_point_samples(pts, n_samples=3)
    assert d.values().shape == (3, 2)


def test_fitc_laplace_joint_draws():
    """test_fitc_laplace.py:155 on the port's ops: the draw moments against
    ``fitc_laplace_predict``, and with inducing = training points the dense
    Laplace draw law (both on one normal block from JAX's key), each within
    1e-8 of the reference's draws on that block."""
    rng = np.random.default_rng(0)
    n = 50
    xc = np.sort(rng.uniform(-2, 2, size=(n, 1)), axis=0)
    f = 2.0 * np.sin(1.4 * xc[:, 0])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-f))).astype(float)
    jspec = jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=1, ard=True, likelihood="bernoulli")
    spec = spec_from_reference(jspec)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
    params = {"ls_total": t([0.6]), "η_total": t(1.2)}
    jparams = {"ls_total": jnp.full((1,), 0.6), "η_total": jnp.asarray(1.2)}
    xs = np.linspace(-2, 2, 9).reshape(-1, 1)
    zk = lambda m: torch.zeros((m, 0), dtype=torch.long)  # noqa: E731
    jzk = lambda m: jnp.zeros((m, 0), dtype=jnp.int32)  # noqa: E731
    key = jax.random.PRNGKey(0)
    eps = t(jax.random.normal(key, (6000, 9), dtype=jnp.float64))
    draws = _np(tfl.fitc_laplace_draw_latent(spec, params, t(xc), zk(n), t(xc[::2]), zk(25), t(y), t(xs), zk(9),
                                             n_samples=6000, eps=eps))
    mu, var, _ = (_np(a) for a in tfl.fitc_laplace_predict(spec, params, t(xc), zk(n), t(xc[::2]), zk(25), t(y),
                                                           t(xs), zk(9)))
    np.testing.assert_allclose(draws.mean(0), mu, atol=4.5 * float(np.sqrt(var.max() / 6000)) + 5e-3)
    np.testing.assert_allclose(draws.std(0), np.sqrt(var), rtol=0.1, atol=5e-3)
    ref = np.asarray(jfl.fitc_laplace_draw_latent(jspec, jparams, jnp.asarray(xc), jzk(n), jnp.asarray(xc[::2]),
                                                  jzk(25), jnp.asarray(y), jnp.asarray(xs), jzk(9), key,
                                                  n_samples=6000))
    np.testing.assert_allclose(draws, ref, rtol=0, atol=PROBA_ATOL * np.abs(ref).max())

    d_fitc = _np(tfl.fitc_laplace_draw_latent(spec, params, t(xc), zk(n), t(xc), zk(n), t(y), t(xs), zk(9),
                                              n_samples=4, eps=eps[:4]))
    d_dense = _np(tl.laplace_draw_latent(spec, params, t(xc), zk(n), t(y), t(xs), zk(9), n_samples=4, eps=eps[:4]))
    np.testing.assert_allclose(d_fitc, d_dense, rtol=0.05, atol=0.08)


def test_gpc_sparse_draw_point_samples():
    """test_fitc_laplace.py:188 on the port."""
    rng = np.random.default_rng(4)
    n = 90
    x = np.sort(rng.uniform(-3, 3, n))
    yb = (rng.uniform(size=n) < 1 / (1 + np.exp(-2.2 * x))).astype(float)
    ds = gmt.DataSet(pd.DataFrame({"x": x, "hit": yb}), outputs=["hit"])
    gpc = gmt.GPC(ds, device="cpu").fit(outputs=["hit"], **SPARSE_KW, sparse=True, n_u=15,
                                        MAP_kwargs=dict(n_restarts=2, maxiter=80))
    gpc.prepare_grid(resolution=11)
    vals = gpc.draw_grid_samples(n_samples=600, seed=0).values()
    assert vals.shape == (600, 11) and np.all(vals > 0) and np.all(vals < 1)
    np.testing.assert_allclose(vals.mean(axis=0), np.asarray(gpc.predict_grid_proba(), dtype=float), atol=0.06)
    assert "posterior_samples" in gpc.sample_vars


@pytest.mark.parametrize("sampler", ["chees", "hmc"])
def test_sparse_gpc_hyper_sample_replays_the_reference_draw_by_draw(sparse_pair, sampler):
    """The sparse classifier's per-chain sampler on JAX's keys (tune/draws
    2/2, 2 chains, HMC at 4 leapfrog steps), from the shared MAP; and its
    draws on the reference's normal block."""
    _, _, port, shared = sparse_pair
    kw = dict(draws=2, tune=2, chains=2, seed=1, sampler=sampler, n_leapfrog=4)
    tr = shared.sample(**kw)
    tp = port.sample(**kw, stream=JaxStream(jax.random.PRNGKey(1)))
    _trace_close(tp, tr)
    pts = port.parray(x=np.array([-1.0, 0.0, 1.0]))
    dp = port.draw_point_samples(pts, n_samples=3, seed=5, stream=JaxStream(jax.random.PRNGKey(5)))
    dr = shared.draw_point_samples(shared.parray(x=np.array([-1.0, 0.0, 1.0])), n_samples=3, seed=5)
    np.testing.assert_allclose(dp["hit"].values(), dr["hit"].values(), rtol=0, atol=PROBA_ATOL)


# ------------------------------------------------------------------
# Aliases, the array table, phase 19's drivers
# ------------------------------------------------------------------


def test_regression_aliases_resolve_to_the_port():
    """test_regression.py:256-265's check on the port."""
    from gumbi_tpu_torch import regression
    from gumbi_tpu_torch.regression import botorch, pymc

    assert regression.GP is gmt.GP and regression.GPC is gmt.GPC and regression.Regressor is gmt.Regressor
    assert pymc.GP is gmt.GP and pymc.GPC is gmt.GPC and pymc.PymcGP is gmt.GP and pymc.PymcGPC is gmt.GPC
    assert botorch.GP is gmt.GP and botorch.BotorchGP is gmt.GP
    assert gmt.regression is regression and gmt.models.GPC is gmt.GPC


@pytest.mark.parametrize("sparse", [False, True])
def test_array_table_gpc_equals_the_dataset_path(sparse):
    df = _binary_df(n=60, seed=8).assign(z=lambda d: np.cos(d["x"]))
    kw = dict(outputs=["hit"], continuous_dims=["x", "z"], **LABEL_KW, MAP_kwargs=dict(n_restarts=2, maxiter=30),
              **(dict(sparse=True, n_u=12) if sparse else {}))
    a = gmt.GPC(gmt.DataSet(df, outputs=["hit"]), device="cpu").fit(**kw)
    table = ArrayTable({c: df[c].to_numpy() for c in df.columns}, outputs=["hit"])
    b = ArrayTableGPC(table, outputs=["hit"], device="cpu").fit(**kw)
    assert isinstance(b, gmt.GPC)
    np.testing.assert_array_equal(_np(a._xc), _np(b._xc))
    np.testing.assert_array_equal(_np(a._yz), _np(b._yz))
    assert a._neg_logp == b._neg_logp
    a.prepare_grid(resolution=6)
    b.prepare_grid(resolution=6)
    np.testing.assert_array_equal(a.predict_grid_proba(), b.predict_grid_proba())


def test_phase19_drivers_on_the_cpu(tmp_path):
    """chip_smoke's phase 19 (a)-(e) drivers at a small N on the CPU, at f64,
    with their checks: the same calls the card runs at f32."""
    r = chip_smoke.phase19_run(device="cpu", dtype=torch.float64, n_dense=120, n_sampler=32, n_sparse=240,
                               n_sparse_sampler=64, n_u=12, n_u_sampler=6, grid=10, small=True,
                               tmp_dir=str(tmp_path))
    a, b, c, h, d, e = (r[k] for k in ("dense", "latent", "chees", "hmc", "sparse", "sparse_chees"))
    assert a["loaded_equal"] and d["loaded_equal"]
    # at f64 the twin is the model itself, and the two sums agree to rounding
    assert a["per_pt"] == 0.0 and a["dprob"] == 0.0 and d["per_pt"] == 0.0 and c["median_gap"][2] == 0.0
    assert a["sums"]["f32_sum"] <= 1e-12 * max(a["sums"]["scale"], 1.0) and a["sums"]["f64_sum"] <= 1e-12 * max(
        a["sums"]["scale"], 1.0)
    assert a["draws"].shape == (4, 10, 10) and np.isfinite(a["draws"]).all() and a["floor"] == 1e-6
    assert c["calls"] == 1 + c["leapfrog_steps"] and h["calls"] == 1 + 6 * 4
    assert b["trace"]["_latent_f"].shape == (2, 10, 120) and np.isfinite(b["prob"]).all()
    assert d["draws"].shape == (4, 200) and np.isfinite(d["draws"]).all()
    for trace in (b["trace"], c["chees"], h["trace"], e["trace"]):
        assert all(np.isfinite(v).all() for k, v in trace.items() if not k.startswith("_"))
