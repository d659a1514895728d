"""Port parity: gumbi_tpu_torch.ops.acquisition against gumbi_tpu.ops.acquisition.

The same inputs, from numpy seeds, through the JAX function and the port's
at f64 on the CPU, with the reference's posterior cache carried across by
``convert.posterior_cache_from_numpy``: Sobol blocks (bit-equal), EI/UCB,
the joint samples and qLogNEI given the same Sobol block, the 2-D and QMC
hypervolumes, both qLogNEHVI acquisitions (joint cache and model list), the
model list's block layout, the batched raw sweep against one-at-a-time
evaluation, both optimizers against the reference's optimum, and the named
f32 divergence of the joint factor's floor. Comparisons are at rtol 1e-9
unless a test says why not.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gumbi_tpu.ops.acquisition as ja
import gumbi_tpu.ops.kernels as jk
import gumbi_tpu.ops.posterior as jpost
import gumbi_tpu.ops.priors as jp
import gumbi_tpu_torch.ops.acquisition as ta
from gumbi_tpu_torch.convert import params_from_numpy, posterior_cache_from_numpy, spec_from_reference
from gumbi_tpu_torch.ops.kernels import gram
from gumbi_tpu_torch.ops.posterior import joint_draws

torch.set_num_threads(2)

RTOL = 1e-9
F64 = dict(dtype=torch.float64, device="cpu")
N, Q, NB, S = 20, 3, 6, 64


def _model(jspec, n, seed, n_out=1, params=None):
    """A GP on ``n`` locations over 2 dims (``n_out`` outputs stacked
    output-major, level index in column 0): reference params (restart 1 of
    ``initial_params`` unless given), its cache, and both packages' copies."""
    rng = np.random.default_rng(seed)
    locs = rng.uniform(-2, 2, size=(n, 2))
    xc = np.concatenate([locs] * n_out)
    xk = np.repeat(np.arange(n_out), n).reshape(-1, 1)[:, : 1 if n_out > 1 else 0].astype(np.int32)
    y = np.concatenate([np.sin(1.3 * locs[:, 0] + j) * np.cos(0.9 * locs[:, 1]) for j in range(n_out)])
    y = y + rng.normal(0, 0.1, len(y))
    if params is None:
        la, lb = jp.ls_prior_params([0.3, 0.3], [4.0, 4.0])
        params = jp.constrain({k: v[1] for k, v in jp.initial_params(jspec, la, lb, 2, seed=seed).items()})
    params = {k: np.asarray(v) for k, v in params.items()}
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    cache = jpost.posterior_cache(jspec, pj, jnp.asarray(xc), jnp.asarray(xk), jnp.asarray(y))
    return dict(jspec=jspec, spec=spec_from_reference(jspec), locs=locs, pj=pj, pt=params_from_numpy(params, **F64),
                cj=cache, ct=posterior_cache_from_numpy(cache, **F64))


def _one_output(seed=0, n=N):
    return _model(jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2), n, seed)


def _two_outputs(seed=1):
    cg = jk.CoregTerm(name="Parameter", col=0, d_out=2, rank=1)
    jspec = jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad", coregs=(cg,)),), d_cont=2)
    return _model(jspec, N, seed, n_out=2)


@pytest.fixture(scope="module")
def one():
    return _one_output()


@pytest.fixture(scope="module")
def two():
    return _two_outputs()


@pytest.fixture(scope="module")
def indep():
    """Three single-output sub-models (the Independent structure's model list)."""
    return [_one_output(seed=10 + j) for j in range(3)]


def _both(a):
    return jnp.asarray(a), torch.tensor(a)


def _close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _cand(rng, q=Q, lead=()):
    return rng.uniform(-2, 2, size=(*lead, q, 2))


def _rows(d_out, n):
    """Output-major level column: n rows per output."""
    return np.repeat(np.arange(d_out), n).reshape(-1, 1).astype(np.int32)


def test_sobol_blocks_are_the_reference_bits():
    np.testing.assert_array_equal(ta.sobol_uniform(256, 5, seed=3), ja.sobol_uniform(256, 5, seed=3))
    np.testing.assert_array_equal(ta.sobol_normal(256, 68, seed=0), ja.sobol_normal(256, 68, seed=0))


@pytest.mark.parametrize("maximize", [True, False])
def test_expected_improvement_and_ucb(maximize):
    rng = np.random.default_rng(0)
    mean, var = rng.normal(size=50), rng.uniform(0, 2, size=50)
    var[:3] = 0.0
    (mj, mt), (vj, vt) = _both(mean), _both(var)
    _close(ta.expected_improvement(mt, vt, 0.3, maximize=maximize, xi=0.01),
           ja.expected_improvement(mj, vj, 0.3, maximize=maximize, xi=0.01), rtol=1e-13, atol=1e-300)
    _close(ta.upper_confidence_bound(mt, vt, beta=1.7, maximize=maximize),
           ja.upper_confidence_bound(mj, vj, beta=1.7, maximize=maximize), rtol=1e-14)


def test_joint_samples_given_the_same_sobol_block(one):
    """Mean + eps·Lᵀ at candidate and baseline rows: at f64 the port's floor
    is the reference's jitter, so the draws are the reference's."""
    rng = np.random.default_rng(2)
    xj, xt = _both(rng.uniform(-2, 2, size=(Q + NB, 2)))
    eps = ja.sobol_normal(S, Q + NB, seed=0)
    yj = ja._joint_samples(one["jspec"], one["pj"], one["cj"], xj, jnp.zeros((Q + NB, 0), jnp.int32), jnp.asarray(eps))
    yt = ta._joint_samples(one["spec"], one["pt"], one["ct"], xt, torch.zeros((Q + NB, 0), dtype=torch.long),
                           torch.tensor(eps))
    _close(yt, yj, atol=1e-12)


@pytest.mark.parametrize("maximize", [True, False])
def test_qlog_nei_given_the_same_sobol_block(one, maximize):
    rng = np.random.default_rng(3)
    (cj, ct), (bj, bt) = _both(_cand(rng)), _both(one["locs"][:NB])
    eps = ja.sobol_normal(S, Q + NB, seed=1)
    vj = ja.qlog_nei(one["jspec"], one["pj"], one["cj"], cj, jnp.zeros((Q, 0), jnp.int32), bj,
                     jnp.zeros((NB, 0), jnp.int32), jnp.asarray(eps), maximize=maximize)
    vt = ta.qlog_nei(one["spec"], one["pt"], one["ct"], ct, torch.zeros((Q, 0), dtype=torch.long), bt,
                     torch.zeros((NB, 0), dtype=torch.long), torch.tensor(eps), maximize=maximize)
    _close(vt, vj)


def test_hv2d_against_the_reference_and_known_values():
    ref_j, ref_t = _both(np.array([0.0, 0.0]))
    assert np.isclose(float(ta._hv2d(torch.tensor([[1.0, 3.0], [3.0, 1.0], [0.5, 0.5]]), ref_t)), 5.0)
    rng = np.random.default_rng(4)
    for _ in range(10):
        pts = rng.uniform(-0.5, 3.0, size=(7, 2))
        _close(ta._hv2d(torch.tensor(pts), ref_t), ja._hv2d(jnp.asarray(pts), ref_j), rtol=1e-14)
    batch = rng.uniform(-0.5, 3.0, size=(4, 5, 7, 2))  # leading batch axes
    hb = ta._hv2d(torch.tensor(batch), ref_t)
    for i in np.ndindex(4, 5):
        _close(hb[i], ja._hv2d(jnp.asarray(batch[i]), ref_j), rtol=1e-14)


def test_hv_dominated_mc_against_the_reference():
    rng = np.random.default_rng(5)
    u = ja.sobol_uniform(2048, 3, seed=3)
    for _ in range(5):
        pts = rng.uniform(0.1, 3.0, size=(6, 3))
        _close(ta.hv_dominated_mc(torch.tensor(pts), torch.zeros(3, dtype=torch.float64), torch.tensor(u)),
               ja.hv_dominated_mc(jnp.asarray(pts), jnp.zeros(3), jnp.asarray(u)), rtol=1e-14)


def _nehvi_inputs(model_locs, d_out, q, seed):
    rng = np.random.default_rng(seed)
    cand = _cand(rng, q)
    base = model_locs[:NB]
    return dict(xc_c=np.concatenate([cand] * d_out), xk_c=_rows(d_out, q), xc_b=np.concatenate([base] * d_out),
                xk_b=_rows(d_out, NB), eps=ja.sobol_normal(S, d_out * (q + NB), seed=seed), cand=cand)


def _indep_fns(indep):
    fj = ja.make_indep_sample_fn(indep[0]["jspec"], [m["pj"] for m in indep], [m["cj"] for m in indep], 0)
    ft = ta.make_indep_sample_fn(indep[0]["spec"], [m["pt"] for m in indep], [m["ct"] for m in indep], 0)
    return fj, ft


@pytest.mark.parametrize("structure", ["joint", "model_list"])
def test_qlog_nehvi_2d(two, indep, structure):
    """Two outputs, from the Hadamard LMC's joint cache or from a model list
    of the first two sub-models."""
    d = _nehvi_inputs(two["locs"], 2, 2, seed=6)
    fj = ft = None
    if structure == "model_list":
        fj, ft = _indep_fns(indep[:2])
    args_j = [jnp.asarray(d[k]) for k in ("xc_c", "xk_c", "xc_b", "xk_b", "eps")]
    args_t = [torch.tensor(d[k]) for k in ("xc_c", "xk_c", "xc_b", "xk_b", "eps")]
    for maximize in (True, False):
        ref = np.array([-1.5, -1.2]) if maximize else np.array([1.5, 1.2])
        vj = ja.qlog_nehvi_2d(two["jspec"], two["pj"], two["cj"], *args_j, jnp.asarray(ref), maximize=maximize,
                              sample_fn=fj)
        vt = ta.qlog_nehvi_2d(two["spec"], two["pt"], two["ct"], *args_t, ref, maximize=maximize, sample_fn=ft)
        _close(vt, vj)


@pytest.mark.parametrize("structure", ["joint", "model_list"])
def test_qlog_nehvi_mc(two, indep, structure):
    """The QMC-box acquisition: 2 outputs from the joint cache, 3 from the
    model list."""
    d_out = 2 if structure == "joint" else 3
    d = _nehvi_inputs(two["locs"] if d_out == 2 else indep[0]["locs"], d_out, 1, seed=7)
    fj = ft = None
    if structure == "model_list":
        fj, ft = _indep_fns(indep)
    u_box = ja.sobol_uniform(256, d_out, seed=8)
    ref = -1.5 * np.ones(d_out)
    vj = ja.qlog_nehvi_mc(two["jspec"], two["pj"], two["cj"], *[jnp.asarray(d[k]) for k in ("xc_c", "xk_c", "xc_b",
                          "xk_b", "eps")], jnp.asarray(ref), jnp.asarray(u_box), d_out, sample_fn=fj)
    vt = ta.qlog_nehvi_mc(two["spec"], two["pt"], two["ct"], *[torch.tensor(d[k]) for k in ("xc_c", "xk_c", "xc_b",
                          "xk_b", "eps")], ref, u_box, d_out, sample_fn=ft)
    _close(vt, vj)


def test_indep_sample_fn_block_layout(indep):
    """tests/test_bo.py's layout oracle on the port: each output's rows are
    its own sub-model's mean + eps·Lᵀ, and the whole block equals the
    reference's sampler's."""
    q, nb, d_out = 2, 3, 2
    P = d_out * (q + nb)
    rng = np.random.default_rng(9)
    xc = rng.uniform(-2, 2, (P, 1)).repeat(2, 1)
    xk = np.concatenate([np.repeat([0, 1], q), np.repeat([0, 1], nb)]).reshape(-1, 1).astype(np.int32)
    eps = ja.sobol_normal(64, P, seed=3)
    fj, ft = _indep_fns(indep[:2])
    ys_t = ft(torch.tensor(xc), torch.tensor(xk), torch.tensor(eps), d_out, q, nb)
    _close(ys_t, fj(jnp.asarray(xc), jnp.asarray(xk), jnp.asarray(eps), d_out, q, nb), atol=1e-12)
    for j in range(d_out):
        idx = np.concatenate([np.arange(j * q, (j + 1) * q), np.arange(d_out * q + j * nb, d_out * q + (j + 1) * nb)])
        m = indep[j]
        mean, cov = jpost.predict_cov(m["jspec"], m["pj"], m["cj"], jnp.asarray(xc[idx]), jnp.zeros((q + nb, 0),
                                      jnp.int32), with_noise=False)
        L = np.linalg.cholesky(np.asarray(cov) + 1e-6 * np.eye(q + nb))
        _close(ys_t[:, idx], np.asarray(mean)[None, :] + eps[:, idx] @ L.T, rtol=1e-8, atol=1e-10)


def test_batched_raw_sweep_equals_one_at_a_time(two, indep, monkeypatch):
    """Each acquisition on a (R, q, d) stack of raw q-batches, in chunks of
    5 (``RAW_CHUNK`` set so that R = 12 ends in a partial chunk), against a
    loop over the R blocks (rtol 1e-12: one (B·P)² Gram and batched factors
    against B separate ones)."""
    rng = np.random.default_rng(11)
    R = 12
    raw = torch.tensor(_cand(rng, 2, lead=(R,)))
    d = _nehvi_inputs(two["locs"], 2, 2, seed=12)
    xk_c, xc_b, xk_b = (torch.tensor(d[k]) for k in ("xk_c", "xc_b", "xk_b"))
    eps2 = torch.tensor(d["eps"])
    eps1 = torch.tensor(ja.sobol_normal(S, 2 + NB, seed=13))
    _, ft = _indep_fns(indep)
    d3 = _nehvi_inputs(indep[0]["locs"], 3, 2, seed=14)
    m = indep[0]
    acqs = {
        "qlog_nei": lambda X: ta.qlog_nei(m["spec"], m["pt"], m["ct"], X, torch.zeros((2, 0), dtype=torch.long),
                                          torch.tensor(m["locs"][:NB]), torch.zeros((NB, 0), dtype=torch.long), eps1),
        "qlog_nehvi_2d": lambda X: ta.qlog_nehvi_2d(two["spec"], two["pt"], two["ct"], torch.cat([X, X], -2), xk_c,
                                                    xc_b, xk_b, eps2, [-1.5, -1.2]),
        "qlog_nehvi_mc": lambda X: ta.qlog_nehvi_mc(m["spec"], None, None, torch.cat([X, X, X], -2),
                                                    torch.tensor(d3["xk_c"]), torch.tensor(d3["xc_b"]),
                                                    torch.tensor(d3["xk_b"]), torch.tensor(d3["eps"]), -1.5 * np.ones(3),
                                                    ja.sobol_uniform(128, 3, seed=2), 3, sample_fn=ft),
    }
    monkeypatch.setattr(ta, "RAW_CHUNK", 5)
    for name, acq in acqs.items():
        swept = ta.raw_sweep(acq, raw)
        one_by_one = torch.stack([acq(raw[i]) for i in range(R)])
        assert swept.shape == (R,)
        _close(swept, one_by_one.numpy(), rtol=1e-12)


def _quadratic_j(center):
    """A unimodal acquisition: 1 − Σ (X − c)², max 1 at c (reference side)."""
    return lambda X: 1.0 - jnp.sum((X - center) ** 2, axis=(-2, -1))


def _quadratic_t(center):
    """The same acquisition on the port's side, on (..., q, d) batches."""
    return lambda X: 1.0 - ((X - torch.tensor(center)) ** 2).sum((-2, -1))


def test_optimize_acqf_reaches_the_reference_optimum():
    """The same raw starts and top-k, then each package's L-BFGS (the port's
    backtracking host loop, the reference's optax zoom search): the optimum's
    value within 1e-6 relative."""
    center = np.array([[0.3, -0.4], [-0.2, 0.5]])
    bounds = (np.array([-1.0, -1.0]), np.array([1.0, 1.0]))
    kw = dict(q=2, num_restarts=4, raw_samples=32, seed=5, maxiter=60)
    xj, vj = ja.optimize_acqf(_quadratic_j(center), tuple(jnp.asarray(b) for b in bounds), **kw)
    xt, vt, aux = ta.optimize_acqf(_quadratic_t(center), bounds, device="cpu", return_aux=True, **kw)
    raw = ja.sobol_uniform(32 * 2, 2, seed=5).reshape(32, 2, 2) * 2.0 - 1.0
    raw_vals = jax.lax.map(_quadratic_j(center), jnp.asarray(raw))
    _close(aux["raw_values"], raw_vals, rtol=1e-14)
    np.testing.assert_array_equal(aux["top"].numpy(), np.asarray(jnp.argsort(-raw_vals)[:4]))
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-6)
    np.testing.assert_allclose(xt.numpy(), center, atol=2e-3)
    assert xt.shape == (2, 2) and bool(((xt >= -1) & (xt <= 1)).all())


def test_optimize_qlog_nei_reaches_the_reference_optimum():
    """``GP.propose``'s single-output route at q = 1: the same raw starts and
    top-k, then the optimum's value within 1e-6 relative. The optimum lies
    on the box's bound in one coordinate, which the sigmoid map reaches only
    as u → ∞, and the two L-BFGS stop at different u: the port's when an
    iteration lowers the value by less than 1e-6 relative (the reference's
    ``lbfgs_host_minimize`` rule), the reference's zoom search when the
    gradient norm falls below 1e-6. As returned the two values agree within
    1e-5 (the port's x sits ~2e-6 short of the bound); each taken to the
    bound it approaches, within 1e-6 (measured ~1e-9)."""
    jspec = jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2)
    m = _model(jspec, 16, seed=15, params={"ls_total": np.array([0.8, 0.8]), "η_total": np.array(1.0),
                                             "σ": np.array(0.1)})
    base = m["locs"][:NB]
    eps = ja.sobol_normal(64, 1 + NB, seed=0)
    lo, hi = m["locs"].min(0), m["locs"].max(0)
    raw = ja.sobol_uniform(32, 2, seed=0).reshape(32, 1, 2)
    X_raw = raw * (hi - lo) + lo
    xj, vj = ja.optimize_qlog_nei(jspec, m["pj"], m["cj"], jnp.zeros((1, 0), jnp.int32), jnp.asarray(base),
                                  jnp.zeros((NB, 0), jnp.int32), jnp.asarray(eps), jnp.asarray(X_raw), jnp.asarray(lo),
                                  jnp.asarray(hi), num_restarts=3, maxiter=60)
    xt, vt, aux = ta.optimize_qlog_nei(m["spec"], m["pt"], m["ct"], torch.zeros((1, 0), dtype=torch.long),
                                       torch.tensor(base), torch.zeros((NB, 0), dtype=torch.long), torch.tensor(eps),
                                       torch.tensor(X_raw), torch.tensor(lo), torch.tensor(hi), num_restarts=3,
                                       maxiter=60, return_aux=True)
    acq_j = lambda X: ja.qlog_nei(jspec, m["pj"], m["cj"], X, jnp.zeros((1, 0), jnp.int32), jnp.asarray(base),  # noqa: E731
                                  jnp.zeros((NB, 0), jnp.int32), jnp.asarray(eps))
    raw_vals = jax.lax.map(acq_j, jnp.asarray(X_raw))
    _close(aux["raw_values"], raw_vals)
    np.testing.assert_array_equal(aux["top"].numpy(), np.asarray(jnp.argsort(-raw_vals)[:3]))
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-5)
    assert bool(((xt >= torch.tensor(lo)) & (xt <= torch.tensor(hi))).all())

    # The sigmoid map reaches a bound only as u → ∞, and here the optimum
    # lies on the box's upper bound in x0: where each optimizer stopped,
    # x0 is short of it by (hi − lo)·e^(−u), ~2e-6 for the port's u of 14
    # and ~7e-8 for the reference's, and the value by as much times its
    # slope. Each optimum is taken to the bound it approaches.
    def on_bound(x):
        x = np.asarray(x)
        span = hi - lo
        return np.where(x - lo < 1e-5 * span, lo, np.where(hi - x < 1e-5 * span, hi, x))

    xt_b, xj_b = on_bound(xt.numpy()), on_bound(xj)
    assert (xt_b != xt.numpy()).any()
    vt_b = float(ta.qlog_nei(m["spec"], m["pt"], m["ct"], torch.tensor(xt_b), torch.zeros((1, 0), dtype=torch.long),
                             torch.tensor(base), torch.zeros((NB, 0), dtype=torch.long), torch.tensor(eps)))
    vj_b = float(acq_j(jnp.asarray(xj_b)))
    assert vt_b >= float(vt) and vj_b >= float(vj)
    np.testing.assert_allclose(vt_b, vj_b, rtol=1e-6)


# ------------------------------------------------------------------
# The named f32 divergence: the joint factor's floor
# ------------------------------------------------------------------


def _smooth_problem():
    """GP.propose's setting at f32: a smooth fitted surface at N = 256 over
    2 dims, 64 of its training rows as the baseline."""
    jspec = jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2)
    n = 256
    rng = np.random.default_rng(0)
    locs = rng.uniform(-2, 2, size=(n, 2))
    y = np.sin(1.3 * locs[:, 0]) * np.cos(0.9 * locs[:, 1]) + rng.normal(0, 0.1, n)
    params = {"ls_total": np.array([1.28, 1.80]), "η_total": np.array(0.76), "σ": np.array(0.10)}
    base = locs[np.random.default_rng(1).choice(n, 64, replace=False)]
    return dict(jspec=jspec, spec=spec_from_reference(jspec), n=n, locs=locs, y=y, params=params, base=base)


def _port_state(pr, dtype, np_dtype):
    """The port's parameters and the reference's posterior cache at ``dtype``."""
    kw = dict(dtype=dtype, device="cpu")
    c = jpost.posterior_cache(pr["jspec"], {k: jnp.asarray(v, np_dtype) for k, v in pr["params"].items()},
                              jnp.asarray(pr["locs"], np_dtype), jnp.zeros((pr["n"], 0), jnp.int32),
                              jnp.asarray(pr["y"], np_dtype))
    return params_from_numpy(pr["params"], **kw), posterior_cache_from_numpy(c, **kw)


def test_joint_covariance_factors_at_f32_where_the_reference_is_nan():
    """GP.propose's qLogNEI block at f32 (q = 4 candidates + 64 training
    rows as the baseline, N = 256, a smooth fitted surface): the noise-free
    posterior covariance is numerically low rank, the f32 accumulation of
    VᵀV takes its smallest eigenvalues below −1e-6, and the reference's
    jittered factor is NaN for every block. The port forms Kss, Kss − VᵀV
    and its factor in f64: every block factors with the same 1e-6 jitter,
    and the f32 values sit within 1e-4 relative of the port's f64 ones
    (random raw blocks lie deep in the tail, log EI from −58 to −12, where
    a log unit is not the scale; chip_smoke.py holds the optimum in log
    units)."""
    pr = _smooth_problem()
    jspec, spec, n, base = pr["jspec"], pr["spec"], pr["n"], pr["base"]
    f32 = {k: jnp.asarray(v, jnp.float32) for k, v in pr["params"].items()}
    cache = jpost.posterior_cache(jspec, f32, jnp.asarray(pr["locs"], jnp.float32), jnp.zeros((n, 0), jnp.int32),
                                  jnp.asarray(pr["y"], jnp.float32))
    raw = ja.sobol_uniform(8 * 4, 2, seed=0).reshape(8, 4, 2) * 4 - 2
    eps = ja.sobol_normal(64, 68, seed=0)
    vals_j = [float(ja.qlog_nei(jspec, f32, cache, jnp.asarray(r, jnp.float32), jnp.zeros((4, 0), jnp.int32),
                                jnp.asarray(base, jnp.float32), jnp.zeros((64, 0), jnp.int32),
                                jnp.asarray(eps, jnp.float32))) for r in raw]
    assert np.isnan(vals_j).all()

    def sweep(dtype, np_dtype):
        kw = dict(dtype=dtype, device="cpu")
        p, c = _port_state(pr, dtype, np_dtype)
        return ta.raw_sweep(
            lambda X: ta.qlog_nei(spec, p, c, X, torch.zeros((4, 0), dtype=torch.long), torch.tensor(base, **kw),
                                  torch.zeros((64, 0), dtype=torch.long), torch.tensor(eps, **kw)),
            torch.tensor(raw, **kw))

    v32, v64 = sweep(torch.float32, np.float32), sweep(torch.float64, np.float64)
    assert bool(torch.isfinite(v32).all())
    np.testing.assert_allclose(v32.double().numpy(), v64.numpy(), rtol=1e-4)


def test_joint_draws_at_f32_form_the_prior_block_in_f64():
    """The joint draws at one candidate + the 64 baseline rows, f32 against
    f64 on the same Sobol normals. Kss's f32 rounding (~eps·η² an entry)
    moves the low-rank covariance's near-null directions by about its
    square root, so draws formed from the f32 Kss (cancelled and factored
    in f64 all the same) sit several times further from the f64 draws
    than the port's, which forms Kss in f64: the port's within 2e-4, the
    f32 Kss's at least 4 times as far."""
    pr = _smooth_problem()
    spec = pr["spec"]
    xj = np.concatenate([[[0.5, -0.3]], pr["base"]])
    zk = torch.zeros((65, 0), dtype=torch.long)
    eps = ja.sobol_normal(64, 65, seed=0)
    draws = {}
    for dtype, np_dtype in ((torch.float32, np.float32), (torch.float64, np.float64)):
        p, c = _port_state(pr, dtype, np_dtype)
        draws[dtype] = ta._joint_samples(spec, p, c, torch.tensor(xj, dtype=dtype), zk, torch.tensor(eps, dtype=dtype))
    err = float((draws[torch.float32].double() - draws[torch.float64]).abs().max())

    p, c = _port_state(pr, torch.float32, np.float32)
    x32 = torch.tensor(xj, dtype=torch.float32)
    mean, cov, prior = ta._joint_mean_cov(spec, p, c, x32, zk)
    p64 = {k: v.double() for k, v in p.items()}
    kss32_rounding = gram(spec, p, x32, zk, x32, zk).double() - gram(spec, p64, x32.double(), zk, x32.double(), zk)
    from_f32_kss = joint_draws(mean.double(), cov + kss32_rounding, prior.double(), 1e-6, eps=torch.tensor(eps))
    err_f32_kss = float((from_f32_kss - draws[torch.float64]).abs().max())
    assert bool(torch.isfinite(draws[torch.float32]).all())
    assert err <= 2e-4 and err_f32_kss >= 4 * err  # measured 7.7e-5 and 5.7e-4


def test_joint_mean_at_f32_is_the_f64_product():
    """The joint posterior mean Ks·α sums N terms of up to |α|·η² (|α| ~ 25
    here) into an O(1) value, so its f32 accumulation (the reference's
    ``Ks @ alpha``) carries the summation's rounding: ~1e-5 on the CPU at
    N = 256, and 1.9e-3 log units of qLogNEI at phase 12a's candidate on
    the card. The port forms the product in f64 from the f32 factors:
    equal to the f64 product of the same f32 Ks and α within 1e-12."""
    pr = _smooth_problem()
    p, c = _port_state(pr, torch.float32, np.float32)
    x32 = torch.tensor(np.concatenate([[[0.5, -0.3]], pr["base"]]), dtype=torch.float32)
    zk = torch.zeros((65, 0), dtype=torch.long)
    mean, _, _ = ta._joint_mean_cov(pr["spec"], p, c, x32, zk)
    Ks = gram(pr["spec"], p, x32, zk, c.xc, c.xk)
    exact = Ks.double() @ c.alpha.double()
    assert mean.dtype == torch.float64
    np.testing.assert_allclose(mean.numpy(), exact.numpy(), rtol=0, atol=1e-12)
    assert float(((Ks @ c.alpha).double() - exact).abs().max()) > 1e-6


def test_port_and_chip_smoke_sources_import_neither_jax_nor_the_reference():
    """No import line of the port's modules or of chip_smoke.py names
    ``jax`` or ``gumbi_tpu`` (the port imports torch, numpy and scipy only)."""
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parents[1]
    pattern = re.compile(r"^\s*(import|from)\s+(jax|gumbi_tpu)(\s|\.|$)")
    package = root / "gumbi_tpu_torch"
    files = sorted(f for f in package.rglob("*.py") if "_build" not in f.relative_to(package).parts)
    files.append(root / "chip_smoke.py")
    assert any(f.name == "acquisition.py" for f in files) and any(f.name == "ess.py" for f in files)
    bad = [f"{f.relative_to(root)}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1) if pattern.match(line)]
    assert not bad, bad
