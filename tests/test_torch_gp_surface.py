"""The rest of the port's ``GP`` surface against the JAX reference, at f64 on the CPU.

Each fixture fits the port once (``gmt.GP(..., device="cpu")``), saves it,
and loads the save file in the reference (``gmb.GP.load``), so both models
hold the same MAP and what is compared is this slice alone:

* ``draw_point_samples``/``draw_grid_samples`` (MAP, the joint multi-output
  Kronecker draws, Independent, ``additive_level``, ``source=`` a trace)
  given JAX's own normal blocks through ``stream=`` (rtol 1e-8);
* the ``predict_grad`` family on ``tests/test_regression_extra.py``'s two
  gradient cases (multi-output, Independent), norms included (rtol 1e-8);
* ``GP.sample`` (ChEES and HMC, tune/draws 5/5) draw by draw on JAX's
  keys, within 1e-8 of each array's largest entry;
* ``GP.propose(q=)`` (qLogNEI, qLogNEHVI-2d, the three-output QMC box,
  Independent, ``sequential=True``): the same Sobol blocks and raw starts,
  each package's L-BFGS; values at rtol 1e-5, candidates on the box's
  bounds equal and inside it within 2e-3 in z-units;
* the draws' floor (``ops.posterior.draw_floor``): the reference's jitter
  at f64, and finite f32 draws where the reference's are NaN;
* ``Regressor.cross_validate`` and ``propose(target=)``, which step 9a
  carried whole, on the reference's own test cases.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import gumbi_tpu as gmb
import gumbi_tpu.ops.posterior as jpost
import gumbi_tpu_torch as gmt
import gumbi_tpu_torch.ops.acquisition as ta
import gumbi_tpu_torch.ops.posterior as tpost
from gumbi_tpu_torch.convert import params_from_numpy, posterior_cache_from_numpy, spec_from_reference
from test_torch_hmc import JaxStream

torch.set_num_threads(2)

DRAW_RTOL = 1e-8
GRAD_RTOL = 1e-8
TRACE_TOL = 1e-8  # of each trace array's largest entry
# Values as returned: where the optimum lies on the box's bound, each
# optimizer stops short of it by its own (hi − lo)·e^(−u) (see
# ``_on_bound``) and the value by as much times its slope
# (``tests/test_torch_acquisition.py``: 1.1e-6 relative at qLogNEI's)
PROPOSE_VALUE_RTOL = 1e-5
MAP_KW = dict(n_restarts=2, maxiter=100)
CARS_KW = dict(outputs=["mpg", "acceleration"], log_vars=["mpg", "acceleration", "horsepower"])


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _pair(tmp_path_factory, frame, ds_kw, fit_kw):
    """The port fitted on ``frame`` and the reference loaded from its save."""
    port = gmt.GP(gmt.DataSet(frame, **ds_kw), device="cpu").fit(**fit_kw, MAP_kwargs=MAP_KW)
    path = tmp_path_factory.mktemp("gp") / "gp.npz"
    port.save(path)
    ref = gmb.GP.load(path, gmb.DataSet(frame, **ds_kw))
    assert ref._structure == port._structure
    return ref, port


def _linear_frame(n_out=2):
    """``tests/test_regression_extra.py``'s gradient oracle: a 5×5 grid of
    y = x₀ + x₁ (+ 0.5 per further output)."""
    g1, g2 = np.meshgrid(np.linspace(0, 1, 5), np.linspace(0, 1, 5))
    cols = {"input_0": g1.ravel(), "input_1": g2.ravel()}
    cols.update({f"output_{j}": (g1 + g2).ravel() + 0.5 * j for j in range(n_out)})
    return pd.DataFrame(cols)


LINEAR_DS = dict(outputs=["output_0", "output_1"])
LINEAR_FIT = dict(outputs=["output_0", "output_1"], continuous_dims=["input_0", "input_1"])


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """``tests/test_extras.py``'s small cars table, one output (Hadamard)."""
    return _pair(tmp_path_factory, gmb.data.cars(n=40, seed=11), CARS_KW,
                 dict(outputs=["mpg"], continuous_dims=["horsepower"]))


@pytest.fixture(scope="module")
def kron(tmp_path_factory):
    """The multi-output gradient case (Kronecker auto-selected)."""
    return _pair(tmp_path_factory, _linear_frame(), LINEAR_DS, LINEAR_FIT)


@pytest.fixture(scope="module")
def indep(tmp_path_factory):
    """The Independent gradient case."""
    return _pair(tmp_path_factory, _linear_frame(), LINEAR_DS, dict(**LINEAR_FIT, multitask_kernel="Independent"))


@pytest.fixture(scope="module")
def additive(tmp_path_factory):
    return _pair(tmp_path_factory, gmb.data.cars(n=40, seed=11), CARS_KW,
                 dict(outputs=["mpg"], continuous_dims=["horsepower"], categorical_dims=["origin"], additive=True))


CARS2_FIT = dict(outputs=["mpg", "acceleration"], continuous_dims=["horsepower"])


@pytest.fixture(scope="module")
def cars2(tmp_path_factory):
    """``tests/test_bo.py``'s two-output qLogNEHVI table (Kronecker)."""
    return _pair(tmp_path_factory, gmb.data.cars(n=40, seed=4), CARS_KW, CARS2_FIT)


@pytest.fixture(scope="module")
def cars2_indep(tmp_path_factory):
    return _pair(tmp_path_factory, gmb.data.cars(n=40, seed=4), CARS_KW,
                 dict(**CARS2_FIT, multitask_kernel="Independent"))


@pytest.fixture(scope="module")
def three(tmp_path_factory):
    """``tests/test_bo.py``'s cars table with three outputs (Kronecker)."""
    kw = dict(outputs=["mpg", "acceleration", "weight"], log_vars=["mpg", "acceleration", "horsepower", "weight"])
    return _pair(tmp_path_factory, gmb.data.cars(n=60, seed=3), kw,
                 dict(outputs=kw["outputs"], continuous_dims=["horsepower"]))


@pytest.fixture(scope="module")
def trace(single):
    """A short reference ChEES trace of the single-output model."""
    ref, _ = single
    return ref.sample(draws=4, tune=4, chains=2, seed=5)


def _close_parrays(p, r, rtol):
    assert p.names == r.names and p.shape == r.shape
    for name in r.names:
        np.testing.assert_allclose(p[name].values(), r[name].values(), rtol=rtol, atol=0, err_msg=name)


# ------------------------------------------------------------------
# Draws
# ------------------------------------------------------------------

DRAW_CASES = {
    # fixture, draw kwargs, grid kwargs
    "map_single": ("single", {}, {}),
    "joint_multi_output": ("kron", {}, {}),
    "joint_multi_output_with_noise": ("kron", dict(with_noise=True), {}),
    "independent": ("indep", {}, {}),
    "additive_global": ("additive", dict(additive_level="global"), dict(categorical_levels={"origin": "usa"})),
    "additive_origin": ("additive", dict(additive_level="origin"), dict(categorical_levels={"origin": "japan"})),
}


@pytest.mark.parametrize("case", list(DRAW_CASES))
def test_grid_draws_match_the_reference_on_its_normal_block(case, request):
    fixture, draw_kw, grid_kw = DRAW_CASES[case]
    ref, port = request.getfixturevalue(fixture)
    for gp in (ref, port):
        gp.prepare_grid(resolution=6)
    yr = ref.draw_grid_samples(n_samples=3, seed=7, **draw_kw, **grid_kw)
    yp = port.draw_grid_samples(n_samples=3, seed=7, stream=JaxStream(jax.random.PRNGKey(7)), **draw_kw, **grid_kw)
    assert yp.shape[0] == 3 and np.isfinite(np.stack([yp[n].values() for n in yp.names])).all()
    _close_parrays(yp, yr, DRAW_RTOL)
    _close_parrays(port.predictions_X, ref.predictions_X, 0)


def test_trace_draws_match_the_reference(single, trace):
    """``source=`` a reference trace: the same subsampled draws
    (``default_rng(seed)``), one posterior cache and one normal block
    (``fold_in(i)``) each."""
    ref, port = single
    for gp in (ref, port):
        gp.prepare_grid(resolution=6)
    yr = ref.draw_point_samples(ref.grid_points, n_samples=5, seed=3, source=trace)
    yp = port.draw_point_samples(port.grid_points, n_samples=5, seed=3, source=trace,
                                 stream=JaxStream(jax.random.PRNGKey(3)))
    _close_parrays(yp, yr, DRAW_RTOL)


def test_draws_from_the_generator_are_finite_and_reproducible(single):
    """Without ``stream=`` the blocks come from a torch generator seeded with
    ``seed``: the same seed gives the same draws, another seed others."""
    _, port = single
    port.prepare_grid(resolution=6)
    a = port.draw_grid_samples(n_samples=4, seed=1)["mpg"].values()
    b = port.draw_grid_samples(n_samples=4, seed=1)["mpg"].values()
    c = port.draw_grid_samples(n_samples=4, seed=2)["mpg"].values()
    assert np.isfinite(a).all() and a.shape == (4, 6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_sample_vars_bookkeeping_matches_the_reference(single):
    ref, port = single
    for gp in (ref, port):
        gp.sample_vars = None
        gp.prepare_grid(resolution=4)
        gp.draw_grid_samples(var_name="s")
        gp.draw_grid_samples(var_name="s")
        with pytest.raises(ValueError, match="already exists"):
            gp.draw_grid_samples(var_name="s", increment_var=False)
    assert list(port.sample_vars) == list(ref.sample_vars) == ["s", "s_"]


# ------------------------------------------------------------------
# Gradients of the posterior mean
# ------------------------------------------------------------------

@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("fixture", ["kron", "indep"])
def test_grid_gradients_match_the_reference(fixture, norm, request):
    """``predict_grid_grad`` on test_regression_extra.py's linear surfaces
    (:326 multi-output, :458 Independent): torch autograd against
    ``jax.vmap(jax.grad(...))``, and the reference test's own oracle."""
    ref, port = request.getfixturevalue(fixture)
    limits = dict(input_0=(0.25, 0.75), input_1=(0.25, 0.75))
    for gp in (ref, port):
        gp.prepare_grid(resolution=10, limits=gp.parray(**limits, stdzd=False))
    gr, gp_ = ref.predict_grid_grad(norm=norm), port.predict_grid_grad(norm=norm)
    _close_parrays(gp_, gr, GRAD_RTOL)
    vals = np.concatenate([gp_[n].values().ravel() for n in gp_.names])
    assert len(gp_.names) == (2 if norm else 4)
    assert np.allclose(vals, np.sqrt(2) if norm else 1.0, atol=0.1), (vals.min(), vals.max())


def test_points_and_raw_gradients_match_the_reference(single):
    ref, port = single
    pts = ref.parray(horsepower=np.linspace(60, 200, 9), stdzd=False)
    _close_parrays(port.predict_points_grad(pts, norm=False), ref.predict_points_grad(pts, norm=False), GRAD_RTOL)
    arr, _, _ = port._prepare_points_for_prediction(pts, output=["mpg"])
    np.testing.assert_allclose(port.predict_grad(arr), np.asarray(ref.predict_grad(arr)), rtol=GRAD_RTOL)
    xc = port._split_X(arr)[0][0]
    xk = port._split_X(arr)[1][0]
    np.testing.assert_allclose(float(port._mean_fn_single(xc, xk)), float(ref._mean_fn_single(
        jnp.asarray(_np(xc)), jnp.asarray(_np(xk)))), rtol=1e-12)


def test_gradients_raise_as_the_reference(additive):
    for gp in additive:
        with pytest.raises(NotImplementedError, match="sublevels"):
            gp.predict_grad(np.zeros((1, 2)), additive_level="origin")


# ------------------------------------------------------------------
# GP.sample
# ------------------------------------------------------------------

def _trace_close(tp, tr, chains=slice(None)):
    names = [k for k in tr if k != "_stats"]
    assert sorted(k for k in tp if k != "_stats") == sorted(names)
    for k in names:
        a, b = np.asarray(tp[k])[chains], np.asarray(tr[k])[chains]
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=TRACE_TOL * np.abs(b).max(), err_msg=k)
    b = np.asarray(tr["_stats"]["accept_prob"])[chains]
    np.testing.assert_allclose(np.asarray(tp["_stats"]["accept_prob"])[chains], b, rtol=0, atol=TRACE_TOL)


@pytest.mark.parametrize("sampler, seed", [("chees", 9), ("hmc", 3)])
def test_sample_matches_the_reference_draw_by_draw(single, sampler, seed):
    """Short chains (tune/draws 5/5, the sampler's default chains) from the
    MAP, the port on JAX's keys: every trace array within 1e-8 of its
    largest entry, acceptance within 1e-8."""
    ref, port = single
    kw = dict(draws=5, tune=5, seed=seed, sampler=sampler)
    tr = ref.sample(**kw)
    tp = port.sample(**kw, stream=JaxStream(jax.random.PRNGKey(seed)))
    assert np.asarray(tp["σ"]).shape == ((16 if sampler == "chees" else 2), 5)
    _trace_close(tp, tr)
    np.testing.assert_allclose(tp["_stats"]["mean_accept"], tr["_stats"]["mean_accept"], rtol=0, atol=TRACE_TOL)
    assert port.trace is tp


def test_sample_hmc_keeps_a_chain_moving_where_the_reference_stalls(single):
    """The named divergence of ``ops/hmc.py`` through the model layer: at
    seed 2 the reference's chain 0 rejects warmup steps 2 and 3, its Welford
    variance is 0, and with inverse mass 0 it never moves again; the port
    keeps unit mass there. Chain 1 is the reference's draw by draw."""
    ref, port = single
    kw = dict(draws=5, tune=5, seed=2, sampler="hmc")
    tr = ref.sample(**kw)
    tp = port.sample(**kw, stream=JaxStream(jax.random.PRNGKey(2)))
    assert np.ptp(tr["σ"][0]) == 0 and (np.asarray(tr["_stats"]["accept_prob"])[0] == 0).all()
    assert np.ptp(tp["σ"][0]) > 0
    _trace_close(tp, tr, chains=slice(1, 2))


def test_sample_from_a_built_model_and_for_independent():
    """An unfitted model starts from the prior moments, as the reference's;
    the Independent structure raises in both packages."""
    frame = gmb.data.cars(n=30, seed=2)
    port = gmt.GP(gmt.DataSet(frame, **CARS_KW), device="cpu")
    port.specify_model(outputs=["mpg"], continuous_dims=["horsepower"])
    port.build_model()
    tr = port.sample(draws=3, tune=3, chains=2, sampler="hmc", n_leapfrog=4)
    assert tr["σ"].shape == (2, 3) and np.isfinite(tr["σ"]).all()
    for pkg, ds in ((gmt, gmt.DataSet(frame, **CARS_KW)), (gmb, gmb.DataSet(frame, **CARS_KW))):
        gp = pkg.GP(ds, device="cpu") if pkg is gmt else pkg.GP(ds)
        gp.specify_model(outputs=["mpg", "acceleration"], continuous_dims=["horsepower"])
        gp.build_model(multitask_kernel="Independent")
        with pytest.raises(NotImplementedError, match="Independent"):
            gp.sample()


# ------------------------------------------------------------------
# GP.propose(q=)
# ------------------------------------------------------------------

PROPOSE_CASES = {
    "qlog_nei": ("single", dict(q=2)),
    "qlog_nei_sequential": ("single", dict(q=2, sequential=True)),
    "qlog_nehvi_2d": ("cars2", dict(q=2)),
    # q = 1: at q = 2 this table's acquisition is multimodal along the
    # restarts' paths, and the two L-BFGS reach different local optima from
    # the same start (the port's −4.86, the reference's −5.69)
    "qlog_nehvi_2d_independent": ("cars2_indep", dict(q=1)),
    # three restarts, one fewer than the other cases: the reference's L-BFGS
    # over the QMC-box acquisition of three outputs takes ~4 s a restart on
    # a CPU, and both packages reach the same optimum from the top three
    "qlog_nehvi_mc_three_outputs": ("three", dict(q=1, max_baseline=16, num_restarts=3)),
}
# The port's L-BFGS stops when an iteration lowers the value by less than
# 1e-6 relative (the reference's ``lbfgs_host_minimize`` rule), the
# reference's zoom search when the gradient norm falls below 1e-6: along a
# flat direction of the acquisition the two stopping points lie ~√(1e-6·|f|
# / f'') apart, up to ~1e-3 in z-units here, while their values agree to
# second order in that distance.
CAND_ATOL_Z = 2e-3


def _on_bound(z, lo, hi):
    """Coordinates within 1e-5 of the box's width of a bound, taken to it:
    the sigmoid map reaches a bound only as u → ∞, and the two optimizers
    stop at different u (``tests/test_torch_acquisition.py``)."""
    span = hi - lo
    return np.where(z - lo < 1e-5 * span, lo, np.where(hi - z < 1e-5 * span, hi, z))


@pytest.mark.parametrize("case", list(PROPOSE_CASES))
def test_propose_q_matches_the_reference(case, request):
    """The same Sobol blocks, baseline and raw q-batches in both packages;
    the top raw starts then go through each package's L-BFGS (the port's
    backtracking host loop, the reference's zoom search). The values agree
    within ``PROPOSE_VALUE_RTOL``, the candidates' bound coordinates exactly
    (each taken to the bound it approaches) and the rest within
    ``CAND_ATOL_Z``."""
    fixture, kw = PROPOSE_CASES[case]
    ref, port = request.getfixturevalue(fixture)
    kw = {**dict(raw_samples=64, num_restarts=4, mc_samples=64), **kw}
    cr, vr = ref.propose(**kw)
    cp, vp = port.propose(**kw)
    assert np.isfinite(vp) and vp > np.log(1e-25) + 1.0  # a real improvement, not the log floor
    np.testing.assert_allclose(vp, vr, rtol=PROPOSE_VALUE_RTOL)
    assert cp.names == cr.names == port.continuous_dims and cp.shape == cr.shape == (kw["q"],)
    xc = _np(port._xc)
    lo, hi = xc.min(0), xc.max(0)
    zp = _on_bound(np.stack([cp[n].z.values() for n in cp.names], -1), lo, hi)
    zr = _on_bound(np.stack([cr[n].z.values() for n in cr.names], -1), lo, hi)
    assert ((zp >= lo) & (zp <= hi)).all()
    bound = (zr == lo) | (zr == hi)
    np.testing.assert_array_equal(zp[bound], zr[bound])
    np.testing.assert_allclose(zp, zr, rtol=0, atol=CAND_ATOL_Z)


def test_qlog_nehvi_2d_independent_at_q2_matches_the_reference_at_its_candidate(cars2_indep):
    """At q = 2 the Independent table's acquisition is multimodal along the
    restarts' paths, and the two L-BFGS stop at different local optima from
    the same start. So the acquisition itself is held: the port's
    ``q_acquisition`` at the reference's returned candidate is the
    reference's value (rtol 1e-6), and the port's own optimum is not below
    it. One restart from the top of 16 raw q-batches, 32 MC samples (the
    reference's L-BFGS takes ~15 s a restart on a CPU)."""
    ref, port = cars2_indep
    kw = dict(q=2, raw_samples=16, num_restarts=1, mc_samples=32)
    cr, vr = ref.propose(**kw)
    _, vp = port.propose(**kw)
    z = np.stack([cr[n].z.values() for n in cr.names], -1)  # (q, d) in z-space
    acq = port.q_acquisition(2, mc_samples=32)["acq"]
    with torch.no_grad():
        at_ref = float(acq(port._tensor(z)))
    np.testing.assert_allclose(at_ref, vr, rtol=1e-6)
    assert vp >= vr - 1e-6 * abs(vr), (vp, vr)


def test_kronecker_dense_cache_and_joint_posterior_match_the_dense_solve(cars2):
    """A Kronecker model's dense cache takes its α from the Kronecker solve,
    and its acquisitions' joint posterior comes from the Kronecker cache
    (``acquisition._kron_joint_mean_cov``): at f64 both equal the dense
    solve's (α rtol 1e-8; mean, covariance and prior variance of three
    point sets of five rows, outputs mixed, within 1e-10 of their largest
    entry)."""
    _, port = cars2
    dense = tpost.posterior_cache(port._spec, port._params, port._xc, port._xk, port._yz)
    np.testing.assert_allclose(_np(port._ensure_dense_cache().alpha), _np(dense.alpha), rtol=1e-8)
    rng = np.random.default_rng(0)
    xc = torch.tensor(rng.uniform(-2, 2, size=(3, 5, 1)))
    out = torch.tensor(rng.integers(0, 2, size=(3, 5)))
    got = ta._kron_joint_mean_cov(port._spec, port._params, port._kron_cache, xc, out)
    want = ta._joint_mean_cov(port._spec, port._params, dense, xc, out[..., None])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=1e-10 * float(w.abs().max()))


# ------------------------------------------------------------------
# The draws' floor: the reference's jitter at f64, finite draws at f32
# ------------------------------------------------------------------

def _dense_problem(n, m, dtype, seed=0):
    """A one-output ExpQuad model on ``n`` noisy points of a smooth 2-D
    surface, with the reference's cache, and ``m``² grid points."""
    import gumbi_tpu.ops.kernels as jk

    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(n, 2))
    y = np.sin(1.3 * X[:, 0]) * np.cos(0.9 * X[:, 1]) + rng.normal(0, 0.1, n)
    g = np.linspace(-2, 2, m)
    Xs = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    params = {"ls_total": np.array([0.8, 0.9]), "η_total": np.array(1.0), "σ": np.array(0.1)}
    jspec = jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2)
    pj = {k: jnp.asarray(v, dtype=dtype) for k, v in params.items()}
    zk = lambda k: jnp.zeros((k, 0), jnp.int32)  # noqa: E731
    cache = jpost.posterior_cache(jspec, pj, jnp.asarray(X, dtype), zk(n), jnp.asarray(y, dtype))
    return dict(jspec=jspec, pj=pj, cache=cache, Xs=Xs, params=params, zk=zk)


def _port_draws(pr, dtype, eps, jitter=tpost.DEFAULT_JITTER):
    f = dict(dtype=dtype, device="cpu")
    c = posterior_cache_from_numpy(pr["cache"], **f)
    xs = torch.as_tensor(pr["Xs"], **f)
    return tpost.draw_samples(spec_from_reference(pr["jspec"]), params_from_numpy(pr["params"], **f), c, xs,
                              torch.zeros((xs.shape[0], 0), dtype=torch.long), eps=torch.as_tensor(eps, **f),
                              jitter=jitter)


def test_draw_floor_is_the_reference_jitter_at_f64():
    """At f64 the floor max(jitter, M·eps·mean prior variance) is the
    jitter itself, bit for bit, and the draws are the reference's given its
    normal block (rtol 1e-8; the noise-free covariance's cancellation
    leaves entries near 0 at ~1e-11 absolute)."""
    pr = _dense_problem(64, 12, jnp.float64)
    key = jax.random.PRNGKey(0)
    M = pr["Xs"].shape[0]
    ref = jpost.draw_samples(pr["jspec"], pr["pj"], pr["cache"], jnp.asarray(pr["Xs"]), pr["zk"](M), key,
                             n_samples=3)
    eps = np.asarray(jax.random.normal(key, (3, M), dtype=jnp.float64))
    np.testing.assert_allclose(_np(_port_draws(pr, torch.float64, eps)), np.asarray(ref), rtol=DRAW_RTOL,
                               atol=DRAW_RTOL * np.abs(np.asarray(ref)).max())
    cov = torch.zeros((M, M), dtype=torch.float64)
    floor = tpost.draw_floor(cov, torch.ones(M, dtype=torch.float64), 1e-6)
    assert float(floor) == 1e-6
    big = tpost.draw_floor(torch.zeros((4, 4), dtype=torch.float32), torch.full((4,), 1e4), 1e-6)
    assert float(big) == pytest.approx(4 * np.finfo(np.float32).eps * 1e4)


def test_f32_noise_free_grid_draws_are_finite_where_the_reference_is_nan():
    """The named divergence: a noise-free joint covariance of 256 grid
    points against 512 training points at f32. Its rounding takes the
    smallest eigenvalues below −1e-6, so the reference's bare jitter gives
    NaN draws; the port's floor (256·eps·η² ≈ 3.1e-5) factors it.

    Against f64 draws on the same normal block and with the same floor, the
    f32 covariance's rounding (entries off by ~floor) moves the factor's
    near-null columns by ~√floor: the draws stay within √floor·max|eps|
    (measured ~0.03 of it). The floor itself moves draws on one block much
    more (~0.12 here: the factor of a near-singular matrix turns with its
    diagonal), but not their distribution."""
    pr32 = _dense_problem(512, 16, jnp.float32)
    M = pr32["Xs"].shape[0]
    key = jax.random.PRNGKey(0)
    ref = np.asarray(jpost.draw_samples(pr32["jspec"], pr32["pj"], pr32["cache"], jnp.asarray(pr32["Xs"], jnp.float32),
                                        pr32["zk"](M), key, n_samples=2))
    assert np.isnan(ref).any()
    eps = np.asarray(jax.random.normal(key, (2, M), dtype=jnp.float64))
    d32 = _np(_port_draws(pr32, torch.float32, eps.astype(np.float32)))
    assert np.isfinite(d32).all()
    floor = M * np.finfo(np.float32).eps  # η² = 1
    d64 = _np(_port_draws(_dense_problem(512, 16, jnp.float64), torch.float64, eps, jitter=floor))
    assert np.abs(d32 - d64).max() <= np.sqrt(floor) * np.abs(eps).max()


# ------------------------------------------------------------------
# Regressor paths step 9a carried whole: cross_validate, propose(target=)
# ------------------------------------------------------------------

def _cv_results(result):
    return {part: (result[part]["data"].wide.reset_index(drop=True), np.asarray(result[part]["NLPDs"]),
                   np.asarray(result[part]["errors"])) for part in ("train", "test")}


CV_TOL = 1e-5  # the refits' two L-BFGS land in one basin, not on one point


def _cv_match(rr, rp):
    for part in ("train", "test"):
        (dr, nr, er), (dp, np_, ep) = _cv_results(rr)[part], _cv_results(rp)[part]
        pd.testing.assert_frame_equal(dp, dr)
        assert np.isfinite(np_).all()
        np.testing.assert_allclose(np_, nr, rtol=CV_TOL, atol=CV_TOL, err_msg=part)
        np.testing.assert_allclose(ep, er, rtol=CV_TOL, atol=CV_TOL, err_msg=part)


def test_cross_validate_matches_the_reference():
    """tests/test_extras.py:208: the same split (``default_rng(seed)``), the
    refit on it, NLPDs and errors."""
    frame = gmb.data.cars(n=40, seed=11)
    out = []
    for pkg in (gmb, gmt):
        kw = dict(device="cpu") if pkg is gmt else {}
        gp = pkg.GP(pkg.DataSet(frame, **CARS_KW), outputs="mpg", **kw)
        gp.specify_model(outputs=["mpg"], continuous_dims=["horsepower"])
        out.append(gp.cross_validate(pct_train=0.7, warm_start=False, n_restarts=2, maxiter=80))
    rr, rp = out
    _cv_match(rr, rp)
    assert np.abs(rp["train"]["errors"]).mean() <= np.abs(rp["test"]["errors"]).mean() * 3


def test_cross_validate_by_unit_and_train_only_matches_the_reference():
    """tests/test_extras.py:327: entities grouped by ``unit`` and rows pinned
    by ``train_only``."""
    df = gmb.data.cars(n=30, seed=13)
    df["batch"] = ["b%d" % (i % 6) for i in range(len(df))]
    pin_val = df["batch"].iloc[0]
    out = {}
    for pkg in (gmb, gmt):
        kw = dict(device="cpu") if pkg is gmt else {}
        gp = pkg.GP(pkg.DataSet(df, **CARS_KW), outputs="mpg", **kw)
        gp.specify_model(outputs=["mpg"], continuous_dims=["horsepower"])
        out[pkg] = (gp.cross_validate(unit="batch", n_train=4, warm_start=False, n_restarts=2, maxiter=60),
                    gp.cross_validate(pct_train=0.7, train_only={"batch": pin_val}, warm_start=False, n_restarts=2,
                                      maxiter=60))
    for rr, rp in zip(out[gmb], out[gmt]):
        _cv_match(rr, rp)
    train_df = out[gmt][1]["train"]["data"].wide
    assert (train_df["batch"] == pin_val).sum() >= (df["batch"] == pin_val).sum()


@pytest.mark.parametrize("acquisition", ["EI", "PD"])
def test_grid_propose_toward_a_target_matches_the_reference(single, acquisition):
    """tests/test_bo.py:172: the grid proposal toward mpg = 30 over the
    30-point grid's predictions."""
    ref, port = single
    props = []
    for gp in (ref, port):
        gp.prepare_grid(resolution=30)
        gp.predict_grid()
        props.append(gp.propose(30.0, acquisition=acquisition))
    np.testing.assert_allclose(port.proposal_surface, ref.proposal_surface, rtol=1e-9)
    assert port.proposal_idx == ref.proposal_idx
    assert props[1].names == props[0].names == ["horsepower"]
    np.testing.assert_allclose(props[1].values(), props[0].values(), rtol=1e-12)


# ------------------------------------------------------------------
# chip_smoke.py's phase 16 functions, rehearsed at f64 on the CPU
# ------------------------------------------------------------------

def test_chip_smoke_surface_phase_runs_on_the_cpu():
    """Phase 16's functions at small sizes: (a) on a Kronecker fit of 96
    locations and a 6×6 grid, (b) on phase 12a's generator at N = 64 with
    short chains. At f64 the f32 − f64 gaps read zero, the central
    differences hold, and every call returns finite numbers."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs

    fast = dict(raw_samples=32, num_restarts=2)
    r = cs.run_model_fit(cs.bench_table(96), "cpu", torch.float64, map_kwargs=dict(n_restarts=2, maxiter=20), grid=6)
    gp = r["gp"]
    assert gp._structure == "Kronecker"
    res = cs.run_surface_a(gp, n_draws=2, propose_kw=fast)
    assert set(res) == {"draw_grid_samples", "predict_grid_grad(norm=False)", "predict_grid_grad(norm=True)",
                        "propose(q=2)"}
    ca = cs.check_surface_a(gp, res, n_draws=2)
    assert ca["draws"]["finite"] and ca["draws"]["gap"] < 1e-10 and ca["draws"]["m"] == 72
    assert all(gap < 1e-10 for gap, _ in ca["grad"].values()) and len(ca["grad"]) == 6
    assert ca["fd"]["f64"] <= cs.SURFACE_FD_RTOL
    assert ca["routes"]["grad_kron"] == 0 and ca["routes"]["grad_dense"] < 1e-8 and ca["routes"]["mean_dense"] < 1e-10
    pa = ca["propose"]
    assert pa["in_box"] and abs(pa["at32"] - pa["at64"]) < 1e-10 and abs(pa["value"] - pa["at32"]) < 1e-9

    gp_b, res_b = cs.run_surface_b(cs.surface_table(64), "cpu", torch.float64,
                                   map_kwargs=dict(n_restarts=2, maxiter=20), chees_kw=dict(tune=5, draws=5),
                                   hmc_kw=dict(tune=5, draws=5, n_leapfrog=4), grid=5, n_trace=3, propose_kw=fast)
    cb = cs.check_surface_b(gp_b, res_b)
    assert cb["finite"] and cb["draws_shape"] == (3, 25) and cb["propose"]["in_box"]
    assert abs(cb["propose"]["at32"] - cb["propose"]["at64"]) < 1e-10
    assert cb["ls_median"].shape == (2,) and 0.0 <= cb["hmc_accept"] <= 1.0
