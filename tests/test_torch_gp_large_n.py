"""The port's two large-N regressors in ``GP`` against the JAX reference.

At f64 on the CPU:

* ``find_MAP(engine='iterative')`` unstaged on the cars table (N = 120,
  ``block=32``, so bucket padding runs): the port's probes are the
  reference's bit for bit, the reference's ``iter_map_neg_logp`` on the
  port's padded state, probes and MAP is the port's ``_neg_logp``, the
  port's iterative cache in the reference's ``iter_predict_diag`` gives the
  port's grid (rtol 1e-8), and the reference test's basin and grid rules
  hold against the port's own Cholesky fit;
* the staged fit (``coarse_n``) against one reference staged fit, and the
  polish's recovery ladder (escalation, the flagged fallback, a CG cap of
  0) as ``tests/test_iterative.py`` holds the reference's;
* ``GP(sparse=True)`` on ``tests/test_extras.py``'s small cars table: the
  inducing points, the FITC objective, the grid (the reference's
  ``GP.load`` of the port's save), the draws on JAX's normal blocks, the
  port's own save round trip and the sparse-vs-dense rule;
* after an iterative fit, the mean gradients through the dense cache
  against the reference's on a load of the port's save.
"""

import warnings
from dataclasses import asdict

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import gumbi_tpu as gmb
import gumbi_tpu.ops.fitc as jfitc
import gumbi_tpu.ops.iterative as ji
import gumbi_tpu_torch as gmt
from gumbi_tpu_torch.convert import iter_cache_to_numpy, params_to_numpy
from gumbi_tpu_torch.ops import IterConfig, draw_probes, map_neg_logp, unconstrain
from test_torch_hmc import JaxStream

torch.set_num_threads(2)

BASIN_TOL = 0.005  # nats/point, tests/test_bench_quality.py's tolerance
PARITY_RTOL = 1e-8
# tests/test_iterative.py's engine test: block 32 on 120 rows pads to 128
ITER_CFG = dict(maxiter=200, tol=1e-6, n_probes=16, precond_rank=32, quad_steps=32, block=32)
ITER_MAP = dict(n_restarts=3, maxiter=150)
CARS_FIT = dict(outputs=["mpg"], continuous_dims=["horsepower"])
# tests/test_iterative.py's staged fit
STAGED_CFG = dict(block=0, maxiter=200, tol=1e-6, precond_rank=16, love_rank=80)
STAGED_MAP = dict(engine="iterative", n_restarts=4, coarse_n=120, polish_maxiter=60)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _jcfg(cfg):
    return ji.IterConfig(**asdict(cfg))


def _cars_iter_frame():
    return gmb.data.cars(n=120)[["mpg", "horsepower"]].dropna()


def _cars_iter_ds(pkg):
    return pkg.DataSet(_cars_iter_frame(), outputs=["mpg"], log_vars=["mpg", "horsepower"])


def _grid_points(gp, resolution=40):
    gp.prepare_grid(resolution=resolution)
    arr, _, _ = gp._prepare_points_for_prediction(gp.grid_points, output=gp.outputs)
    return np.asarray(arr)


# ------------------------------------------------------------------
# engine='iterative', unstaged
# ------------------------------------------------------------------


@pytest.fixture(scope="module")
def iter_fit():
    """The port's iterative fit and its Cholesky twin on the cars table,
    with the reference's spec for the same build."""
    ds = _cars_iter_ds(gmt)
    gp_i = gmt.GP(ds, device="cpu").fit(**CARS_FIT, MAP_kwargs=dict(
        **ITER_MAP, engine="iterative", iter_config=IterConfig(**ITER_CFG)))
    gp_c = gmt.GP(ds, device="cpu").fit(**CARS_FIT, MAP_kwargs=ITER_MAP)
    ref = gmb.GP(_cars_iter_ds(gmb))
    ref.specify_model(**CARS_FIT)
    ref.build_model()
    return gp_i, gp_c, ref


def test_iterative_fit_keeps_no_dense_cache(iter_fit):
    gp_i, _, _ = iter_fit
    st = gp_i._iter_state
    assert gp_i._cache is None and gp_i._iter_cache is not None
    assert st["xc"].shape[0] == 128 and _np(st["mask"]).sum() == 120 and not _np(st["mask"])[120:].any()
    assert set(gp_i._iter_cache) == {"alpha", "L", "d", "W"}
    assert float(gp_i._fit_aux["cache_rel_res"]) <= 1e-4 and "cache_cg_iters" in gp_i._fit_aux


def test_iterative_probes_are_the_references(iter_fit):
    gp_i, _, _ = iter_fit
    cfg = gp_i._iter_state["cfg"]
    pn, pk = draw_probes(gp_i.seed, 128, cfg, dtype=torch.float64, device="cpu")
    jn, jk = ji.draw_probes(gp_i.seed, 128, _jcfg(cfg), dtype=jnp.float64)
    np.testing.assert_array_equal(_np(pn), np.asarray(jn))
    np.testing.assert_array_equal(_np(pk), np.asarray(jk))


def test_iterative_objective_is_the_references(iter_fit):
    """The reference's objective on the port's padded state, probes and MAP."""
    gp_i, _, ref = iter_fit
    st, cfg = gp_i._iter_state, gp_i._iter_state["cfg"]
    jn, jk = ji.draw_probes(gp_i.seed, 128, _jcfg(cfg), dtype=jnp.float64)
    u = {k: jnp.asarray(v) for k, v in params_to_numpy(unconstrain(gp_i._params)).items()}
    f = ji.iter_map_neg_logp(
        ref._spec, u, jnp.asarray(_np(st["xc"])), jnp.asarray(_np(st["xk"]).astype(np.int32)),
        jnp.asarray(_np(st["yz"])), jnp.asarray(gp_i._ls_alpha), jnp.asarray(gp_i._ls_beta), jn, jk, _jcfg(cfg),
        mask=jnp.asarray(_np(st["mask"])),
    )
    np.testing.assert_allclose(gp_i._neg_logp, float(f), rtol=PARITY_RTOL)


def test_iterative_cache_predicts_the_ports_grid_in_the_reference(iter_fit):
    gp_i, _, ref = iter_fit
    st, cfg = gp_i._iter_state, gp_i._iter_state["cfg"]
    arr = _grid_points(gp_i)
    mean, var = gp_i.predict(arr)
    xs = jnp.asarray(arr)
    p = {k: jnp.asarray(v) for k, v in params_to_numpy(gp_i._params).items()}
    cache = {k: jnp.asarray(v) for k, v in iter_cache_to_numpy(gp_i._iter_cache).items()}
    jm, jv = ji.iter_predict_diag(
        ref._spec, _jcfg(cfg), p, cache, jnp.asarray(_np(st["xc"])), jnp.asarray(_np(st["xk"]).astype(np.int32)),
        xs, jnp.zeros((xs.shape[0], 0), jnp.int32), with_noise=True, mask=jnp.asarray(_np(st["mask"])),
    )
    np.testing.assert_allclose(mean, np.asarray(jm), rtol=PARITY_RTOL, atol=1e-12)
    np.testing.assert_allclose(var, np.asarray(jv), rtol=PARITY_RTOL, atol=1e-12)


def test_iterative_fit_meets_the_cholesky_fit(iter_fit):
    """tests/test_iterative.py's rules for the reference's iterative fit,
    held against the port's own Cholesky fit: close grids, and the
    iterative optimum within a nat of the Cholesky one on the exact
    objective."""
    gp_i, gp_c, _ = iter_fit
    gp_c.prepare_grid(resolution=40)
    gp_i.prepare_grid(resolution=40)
    y_c, y_i = gp_c.predict_grid(), gp_i.predict_grid()
    mu_c, mu_i = np.asarray(y_c.μ, float), np.asarray(y_i.μ, float)
    sd_c, sd_i = np.asarray(y_c.σ, float), np.asarray(y_i.σ, float)
    assert np.allclose(mu_i, mu_c, rtol=0.05, atol=0.05 * np.abs(mu_c).max())
    assert np.allclose(sd_i, sd_c, rtol=0.25, atol=0.1 * sd_c.max())
    la, lb = torch.as_tensor(gp_c._ls_alpha), torch.as_tensor(gp_c._ls_beta)

    def f_exact(p):
        return float(map_neg_logp(gp_c._spec, unconstrain(p), gp_c._xc, gp_c._xk, gp_c._yz, la, lb))

    assert f_exact(gp_i._params) - f_exact(gp_c._params) < 1.0


@pytest.mark.parametrize("case", ["exact_woodbury", "inexact_woodbury", "cg_regime"])
def test_posterior_solve_keeps_the_woodbury_solve_only_where_it_solves(case):
    """The posterior solve takes P⁻¹y where P = A (the f64 exhausted regime:
    the reference's answer), PCG from P to the target where the gate's first
    half read exhausted but P ≠ A (the f32 fault at large N, made here by
    perturbing P), and PCG in the CG regime; α is A⁻¹y in every case."""
    from gumbi_tpu_torch.ops.iterative import POSTERIOR_TOL, _posterior_solve

    rng = np.random.default_rng(5)
    n = 80
    G = rng.standard_normal((n, 20))
    A = torch.as_tensor(G @ G.T + 0.05 * np.eye(n))
    B = torch.as_tensor(0.5 * rng.standard_normal((n, 5)))
    P = A + (B @ B.T if case == "inexact_woodbury" else 0.0)  # SPD, as LLᵀ + D is
    Pinv = torch.linalg.inv(P)
    y = torch.as_tensor(rng.standard_normal(n))
    cfg = IterConfig(maxiter=200, tol=1e-2)
    alpha, _, rel, exhausted, woodbury_rel = _posterior_solve(lambda V: A @ V, lambda V: Pinv @ V, y, cfg,
                                                              case != "cg_regime")
    true_rel = float(torch.linalg.norm(y - A @ alpha) / torch.linalg.norm(y))
    assert exhausted == (case == "exact_woodbury")
    if case == "exact_woodbury":
        assert woodbury_rel <= 1e-12
        np.testing.assert_allclose(alpha.numpy(), torch.linalg.solve(A, y).numpy(), rtol=1e-9)
    else:
        assert true_rel <= 1.01 * POSTERIOR_TOL and abs(float(rel) - true_rel) <= 1e-6
    if case == "inexact_woodbury":
        assert woodbury_rel > 100 * POSTERIOR_TOL
    assert np.isnan(woodbury_rel) == (case == "cg_regime")


@pytest.mark.parametrize("rank", [8, 60], ids=["inexact", "exact"])
def test_objective_takes_the_woodbury_solve_only_where_it_solves(rank, monkeypatch):
    """The fit's objective shares the posterior's gate. With the gate's first
    half forced to read exhausted (as it does at f32 at N = 50,000), log|P|
    and P⁻¹B stand in only where P = A (rank = n: the exact dense value);
    at rank 8 the Woodbury residual misses tol, and the value and gradient
    are the CG regime's, bit for bit, with the unconverged-solve guard on."""
    import gumbi_tpu_torch.ops.iterative as ti
    from gumbi_tpu_torch.ops import GPSpec, GPTerm, mll

    spec = GPSpec(terms=(GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2)
    rng = np.random.default_rng(3)
    n = 60
    xc = torch.as_tensor(rng.uniform(-2, 2, (n, 2)))
    xk = torch.zeros((n, 0), dtype=torch.int64)
    y = torch.as_tensor(np.sin(xc.numpy()).sum(1) + 0.1 * rng.standard_normal(n))
    cfg = IterConfig(maxiter=200, tol=1e-6, n_probes=8, precond_rank=rank, quad_steps=32, block=0)
    pn, pk = draw_probes(0, n, cfg, dtype=torch.float64, device="cpu")

    def value_and_grad(info):
        p = {"ls_total": torch.tensor([0.9, 1.1], dtype=torch.float64, requires_grad=True),
             "η_total": torch.tensor(1.3, dtype=torch.float64, requires_grad=True),
             "σ": torch.tensor(0.2, dtype=torch.float64, requires_grad=True)}
        v = ti.iter_gaussian_logp(spec, cfg, p, xc, xk, y, pn, pk, info=info)
        g = torch.autograd.grad(v, list(p.values()))
        return float(v.detach()), torch.cat([t.reshape(-1) for t in g]), p

    free = {}
    v_free, g_free, p = value_and_grad(free)
    monkeypatch.setattr(ti, "exhausted_factorization", lambda *a: torch.tensor(True))
    info = {}
    v, g, _ = value_and_grad(info)
    if rank == n:
        assert free["exhausted"] and info["exhausted"] and info["iters"] == 0 and info["woodbury_rel"] <= 1e-10
        exact = float(mll(spec, {k: t.detach() for k, t in p.items()}, xc, xk, y))
        np.testing.assert_allclose(v, exact, rtol=1e-10)
    else:
        assert not free["exhausted"] and np.isnan(free["woodbury_rel"])
        assert not info["exhausted"] and info["woodbury_rel"] > cfg.tol and info["iters"] == free["iters"] > 0
        assert v == v_free and torch.equal(g, g_free)


def test_gradients_after_an_iterative_fit_match_the_reference(iter_fit, tmp_path):
    """``predict_points_grad`` of an iterative model goes through the dense
    cache from the unpadded rows, as the reference's; the reference's load
    of the port's save predicts the same gradients."""
    gp_i, _, _ = iter_fit
    path = tmp_path / "iter.npz"
    gp_i.save(path)
    ref = gmb.GP.load(path, _cars_iter_ds(gmb))
    pts = ref.parray(horsepower=np.linspace(60, 200, 9), stdzd=False)
    gp_i._cache = None
    gp = gp_i.predict_points_grad(pts, norm=False)
    assert gp_i._cache is not None and gp_i._cache.alpha.shape == (120,)
    gr = ref.predict_points_grad(pts, norm=False)
    for name in gr.names:
        np.testing.assert_allclose(gp[name].values(), gr[name].values(), rtol=1e-9, atol=0)
    loaded = gmt.GP.load(path, _cars_iter_ds(gmt), device="cpu")
    assert loaded._iter_cache is None and loaded._cache is not None
    gp_i._cache = None


# ------------------------------------------------------------------
# The staged fit and its recovery ladder
# ------------------------------------------------------------------


def _staged_frame(n=240, seed=0):
    """tests/test_iterative.py's ``_staged_fit_dataset``."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(1, 4, n)
    y = np.exp(0.3 * np.sin(2.0 * x) + 0.1 * rng.normal(size=n)) + 1.0
    return pd.DataFrame({"hp": x, "mpg": y})


def _staged_gp(pkg, n=240, **kw):
    ds = pkg.DataSet(_staged_frame(n), outputs=["mpg"], log_vars=["mpg"])
    gp = pkg.GP(ds, **kw)
    gp.specify_model(outputs=["mpg"], continuous_dims=["hp"])
    gp.build_model()
    return gp


@pytest.fixture(scope="module")
def staged():
    port = _staged_gp(gmt, device="cpu")
    port.find_MAP(**STAGED_MAP, iter_config=IterConfig(**STAGED_CFG))
    ref = _staged_gp(gmb)
    ref.find_MAP(**STAGED_MAP, iter_config=ji.IterConfig(**STAGED_CFG))
    return port, ref


def test_staged_fit_lands_on_the_references(staged):
    port, ref = staged
    assert "polish_iters" in port._fit_aux and int(port._fit_aux["polish_iters"]) > 0
    assert not bool(port._fit_aux["polish_fallback"]) and int(port._fit_aux["polish_rung"]) == 0
    # Every coarse restart reaches the one optimum (the values agree to
    # ~1e-11 relative), so which index wins is a tie broken by round-off:
    # the polish starts from the reference's coarse optimum, whatever index
    # holds it.
    fp, fr = port._fit_aux["all_values"], ref._fit_aux["all_values"]
    np.testing.assert_allclose(fp, fr, rtol=1e-6)
    np.testing.assert_allclose(fp[int(port._fit_aux["polish_start_restart"])],
                               fr[int(ref._fit_aux["polish_start_restart"])], rtol=1e-9)
    assert abs(port._neg_logp - ref._neg_logp) <= BASIN_TOL * 240, (port._neg_logp, ref._neg_logp)
    assert len(port._fit_aux["polish_exhausted"]) == len(port._fit_aux["polish_cg_iters"]) > 0


def test_staged_grid_meets_the_references(staged):
    port, ref = staged
    for gp in staged:
        gp.prepare_grid(resolution=30)
    mu_p = np.asarray(port.predict_grid().μ, float)
    mu_r = np.asarray(ref.predict_grid().μ, float)
    assert np.allclose(mu_p, mu_r, rtol=0.05, atol=0.05 * np.abs(mu_r).max())


def test_staged_polish_escalates_unconverged_start():
    """A CG cap of 1 leaves the coarse winner's full-N objective unconverged
    (+inf): the polish escalates the cap, names the cap that failed, and
    lands a finite full-N fit, not the subsample fallback."""
    cfg = IterConfig(block=0, maxiter=1, tol=1e-6, precond_rank=1, quad_steps=60, love_rank=40)
    gp = _staged_gp(gmt, device="cpu")
    with pytest.warns(UserWarning, match="escalating the cap") as record:
        gp.find_MAP(engine="iterative", n_restarts=2, coarse_n=120, polish_maxiter=20, iter_config=cfg)
    assert any("within maxiter=1 CG" in str(w.message) for w in record)
    assert np.isfinite(gp._neg_logp)
    assert not bool(gp._fit_aux["polish_fallback"]) and int(gp._fit_aux["polish_rung"]) > 0
    assert gp._iter_state["cfg"].maxiter > 1


def test_staged_polish_fallback_flagged():
    """A negative tol makes CG unconvergeable at any cap: the fit keeps the
    coarse-subsample MAP and flags the stored objective's provenance."""
    cfg = IterConfig(block=0, maxiter=1024, tol=-1.0, precond_rank=8, quad_steps=40, love_rank=20)
    gp = _staged_gp(gmt, n=120, device="cpu")
    with pytest.warns(UserWarning, match="subsample"):
        gp.find_MAP(engine="iterative", n_restarts=2, coarse_n=60, polish_maxiter=10, iter_config=cfg)
    assert bool(gp._fit_aux["polish_fallback"])
    assert int(gp._fit_aux["polish_iters"]) == 0 and int(gp._fit_aux["polish_rung"]) == -1
    np.testing.assert_allclose(gp._neg_logp, gp._fit_aux["all_values"].min())


def test_staged_polish_ladder_survives_degenerate_maxiter():
    """cfg.maxiter = 0 must not hang building the ladder; the fit ends with
    its fallback flag."""
    cfg = IterConfig(block=0, maxiter=0, tol=1e-6, precond_rank=4, quad_steps=8, love_rank=8)
    gp = _staged_gp(gmt, n=120, device="cpu")
    with pytest.warns(UserWarning):
        gp.find_MAP(engine="iterative", n_restarts=2, coarse_n=60, polish_maxiter=5, iter_config=cfg)
    assert "polish_fallback" in gp._fit_aux


def test_repeat_staged_fits_are_equal():
    """Two identical staged fits give the same objective (the probes and
    the subsample are drawn from the seed)."""
    cfg = IterConfig(block=0, maxiter=200, tol=1e-6, precond_rank=16, quad_steps=40, love_rank=20)

    def fit_once():
        gp = _staged_gp(gmt, n=256, device="cpu")
        gp.find_MAP(engine="iterative", n_restarts=2, coarse_n=128, polish_maxiter=10, iter_config=cfg)
        return gp._neg_logp

    assert fit_once() == fit_once()


GUARDS = {
    "sparse": (dict(sparse=True, n_u=16), dict(engine="iterative"), NotImplementedError),
    "kronecker": (dict(), dict(engine="iterative"), NotImplementedError),
    "independent": (dict(multitask_kernel="Independent"), dict(engine="iterative"), NotImplementedError),
    "bogus_engine": (dict(), dict(engine="bogus"), ValueError),
}


@pytest.mark.parametrize("name", list(GUARDS))
def test_iterative_engine_guards(name):
    build_kw, map_kw, error = GUARDS[name]
    ds = gmt.DataSet(gmb.data.cars(n=60)[["mpg", "acceleration", "horsepower"]].dropna(),
                     outputs=["mpg", "acceleration"], log_vars=["mpg", "horsepower"])
    gp = gmt.GP(ds, device="cpu")
    outputs = ["mpg", "acceleration"] if name in ("kronecker", "independent") else ["mpg"]
    gp.specify_model(outputs=outputs, continuous_dims=["horsepower"])
    gp.build_model(**build_kw)
    with pytest.raises(error):
        gp.find_MAP(**map_kw)


# ------------------------------------------------------------------
# sparse=True
# ------------------------------------------------------------------

SMALL_KW = dict(outputs=["mpg", "acceleration"], log_vars=["mpg", "acceleration", "horsepower"])
SPARSE_FIT = dict(outputs=["mpg"], continuous_dims=["horsepower"], sparse=True, n_u=30,
                  MAP_kwargs=dict(n_restarts=2, maxiter=100))


def _small_ds(pkg):
    """tests/test_extras.py's ``small_ds``."""
    return pkg.DataSet(gmb.data.cars(n=40, seed=11), **SMALL_KW)


@pytest.fixture(scope="module")
def sparse(tmp_path_factory):
    """The port's sparse fit, its save, and the reference's load of it."""
    port = gmt.GP(_small_ds(gmt), device="cpu").fit(**SPARSE_FIT)
    path = tmp_path_factory.mktemp("sparse") / "sparse.npz"
    port.save(path)
    ref = gmb.GP.load(path, _small_ds(gmb))
    return port, ref, path


def test_sparse_inducing_points_are_the_references(sparse):
    port, ref, _ = sparse
    built = gmb.GP(_small_ds(gmb))
    built.specify_model(outputs=["mpg"], continuous_dims=["horsepower"])
    built.build_model(sparse=True, n_u=30)
    np.testing.assert_array_equal(_np(port._xu_c), np.asarray(built._xu_c))
    np.testing.assert_array_equal(_np(port._xu_k), np.asarray(built._xu_k))
    assert port.sparse and ref.sparse and port._cache is None and port._structure == "Hadamard"


def _exact_fitc_neg_logp(gp, dps=50):
    """The FITC evidence (+ hyperprior) at ``gp``'s MAP from its dense N×N
    form Q + Λ, Q = Kxu Kuu⁻¹ Kux, in ``dps``-digit arithmetic."""
    import mpmath

    from gumbi_tpu_torch.ops import gram, gram_diag, log_prior, noise_diag
    from gumbi_tpu_torch.ops.fitc import _stabilized_kuu
    from gumbi_tpu_torch.ops.mll import DEFAULT_JITTER

    mpmath.mp.dps = dps
    p, spec = gp._params, gp._spec
    kuu = _stabilized_kuu(spec, p, gp._xu_c, gp._xu_k, torch.float64, DEFAULT_JITTER)
    kux = mpmath.matrix(_np(gram(spec, p, gp._xu_c, gp._xu_k, gp._xc, gp._xk)).tolist())
    q = kux.T * mpmath.inverse(mpmath.matrix(_np(kuu).tolist())) * kux
    kxx, noise = _np(gram_diag(spec, p, gp._xc, gp._xk)), _np(noise_diag(spec, p, gp._xk, dtype=torch.float64))
    n = q.rows
    cov = q + mpmath.diag([max(kxx[i] - q[i, i], 0) + noise[i] for i in range(n)])
    y = mpmath.matrix(_np(gp._yz).tolist())
    quad = (y.T * mpmath.lu_solve(cov, y))[0, 0]
    mll = -0.5 * (quad + mpmath.log(mpmath.det(cov)) + n * mpmath.log(2 * mpmath.pi))
    la, lb = torch.as_tensor(gp._ls_alpha), torch.as_tensor(gp._ls_beta)
    return -(float(mll) + float(log_prior(spec, unconstrain(p), la, lb)))


def test_sparse_objective_is_the_references(sparse):
    """The port's FITC objective at its MAP against the reference's and a
    50-digit evaluation. The port's whitened form (B = I + AΛ⁻¹Aᵀ) keeps
    its digits (rtol 1e-12); the reference's log|Kuu + G| − log|Kuu| loses
    digits to cond(Kuu), 2.8e7 here (30 inducing points on 40 rows in one
    dimension), and lands 1.0e-7 relative off: the FITC evidence's named
    divergence (``ops/fitc.py``), seen at f64. Both held to the exact value, the reference at 1e-6."""
    port, ref, _ = sparse
    u = {k: jnp.asarray(v) for k, v in params_to_numpy(unconstrain(port._params)).items()}
    f = float(jfitc.fitc_neg_logp(ref._spec, u, ref._xc, ref._xk, ref._xu_c, ref._xu_k, ref._yz,
                                  jnp.asarray(ref._ls_alpha), jnp.asarray(ref._ls_beta)))
    exact = _exact_fitc_neg_logp(port)
    np.testing.assert_allclose(port._neg_logp, exact, rtol=1e-12)
    np.testing.assert_allclose(f, exact, rtol=1e-6)
    assert abs(port._neg_logp - exact) <= abs(f - exact)


def test_reference_load_of_the_sparse_save_predicts_the_ports_grid(sparse):
    port, ref, _ = sparse
    for gp in (port, ref):
        gp.prepare_grid(resolution=20)
    yp, yr = port.predict_grid(), ref.predict_grid()
    np.testing.assert_allclose(yp.μ, yr.μ, rtol=1e-9)
    np.testing.assert_allclose(yp.σ2, yr.σ2, rtol=1e-9)


def test_sparse_save_round_trips_in_the_port(sparse):
    port, _, path = sparse
    loaded = gmt.GP.load(path, _small_ds(gmt), device="cpu")
    assert loaded.sparse and loaded._cache is None
    np.testing.assert_array_equal(_np(loaded._xu_c), _np(port._xu_c))
    np.testing.assert_array_equal(_np(loaded._xu_k), _np(port._xu_k))
    for gp in (port, loaded):
        gp.prepare_grid(resolution=20)
    a, b = port.predict_grid(), loaded.predict_grid()
    np.testing.assert_array_equal(a.μ, b.μ)
    np.testing.assert_array_equal(a.σ2, b.σ2)


def test_sparse_grid_tracks_the_dense_fit(sparse):
    """tests/test_extras.py's FITC-against-dense rule, on the port's fits."""
    port, _, _ = sparse
    dense = gmt.GP(_small_ds(gmt), device="cpu").fit(outputs=["mpg"], continuous_dims=["horsepower"],
                                                     MAP_kwargs=dict(n_restarts=2, maxiter=100))
    for gp in (port, dense):
        gp.prepare_grid(resolution=20)
    ys, yd = port.predict_grid(), dense.predict_grid()
    assert np.allclose(ys.μ, yd.μ, rtol=0.1, atol=0.5)


def _trace_of(gp, n_draws=3):
    """A two-chain trace of the MAP, its lengthscale and noise scaled per
    draw (enough to hold the per-draw path: each draw its own parameters)."""
    scale = np.linspace(0.8, 1.25, 2 * n_draws).reshape(2, n_draws)
    trace = {}
    for k, v in gp.MAP.items():
        v = np.asarray(v)
        s = scale.reshape(2, n_draws, *([1] * v.ndim))
        trace[k] = (v[None, None] * s) if k.startswith(("ls", "σ")) else np.broadcast_to(v, (2, n_draws, *v.shape))
    return {k: np.ascontiguousarray(v) for k, v in trace.items()}


@pytest.mark.parametrize("source", ["map", "trace"])
def test_sparse_draws_match_the_reference_on_its_normal_blocks(sparse, source):
    port, ref, _ = sparse
    for gp in (port, ref):
        gp.prepare_grid(resolution=6)
    src = _trace_of(port) if source == "trace" else None
    yr = ref.draw_point_samples(ref.grid_points, n_samples=4, seed=7, source=src)
    yp = port.draw_point_samples(port.grid_points, n_samples=4, seed=7, source=src,
                                 stream=JaxStream(jax.random.PRNGKey(7)))
    vp, vr = yp["mpg"].values(), yr["mpg"].values()
    assert vp.shape == (4, 6) and np.isfinite(vp).all()
    np.testing.assert_allclose(vp, vr, rtol=PARITY_RTOL, atol=0)


def test_sparse_draws_from_the_generator_are_reproducible(sparse):
    port, _, _ = sparse
    port.prepare_grid(resolution=6)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        a = port.draw_grid_samples(n_samples=3, seed=1)["mpg"].values()
    b = port.draw_grid_samples(n_samples=3, seed=1)["mpg"].values()
    assert np.isfinite(a).all() and a.shape == (3, 6)
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------
# chip_smoke.py's phases 17-18 at a small size on the CPU
# ------------------------------------------------------------------


def _chip_smoke():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


def test_exact_f64_posterior_is_the_dense_objective_and_posterior():
    """chip_smoke's row-blocked f64 anchor is ``map_neg_logp``'s value and
    the dense posterior (``posterior_cache`` → ``predict_diag``)."""
    from gumbi_tpu_torch.ops import constrain, posterior_cache, predict_diag

    cs = _chip_smoke()
    X, y = cs.make_iter_data(300, seed=3)
    spec = cs._iter_spec()
    xc, yt = torch.as_tensor(X, dtype=torch.float64), torch.as_tensor(y, dtype=torch.float64)
    xk = torch.zeros((300, 0), dtype=torch.long)
    u = {"ls_total": torch.log(torch.tensor([0.4, 0.5], dtype=torch.float64)),
         "η_total": torch.tensor(0.1, dtype=torch.float64), "σ": torch.log(torch.tensor(0.1, dtype=torch.float64))}
    p = constrain(u)
    la, lb = np.array([2.0, 2.0]), np.array([1.0, 1.0])
    xs = torch.as_tensor(np.random.default_rng(1).uniform(-2, 2, (37, 2)))
    xks = torch.zeros((37, 0), dtype=torch.long)
    f, mean, var, alpha = cs.exact_f64_posterior(spec, p, xc, xk, yt, la, lb, xs, xks, row_block=64)
    f_ref = float(map_neg_logp(spec, u, xc, xk, yt, torch.as_tensor(la), torch.as_tensor(lb)))
    m_ref, v_ref = predict_diag(spec, p, posterior_cache(spec, p, xc, xk, yt), xs, xks, with_noise=False)
    np.testing.assert_allclose(f, f_ref, rtol=1e-12)
    np.testing.assert_allclose(mean.numpy(), m_ref.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(var.numpy(), v_ref.numpy(), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(alpha.numpy(), posterior_cache(spec, p, xc, xk, yt).alpha.numpy(), rtol=1e-9, atol=1e-12)


def test_chip_smoke_gp_iterative_phase_runs_on_the_cpu():
    """Phase 17's functions at N = 600 (block 128, so padding runs), a
    128-row coarse stage and 3 restarts: a staged fit through the table's
    GP, its grid and the exact anchor."""
    cs = _chip_smoke()
    X, y = cs.make_iter_data(600)
    cfg = cs.gp_iter_config(block=128, rank=64, probes=8, love_rank=128)
    r = cs.run_gp_iterative(cs.xy_table(X, y), "cpu", torch.float64, cfg,
                            map_kw=dict(cs.GP_ITER_MAP, n_restarts=3, coarse_n=128, polish_maxiter=10), grid=12)
    gp = r["gp"]
    assert set(r["stages"]) >= {"find_MAP", "iter_coarse", "iter_polish", "iter_cache", "predict"}
    assert gp._iter_state["xc"].shape[0] == 640 and gp._cache is None
    assert not bool(gp._fit_aux["polish_fallback"]) and r["y"].shape == (12, 12)
    zero = {"rbf_gram": 0, "fused_stationary_matvec": 0, "fused_stationary_matvec_sym": 0}
    assert r["launches"] == {"fit": zero, "predict": zero}  # no CUDA kernel on the CPU
    a = cs.anchor_gp_iterative(gp, n_points=50)
    assert a["m"] == 50 and a["rel"] <= cs.ANCHOR_TOL and a["dmean"] <= cs.GRID_TOL
    assert a["love_med"] <= cs.LOVE_MEDIAN_TOL, a
    ra = a["ref_alpha"]
    assert np.isfinite(ra["woodbury"]) and ra["pcg"] <= cs.GRID_TOL and ra["pcg_iters"] > 0, ra


def test_chip_smoke_gp_sparse_phase_runs_on_the_cpu():
    """Phase 18's functions at N = 600, M = 32, 2 restarts."""
    cs = _chip_smoke()
    table, g = cs.fitc_table(600)
    r = cs.run_gp_sparse(table, g, "cpu", torch.float64, n_u=32, map_kw=dict(n_restarts=2, maxiter=30))
    gp = r["gp"]
    assert gp.sparse and gp._xu_c.shape == (32, 2) and set(r["stages"]) >= {"build_model", "predict", "draws"}
    assert r["pred"].shape == (len(g),) and np.isfinite(r["pred"].μ).all()
    assert r["draws"]["y"].values().shape == (cs.GP_SPARSE_DRAWS, len(g))
    f32, f64, per_pt = cs.sparse_f64_gap(gp)
    assert f32 == f64 and per_pt == 0.0  # the model is f64 here
