"""The port's ``parallel`` package against the JAX reference's single-device functions.

One module-scoped pool (``gumbi_tpu_torch.tools.mesh_jobs.launch``) runs
every job once on a 4-rank gloo world on the CPU (one process and one thread
a rank) holding a (2, 2) ('restart', 'data') mesh and a (1, 4) one, and
brings every rank's result back here; each test holds one job's result. The
pool stops every process within ``POOL_TIMEOUT`` seconds, so a stalled
collective fails its tests and hangs nothing. A second pool runs a one-rank
world, the card's configuration.

The reference's own ``tests/test_parallel.py`` holds its sharded functions
equal to its single-device ones, so each port result is held here against
the reference's single-device function at f64 (``mll``, ``quad_and_logdet``,
``map_neg_logp`` and its kin at the MAP, ``posterior_cache``/
``predict_diag``, ``iter_*``), values and gradients at ``RTOL``; the fits
against the port's single-device fits at the fit rule (values 1e-6, MAPs
1e-5: ``tests/test_torch_gpc.py``'s); and every rank's result against rank
0's, bit for bit (the outputs are replicated).
"""

from dataclasses import asdict

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import importlib

import gumbi_tpu.ops as jops
from gumbi_tpu_torch.ops import (
    IterConfig,
    constrain,
    draw_probes,
    fit_fitc_laplace_map,
    fit_gp_map,
    fit_kron_map,
    fit_laplace_map,
    fitc_neg_logp,
    initial_params,
    iter_posterior_cache,
    multi_restart_minimize,
    unconstrain,
)
from gumbi_tpu_torch.tools.array_table import ArrayTable, ArrayTableGP, ArrayTableGPC
from gumbi_tpu_torch.tools.mesh_jobs import launch

# ``gumbi_tpu.ops`` re-exports functions under some of its modules' names
jfitc, jfl, ji, jkron, jlap, jlinalg, jmll, jpost = (
    importlib.import_module(f"gumbi_tpu.ops.{m}")
    for m in ("fitc", "fitc_laplace", "iterative", "kronecker", "laplace", "linalg", "mll", "posterior"))

torch.set_num_threads(2)

RTOL = 1e-10
FIT_VALUE_RTOL = 1e-6
FIT_MAP_RTOL = 1e-5
POOL_TIMEOUT = 120
MESHES = {"2x2": 2, "1x4": 1}
FIT = dict(maxiter=40, tol=1e-8)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, dict):
        return {k: _np(x) for k, x in v.items()}
    return np.asarray(v)


def _ref_spec(spec):
    """The reference's ``GPSpec`` with the port spec's fields."""
    d = asdict(spec)
    cg = lambda c: None if c is None else jops.CoregTerm(**c)  # noqa: E731
    terms = tuple(jops.GPTerm(suffix=t["suffix"], kernel=t["kernel"], linear_idx=tuple(t["linear_idx"]),
                              coregs=tuple(cg(c) for c in t["coregs"])) for t in d["terms"])
    return jops.GPSpec(terms=terms, d_cont=d["d_cont"], ard=d["ard"], noise_coreg=cg(d["noise_coreg"]),
                       period=d["period"], likelihood=d["likelihood"])


def _j(tree):
    return {k: jnp.asarray(np.asarray(v)) for k, v in tree.items()}


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


# ------------------------------------------------------------------
# Problems (numpy, from seeds)
# ------------------------------------------------------------------


def _surface(n, seed, d=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, d))
    y = np.sin(1.3 * x[:, 0]) + 0.5 * np.cos(x[:, -1]) + 0.1 * rng.standard_normal(n)
    return x, y


def _table(n, seed, outputs=("y",), label=False):
    x, y = _surface(n, seed)
    cols = {"x1": x[:, 0], "x2": x[:, 1]}
    for j, o in enumerate(outputs):
        yo = y + 0.3 * j * x[:, 1]
        cols[o] = (yo > 0).astype(float) if label else yo
    return cols


def _built(cls, cols, outputs, **build):
    gp = cls(ArrayTable(cols, outputs=list(outputs)), outputs=list(outputs), device="cpu")
    gp.specify_model(outputs=list(outputs), continuous_dims=["x1", "x2"])
    gp.build_model(**build)
    return gp


def _prior(gp):
    return np.asarray(gp._ls_alpha), np.asarray(gp._ls_beta)


def _u0s(gp, n_restarts=3, seed=0):
    return _np(initial_params(gp._spec, gp._ls_alpha, gp._ls_beta, n_restarts=n_restarts, seed=seed,
                              dtype=torch.float64, device="cpu"))


PROBLEMS = {}


def _problems():
    """Built (unfitted) port models whose arrays the jobs take."""
    if not PROBLEMS:
        PROBLEMS["dense"] = _built(ArrayTableGP, _table(40, 0), ["y"])
        PROBLEMS["kron"] = _built(ArrayTableGP, _table(30, 1, ("y1", "y2")), ["y1", "y2"])
        PROBLEMS["laplace"] = _built(ArrayTableGPC, _table(40, 2, label=True), ["y"], heteroskedastic_outputs=False)
        PROBLEMS["fitc"] = _built(ArrayTableGP, _table(60, 3), ["y"], sparse=True, n_u=8)
        PROBLEMS["fitc_laplace"] = _built(ArrayTableGPC, _table(60, 4, label=True), ["y"],
                                          heteroskedastic_outputs=False, sparse=True, n_u=8)
    return PROBLEMS


def _fit_arrays(kind):
    gp = _problems()[kind]
    la, lb = _prior(gp)
    if kind == "kron":
        return gp, (_np(gp._xc_locs), _np(gp._Y), la, lb)
    if kind in ("fitc", "fitc_laplace"):
        return gp, (_np(gp._xc), _np(gp._xk), _np(gp._xu_c), _np(gp._xu_k), _np(gp._yz), la, lb)
    return gp, (_np(gp._xc), _np(gp._xk), _np(gp._yz), la, lb)


def _single_device_fit(kind, arrays, u0s):
    """The port's single-device fit of the same problem and starts:
    (natural params, value)."""
    gp = _problems()["dense" if kind == "gp" else kind]
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    u = {k: t(v) for k, v in u0s.items()}
    if kind == "gp":
        p, f, _ = fit_gp_map(gp._spec, *arrays, u, **FIT, device="cpu")
        return _np(p), float(f)
    if kind == "kron":
        ub, f, _ = fit_kron_map(gp._spec, *arrays, u, **FIT, device="cpu")
    elif kind == "laplace":
        ub, f, _ = fit_laplace_map(gp._spec, *arrays, u, **FIT, device="cpu")
    elif kind == "fitc_laplace":
        ub, f, _ = fit_fitc_laplace_map(gp._spec, *arrays, u, **FIT, device="cpu")
    else:
        xc, xk, xu_c, xu_k, y, la, lb = (t(a) for a in arrays)

        def obj(uu):
            return fitc_neg_logp(gp._spec, uu, xc, xk.long(), xu_c, xu_k.long(), y, la, lb)

        ub, f, _ = multi_restart_minimize(obj, u, **FIT)
    return _np(constrain(ub)), float(f)


def _ref_value(kind, arrays, params):
    """The reference's objective at the port's MAP (natural params)."""
    spec = _ref_spec(_problems()[{"gp": "dense"}.get(kind, kind)]._spec)
    u = _j(_np(unconstrain({k: torch.as_tensor(v) for k, v in params.items()})))
    a = [jnp.asarray(x) for x in arrays]
    fn = {"gp": jmll.map_neg_logp, "kron": jkron.kron_neg_logp, "laplace": jlap.laplace_neg_logp,
          "fitc": jfitc.fitc_neg_logp, "fitc_laplace": jfl.fitc_laplace_neg_logp}[kind]
    return float(fn(spec, u, *a))


# the dense problem's lengthscales for the value/gradient jobs
PARAMS = {"ls_total": np.array([0.6, 0.9]), "η_total": np.array(1.2), "σ": np.array(0.15)}
ITER_CG = IterConfig(maxiter=200, tol=1e-10, n_probes=6, precond_rank=4, block=8, quad_steps=64, love_rank=16)
ITER_EXH = IterConfig(maxiter=200, tol=1e-10, n_probes=6, precond_rank=64, block=8, quad_steps=64, love_rank=16)


def _iter_problem(cfg, seed=5, n=60, pad_to=64):
    gp = _problems()["dense"]
    x, y = _surface(n, seed)
    xc = np.concatenate([x, np.zeros((pad_to - n, 2))])
    yp = np.concatenate([y, np.zeros(pad_to - n)])
    mask = np.concatenate([np.ones(n), np.zeros(pad_to - n)])
    pn, pk = (_np(t) for t in draw_probes(7, pad_to, cfg, dtype=torch.float64, device="cpu"))
    la, lb = _prior(gp)
    ls = np.array([0.5, 0.7]) if cfg is ITER_CG else np.array([1.6, 1.8])
    u = _np(unconstrain({"ls_total": torch.as_tensor(ls), "η_total": torch.tensor(1.1, dtype=torch.float64),
                              "σ": torch.tensor(0.2, dtype=torch.float64)}))
    return dict(spec=gp._spec, cfg=cfg, uparams=u, xc=xc, xk=np.zeros((pad_to, 0), np.int64), y=yp,
                ls_alpha=la, ls_beta=lb, probe_n=pn, probe_k=pk, mask=mask)


BUCKET_MASK = np.concatenate([np.ones(32), np.zeros(8)])  # 40 training rows, 8 of them padding


def _bucket_predict_problem():
    x, y = _surface(40, 6)
    xs, _ = _surface(37, 8)
    return dict(spec=_problems()["dense"]._spec, params=PARAMS, xc=x, xk=np.zeros((40, 0), np.int64),
                y=y * BUCKET_MASK, xs=xs, ks=np.zeros((37, 0), np.int64))


MODEL_POINTS = np.column_stack([np.linspace(-1.8, 1.8, 9), np.linspace(1.5, -1.5, 9)])
ITER_MODEL_CFG = IterConfig(maxiter=200, tol=1e-6, n_probes=8, precond_rank=16, block=8, love_rank=16)
# name → (class, columns, outputs, fit kwargs, find_MAP kwargs, points, predict with the mesh)
MODELS = {
    "dense": ("gp", _table(40, 0), ["y"], dict(continuous_dims=["x1", "x2"]), dict(n_restarts=3, maxiter=30),
              MODEL_POINTS, True),
    "kronecker": ("gp", _table(30, 1, ("y1", "y2")), ["y1", "y2"], dict(continuous_dims=["x1", "x2"]),
                  dict(n_restarts=3, maxiter=30), None, False),
    "independent": ("gp", _table(30, 1, ("y1", "y2")), ["y1", "y2"],
                    dict(continuous_dims=["x1", "x2"], multitask_kernel="Independent"),
                    dict(n_restarts=3, maxiter=30), "tall", True),
    "sparse": ("gp", _table(60, 3), ["y"], dict(continuous_dims=["x1", "x2"], sparse=True, n_u=8),
               dict(n_restarts=3, maxiter=30), MODEL_POINTS, False),
    "shard_data": ("gp", _table(30, 0), ["y"], dict(continuous_dims=["x1", "x2"]),
                   dict(n_restarts=2, maxiter=20, shard_data=True), MODEL_POINTS, True),
    "iterative": ("gp", _table(60, 5), ["y"], dict(continuous_dims=["x1", "x2"]),
                  dict(n_restarts=2, maxiter=15, engine="iterative", iter_config=ITER_MODEL_CFG), MODEL_POINTS,
                  False),
    "gpc": ("gpc", _table(40, 2, label=True), ["y"], dict(continuous_dims=["x1", "x2"], heteroskedastic_outputs=False),
            dict(n_restarts=3, maxiter=30), None, False),
    "gpc_sparse": ("gpc", _table(60, 4, label=True), ["y"],
                   dict(continuous_dims=["x1", "x2"], heteroskedastic_outputs=False, sparse=True, n_u=8),
                   dict(n_restarts=3, maxiter=30), None, False),
}


def _tall_points(outputs):
    """MODEL_POINTS tiled per output, with the output index column."""
    blocks = [np.column_stack([MODEL_POINTS, np.full(len(MODEL_POINTS), j)]) for j in range(len(outputs))]
    return np.concatenate(blocks)


def _model_job(name, mesh="2x2"):
    cls, cols, outputs, fit_kw, find_kw, points, predict_mesh = MODELS[name]
    if isinstance(points, str):
        points = _tall_points(outputs)
    return (f"model_{name}", "model", dict(mesh=mesh, cls=cls, columns=cols, outputs=outputs, fit_kw=fit_kw,
                                           find_kw=find_kw, points=points, predict_mesh=predict_mesh))


def _jobs():
    jobs = []
    for kind in ("gp", "kron", "laplace", "fitc", "fitc_laplace"):
        gp, arrays = _fit_arrays("dense" if kind == "gp" else kind)
        jobs.append((f"fit_{kind}", "restart_fit", dict(mesh="2x2", kind=kind, spec=gp._spec, arrays=arrays,
                                                        u0s=_u0s(gp), **FIT)))
    x, y = _surface(50, 9)
    for mesh, n in (("1x4", 50), ("2x2", 45)):
        jobs.append((f"mll_{mesh}", "gram_mll", dict(mesh=mesh, spec=_problems()["dense"]._spec, params=PARAMS,
                                                     xc=x[:n], xk=np.zeros((n, 0), np.int64), y=y[:n])))
    rng = np.random.default_rng(11)
    A = rng.standard_normal((48, 48))
    jobs.append(("quad_logdet", "quad_logdet", dict(mesh="1x4", K=A @ A.T / 48 + np.eye(48),
                                                    y=rng.standard_normal(48), g_quad=0.7, g_logdet=1.3)))
    gp = _problems()["dense"]
    xd, yd = _np(gp._xc)[:30], _np(gp._yz)[:30]
    jobs.append(("data_fit", "data_fit", dict(mesh="2x2", spec=gp._spec, xc=xd, xk=np.zeros((30, 0), np.int64),
                                              y=yd, ls_alpha=_prior(gp)[0], ls_beta=_prior(gp)[1],
                                              u0s=_u0s(gp, 2), maxiter=20, tol=1e-8)))
    bp = _bucket_predict_problem()
    for mesh in ("2x2", "1x4"):
        for masked in (False, True):
            jobs.append((f"predict_{mesh}_{masked}", "predict",
                         dict(mesh=mesh, mask=BUCKET_MASK if masked else None, **bp)))
    for label, cfg in (("cg", ITER_CG), ("exhausted", ITER_EXH)):
        jobs.append((f"iter_{label}", "dist_iter", dict(mesh="1x4", **_iter_problem(cfg))))
    jobs.extend(_model_job(name) for name in MODELS)
    return jobs


def _check_replicated(per_rank):
    for r, res in enumerate(per_rank):
        assert res[0] == "ok", f"rank {r}:\n{res[1]}"
    first = per_rank[0][1]

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    for res in per_rank[1:]:
        same(first, res[1])
    return first


@pytest.fixture(scope="module")
def pool():
    return launch(_jobs(), world=4, meshes=MESHES, timeout=POOL_TIMEOUT)


def _result(pool, name):
    return _check_replicated(pool[name])


# ------------------------------------------------------------------
# Restart-sharded fits
# ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["gp", "kron", "laplace", "fitc", "fitc_laplace"])
def test_restart_sharded_fit_is_the_single_device_fit(pool, kind):
    """3 restarts padded to the 4 ranks with a copy of restart 0: the MAP and
    value of the port's single-device fit from the same starts, and the
    reference's objective there."""
    r = _result(pool, f"fit_{kind}")
    gp, arrays = _fit_arrays("dense" if kind == "gp" else kind)
    params, f = _single_device_fit(kind, arrays, _u0s(gp))
    assert r["n_padded"] == 4 and len(r["all_values"]) == 4 and r["all_values"][3] == r["all_values"][0]
    _close(r["f"], f, FIT_VALUE_RTOL)
    for k in params:
        _close(r["params"][k], params[k], FIT_MAP_RTOL, 1e-8)
    _close(_ref_value(kind, arrays, r["params"]), r["f"], 1e-8)


# ------------------------------------------------------------------
# Data-sharded Gram, blocked Cholesky, distributed quad/logdet
# ------------------------------------------------------------------


def _ref_mll_and_grads(x, y):
    spec = _ref_spec(_problems()["dense"]._spec)
    xk = jnp.zeros((len(y), 0), jnp.int32)

    def f(p):
        return jmll.mll(spec, p, jnp.asarray(x), xk, jnp.asarray(y))

    v, g = jax.value_and_grad(f)(_j(PARAMS))
    return float(v), {k: np.asarray(a) for k, a in g.items()}


@pytest.mark.parametrize("mesh,n", [("1x4", 50), ("2x2", 45)])
def test_sharded_gram_mll_and_its_gradient_match_the_reference_mll(pool, mesh, n):
    """N = 50 on 4 'data' ranks (two pad rows) and N = 45 on 2 (one): the
    value, with and without a gradient, and the gradient in every parameter,
    each rank's share summed over the axis."""
    r = _result(pool, f"mll_{mesh}")
    x, y = _surface(50, 9)
    v, g = _ref_mll_and_grads(x[:n], y[:n])
    _close(r["value"], v)
    _close(r["value_nograd"], v)
    for k in g:
        _close(r["grads"][k], g[k])


def test_blocked_cholesky_and_dist_quad_and_logdet_match_the_reference(pool):
    r = _result(pool, "quad_logdet")
    rng = np.random.default_rng(11)
    A = rng.standard_normal((48, 48))
    K, y = A @ A.T / 48 + np.eye(48), rng.standard_normal(48)
    _close(r["L"], np.linalg.cholesky(K), RTOL, 1e-13)

    def f(K, y):
        q, ld = jlinalg.quad_and_logdet(K, y)
        return 0.7 * q + 1.3 * ld, (q, ld)

    (_, (q, ld)), (gK, gy) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(jnp.asarray(K), jnp.asarray(y))
    _close(r["quad"], q)
    _close(r["logdet"], ld)
    # the reference's backward gives the symmetric K̄; a row block's rows
    # carry the same entries
    _close(r["gK"], gK, RTOL, 1e-14)
    _close(r["gy"], gy)


def test_data_sharded_fit_meets_the_single_device_fit(pool):
    """Two restarts of 20 iterations on 2 'data' ranks: the MAP of the
    port's ``fit_gp_map`` from the same starts (the objectives differ in
    their last bits), and the reference's ``map_neg_logp`` there."""
    r = _result(pool, "data_fit")
    gp = _problems()["dense"]
    arrays = (_np(gp._xc)[:30], np.zeros((30, 0), np.int64), _np(gp._yz)[:30], *_prior(gp))
    u = {k: torch.as_tensor(v) for k, v in _u0s(gp, 2).items()}
    p, f, _ = fit_gp_map(gp._spec, *arrays, u, maxiter=20, tol=1e-8, device="cpu")
    _close(r["f"], float(f), FIT_VALUE_RTOL)
    for k in p:
        _close(r["params"][k], _np(p[k]), FIT_MAP_RTOL, 1e-8)
    _close(_ref_value("gp", arrays, r["params"]), r["f"], 1e-8)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_sharded_predict_diag_matches_the_reference(pool, mesh, masked):
    """37 points over 2 and 4 'data' ranks (one and three pad points), with
    and without a bucket mask on the training rows (the masked columns
    zeroed)."""
    r = _result(pool, f"predict_{mesh}_{masked}")
    bp = _bucket_predict_problem()
    spec = _ref_spec(bp["spec"])
    mask = jnp.asarray(BUCKET_MASK) if masked else None
    xk = jnp.zeros((40, 0), jnp.int32)
    cache = jpost.posterior_cache(spec, _j(PARAMS), jnp.asarray(bp["xc"]), xk, jnp.asarray(bp["y"]), mask=mask)
    for noise in (True, False):
        m, v = jpost.predict_diag(spec, _j(PARAMS), cache, jnp.asarray(bp["xs"]), jnp.zeros((37, 0), jnp.int32),
                                  with_noise=noise)
        assert r[f"mean_{noise}"].shape == (37,)
        _close(r[f"mean_{noise}"], m)
        _close(r[f"var_{noise}"], v)


# ------------------------------------------------------------------
# Distributed iterative engine
# ------------------------------------------------------------------


def _jcfg(cfg):
    return ji.IterConfig(**asdict(cfg))


@pytest.mark.parametrize("label", ["cg", "exhausted"])
def test_dist_iter_objective_gradient_and_cache_match_the_reference(pool, label):
    """N = 60 padded to 64 rows (4 ranks × block 8), the reference's probes:
    the objective, its surrogate gradient and the posterior cache (α, the
    preconditioner factor, d and the LOVE factor by scalar Lanczos) of the
    reference's single-device engine, with PCG run (rank 4) and in the
    exhausted regime (rank 32 on a smooth kernel)."""
    r = _result(pool, f"iter_{label}")
    cfg = ITER_CG if label == "cg" else ITER_EXH
    pb = _iter_problem(cfg)
    assert r["exhausted"] == (label == "exhausted") and (r["iters"] > 0) == (label == "cg")
    spec, jc = _ref_spec(pb["spec"]), _jcfg(cfg)
    a = {k: jnp.asarray(pb[k]) for k in ("xc", "y", "ls_alpha", "ls_beta", "probe_n", "probe_k", "mask")}
    xk = jnp.zeros((64, 0), jnp.int32)

    def f(u):
        return ji.iter_map_neg_logp(spec, u, a["xc"], xk, a["y"], a["ls_alpha"], a["ls_beta"], a["probe_n"],
                                    a["probe_k"], jc, mask=a["mask"])

    v, g = jax.value_and_grad(f)(_j(pb["uparams"]))
    _close(r["value"], v, 1e-9)
    for k in g:
        _close(r["grads"][k], g[k], 1e-8)
    p = jops.constrain(_j(pb["uparams"]))
    cache = ji.iter_posterior_cache(spec, jc, p, a["xc"], xk, a["y"], mask=a["mask"])
    # the pivoted Cholesky's last columns sit at the f64 floor, where the
    # pivots' order follows the rounding of the residual diagonal
    for k in ("alpha", "L", "d", "W"):
        _close(r["cache"][k], cache[k], 1e-8, 1e-9)


def test_dist_iter_cache_is_the_single_device_cache(pool):
    """The same solve through the port's single-device engine: one engine,
    one distributed primitive."""
    r = _result(pool, "iter_cg")
    pb = _iter_problem(ITER_CG)
    t = {k: torch.as_tensor(pb[k]) for k in ("xc", "y", "mask")}
    p = constrain({k: torch.as_tensor(v) for k, v in pb["uparams"].items()})
    cache = iter_posterior_cache(pb["spec"], ITER_CG, p, t["xc"], torch.zeros((64, 0), dtype=torch.long), t["y"],
                                 mask=t["mask"])
    for k in ("alpha", "L", "d", "W"):
        _close(r["cache"][k], _np(cache[k]), 1e-9, 1e-12)


# ------------------------------------------------------------------
# GP / GPC find_MAP(mesh=) and predict(mesh=)
# ------------------------------------------------------------------


def _single_device_model(name):
    cls, cols, outputs, fit_kw, find_kw, points, _ = MODELS[name]
    klass = ArrayTableGP if cls == "gp" else ArrayTableGPC
    gp = klass(ArrayTable(cols, outputs=outputs), outputs=outputs, device="cpu")
    kw = {k: v for k, v in find_kw.items() if k != "shard_data"}
    gp.fit(outputs=outputs, **fit_kw, MAP_kwargs=kw)
    return gp


def _maps(m):
    return m if not all(isinstance(v, dict) for v in m.values()) else {
        f"{o}/{k}": v for o, d in m.items() for k, v in d.items()}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_find_map_on_a_mesh_is_the_single_device_fit(pool, name):
    """``fit(..., MAP_kwargs={'mesh': mesh})`` on the (2, 2) mesh: the dense,
    Kronecker, Independent (output by output), sparse, data-sharded and
    iterative branches of ``GP.find_MAP`` and ``GPC.find_MAP`` dense and
    sparse, against the single-device fit of the same table; and
    ``predict(mesh=)`` against ``predict`` on the same model."""
    r = _result(pool, f"model_{name}")
    gp = _single_device_model(name)
    assert r["structure"] == gp._structure
    _close(r["neg_logp"], gp._neg_logp, FIT_VALUE_RTOL)
    mp, ms = _maps(r["MAP"]), _maps(gp.MAP)
    assert mp.keys() == ms.keys()
    for k in mp:
        _close(mp[k], ms[k], FIT_MAP_RTOL, 1e-8)
    assert r["has_cache"] == (name in ("dense",))
    if "mean_mesh" in r:
        _close(r["mean_mesh"], r["mean"], 1e-10, 1e-12)
        _close(r["var_mesh"], r["var"], 1e-10, 1e-12)
    if "mean" in r:
        points = _tall_points(MODELS[name][2]) if isinstance(MODELS[name][5], str) else MODELS[name][5]
        m, v = gp.predict(np.asarray(points))
        _close(r["mean"], m, 1e-5, 1e-7)
        _close(r["var"], v, 1e-5, 1e-7)


def test_one_rank_world_is_the_single_device_path():
    """The card's configuration: a one-rank world, a (1, 1) mesh. The dense
    model's fit and predictions and the distributed iterative objective are
    the single-device ones."""
    res = launch([_model_job("dense", "1x1"), ("iter", "dist_iter", dict(mesh="1x1", **_iter_problem(ITER_CG)))],
                 world=1, meshes={"1x1": 1}, timeout=POOL_TIMEOUT)
    r = _check_replicated(res["model_dense"])
    gp = _single_device_model("dense")
    _close(r["neg_logp"], gp._neg_logp, 1e-12)
    for k in gp.MAP:
        _close(r["MAP"][k], gp.MAP[k], 1e-10, 1e-12)
    m, v = gp.predict(MODEL_POINTS)
    _close(r["mean_mesh"], m, 1e-10, 1e-12)
    _close(r["var_mesh"], v, 1e-10, 1e-12)
    it = _check_replicated(res["iter"])
    pool_like = {"iter_cg": [("ok", it)]}
    test_dist_iter_objective_gradient_and_cache_match_the_reference(pool_like, "cg")


def test_chip_smoke_mesh_phase_runs_on_the_cpu():
    """chip_smoke.py's phase 21 run on a one-rank gloo mesh at small sizes
    (f64 on the CPU): the refits on the mesh are the single-device fits, the
    data-sharded objective is the dense one (its f32 gradient no further
    from f64 than the dense f32 one), ``predict(mesh=)`` is ``predict()``,
    the distributed iterative fit's objective is the single-device one at
    its parameters and probes, and (f)'s two-rank world meets the one-rank
    results."""
    import os
    import sys

    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs
    from gumbi_tpu_torch.parallel import make_mesh

    models = cs.phase21_small_models()
    mesh = make_mesh(device_type="cpu")
    try:
        out = cs.phase21_run(mesh, models, device="cpu", dtype=torch.float64, small=True)
    finally:
        dist.destroy_process_group()
    for name in ("kronecker", "gpc", "sparse", "gpc_sparse"):
        assert out[name]["gap"] == (0.0, 0.0), name
    b, c, f = out["data_sharded"], out["iterative"], out["two_ranks"]
    assert b["no_cache"] and b["finite"] and b["grid_rel"] == (0.0, 0.0)
    for rd in b["readings"].values():
        assert abs(rd["s32"] - rd["d32"]) / abs(rd["d32"]) <= cs.MESH_REL_TOL and rd["shard64_rel"] <= 1e-12
        assert rd["grad_gap64"] <= cs.MESH_GRAD_F64_RATIO * rd["dense_gap64"] + cs.MESH_REL_TOL * rd["grad_scale"]
    assert c["obj_rel"] < 1e-12 and c["anchor"]["dmean"] <= cs.GRID_TOL and c["evaluations"] > 0
    # two gloo ranks: the restarts split one a rank, the Gram's rows over both
    assert not any(f["errors"].values()) and f["same"] and f["qld_rel"] <= 1e-10
    assert max(f["kron_gap"]) <= 1e-10 and f["mll_rel"] <= cs.MESH_REL_TOL
    assert f["grad_gap64"] <= cs.MESH_GRAD_F64_RATIO * f["dense_gap64"] + cs.MESH_REL_TOL * f["grad_scale"]
