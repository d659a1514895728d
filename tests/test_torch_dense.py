"""Port parity: the exact dense GP path of gumbi_tpu_torch vs gumbi_tpu.

The blocked-backward likelihood, the additive-level and full-covariance
posterior functions, ``draw_samples``, the ``PosteriorCache`` carried
across both ways, and the dense slice as a whole (the chain that
``chip_smoke.py`` runs on the card at N = 16,384, here at N = 512 on the
CPU at f64). All inputs come from numpy seeds; comparisons at f64 are at
rtol 1e-9 unless a test says why not (same formulas, LAPACK/BLAS summation
order apart).
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gumbi_tpu.ops.kernels as jk
import gumbi_tpu.ops.optimize as jo
import gumbi_tpu.ops.posterior as jpo
import gumbi_tpu.ops.priors as jp
import gumbi_tpu_torch.ops.posterior as tpo
from gumbi_tpu_torch.convert import (
    params_from_numpy,
    params_to_numpy,
    posterior_cache_from_numpy,
    posterior_cache_to_numpy,
    spec_from_reference,
)
from gumbi_tpu_torch.ops import constrain, seam_cholesky

jm = importlib.import_module("gumbi_tpu.ops.mll")
tm = importlib.import_module("gumbi_tpu_torch.ops.mll")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-9
F64 = dict(dtype=torch.float64, device="cpu")


# ------------------------------------------------------------------
# Blocked backward
# ------------------------------------------------------------------


@pytest.mark.parametrize("n", [16384, 5120, 3072, 1536, 768, 640, 100, 50000])
def test_pick_panel(n):
    assert tm._pick_panel(n) == jm._pick_panel(n)
    b = tm._pick_panel(n)
    assert b == 0 or (n % b == 0 and b <= 2048)


def _blocked_problem(n=512, seed=0):
    """One coregionalized ExpQuad term over 2 dims (so the panel slices both
    xc and xk) with homoskedastic noise, the case the blocked backward covers."""
    rng = np.random.default_rng(seed)
    cg = jk.CoregTerm(name="Code", col=0, d_out=3)
    jspec = jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad", coregs=(cg,)),), d_cont=2)
    xc = rng.uniform(-2, 2, size=(n, 2))
    xk = rng.integers(0, 3, size=(n, 1)).astype(np.int32)
    y = np.sin(1.3 * xc[:, 0]) * np.cos(0.9 * xc[:, 1]) + 0.2 * xk[:, 0] + rng.normal(0, 0.1, n)
    la, lb = jp.ls_prior_params([0.1, 0.1], [4.0, 4.0])
    u = {k: np.asarray(v[1]) for k, v in jp.initial_params(jspec, la, lb, 2, seed=seed).items()}
    return jspec, xc, xk, y, la, lb, u


def _jax_vg(fn, tree):
    v, g = jax.value_and_grad(fn)({k: jnp.asarray(x) for k, x in tree.items()})
    return float(v), {k: np.asarray(x) for k, x in g.items()}


def _torch_vg(fn, tree):
    t = {k: torch.tensor(x, requires_grad=True) for k, x in tree.items()}
    v = fn(t)
    v.backward()
    return v.item(), {k: x.grad.numpy() for k, x in t.items()}


def _assert_vg_close(a, b, rtol=RTOL):
    np.testing.assert_allclose(a[0], b[0], rtol=rtol)
    for k in b[1]:
        np.testing.assert_allclose(a[1][k], b[1][k], rtol=rtol, atol=1e-9 * np.abs(b[1][k]).max() + 1e-12, err_msg=k)


@pytest.fixture(scope="module")
def blocked():
    jspec, xc, xk, y, la, lb, u = _blocked_problem()
    J = dict(xc=jnp.asarray(xc), xk=jnp.asarray(xk), y=jnp.asarray(y))
    T = dict(xc=torch.tensor(xc), xk=torch.tensor(xk), y=torch.tensor(y))
    return jspec, spec_from_reference(jspec), J, T, la, lb, u


def test_map_neg_logp_blocked_value_and_grad(blocked):
    """N = 512, panel 128: against the reference's blocked objective and
    against the port's own dense objective."""
    jspec, spec, J, T, la, lb, u = blocked
    ref = _jax_vg(lambda u: jm.map_neg_logp_blocked(jspec, u, J["xc"], J["xk"], J["y"], la, lb, panel=128), u)
    port = _torch_vg(lambda u: tm.map_neg_logp_blocked(spec, u, T["xc"], T["xk"], T["y"], la, lb, panel=128), u)
    dense = _torch_vg(lambda u: tm.map_neg_logp(spec, u, T["xc"], T["xk"], T["y"], la, lb), u)
    _assert_vg_close(port, ref)
    _assert_vg_close(port, dense)
    # the default panel (512 itself here) and the no-gradient value agree too
    auto = _torch_vg(lambda u: tm.map_neg_logp_blocked(spec, u, T["xc"], T["xk"], T["y"], la, lb), u)
    _assert_vg_close(auto, dense)
    with torch.no_grad():
        v = tm.map_neg_logp_blocked(spec, {k: torch.tensor(x) for k, x in u.items()}, T["xc"], T["xk"], T["y"],
                                    la, lb, panel=128)
    np.testing.assert_allclose(v.item(), dense[0], rtol=RTOL)


def test_blocked_gaussian_logp_value_and_grads(blocked):
    """The likelihood alone, with gradients to the parameters, xc and y."""
    jspec, spec, J, T, la, lb, u = blocked
    p = {k: np.asarray(v) for k, v in jp.constrain({k: jnp.asarray(v) for k, v in u.items()}).items()}
    tree = dict(p, __xc=np.asarray(J["xc"]), __y=np.asarray(J["y"]))

    def split(t):
        return {k: v for k, v in t.items() if not k.startswith("__")}, t["__xc"], t["__y"]

    def f_j(t):
        params, xc, y = split(t)
        return jm.blocked_gaussian_logp(jspec, 128, params, xc, J["xk"], y, 1e-6)

    def f_t(t):
        params, xc, y = split(t)
        return tm.blocked_gaussian_logp(spec, 128, params, xc, T["xk"], y, 1e-6)

    def f_dense(t):
        params, xc, y = split(t)
        return tm.mll(spec, params, xc, T["xk"], y)

    port = _torch_vg(f_t, tree)
    _assert_vg_close(port, _jax_vg(f_j, tree))
    _assert_vg_close(port, _torch_vg(f_dense, tree))


def test_blocked_falls_back_and_validates():
    jspec, xc, xk, y, la, lb, u = _blocked_problem(n=100)
    spec = spec_from_reference(jspec)
    T = (torch.tensor(xc), torch.tensor(xk), torch.tensor(y))
    # N = 100 has no clean divisor: the dense backward, same numbers
    a = _torch_vg(lambda u: tm.map_neg_logp_blocked(spec, u, *T, la, lb), u)
    b = _torch_vg(lambda u: tm.map_neg_logp(spec, u, *T, la, lb), u)
    _assert_vg_close(a, b, rtol=1e-12)
    with pytest.raises(ValueError):
        tm.blocked_gaussian_logp(spec, 64, constrain({k: torch.tensor(v) for k, v in u.items()}), *T)


# ------------------------------------------------------------------
# Posterior: additive levels, full covariance, draws
# ------------------------------------------------------------------


def _additive_problem(seed=3, n=40, m=17):
    """Two additive terms: the global continuous one and a per-Code one."""
    rng = np.random.default_rng(seed)
    cg = jk.CoregTerm(name="Code", col=0, d_out=2)
    jspec = jk.GPSpec(
        terms=(
            jk.GPTerm(suffix="total", kernel="ExpQuad"),
            jk.GPTerm(suffix="Code", kernel="Matern52", coregs=(cg,)),
        ),
        d_cont=2,
    )
    xc = rng.uniform(-2, 2, size=(n, 2))
    xk = rng.integers(0, 2, size=(n, 1)).astype(np.int32)
    y = np.sin(xc[:, 0]) + 0.4 * xk[:, 0] * np.cos(xc[:, 1]) + rng.normal(0, 0.1, n)
    la, lb = jp.ls_prior_params([0.1, 0.1], [4.0, 4.0])
    u = {k: jnp.asarray(v[0]) for k, v in jp.initial_params(jspec, la, lb, 1, seed=seed).items()}
    p = {k: np.asarray(v) for k, v in jp.constrain(u).items()}
    xcn = rng.uniform(-2, 2, size=(m, 2))
    xkn = rng.integers(0, 2, size=(m, 1)).astype(np.int32)
    mask = np.ones(n)
    mask[-6:] = 0.0
    return jspec, xc, xk, y, p, xcn, xkn, mask


@pytest.fixture(scope="module", params=[False, True], ids=["full", "masked"])
def additive(request):
    jspec, xc, xk, y, p, xcn, xkn, mask = _additive_problem()
    masked = request.param
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    cj = jpo.posterior_cache(jspec, pj, jnp.asarray(xc), jnp.asarray(xk), jnp.asarray(y),
                             mask=jnp.asarray(mask) if masked else None)
    spec = spec_from_reference(jspec)
    pt = params_from_numpy(p, **F64)
    ct = tpo.posterior_cache(spec, pt, torch.tensor(xc), torch.tensor(xk), torch.tensor(y),
                             mask=torch.tensor(mask) if masked else None)
    new_j = (jnp.asarray(xcn), jnp.asarray(xkn))
    new_t = (torch.tensor(xcn), torch.tensor(xkn))
    return jspec, pj, cj, new_j, spec, pt, ct, new_t


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("level", ["total", "Code"])
def test_predict_levels(additive, level):
    jspec, pj, cj, new_j, spec, pt, ct, new_t = additive
    mj, vj = jpo.predict_diag_level(jspec, pj, cj, *new_j, level=level)
    mt, vt = tpo.predict_diag_level(spec, pt, ct, *new_t, level=level)
    _close(mt, mj)
    _close(vt, vj)
    mj, Cj = jpo.predict_cov_level(jspec, pj, cj, *new_j, level=level)
    mt, Ct = tpo.predict_cov_level(spec, pt, ct, *new_t, level=level)
    _close(mt, mj)
    _close(Ct, Cj)


@pytest.mark.parametrize("with_noise", [False, True])
def test_predict_cov(additive, with_noise):
    jspec, pj, cj, new_j, spec, pt, ct, new_t = additive
    mj, Cj = jpo.predict_cov(jspec, pj, cj, *new_j, with_noise=with_noise)
    mt, Ct = tpo.predict_cov(spec, pt, ct, *new_t, with_noise=with_noise)
    _close(mt, mj)
    _close(Ct, Cj)
    # its diagonal is predict_diag's variance (before the clamp at 0)
    _, vt = tpo.predict_diag(spec, pt, ct, *new_t, with_noise=with_noise)
    np.testing.assert_allclose(np.diagonal(Ct.numpy()), vt.numpy(), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("level,with_noise", [(None, False), (None, True), ("Code", False)])
def test_draw_samples_with_reference_eps(additive, level, with_noise):
    """The reference's own standard-normal block through the port's
    ``eps=``: the same draws (rtol 1e-8: a second Cholesky, of a covariance
    whose small eigenvalues sit at the jitter)."""
    jspec, pj, cj, new_j, spec, pt, ct, new_t = additive
    key = jax.random.PRNGKey(11)
    m = new_j[0].shape[0]
    dj = jpo.draw_samples(jspec, pj, cj, *new_j, key, n_samples=5, with_noise=with_noise, level=level)
    eps = np.asarray(jax.random.normal(key, (5, m), dtype=jnp.float64))
    dt = tpo.draw_samples(spec, pt, ct, *new_t, n_samples=5, with_noise=with_noise, level=level,
                          eps=torch.tensor(eps))
    assert dt.shape == (5, m)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-8, atol=1e-8)


def test_draw_samples_with_generator_by_moments(additive):
    """With a ``torch.Generator`` the draws differ from the reference's but
    have its distribution: 40,000 draws reproduce predict_cov's mean and
    covariance within 5 standard errors, and a seed repeats."""
    jspec, pj, cj, new_j, spec, pt, ct, new_t = additive
    n = 40_000
    d = tpo.draw_samples(spec, pt, ct, *new_t, torch.Generator().manual_seed(5), n_samples=n)
    d2 = tpo.draw_samples(spec, pt, ct, *new_t, torch.Generator().manual_seed(5), n_samples=n)
    assert torch.equal(d, d2)
    mean, cov = tpo.predict_cov(spec, pt, ct, *new_t)
    sd = torch.sqrt(torch.diagonal(cov) + 1e-6)
    assert ((d.mean(0) - mean).abs() <= 5 * sd / np.sqrt(n)).all()
    emp = torch.cov(d.T)
    bound = 5 * np.sqrt(2.0 / n) * sd[:, None] * sd[None, :]
    assert ((emp - cov).abs() <= bound + 1e-6).all()


def test_posterior_cache_round_trip(additive):
    """A cache made in one package predicts and draws identically in the
    other, in both directions."""
    jspec, pj, cj, new_j, spec, pt, ct, new_t = additive
    eps = np.random.default_rng(2).normal(size=(3, new_j[0].shape[0]))
    # reference → port
    c_in = posterior_cache_from_numpy(cj, **F64)
    assert c_in.xk.dtype == torch.long and (c_in.mask is None) == (cj.mask is None)
    mt, vt = tpo.predict_diag(spec, pt, c_in, *new_t)
    mj, vj = jpo.predict_diag(jspec, pj, cj, *new_j)
    _close(mt, mj)
    _close(vt, vj)
    # port → reference
    d = posterior_cache_to_numpy(ct)
    c_out = jpo.PosteriorCache(**{k: None if v is None else jnp.asarray(v) for k, v in d.items()})
    mj2, Cj2 = jpo.predict_cov(jspec, pj, c_out, *new_j)
    mt2, Ct2 = tpo.predict_cov(spec, pt, ct, *new_t)
    _close(mt2, mj2)
    _close(Ct2, Cj2)
    # draws from the carried cache with one shared eps
    Lss = np.linalg.cholesky(np.asarray(Cj2) + 1e-6 * np.eye(len(eps[0])))
    dt = tpo.draw_samples(spec, pt, c_in, *new_t, eps=torch.tensor(eps))
    np.testing.assert_allclose(dt.numpy(), np.asarray(mj2)[None] + eps @ Lss.T, rtol=1e-8, atol=1e-8)


# ------------------------------------------------------------------
# The dense slice as a whole
# ------------------------------------------------------------------

N, COARSE_N, RESTARTS, COARSE_ITERS, POLISH_ITERS, GRID, DRAW_GRID = 512, 128, 4, 6, 4, 12, 8


@pytest.fixture(scope="module")
def port_run():
    return chip_smoke.run_dense_campaign("cpu", torch.float64, n=N, coarse_n=COARSE_N, n_restarts=RESTARTS,
                                         coarse_iters=COARSE_ITERS, polish_iters=POLISH_ITERS, grid=GRID,
                                         draw_grid=DRAW_GRID, n_draws=3)


@pytest.fixture(scope="module")
def ref_run(port_run):
    """The reference's ops chained the same way on the port's data and
    starts, each stage through ``lbfgs_host_minimize``."""
    r = port_run
    jspec = jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2, ard=True)
    xc, y = jnp.asarray(r["xc"].numpy()), jnp.asarray(r["y"].numpy())
    xk = jnp.zeros((N, 0), jnp.int32)
    la, lb = jnp.asarray(r["la"]), jnp.asarray(r["lb"])
    u0s = jp.initial_params(jspec, r["la"], r["lb"], n_restarts=RESTARTS, seed=0)
    sub = jnp.asarray(r["subi"])

    def coarse(u):
        return jm.map_neg_logp(jspec, u, xc[sub], xk[sub], y[sub], la, lb)

    vg, v = jax.jit(jax.value_and_grad(coarse)), jax.jit(coarse)
    runs = [jo.lbfgs_host_minimize(coarse, jax.tree_util.tree_map(lambda a: a[i], u0s), maxiter=COARSE_ITERS,
                                   vg_fun=vg, v_fun=v) for i in range(RESTARTS)]
    fs = np.asarray([float(f) for _, f, _ in runs])
    best = int(np.argmin(np.where(np.isfinite(fs), fs, np.inf)))
    u_best, f_best, _ = jo.lbfgs_host_minimize(lambda u: jm.map_neg_logp(jspec, u, xc, xk, y, la, lb),
                                               runs[best][0], maxiter=POLISH_ITERS)
    params = jp.constrain(u_best)
    cache = jpo.posterior_cache(jspec, params, xc, xk, y)
    xg = jnp.asarray(r["xg"].numpy())
    mean, var = jpo.predict_diag(jspec, params, cache, xg, jnp.zeros((GRID * GRID, 0), jnp.int32))
    return dict(jspec=jspec, best=best, fs=fs, f_best=float(f_best), mean=np.asarray(mean), var=np.asarray(var),
                xc=xc, xk=xk, y=y, xg=xg)


def test_dense_campaign_outputs(port_run):
    r = port_run
    assert r["mean"].shape == (GRID * GRID,) and r["var"].shape == (GRID * GRID,)
    assert r["mean"].dtype == torch.float64  # the CPU model dtype
    assert torch.isfinite(r["mean"]).all() and (r["var"] >= 0).all()
    assert r["draws"].shape == (3, DRAW_GRID**2) and torch.isfinite(r["draws"]).all()
    assert len(r["aux_c"]["all_values"]) == RESTARTS and len(r["subi"]) == COARSE_N
    assert r["evals"]["coarse"] >= RESTARTS and r["evals"]["polish"] > r["polish_iters"] > 0


def test_dense_campaign_matches_reference_chain(port_run, ref_run):
    """Same coarse winner and per-restart values, and the fitted objective
    within 1e-6 relative: the port's L-BFGS follows ``lbfgs_host_minimize``
    iterate for iterate on an objective that agrees to 1e-9."""
    r, j = port_run, ref_run
    assert r["aux_c"]["best_restart"] == j["best"]
    np.testing.assert_allclose(r["aux_c"]["all_values"], j["fs"], rtol=1e-6)
    np.testing.assert_allclose(r["f_best"], j["f_best"], rtol=1e-6)


def test_dense_campaign_grid_matches_reference(port_run, ref_run):
    r, j = port_run, ref_run
    np.testing.assert_allclose(r["mean"].numpy(), j["mean"], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(r["var"].numpy(), j["var"], rtol=1e-6, atol=1e-8)


def test_port_dense_fit_predicts_in_reference(port_run, ref_run):
    """The port's fitted parameters and cache, carried across as numpy, give
    the port's grid in the reference's ``predict_diag``: rtol 1e-8."""
    r, j = port_run, ref_run
    p = {k: jnp.asarray(v) for k, v in params_to_numpy(constrain(r["u_best"])).items()}
    d = posterior_cache_to_numpy(r["cache"])
    cache = jpo.PosteriorCache(**{k: None if v is None else jnp.asarray(v) for k, v in d.items()})
    mean, var = jpo.predict_diag(j["jspec"], p, cache, j["xg"], jnp.zeros((GRID * GRID, 0), jnp.int32))
    np.testing.assert_allclose(r["mean"].numpy(), np.asarray(mean), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(r["var"].numpy(), np.asarray(var), rtol=1e-8, atol=1e-12)


def test_dense_campaign_with_the_hand_factor_at_the_seam():
    """The same chain at f32 with ``hopper_chol.seam_cholesky`` at the seam (its
    plain version on the CPU) lands within 0.005 nats/point of the stock
    one, and the seam is restored afterwards."""
    import gumbi_tpu_torch.ops.linalg as tlinalg

    kw = dict(n=N, coarse_n=256, n_restarts=2, coarse_iters=4, polish_iters=3, grid=GRID, draw_grid=16, n_draws=2)
    orig = tlinalg.safe_cholesky
    stock = chip_smoke.run_dense_campaign("cpu", torch.float32, **kw)
    hand = chip_smoke.run_dense_campaign("cpu", torch.float32, chol=seam_cholesky, **kw)
    assert tlinalg.safe_cholesky is orig
    assert abs(stock["f_best"] - hand["f_best"]) <= chip_smoke.BASIN_TOL * N
    assert torch.isfinite(hand["draws"]).all() and (hand["var"] >= 0).all()
