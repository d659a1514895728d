"""Port parity: gumbi_tpu_torch.ops.laplace and ops.fitc_laplace vs the
reference's, and both classifiers' fit drivers.

The same inputs, from numpy seeds, go through the JAX function and its port
counterpart at f64: the dense Newton mode, the Laplace evidence with the
autograd ``Function``'s gradient against the reference's ``custom_vjp``,
the sparse evidence differentiated through its Newton loop, predictions and
latent draws given the reference's own standard-normal block, each with and
without a bucket-padding mask; then the named divergences at f32 and with a
mask, and ``fit_laplace_map``/``fit_fitc_laplace_map`` against the
reference's. Comparisons are at rtol 1e-9 unless a test says why not.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gumbi_tpu.ops.fitc as jf
import gumbi_tpu.ops.fitc_laplace as jfl
import gumbi_tpu.ops.kernels as jk
import gumbi_tpu.ops.laplace as jl
import gumbi_tpu.ops.optimize as jo
import gumbi_tpu.ops.priors as jp
import gumbi_tpu_torch.ops.fitc_laplace as tfl
import gumbi_tpu_torch.ops.laplace as tl
import gumbi_tpu_torch.ops.optimize as to
from gumbi_tpu_torch.convert import params_from_numpy, spec_from_reference

torch.set_num_threads(2)

RTOL = 1e-9
BASIN_TOL = 0.005  # nats per data point, tests/test_bench_quality.py's tolerance
N, M, N_NEW, N_PAD = 160, 24, 30, 12
F64 = dict(dtype=torch.float64, device="cpu")


def _problem(n=N, seed=0):
    """Labels from a smooth latent surface over 2 dims; the last N_PAD rows
    are bucket padding (junk coordinates and labels, mask 0)."""
    rng = np.random.default_rng(seed)
    jspec = jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2, likelihood="bernoulli")
    xc = rng.uniform(-2, 2, size=(n, 2))
    f = 2.0 * np.sin(1.3 * xc[:, 0]) * np.cos(0.9 * xc[:, 1])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-f))).astype(float)
    mask = np.ones(n)
    mask[-N_PAD:] = 0.0
    la, lb = jp.ls_prior_params([0.1, 0.1], [4.0, 4.0])
    u = {k: np.asarray(v[1]) for k, v in jp.initial_params(jspec, la, lb, 2, seed=seed).items()}
    xu = jf.kmeans_inducing(xc[: n - N_PAD], M, seed=0)
    new_c = rng.uniform(-2, 2, size=(N_NEW, 2))
    return dict(jspec=jspec, spec=spec_from_reference(jspec), xc=xc, y=y, mask=mask, la=la, lb=lb, u=u, xu=xu,
                new_c=new_c, params=jp.constrain(u))


@pytest.fixture(scope="module")
def prob():
    return _problem()


def _close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _zk(n, torch_side):
    return torch.zeros((n, 0), dtype=torch.long) if torch_side else jnp.zeros((n, 0), jnp.int32)


def _K(pr):
    """The jittered Gram the objectives build, as numpy."""
    p = {k: jnp.asarray(v) for k, v in pr["params"].items()}
    xc = jnp.asarray(pr["xc"])
    return np.asarray(jk.gram(pr["jspec"], p, xc, _zk(len(xc), False), xc, _zk(len(xc), False))) + 1e-6 * np.eye(
        len(xc))


def _mask(pr, masked, torch_side):
    if not masked:
        return None
    return torch.tensor(pr["mask"]) if torch_side else jnp.asarray(pr["mask"])


# ------------------------------------------------------------------
# Dense Laplace
# ------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_laplace_mode(prob, masked):
    K, y = _K(prob), prob["y"]
    fj, aj, Lj, sj = jl.laplace_mode(jnp.asarray(K), jnp.asarray(y), 30, mask=_mask(prob, masked, False))
    ft, at, Lt, st = tl.laplace_mode(torch.tensor(K), torch.tensor(y), 30, mask=_mask(prob, masked, True))
    for t, j in ((ft, fj), (at, aj), (Lt, Lj), (st, sj)):
        _close(t, j, atol=1e-12)


@pytest.mark.parametrize("masked", [False, True])
def test_laplace_mll_function_matches_the_reference_custom_vjp(prob, masked):
    """Value, and the gradient wrt K entry by entry: the port's backward is
    the reference's ``_laplace_mll_bwd`` formula for formula."""
    K, y = _K(prob), prob["y"]
    mj, mt = _mask(prob, masked, False), _mask(prob, masked, True)
    vj, gj = jax.value_and_grad(lambda K: jl.laplace_mll(K, jnp.asarray(y), mask=mj))(jnp.asarray(K))
    Kt = torch.tensor(K, requires_grad=True)
    vt = tl.laplace_mll(Kt, torch.tensor(y), mask=mt)
    (gt,) = torch.autograd.grad(vt, Kt)
    _close(vt, vj)
    _close(gt, gj, atol=1e-12 * float(np.abs(np.asarray(gj)).max()))


def test_laplace_function_matches_autograd_through_the_newton_loop(prob):
    """The Function's gradient against the port's own autograd through 40
    Newton steps (tests/test_laplace_vjp.py's oracle for the reference):
    symmetric parts (K enters symmetrically) at rtol 1e-6, atol 1e-9, the
    reference test's bar (the loop's mode is converged to ~1e-7, and the
    analytic formula holds at the exact mode)."""
    K, y = torch.tensor(_K(prob)), torch.tensor(prob["y"])
    m = torch.ones_like(y)
    K1 = K.clone().requires_grad_(True)
    (g_fn,) = torch.autograd.grad(tl.laplace_mll(K1, y, n_iter=40), K1)
    K2 = K.clone().requires_grad_(True)
    f, a, L, _ = tl.laplace_mode(K2, y, 40, mask=m)
    (g_loop,) = torch.autograd.grad(tl._laplace_Z(f, a, L, y, m), K2)
    sym = lambda G: 0.5 * (G + G.T)  # noqa: E731
    np.testing.assert_allclose(sym(g_fn).numpy(), sym(g_loop).numpy(), rtol=1e-6, atol=1e-9)


def test_laplace_function_does_not_record_the_newton_loop(prob):
    """Autograd keeps the Function's seven tensors and no node of the loop:
    the value's grad_fn is the Function, fed straight by K's leaf. Through
    the loop, autograd saves hundreds of tensors."""
    K, y = torch.tensor(_K(prob)), torch.tensor(prob["y"])
    saved = []
    Kt = K.clone().requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        v = tl.laplace_mll(Kt, y)
    assert type(v.grad_fn).__name__ == "_LaplaceMllBackward"
    assert [type(fn).__name__ for fn, _ in v.grad_fn.next_functions if fn is not None] == ["AccumulateGrad"]
    assert len(saved) == 7
    through = []
    K2 = K.clone().requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(lambda t: through.append(t) or t, lambda t: t):
        tl.laplace_mode(K2, y, 30)
    assert len(through) > 200


@pytest.mark.parametrize("masked", [False, True])
def test_laplace_neg_logp_value_and_grad(prob, masked):
    xc, y = prob["xc"], prob["y"]
    mj, mt = _mask(prob, masked, False), _mask(prob, masked, True)
    la, lb = jnp.asarray(prob["la"]), jnp.asarray(prob["lb"])
    vj, gj = jax.value_and_grad(lambda u: jl.laplace_neg_logp(prob["jspec"], u, jnp.asarray(xc), _zk(N, False),
                                                              jnp.asarray(y), la, lb, mask=mj))(
        {k: jnp.asarray(v) for k, v in prob["u"].items()})
    ut = {k: v.requires_grad_(True) for k, v in params_from_numpy(prob["u"], **F64).items()}
    vt = tl.laplace_neg_logp(prob["spec"], ut, torch.tensor(xc), _zk(N, True), torch.tensor(y),
                             torch.tensor(prob["la"]), torch.tensor(prob["lb"]), mask=mt)
    gt = torch.autograd.grad(vt, list(ut.values()))
    _close(vt, vj)
    for k, g in zip(ut, gt):
        _close(g, gj[k])


@pytest.mark.parametrize("masked", [False, True])
def test_laplace_predict(prob, masked):
    pj = {k: jnp.asarray(v) for k, v in prob["params"].items()}
    pt = params_from_numpy(prob["params"], **F64)
    outj = jl.laplace_predict(prob["jspec"], pj, jnp.asarray(prob["xc"]), _zk(N, False), jnp.asarray(prob["y"]),
                              jnp.asarray(prob["new_c"]), _zk(N_NEW, False), mask=_mask(prob, masked, False))
    outt = tl.laplace_predict(prob["spec"], pt, torch.tensor(prob["xc"]), _zk(N, True), torch.tensor(prob["y"]),
                              torch.tensor(prob["new_c"]), _zk(N_NEW, True), mask=_mask(prob, masked, True))
    for t, j in zip(outt, outj):
        _close(t, j, atol=1e-12)


@pytest.mark.parametrize("masked", [False, True])
def test_laplace_draw_latent_with_reference_eps(prob, masked):
    """Given the reference's own standard-normal block: rtol 1e-8, as
    tests/test_torch_dense.py's draws (a near-singular covariance's factor
    amplifies the packages' different summation orders)."""
    pj = {k: jnp.asarray(v) for k, v in prob["params"].items()}
    pt = params_from_numpy(prob["params"], **F64)
    key = jax.random.PRNGKey(2)
    dj = jl.laplace_draw_latent(prob["jspec"], pj, jnp.asarray(prob["xc"]), _zk(N, False), jnp.asarray(prob["y"]),
                                jnp.asarray(prob["new_c"]), _zk(N_NEW, False), key, n_samples=3,
                                mask=_mask(prob, masked, False))
    eps = np.asarray(jax.random.normal(key, (3, N_NEW), dtype=jnp.float64))
    dt = tl.laplace_draw_latent(prob["spec"], pt, torch.tensor(prob["xc"]), _zk(N, True), torch.tensor(prob["y"]),
                                torch.tensor(prob["new_c"]), _zk(N_NEW, True), n_samples=3,
                                mask=_mask(prob, masked, True), eps=torch.tensor(eps))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-8, atol=1e-8)
    dg = tl.laplace_draw_latent(prob["spec"], pt, torch.tensor(prob["xc"]), _zk(N, True), torch.tensor(prob["y"]),
                                torch.tensor(prob["new_c"]), _zk(N_NEW, True), torch.Generator().manual_seed(0),
                                n_samples=5)
    assert dg.shape == (5, N_NEW) and bool(torch.isfinite(dg).all())


# ------------------------------------------------------------------
# Sparse (FITC) Laplace
# ------------------------------------------------------------------


def _sparse_args(pr, torch_side, n=N):
    if torch_side:
        return (torch.tensor(pr["xc"][:n]), _zk(n, True), torch.tensor(pr["xu"]), _zk(M, True),
                torch.tensor(pr["y"][:n]))
    return (jnp.asarray(pr["xc"][:n]), _zk(n, False), jnp.asarray(pr["xu"]), _zk(M, False), jnp.asarray(pr["y"][:n]))


def test_fitc_laplace_mll_value_and_grad(prob):
    """Both differentiate through the 30-step loop; the port's step is the
    reference's iterate in another form, so at f64 they agree to rtol 1e-9."""
    vj, gj = jax.value_and_grad(lambda p: jfl.fitc_laplace_mll(prob["jspec"], p, *_sparse_args(prob, False)))(
        {k: jnp.asarray(v) for k, v in prob["params"].items()})
    pt = {k: v.requires_grad_(True) for k, v in params_from_numpy(prob["params"], **F64).items()}
    vt = tfl.fitc_laplace_mll(prob["spec"], pt, *_sparse_args(prob, True))
    gt = torch.autograd.grad(vt, list(pt.values()))
    _close(vt, vj)
    for k, g in zip(pt, gt):
        _close(g, gj[k])


def test_fitc_laplace_masked_evidence_and_its_gradient(prob):
    """Named divergence (ROADMAP queue 3): with a mask the reference's value
    is right but its gradient is NaN (√W at W = 0 in its Woodbury pieces);
    the port's value equals the reference's and its gradient is the
    reference's gradient on the unpadded rows, which the masked evidence
    equals exactly."""
    pj = {k: jnp.asarray(v) for k, v in prob["params"].items()}
    fj = lambda p: jfl.fitc_laplace_mll(prob["jspec"], p, *_sparse_args(prob, False),  # noqa: E731
                                        mask=_mask(prob, True, False))
    vj, gj = jax.value_and_grad(fj)(pj)
    _, gj_unpadded = jax.value_and_grad(
        lambda p: jfl.fitc_laplace_mll(prob["jspec"], p, *_sparse_args(prob, False, n=N - N_PAD)))(pj)
    pt = {k: v.requires_grad_(True) for k, v in params_from_numpy(prob["params"], **F64).items()}
    vt = tfl.fitc_laplace_mll(prob["spec"], pt, *_sparse_args(prob, True), mask=_mask(prob, True, True))
    gt = torch.autograd.grad(vt, list(pt.values()))
    _close(vt, vj)
    assert all(np.isnan(np.asarray(g)).all() for g in gj.values())
    for k, g in zip(pt, gt):
        _close(g, gj_unpadded[k])


@pytest.mark.parametrize("masked", [False, True])
def test_fitc_laplace_predict(prob, masked):
    pj = {k: jnp.asarray(v) for k, v in prob["params"].items()}
    pt = params_from_numpy(prob["params"], **F64)
    outj = jfl.fitc_laplace_predict(prob["jspec"], pj, *_sparse_args(prob, False), jnp.asarray(prob["new_c"]),
                                    _zk(N_NEW, False), mask=_mask(prob, masked, False))
    outt = tfl.fitc_laplace_predict(prob["spec"], pt, *_sparse_args(prob, True), torch.tensor(prob["new_c"]),
                                    _zk(N_NEW, True), mask=_mask(prob, masked, True))
    for t, j in zip(outt, outj):
        _close(t, j, atol=1e-12)


@pytest.mark.parametrize("masked", [False, True])
def test_fitc_laplace_draw_latent_with_reference_eps(prob, masked):
    pj = {k: jnp.asarray(v) for k, v in prob["params"].items()}
    pt = params_from_numpy(prob["params"], **F64)
    key = jax.random.PRNGKey(3)
    dj = jfl.fitc_laplace_draw_latent(prob["jspec"], pj, *_sparse_args(prob, False), jnp.asarray(prob["new_c"]),
                                      _zk(N_NEW, False), key, n_samples=3, mask=_mask(prob, masked, False))
    eps = np.asarray(jax.random.normal(key, (3, N_NEW), dtype=jnp.float64))
    dt = tfl.fitc_laplace_draw_latent(prob["spec"], pt, *_sparse_args(prob, True), torch.tensor(prob["new_c"]),
                                      _zk(N_NEW, True), n_samples=3, mask=_mask(prob, masked, True),
                                      eps=torch.tensor(eps))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-8, atol=1e-8)


# ------------------------------------------------------------------
# Named divergences at f32 (ROADMAP queue 3)
# ------------------------------------------------------------------


def _f32_problem(n=400, m=48):
    rng = np.random.default_rng(0)
    xc = rng.uniform(-2, 2, (n, 2))
    f = np.sin(1.3 * xc[:, 0]) * np.cos(0.9 * xc[:, 1])
    y = (f + rng.normal(0, 0.1, n) > 0).astype(float)
    return xc, y, jf.kmeans_inducing(xc, m, seed=0)


def _sparse_values(ls, eta, n=400, m=48):
    """(reference at f32, port at f32, port at f64) FITC-Laplace evidence."""
    xc, y, xu = _f32_problem(n, m)
    jspec = jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2, likelihood="bernoulli")
    spec = spec_from_reference(jspec)
    p = {"ls_total": np.array([ls, ls]), "η_total": np.array(eta)}
    f32 = jnp.float32
    ref = float(jfl.fitc_laplace_mll(jspec, {k: jnp.asarray(v, f32) for k, v in p.items()}, jnp.asarray(xc, f32),
                                     _zk(n, False), jnp.asarray(xu, f32), _zk(m, False), jnp.asarray(y, f32)))
    port = []
    for dt in (torch.float32, torch.float64):
        t = lambda a: torch.as_tensor(a, dtype=dt)  # noqa: E731
        port.append(float(tfl.fitc_laplace_mll(spec, {k: t(v) for k, v in p.items()}, t(xc), _zk(n, True), t(xu),
                                                _zk(m, True), t(y))))
    return ref, port[0], port[1]


def test_fitc_laplace_newton_step_holds_at_f32_where_the_reference_diverges():
    """At ls 2.5, η 10 (‖K‖ ~ 1e4) the reference's f32 step cancels terms of
    size ‖K‖ and its evidence is off by more than 1e5 nats; the port's step
    (the same iterate, no K·b formed) stays within 1e-3 nats/point of f64."""
    ref, port32, port64 = _sparse_values(2.5, 10.0)
    assert abs(ref - port64) > 1e5
    assert abs(port32 - port64) <= 1e-3 * 400


def test_fitc_laplace_inducing_floor_clears_f32_rounding():
    """At ls 2.5, η 30 with 48 k-means centers the reference's absolute
    1e-4 floor lies under Kuu's f32 rounding and its factor is NaN; the
    port's floor, m·eps·mean diag Kuu there, factors, and the f32 evidence
    is finite and within 0.005 nats/point of f64. At f64 the floor is the
    reference's 100·jitter."""
    ref, port32, port64 = _sparse_values(2.5, 30.0)
    assert np.isnan(ref) and np.isfinite(port32)
    assert abs(port32 - port64) <= BASIN_TOL * 400
    xc, _, xu = _f32_problem()
    spec = spec_from_reference(jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2,
                                         likelihood="bernoulli"))
    p = {"ls_total": torch.tensor([2.5, 2.5], dtype=torch.float64), "η_total": torch.tensor(30.0, dtype=torch.float64)}
    _, _, Luu = tfl._whitened_features(spec, p, torch.tensor(xc), _zk(400, True), torch.tensor(xu), _zk(48, True), 1e-6)
    Kuu = tfl.gram(spec, p, torch.tensor(xu), _zk(48, True), torch.tensor(xu), _zk(48, True))
    np.testing.assert_allclose(torch.diagonal(Luu @ Luu.T - Kuu).numpy(), 1e-4, rtol=1e-6)


def test_objectives_turn_a_failed_factor_into_inf(prob):
    """A failed factor gives NaN, never an exception (``torch.linalg.cholesky``
    raises where ``jnp.linalg.cholesky`` returns NaN), and the objectives
    +inf, so the line search backs off: a negative jitter makes the dense
    B = I + SKS indefinite, and a NaN inducing coordinate fails Kuu's factor."""
    ut = params_from_numpy(prob["u"], **F64)
    la, lb = torch.tensor(prob["la"]), torch.tensor(prob["lb"])
    xc, y = torch.tensor(prob["xc"]), torch.tensor(prob["y"])
    dense = tl.laplace_neg_logp(prob["spec"], ut, xc, _zk(N, True), y, la, lb, jitter=-10.0)
    xu = torch.tensor(prob["xu"])
    xu[3, 0] = torch.nan
    sparse = tfl.fitc_laplace_neg_logp(prob["spec"], ut, xc, _zk(N, True), xu, _zk(M, True), y, la, lb)
    assert float(dense) == np.inf and float(sparse) == np.inf


# ------------------------------------------------------------------
# Fit drivers
# ------------------------------------------------------------------


def test_fit_laplace_map_matches_reference_with_mask(prob):
    """From the same 2 starts (maxiter 40) both land in one basin: best
    objectives within 0.005 nats per real row. The returned optimum is
    unconstrained, as the reference's, and re-evaluates to f_best."""
    n_real = int(prob["mask"].sum())
    u0s = jp.initial_params(prob["jspec"], prob["la"], prob["lb"], 2, seed=0)
    _, fj, _ = jo.fit_laplace_map(prob["jspec"], jnp.asarray(prob["xc"]), _zk(N, False), jnp.asarray(prob["y"]),
                                  jnp.asarray(prob["la"]), jnp.asarray(prob["lb"]), u0s, maxiter=40,
                                  mask=jnp.asarray(prob["mask"]))
    ut, ft, aux = to.fit_laplace_map(prob["spec"], prob["xc"], np.zeros((N, 0), np.int32), prob["y"], prob["la"],
                                     prob["lb"], {k: np.asarray(v) for k, v in u0s.items()}, maxiter=40,
                                     mask=prob["mask"], device="cpu")
    assert abs(float(ft) - float(fj)) <= BASIN_TOL * n_real, (float(ft), float(fj))
    assert set(ut) == {"ls_total", "η_total"} and len(aux["all_values"]) == 2
    again = tl.laplace_neg_logp(prob["spec"], ut, torch.tensor(prob["xc"]), _zk(N, True), torch.tensor(prob["y"]),
                                torch.tensor(prob["la"]), torch.tensor(prob["lb"]), mask=torch.tensor(prob["mask"]))
    np.testing.assert_allclose(float(again), float(ft), rtol=1e-12)


def test_fit_fitc_laplace_map_matches_reference(prob):
    """From the same 2 starts (maxiter 40), unmasked (the reference's masked
    gradient is NaN): best objectives within 0.005 nats per row."""
    n = N - N_PAD
    u0s = jp.initial_params(prob["jspec"], prob["la"], prob["lb"], 2, seed=0)
    xc, xk, xu, xuk, y = _sparse_args(prob, False, n=n)
    _, fj, _ = jo.fit_fitc_laplace_map(prob["jspec"], xc, xk, xu, xuk, y, jnp.asarray(prob["la"]),
                                       jnp.asarray(prob["lb"]), u0s, maxiter=40)
    ut, ft, _ = to.fit_fitc_laplace_map(prob["spec"], prob["xc"][:n], np.zeros((n, 0), np.int32), prob["xu"],
                                        np.zeros((M, 0), np.int32), prob["y"][:n], prob["la"], prob["lb"],
                                        {k: np.asarray(v) for k, v in u0s.items()}, maxiter=40, device="cpu")
    assert abs(float(ft) - float(fj)) <= BASIN_TOL * n, (float(ft), float(fj))
    assert all(v.dtype == torch.float64 for v in ut.values())
