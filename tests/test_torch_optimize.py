"""Port parity: gumbi_tpu_torch.ops.optimize vs gumbi_tpu.ops.optimize.

The port's L-BFGS is the reference's host-loop algorithm, so from the same
start it follows the reference's ``lbfgs_host_minimize`` iterate for
iterate. The fit entry points are held to the reference's fits by the best
objective, within 0.005 nats/point (the basin tolerance of
tests/test_bench_quality.py): the reference's vmapped fits use optax's
zoom line search, which takes different steps to the same optimum.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gumbi_tpu.ops.kernels as jk
import gumbi_tpu.ops.kronecker as jkr
import gumbi_tpu.ops.optimize as jo
import gumbi_tpu.ops.priors as jp
import gumbi_tpu_torch.ops.kronecker as tkr
import gumbi_tpu_torch.ops.optimize as to
from gumbi_tpu_torch.convert import spec_from_reference

torch.set_num_threads(2)

BASIN_TOL = 0.005  # nats per data point


def _kron_problem(n=48, seed=0):
    rng = np.random.default_rng(seed)
    out = jk.CoregTerm(name="Parameter", col=0, d_out=2)
    jspec = jk.GPSpec(
        terms=(jk.GPTerm(suffix="total", kernel="ExpQuad", coregs=(out,)),),
        d_cont=2,
        noise_coreg=jk.CoregTerm(name="Output_noise", col=0, d_out=2),
    )
    xc = rng.uniform(-2, 2, size=(n, 2))
    f1 = np.sin(1.3 * xc[:, 0]) * np.cos(0.9 * xc[:, 1])
    Y = np.stack([f1 + rng.normal(0, 0.1, n), 0.7 * f1 + rng.normal(0, 0.15, n)], axis=1)
    la, lb = jp.ls_prior_params([0.05, 0.05], [4.0, 4.0])
    return jspec, xc, Y, la, lb


def test_lbfgs_rosenbrock():
    """Same problem and bar as the reference's test_ops.py::test_lbfgs_rosenbrock."""

    def rosen(p):
        x = p["x"]
        return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2).sum()

    x, f, it = to.lbfgs_backtracking_minimize(
        rosen, {"x": torch.zeros(4, dtype=torch.float64)}, maxiter=200, ftol=1e-14
    )
    np.testing.assert_allclose(x["x"].numpy(), 1.0, atol=1e-5)
    assert float(f) < 1e-10 and 0 < it <= 200


def test_lbfgs_follows_reference_host_loop():
    """Same start, same algorithm: iteration count equal, optimum and value
    to 1e-7 relative (f64; only the objective's round-off differs)."""
    jspec, xc, Y, la, lb = _kron_problem()
    spec = spec_from_reference(jspec)
    u0 = {k: np.asarray(v[1]) for k, v in jp.initial_params(jspec, la, lb, 3, seed=0).items()}

    def obj_j(u):
        return jkr.kron_neg_logp(jspec, u, jnp.asarray(xc), jnp.asarray(Y), la, lb)

    xj, fj, itj = jo.lbfgs_host_minimize(obj_j, {k: jnp.asarray(v) for k, v in u0.items()},
                                        maxiter=25, ftol=1e-9)
    xc_t, Y_t = torch.tensor(xc), torch.tensor(Y)
    xt, ft, itt = to.lbfgs_backtracking_minimize(
        lambda u: tkr.kron_neg_logp(spec, u, xc_t, Y_t, la, lb),
        {k: torch.tensor(v) for k, v in u0.items()}, maxiter=25, ftol=1e-9,
    )
    assert itt == int(itj)
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-7)
    for k in u0:
        np.testing.assert_allclose(xt[k].numpy(), np.asarray(xj[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_nonfinite_start_returns_start():
    x0 = {"x": torch.tensor([1.0, 2.0], dtype=torch.float64)}
    x, f, it = to.lbfgs_backtracking_minimize(lambda p: (p["x"] * torch.inf).sum(), x0)
    assert it == 0 and np.isinf(float(f))
    np.testing.assert_array_equal(x["x"].numpy(), x0["x"].numpy())


def test_multi_restart_argmin_ignores_nan_restarts():
    """A restart whose objective is NaN everywhere never wins; ``aux``
    counts each restart's evaluations of the objective."""
    calls = [0]

    def f(p):
        calls[0] += 1
        x = p["x"]
        return torch.where(x[0] > 5.0, torch.nan, ((x - 1.0) ** 2).sum())

    x0s = {"x": torch.tensor([[9.0, 9.0], [0.0, 0.0], [3.0, -1.0]], dtype=torch.float64)}
    x, fbest, aux = to.multi_restart_minimize(f, x0s, maxiter=50)
    assert np.isnan(aux["all_values"][0]) or np.isinf(aux["all_values"][0])
    assert aux["best_restart"] in (1, 2)
    np.testing.assert_allclose(x["x"].numpy(), 1.0, atol=1e-5)
    assert float(fbest) < 1e-10
    assert int(aux["evals"].sum()) == calls[0] and aux["evals"][0] == 1
    assert (aux["evals"][1:] >= aux["iters"][1:] + 1).all()
    runner = lambda u0: to.lbfgs_backtracking_minimize(f, u0, maxiter=5)  # noqa: E731
    assert to.multi_restart_minimize(None, x0s, runner=runner)[2]["evals"] is None


def test_fit_kron_map_matches_reference():
    jspec, xc, Y, la, lb = _kron_problem()
    spec = spec_from_reference(jspec)
    u0s = jp.initial_params(jspec, la, lb, 3, seed=0)
    _, fj, _ = jo.fit_kron_map(jspec, jnp.asarray(xc), jnp.asarray(Y), jnp.asarray(la),
                               jnp.asarray(lb), u0s, maxiter=100)
    u0t = {k: torch.tensor(np.asarray(v)) for k, v in u0s.items()}
    ut, ft, aux = to.fit_kron_map(spec, xc, Y, la, lb, u0t, maxiter=100, device="cpu")
    assert ft.dtype == torch.float64 and all(v.dtype == torch.float64 for v in ut.values())
    assert len(aux["all_values"]) == 3
    n_points = Y.size
    assert abs(float(ft) - float(fj)) <= BASIN_TOL * n_points, (float(ft), float(fj))
    # the returned optimum is unconstrained and re-evaluates to f_best
    f_again = tkr.kron_neg_logp(spec, ut, torch.tensor(xc), torch.tensor(Y), la, lb)
    np.testing.assert_allclose(f_again.item(), float(ft), rtol=1e-12)


def test_fit_gp_map_matches_reference_with_mask_and_noise_mult():
    jspec, xc, _, la, lb = _kron_problem()
    spec = spec_from_reference(jspec)
    rng = np.random.default_rng(3)
    n = xc.shape[0]
    xk = rng.integers(0, 2, size=(n, 1)).astype(np.int32)
    y = np.sin(xc[:, 0]) + 0.2 * xk[:, 0] + rng.normal(0, 0.1, n)
    mask = np.ones(n)
    mask[-6:] = 0.0
    nm = rng.uniform(0.5, 2.0, n)
    u0s = jp.initial_params(jspec, la, lb, 3, seed=0)
    pj, fj, _ = jo.fit_gp_map(jspec, jnp.asarray(xc), jnp.asarray(xk), jnp.asarray(y), jnp.asarray(la),
                              jnp.asarray(lb), u0s, maxiter=100, mask=jnp.asarray(mask),
                              noise_mult=jnp.asarray(nm))
    u0t = {k: torch.tensor(np.asarray(v)) for k, v in u0s.items()}
    pt, ft, _ = to.fit_gp_map(spec, xc, xk, y, la, lb, u0t, maxiter=100, mask=mask, noise_mult=nm,
                              device="cpu")
    assert abs(float(ft) - float(fj)) <= BASIN_TOL * int(mask.sum()), (float(ft), float(fj))
    assert set(pt) == set(pj) and all(float(v.min()) > 0 for k, v in pt.items() if k.startswith("κ_"))


@pytest.mark.parametrize("in_dtype", [np.float32, np.float64])
def test_fit_casts_inputs_to_model_dtype(in_dtype):
    """Data, priors and starts of any float dtype are cast to the device's
    model dtype (f64 on CPU) before the objective sees them."""
    jspec, xc, Y, la, lb = _kron_problem(n=16)
    spec = spec_from_reference(jspec)
    u0s = {k: torch.tensor(np.asarray(v, in_dtype))
           for k, v in jp.initial_params(jspec, la, lb, 2, seed=0).items()}
    ut, ft, _ = to.fit_kron_map(spec, xc.astype(in_dtype), Y.astype(in_dtype), la.astype(in_dtype),
                                lb.astype(in_dtype), u0s, maxiter=5, device="cpu")
    assert all(v.dtype == torch.float64 and v.device.type == "cpu" for v in ut.values())
    assert np.isfinite(float(ft))


def test_entry_points_without_device_run_on_cuda_or_raise():
    """With numpy inputs and no ``device``, the fit entry points,
    ``initial_params`` and ``select_inducing`` go to the CUDA card; on a host
    without one they raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    jspec, xc, Y, la, lb = _kron_problem(n=8)
    spec = spec_from_reference(jspec)
    from gumbi_tpu_torch.ops.priors import initial_params

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        initial_params(spec, la, lb, n_restarts=2, seed=0)
    u0s = initial_params(spec, la, lb, n_restarts=2, seed=0, device="cpu")
    xk = np.zeros((xc.shape[0], 1), np.int32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        to.fit_gp_map(spec, xc, xk, Y[:, 0], la, lb, {k: v.numpy() for k, v in u0s.items()}, maxiter=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        to.fit_kron_map(spec, xc, Y, la, lb, u0s, maxiter=2)  # CPU starts do not pick the device

    from gumbi_tpu_torch.ops.fitc import select_inducing

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        select_inducing(xc, xk, 4, 2, seed=0, dtype=torch.float32)
    xu_c, xu_k = select_inducing(xc, xk, 4, 2, seed=0, dtype=torch.float64, device="cpu")
    assert xu_c.device.type == "cpu" and xu_k.shape == (4, 1)
    bspec = spec_from_reference(jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2,
                                          likelihood="bernoulli"))
    ub = {k: v.numpy() for k, v in initial_params(bspec, la, lb, n_restarts=1, seed=0, device="cpu").items()}
    labels = (Y[:, 0] > 0).astype(float)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        to.fit_laplace_map(bspec, xc, xk[:, :0], labels, la, lb, ub, maxiter=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        to.fit_fitc_laplace_map(bspec, xc, xk[:, :0], xu_c.numpy(), xu_k[:, :0].numpy(), labels, la, lb, ub,
                                maxiter=2)
