"""Port parity: likelihoods and posteriors of gumbi_tpu_torch vs gumbi_tpu.

Dense MLL / MAP objective (with bucket mask and per-row noise multipliers),
the Kronecker MLL / objective, and both posterior caches with their
diagonal predictions. All comparisons run at f64 on identical numpy inputs
with rtol 1e-9: the two sides compute the same formulas and differ only in
LAPACK/BLAS summation order.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gumbi_tpu.ops.kernels as jk
import gumbi_tpu.ops.kronecker as jkr
import gumbi_tpu.ops.posterior as jpo
import gumbi_tpu.ops.priors as jp
import gumbi_tpu_torch.ops.kronecker as tkr
import gumbi_tpu_torch.ops.posterior as tpo
from gumbi_tpu_torch.convert import params_from_numpy, spec_from_reference

# ``ops.mll`` the module is shadowed by ``ops.mll`` the function (in both
# packages), so the modules are taken from sys.modules.
jm = importlib.import_module("gumbi_tpu.ops.mll")
tm = importlib.import_module("gumbi_tpu_torch.ops.mll")

torch.set_num_threads(2)

RTOL = 1e-9
F64 = dict(dtype=torch.float64, device="cpu")


def _dense_problem(seed=0, n=30):
    rng = np.random.default_rng(seed)
    out = jk.CoregTerm(name="Parameter", col=0, d_out=2)
    jspec = jk.GPSpec(
        terms=(jk.GPTerm(suffix="total", kernel="ExpQuad", linear_idx=(1,), coregs=(out,)),),
        d_cont=2,
        noise_coreg=jk.CoregTerm(name="Output_noise", col=0, d_out=2),
    )
    xc = rng.uniform(-2, 2, size=(n, 2))
    xk = rng.integers(0, 2, size=(n, 1)).astype(np.int32)
    y = np.sin(xc[:, 0]) + 0.3 * xk[:, 0] + rng.normal(0, 0.1, n)
    la, lb = jp.ls_prior_params([0.1, 0.1], [4.0, 4.0])
    u = {k: np.asarray(v[1]) for k, v in jp.initial_params(jspec, la, lb, 3, seed=seed).items()}
    mask = np.ones(n)
    mask[-5:] = 0.0
    noise_mult = rng.uniform(0.5, 2.0, n)
    return jspec, xc, xk, y, la, lb, u, mask, noise_mult


def _kron_problem(seed=0, n=40):
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
    u = {k: np.asarray(v[2]) for k, v in jp.initial_params(jspec, la, lb, 3, seed=seed).items()}
    return jspec, xc, Y, la, lb, u


def _jax_vg(fn, u):
    v, g = jax.value_and_grad(fn)({k: jnp.asarray(x) for k, x in u.items()})
    return float(v), {k: np.asarray(x) for k, x in g.items()}


def _torch_vg(fn, u):
    ut = {k: torch.tensor(x, requires_grad=True) for k, x in u.items()}
    v = fn(ut)
    v.backward()
    return v.item(), {k: x.grad.numpy() for k, x in ut.items()}


def _assert_vg_close(a, b):
    np.testing.assert_allclose(a[0], b[0], rtol=RTOL)
    for k in b[1]:
        np.testing.assert_allclose(a[1][k], b[1][k], rtol=RTOL, atol=1e-10, err_msg=k)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "mask_noise_mult"])
def test_map_neg_logp_and_mll_value_and_grad(masked):
    jspec, xc, xk, y, la, lb, u, mask, nm = _dense_problem()
    spec = spec_from_reference(jspec)
    mask_j, nm_j = (jnp.asarray(mask), jnp.asarray(nm)) if masked else (None, None)
    mask_t, nm_t = (torch.tensor(mask), torch.tensor(nm)) if masked else (None, None)
    xc_t, xk_t, y_t = torch.tensor(xc), torch.tensor(xk), torch.tensor(y)

    ref = _jax_vg(lambda u: jm.map_neg_logp(jspec, u, jnp.asarray(xc), jnp.asarray(xk), jnp.asarray(y),
                                            la, lb, mask=mask_j, noise_mult=nm_j), u)
    port = _torch_vg(lambda u: tm.map_neg_logp(spec, u, xc_t, xk_t, y_t, la, lb,
                                               mask=mask_t, noise_mult=nm_t), u)
    _assert_vg_close(port, ref)

    p = {k: np.asarray(v) for k, v in jp.constrain({k: jnp.asarray(v) for k, v in u.items()}).items()}
    ref = _jax_vg(lambda p: jm.mll(jspec, p, jnp.asarray(xc), jnp.asarray(xk), jnp.asarray(y),
                                   mask=mask_j, noise_mult=nm_j), p)
    port = _torch_vg(lambda p: tm.mll(spec, p, xc_t, xk_t, y_t, mask=mask_t, noise_mult=nm_t), p)
    _assert_vg_close(port, ref)


def test_kron_mll_and_neg_logp_value_and_grad():
    jspec, xc, Y, la, lb, u = _kron_problem()
    spec = spec_from_reference(jspec)
    ref = _jax_vg(lambda u: jkr.kron_neg_logp(jspec, u, jnp.asarray(xc), jnp.asarray(Y), la, lb), u)
    port = _torch_vg(lambda u: tkr.kron_neg_logp(spec, u, torch.tensor(xc), torch.tensor(Y), la, lb), u)
    _assert_vg_close(port, ref)

    p = {k: np.exp(v) if k.startswith(("ls_", "η_", "κ_", "σ")) else v for k, v in u.items()}
    ref = _jax_vg(lambda p: jkr.kron_mll(jspec, p, jnp.asarray(xc), jnp.asarray(Y)), p)
    port = _torch_vg(lambda p: tkr.kron_mll(spec, p, torch.tensor(xc), torch.tensor(Y)), p)
    _assert_vg_close(port, ref)


def test_kron_matches_dense_tall_model():
    """The port's Kronecker MLL equals its own dense Hadamard MLL on the
    stacked data (the reference's test_kronecker identity), rtol 1e-9."""
    jspec, xc, Y, la, lb, u = _kron_problem(seed=4, n=25)
    spec = spec_from_reference(jspec)
    p = params_from_numpy({k: np.exp(v) if k.startswith(("ls_", "η_", "κ_", "σ")) else v
                           for k, v in u.items()}, **F64)
    n = xc.shape[0]
    xc_tall = torch.tensor(np.concatenate([xc, xc]))
    xk_tall = torch.tensor(np.repeat([0, 1], n)[:, None])
    dense = tm.mll(spec, p, xc_tall, xk_tall, torch.tensor(Y.T.ravel()))
    kron = tkr.kron_mll(spec, p, torch.tensor(xc), torch.tensor(Y))
    np.testing.assert_allclose(kron.item(), dense.item(), rtol=RTOL)


@pytest.mark.parametrize("with_noise", [True, False])
def test_kron_cache_and_predict_diag(with_noise):
    jspec, xc, Y, la, lb, u = _kron_problem(seed=1)
    spec = spec_from_reference(jspec)
    p = {k: np.exp(v) if k.startswith(("ls_", "η_", "κ_", "σ")) else v for k, v in u.items()}
    xn = np.random.default_rng(9).uniform(-2.5, 2.5, size=(33, 2))
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    cj = jkr.kron_cache(jspec, pj, jnp.asarray(xc), jnp.asarray(Y))
    mj, vj = jkr.kron_predict_diag(jspec, pj, cj, jnp.asarray(xn), with_noise=with_noise)
    pt = params_from_numpy(p, **F64)
    ct = tkr.kron_cache(spec, pt, torch.tensor(xc), torch.tensor(Y))
    mt, vt = tkr.kron_predict_diag(spec, pt, ct, torch.tensor(xn), with_noise=with_noise)
    for a, b in [(ct.L, cj.L), (ct.alpha, cj.alpha), (ct.C, cj.C), (ct.s2, cj.s2)]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "mask_noise_mult"])
def test_posterior_cache_and_predict_diag(masked):
    jspec, xc, xk, y, la, lb, u, mask, nm = _dense_problem(seed=2)
    spec = spec_from_reference(jspec)
    p = {k: np.asarray(v) for k, v in jp.constrain({k: jnp.asarray(v) for k, v in u.items()}).items()}
    rng = np.random.default_rng(5)
    xcn = rng.uniform(-2, 2, size=(21, 2))
    xkn = rng.integers(0, 2, size=(21, 1)).astype(np.int32)
    kw_j = dict(mask=jnp.asarray(mask), noise_mult=jnp.asarray(nm)) if masked else {}
    kw_t = dict(mask=torch.tensor(mask), noise_mult=torch.tensor(nm)) if masked else {}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    cj = jpo.posterior_cache(jspec, pj, jnp.asarray(xc), jnp.asarray(xk), jnp.asarray(y), **kw_j)
    mj, vj = jpo.predict_diag(jspec, pj, cj, jnp.asarray(xcn), jnp.asarray(xkn))
    pt = params_from_numpy(p, **F64)
    ct = tpo.posterior_cache(spec, pt, torch.tensor(xc), torch.tensor(xk), torch.tensor(y), **kw_t)
    mt, vt = tpo.predict_diag(spec, pt, ct, torch.tensor(xcn), torch.tensor(xkn))
    np.testing.assert_allclose(ct.alpha.numpy(), np.asarray(cj.alpha), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=RTOL, atol=1e-12)
    # chunked prediction (3 chunks, ragged last) gives the same arrays
    mc, vc = tpo.predict_diag_chunked(spec, pt, ct, torch.tensor(xcn), torch.tensor(xkn), chunk=8)
    np.testing.assert_allclose(mc.numpy(), mt.numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(vc.numpy(), vt.numpy(), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("M", [[[2.0, 0.3], [0.3, 1.0]], [[1.0, 0.0], [0.0, 3.0]], [[2.0, 0.0], [0.0, 1.0]],
                               [[1.5, 0.0], [0.0, 1.5]]], ids=["generic", "diag_asc", "diag_desc", "degenerate"])
def test_eigh_2x2_matches_reference(M):
    """Values and the gradient of a smooth function of (w, U), rtol 1e-9,
    including the axis-vector branch and exact degeneracy."""
    M = np.asarray(M)

    def f_j(M):
        w, U = jkr._eigh_2x2(M)
        return jnp.sum(w * jnp.asarray([1.0, 2.0])) + jnp.sum(U**2 * jnp.asarray([[0.3, 0.1], [0.2, 0.7]]))

    w_j, U_j = jkr._eigh_2x2(jnp.asarray(M))
    g_j = jax.grad(f_j)(jnp.asarray(M))
    Mt = torch.tensor(M, requires_grad=True)
    w_t, U_t = tkr._eigh_2x2(Mt)
    f_t = (w_t * torch.tensor([1.0, 2.0], dtype=torch.float64)).sum() + (
        U_t**2 * torch.tensor([[0.3, 0.1], [0.2, 0.7]], dtype=torch.float64)).sum()
    f_t.backward()
    np.testing.assert_allclose(w_t.detach().numpy(), np.asarray(w_j), rtol=RTOL)
    np.testing.assert_allclose(U_t.detach().numpy(), np.asarray(U_j), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(Mt.grad.numpy(), np.asarray(g_j), rtol=RTOL, atol=1e-12)


def test_f32_objectives_stay_f32():
    """f32 data with the f64 numpy prior parameters must not promote the
    objective to f64 (on the card that would bypass the f32 kernel)."""
    jspec, xc, Y, la, lb, u = _kron_problem()
    spec = spec_from_reference(jspec)
    u32 = {k: torch.tensor(v, dtype=torch.float32, requires_grad=True) for k, v in u.items()}
    f = tkr.kron_neg_logp(spec, u32, torch.tensor(xc, dtype=torch.float32),
                          torch.tensor(Y, dtype=torch.float32), la, lb)
    assert f.dtype == torch.float32
    f.backward()
    assert all(v.grad.dtype == torch.float32 for v in u32.values())

    jspec, xc, xk, y, la, lb, u, mask, nm = _dense_problem()
    u32 = {k: torch.tensor(v, dtype=torch.float32) for k, v in u.items()}
    f = tm.map_neg_logp(spec_from_reference(jspec), u32, torch.tensor(xc, dtype=torch.float32),
                        torch.tensor(xk), torch.tensor(y, dtype=torch.float32), la, lb,
                        mask=torch.tensor(mask, dtype=torch.float32))
    assert f.dtype == torch.float32


def test_non_pd_objective_is_inf():
    """A numerically non-PD Gram surfaces as +inf (line searches back off), not an exception."""
    jspec, xc, Y, la, lb, u = _kron_problem()
    u = dict(u, σ=np.asarray(-60.0), κ_Output_noise=np.full(2, -60.0), W_Output_noise=np.zeros((2, 2)))
    u["ls_total"] = np.full(2, 8.0)  # huge lengthscale → rank-deficient Kx
    f = tkr.kron_neg_logp(spec_from_reference(jspec), {k: torch.tensor(v) for k, v in u.items()},
                          torch.tensor(xc), torch.tensor(Y), la, lb, jitter=0.0)
    fj = jkr.kron_neg_logp(jspec, {k: jnp.asarray(v) for k, v in u.items()}, jnp.asarray(xc),
                           jnp.asarray(Y), la, lb, jitter=0.0)
    assert np.isinf(f.item()) and np.isinf(float(fj))
