"""Port parity: gumbi_tpu_torch.ops.iterative vs gumbi_tpu.ops.iterative.

Every module of the large-N engine runs on the same seeded numpy inputs in
both packages at f64 on the CPU. There the reference takes its XLA path
(its fused Pallas matvec is TPU-only) and the port its plain path, so the
two compute the same arithmetic up to BLAS round-off. Tolerances: values
rtol 1e-8 and gradients rtol 1e-6 unless a test says why not.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gumbi_tpu.ops.iterative as ji
import gumbi_tpu.ops.kernels as jk
import gumbi_tpu.ops.optimize as jo
import gumbi_tpu_torch.ops.iterative as ti
from gumbi_tpu_torch.convert import (
    iter_cache_from_numpy,
    iter_cache_to_numpy,
    iter_config_from_reference,
    spec_from_reference,
)
from gumbi_tpu_torch.ops import FusedMatvec, FusedMatvecSym, RbfGram

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _problem(n=60, d=2, seed=0, kernel="ExpQuad"):
    """The reference test file's problem: numpy draws, both packages' views."""
    rng = np.random.default_rng(seed)
    jspec = jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel=kernel),), d_cont=d)
    xc = rng.uniform(-2, 2, size=(n, d))
    y = np.sin(1.3 * xc[:, 0]) + 0.1 * rng.normal(size=n)
    params = {"ls_total": np.array([0.9, 1.2])[:d], "η_total": np.array(1.1), "σ": np.array(0.3)}
    return jspec, spec_from_reference(jspec), xc, np.zeros((n, 0), np.int32), y, params


def _j(a):
    return {k: jnp.asarray(v) for k, v in a.items()} if isinstance(a, dict) else jnp.asarray(a)


def _t(a):
    return {k: torch.as_tensor(np.array(v)) for k, v in a.items()} if isinstance(a, dict) else torch.as_tensor(np.array(a))


def _close(port, ref, rtol=1e-8, atol=0.0, msg=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


def _dense_A(jspec, params, xc, xk):
    K = np.array(jk.gram(jspec, _j(params), _j(xc), _j(xk), _j(xc), _j(xk)))
    d = np.array(jk.noise_diag(jspec, _j(params), _j(xk), dtype=jnp.float64)) + ji.DEFAULT_JITTER
    return K, d


@pytest.mark.parametrize("rank", [0, 6])
def test_draw_probes_bit_equal(rank):
    cfg = ji.IterConfig(n_probes=5, precond_rank=rank)
    pn_j, pk_j = ji.draw_probes(11, 40, cfg, dtype=jnp.float64)
    pn_t, pk_t = ti.draw_probes(11, 40, iter_config_from_reference(cfg), dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(pn_t.numpy(), np.asarray(pn_j))
    np.testing.assert_array_equal(pk_t.numpy(), np.asarray(pk_j))
    assert pn_t.shape == (40, 5) and pk_t.shape == (rank, 5)


def test_iter_config_round_trip():
    cfg = ji.IterConfig(maxiter=77, tol=3e-3, n_probes=9, precond_rank=5, block=20, quad_steps=11,
                        love_rank=128, sym_matvec=False)
    assert iter_config_from_reference(cfg) == ti.IterConfig(77, 3e-3, 9, 5, 20, 11, ji.DEFAULT_JITTER, 128, False)
    assert ti.IterConfig() == iter_config_from_reference(ji.IterConfig())


def test_pivoted_cholesky_matches():
    """L and the residual diagonal, rtol 1e-10 (same greedy pivots, f64)."""
    jspec, _, xc, xk, _, params = _problem()
    K, _ = _dense_A(jspec, params, xc, xk)
    Lj, rj = ji.pivoted_cholesky(lambda i: jnp.asarray(K)[i], jnp.asarray(np.diag(K).copy()), 12, return_resid=True)
    Kt = torch.as_tensor(K)
    Lt, rt = ti.pivoted_cholesky(lambda i: Kt.index_select(0, i)[0], Kt.diagonal().clone(), 12, return_resid=True)
    _close(Lt, Lj, rtol=1e-10, atol=1e-13)
    _close(rt, rj, rtol=1e-10, atol=1e-13)


def test_pivoted_cholesky_relative_guard_stops_at_numerical_rank():
    """Past the working-precision floor the columns are zero in both."""
    jspec, _, xc, xk, _, params = _problem(n=60)
    K, _ = _dense_A(jspec, {**params, "ls_total": np.array([5.0, 5.0])}, xc, xk)
    Lj = ji.pivoted_cholesky(lambda i: jnp.asarray(K)[i], jnp.asarray(np.diag(K).copy()), 60)
    Kt = torch.as_tensor(K)
    Lt = ti.pivoted_cholesky(lambda i: Kt.index_select(0, i)[0], Kt.diagonal().clone(), 60)
    zero_j = np.all(np.asarray(Lj) == 0, axis=0)
    assert zero_j.any()
    np.testing.assert_array_equal(np.all(Lt.numpy() == 0, axis=0), zero_j)
    # atol 1e-8: the last live columns divide cancellation noise by pivots
    # near the 100·eps floor (~1e-7), in both packages
    _close(Lt, Lj, rtol=0, atol=1e-8)


def test_make_precond_matches():
    """Woodbury solve and log|P|, rtol 1e-10."""
    jspec, _, xc, xk, _, params = _problem()
    K, d = _dense_A(jspec, params, xc, xk)
    L = np.array(ji.pivoted_cholesky(lambda i: jnp.asarray(K)[i], jnp.asarray(np.diag(K).copy()), 12))
    V = np.random.default_rng(1).normal(size=(60, 4))
    ps_j, ld_j = ji._make_precond(jnp.asarray(L), jnp.asarray(d))
    ps_t, ld_t = ti._make_precond(torch.as_tensor(L), torch.as_tensor(d))
    _close(ps_t(torch.as_tensor(V)), ps_j(jnp.asarray(V)), rtol=1e-10)
    _close(ld_t, ld_j, rtol=1e-12)
    # and it is the exact inverse of L Lᵀ + D
    np.testing.assert_allclose(ps_t(torch.as_tensor(V)).numpy(), np.linalg.solve(L @ L.T + np.diag(d), V), rtol=1e-9)


def _pcg_inputs():
    jspec, _, xc, xk, _, params = _problem()
    K, d = _dense_A(jspec, params, xc, xk)
    A = K + np.diag(d)
    L = np.array(ji.pivoted_cholesky(lambda i: jnp.asarray(K)[i], jnp.asarray(np.diag(K).copy()), 6))
    B = np.random.default_rng(2).normal(size=(60, 5))
    return A, L, d, B


def test_pcg_matches():
    """Equal iteration counts and validity masks; X rtol 1e-6 (the Krylov
    iterates carry BLAS round-off amplified by A's condition number, ~1e3
    here); the CG scalars rtol 1e-8 over the first 10 iterations. Past the
    point where finite-precision CG loses orthogonality, the scalar
    sequences of two BLAS libraries part chaotically (measured: 1e-9 apart
    at step 13, O(1) by step 16) while X still agrees; so beyond step 10 the
    test holds what the scalars feed, the SLQ log-determinant, to rtol 1e-6.
    The final relative residuals both meet tol = 1e-6 and agree to 1% of it:
    a residual at 1e-6 of ‖b‖ is made of the round-off of the whole run
    (measured 0.4% apart)."""
    A, L, d, B = _pcg_inputs()
    ps_j, _ = ji._make_precond(jnp.asarray(L), jnp.asarray(d))
    ps_t, _ = ti._make_precond(torch.as_tensor(L), torch.as_tensor(d))
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    Xj, alj, bej, vaj, itj, rrj = ji.pcg(lambda V: Aj @ V, ps_j, jnp.asarray(B), 100, 1e-6, track=20)
    Xt, alt, bet, vat, itt, rrt = ti.pcg(lambda V: At @ V, ps_t, torch.as_tensor(B), 100, 1e-6, track=20)
    assert itt == int(itj) and 0 < itt < 100
    np.testing.assert_array_equal(vat.numpy(), np.asarray(vaj))
    _close(Xt, Xj, rtol=1e-6, atol=1e-12)
    _close(alt[:10], alj[:10], rtol=1e-8, atol=1e-14)
    _close(bet[:10], bej[:10], rtol=1e-8, atol=1e-14)
    z2 = np.random.default_rng(4).uniform(0.5, 2.0, 5)
    _close(ti._slq_logdet(alt, bet, vat, torch.as_tensor(z2)), ji._slq_logdet(alj, bej, vaj, jnp.asarray(z2)),
           rtol=1e-6)
    assert float(rrt) <= 1e-6 and float(rrj) <= 1e-6
    assert abs(float(rrt) - float(rrj)) <= 1e-2 * 1e-6
    res = np.linalg.norm(A @ Xt.numpy() - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1.01e-6, res  # it solves A X = B to the residual tolerance


def test_pcg_skip_returns_zero_without_iterating():
    A, L, d, B = _pcg_inputs()
    ps_t, _ = ti._make_precond(torch.as_tensor(L), torch.as_tensor(d))
    X, _, _, va, it, _ = ti.pcg(lambda V: torch.as_tensor(A) @ V, ps_t, torch.as_tensor(B), 100, 1e-6,
                                track=4, skip=True)
    assert it == 0 and not bool(va.any()) and float(X.abs().max()) == 0.0


def test_slq_logdet_matches():
    """The quadrature from the same CG scalars: rtol 1e-10 (batched eigh)."""
    A, L, d, B = _pcg_inputs()
    ps_j, _ = ji._make_precond(jnp.asarray(L), jnp.asarray(d))
    _, al, be, va, _, _ = ji.pcg(lambda V: jnp.asarray(A) @ V, ps_j, jnp.asarray(B), 100, 1e-6, track=20)
    znorm2 = np.random.default_rng(4).uniform(0.5, 2.0, 5)
    ref = ji._slq_logdet(al, be, va, jnp.asarray(znorm2))
    port = ti._slq_logdet(_t(al), _t(be), _t(va), torch.as_tensor(znorm2))
    _close(port, ref, rtol=1e-10)
    _close(ti._tridiag_from_cg(_t(al), _t(be), _t(va)), ji._tridiag_from_cg(al, be, va), rtol=1e-12)


def test_lanczos_matches():
    """Q, diag and off of the fully reorthogonalized Lanczos: rtol 1e-7 on
    T's coefficients and atol 1e-8 on Q (12 steps of two-pass Gram-Schmidt
    amplify BLAS round-off by the growth of the Krylov basis)."""
    A, _, _, B = _pcg_inputs()
    Qj, dj, oj = ji.lanczos(lambda V: jnp.asarray(A) @ V, jnp.asarray(B[:, 0]), 12)
    Qt, dt, ot = ti.lanczos(lambda V: torch.as_tensor(A) @ V, torch.as_tensor(B[:, 0]), 12)
    _close(dt, dj, rtol=1e-7)
    _close(ot, oj, rtol=1e-7)
    _close(Qt, Qj, atol=1e-8)


def test_love_factor_block_path_with_reference_omega():
    """Block-LOVE (k = 256 ≥ 4·64) with the reference's own Ω: W Wᵀ agrees
    to 1e-8 of its largest entry (four block sweeps, CholQR², the Cholesky
    of T), and the scalar path (k = 16) likewise. ls = 0.3 keeps A's
    spectrum wider than the basis: at ls ≈ 1 the Krylov space exhausts it
    below rank 256 and the basis past that breakdown is rounding noise in
    both packages (measured: 3e-3 apart)."""
    jspec, _, xc, xk, y, params = _problem(n=320, seed=5)
    K, d = _dense_A(jspec, {**params, "ls_total": np.array([0.3, 0.3])}, xc, xk)
    A = K + np.diag(d)
    om = jax.random.normal(jax.random.PRNGKey(7), (320, 63), jnp.float64)
    for k in (256, 16):
        Wj = np.asarray(ji._love_factor(lambda V: jnp.asarray(A) @ V, jnp.asarray(y), k))
        Wt = ti._love_factor(lambda V: torch.as_tensor(A) @ V, torch.as_tensor(y), k, omega=torch.as_tensor(np.asarray(om)))
        Mj, Mt = Wj @ Wj.T, Wt.numpy() @ Wt.numpy().T
        np.testing.assert_allclose(Mt, Mj, rtol=0, atol=1e-8 * np.abs(Mj).max(), err_msg=f"k={k}")
    # the port's own Ω (torch.Generator seeded with 7) is a different draw
    # but the same kind of factor: conservative, close to A⁻¹ on y
    Wt = ti._love_factor(lambda V: torch.as_tensor(A) @ V, torch.as_tensor(y), 256).numpy()
    q_love, q_exact = y @ Wt @ Wt.T @ y, y @ np.linalg.solve(A, y)
    assert q_love <= q_exact * (1 + 1e-9) and q_love >= 0.99 * q_exact


def _logp_case(block, n=60):
    jspec, spec, xc, xk, y, params = _problem(n=n, seed=3)
    rng = np.random.default_rng(7)
    mask = np.ones(n)
    mask[-6:] = 0.0
    nm = rng.uniform(0.5, 2.0, n)
    jcfg = ji.IterConfig(maxiter=200, tol=1e-9, n_probes=8, precond_rank=6, quad_steps=60, block=block)
    pn, pk = ji.draw_probes(0, n, jcfg, dtype=jnp.float64)
    return jspec, spec, jcfg, xc, xk, y, params, mask, nm, np.asarray(pn), np.asarray(pk)


@pytest.mark.parametrize("block", [0, 20], ids=["dense", "blocked"])
def test_iter_gaussian_logp_value_and_grad(block):
    """Value rtol 1e-8; gradients (params and y, through the Hutchinson
    surrogate backward) rtol 1e-6; masked rows and noise_mult included."""
    jspec, spec, jcfg, xc, xk, y, params, mask, nm, pn, pk = _logp_case(block)

    def fj(p, yy):
        return ji.iter_gaussian_logp(jspec, jcfg, p, _j(xc), _j(xk), yy, _j(pn), _j(pk), _j(mask), _j(nm))

    vj, (gpj, gyj) = jax.value_and_grad(fj, argnums=(0, 1))(_j(params), _j(y))
    pt = {k: v.requires_grad_(True) for k, v in _t(params).items()}
    yt = _t(y).requires_grad_(True)
    info = {}
    vt = ti.iter_gaussian_logp(spec, iter_config_from_reference(jcfg), pt, _t(xc), _t(xk), yt, _t(pn), _t(pk),
                               _t(mask), _t(nm), info=info)
    vt.backward()
    assert not info["exhausted"] and info["iters"] > 0 and float(info["rel_res"]) <= 1e-9
    _close(vt, vj, rtol=1e-8)
    for k in params:
        _close(pt[k].grad, gpj[k], rtol=1e-6, atol=1e-10, msg=k)
    _close(yt.grad, gyj, rtol=1e-6, atol=1e-12)
    assert float(yt.grad[-6:].abs().max()) == 0.0


def test_iter_map_value_and_grad_and_value():
    """The MAP objective (prior included) value+grad and value-only, against
    jax.value_and_grad of the reference's iter_map_neg_logp."""
    jspec, spec, jcfg, xc, xk, y, params, mask, nm, pn, pk = _logp_case(20)
    u = {k: np.log(v) for k, v in params.items()}
    la, lb = np.array([2.0, 2.0]), np.array([1.0, 1.0])
    vj, gj = jax.value_and_grad(lambda uu: ji.iter_map_neg_logp(
        jspec, uu, _j(xc), _j(xk), _j(y), _j(la), _j(lb), _j(pn), _j(pk), jcfg, mask=_j(mask)))(_j(u))
    cfg = iter_config_from_reference(jcfg)
    args = (spec, cfg, _t(u), _t(xc), _t(xk), _t(y), la, lb, _t(pn), _t(pk))
    vt, gt = ti.iter_map_value_and_grad(*args, mask=_t(mask))
    _close(vt, vj, rtol=1e-8)
    for k in u:
        _close(gt[k], gj[k], rtol=1e-6, atol=1e-10, msg=k)
    _close(ti.iter_map_value(*args, mask=_t(mask)), vj, rtol=1e-8)


def test_unconverged_solve_is_distrusted():
    """maxiter 2 at tol 1e-12 cannot converge: −inf log-density in both,
    +inf objective."""
    jspec, spec, jcfg, xc, xk, y, params, mask, nm, pn, pk = _logp_case(0)
    jcfg = ji.IterConfig(maxiter=2, tol=1e-12, n_probes=8, precond_rank=6, quad_steps=8)
    vj = ji.iter_gaussian_logp(jspec, jcfg, _j(params), _j(xc), _j(xk), _j(y), _j(pn), _j(pk), None, None)
    vt = ti.iter_gaussian_logp(spec, iter_config_from_reference(jcfg), _t(params), _t(xc), _t(xk), _t(y),
                               _t(pn), _t(pk))
    assert np.isneginf(float(vj)) and np.isneginf(float(vt))


def _posterior_case(regime):
    """'cg': rank 6 leaves CG to converge; 'exhausted': rank = n exhausts
    the factorization, so CG is skipped and Woodbury is exact (the f64
    counterpart of the reference's test_exhausted_factorization_woodbury_exact)."""
    n = 60
    jspec, spec, xc, xk, y, params = _problem(n=n, seed=9)
    rank = 6 if regime == "cg" else n
    jcfg = ji.IterConfig(maxiter=200, tol=1e-10, n_probes=4, precond_rank=rank, love_rank=24, block=20)
    rng = np.random.default_rng(12)
    xs = rng.uniform(-2, 2, (37, 2))
    return jspec, spec, jcfg, xc, xk, y, params, xs, np.zeros((37, 0), np.int32)


@pytest.mark.parametrize("regime", ["cg", "exhausted"])
def test_iter_posterior_cache_and_predictions(regime):
    """Cache {alpha, L, d, W} and the diag/mean predictions: rtol 1e-8
    (W Wᵀ to 1e-8 of its largest entry; L to atol 1e-10, since in the
    exhausted regime its trailing columns are cancellation noise)."""
    jspec, spec, jcfg, xc, xk, y, params, xs, xks = _posterior_case(regime)
    cfg = iter_config_from_reference(jcfg)
    cj = ji.iter_posterior_cache(jspec, jcfg, _j(params), _j(xc), _j(xk), _j(y))
    info = {}
    ct = ti.iter_posterior_cache(spec, cfg, _t(params), _t(xc), _t(xk), _t(y), info=info)
    assert info["exhausted"] == (regime == "exhausted")
    assert (info["iters"] == 0) == (regime == "exhausted")
    assert set(ct) == {"alpha", "L", "d", "W"}
    for k in ("alpha", "d"):
        _close(ct[k], cj[k], rtol=1e-8, atol=1e-12, msg=k)
    _close(ct["L"], cj["L"], rtol=1e-8, atol=1e-10)
    Mj = np.asarray(cj["W"]) @ np.asarray(cj["W"]).T
    np.testing.assert_allclose(ct["W"].numpy() @ ct["W"].numpy().T, Mj, atol=1e-8 * np.abs(Mj).max())
    for with_noise in (True, False):
        mj, vj = ji.iter_predict_diag(jspec, jcfg, _j(params), cj, _j(xc), _j(xk), _j(xs), _j(xks),
                                      with_noise=with_noise, chunk=16)
        mt, vt = ti.iter_predict_diag(spec, cfg, _t(params), ct, _t(xc), _t(xk), _t(xs), _t(xks),
                                      with_noise=with_noise, chunk=16)
        _close(mt, mj, rtol=1e-8, atol=1e-12)
        _close(vt, vj, rtol=1e-8, atol=1e-12)
    # the preconditioner (Nyström) surrogate when the cache has no W
    cj0 = {k: v for k, v in cj.items() if k != "W"}
    ct0 = {k: v for k, v in ct.items() if k != "W"}
    _, vj0 = ji.iter_predict_diag(jspec, jcfg, _j(params), cj0, _j(xc), _j(xk), _j(xs), _j(xks))
    _, vt0 = ti.iter_predict_diag(spec, cfg, _t(params), ct0, _t(xc), _t(xk), _t(xs), _t(xks))
    _close(vt0, vj0, rtol=1e-8, atol=1e-12)
    mean_j = ji.iter_predict_mean(jspec, jcfg, _j(params), _j(xc), _j(xk), _j(y), _j(xs), _j(xks), star_block=16)
    mean_t = ti.iter_predict_mean(spec, cfg, _t(params), _t(xc), _t(xk), _t(y), _t(xs), _t(xks), star_block=16)
    _close(mean_t, mean_j, rtol=1e-8, atol=1e-12)


def test_reference_cache_predicts_identically_in_port():
    """A cache built by the reference, carried across with
    iter_cache_from_numpy, gives the reference's mean and variance in the
    port's iter_predict_diag (rtol 1e-10: same cache, same formulas)."""
    jspec, spec, jcfg, xc, xk, y, params, xs, xks = _posterior_case("cg")
    cj = ji.iter_posterior_cache(jspec, jcfg, _j(params), _j(xc), _j(xk), _j(y))
    ct = iter_cache_from_numpy({k: np.asarray(v) for k, v in cj.items()}, device="cpu", dtype=torch.float64)
    assert set(iter_cache_to_numpy(ct)) == set(cj)
    mj, vj = ji.iter_predict_diag(jspec, jcfg, _j(params), cj, _j(xc), _j(xk), _j(xs), _j(xks))
    mt, vt = ti.iter_predict_diag(spec, iter_config_from_reference(jcfg), _t(params), ct, _t(xc), _t(xk),
                                  _t(xs), _t(xks))
    _close(mt, mj, rtol=1e-10, atol=1e-13)
    _close(vt, vj, rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("kernel", ["Matern32", "Exponential"])
def test_blocked_matvec_takes_plain_path_on_cpu(kernel):
    """A fusable single term on the CPU takes the blocked Gram path (as the
    reference does off-TPU): it matches the dense matvec to rtol 1e-12 and
    launches no CUDA kernel."""
    jspec, spec, xc, xk, _, params = _problem(n=40, kernel=kernel)
    V = torch.as_tensor(np.random.default_rng(0).normal(size=(40, 3)))
    before = (RbfGram.launches, FusedMatvec.launches, FusedMatvecSym.launches)
    p = _t(params)
    d = ti._noise_vec(spec, p, _t(xk), 1e-6, None, None, torch.float64)
    out_b = ti._make_matvec(spec, ti.IterConfig(block=10), p, _t(xc), _t(xk), d, None)(V)
    out_d = ti._make_matvec(spec, ti.IterConfig(block=0), p, _t(xc), _t(xk), d, None)(V)
    _close(out_b, out_d.numpy(), rtol=1e-12)
    assert (RbfGram.launches, FusedMatvec.launches, FusedMatvecSym.launches) == before
    with pytest.raises(ValueError, match="divisible"):
        ti._make_matvec(spec, ti.IterConfig(block=7), p, _t(xc), _t(xk), d, None)


def test_fit_iter_map_matches_reference_host_loop():
    """fit_iter_map (the port's multi-restart L-BFGS on the iterative
    objective) against the reference's host-loop L-BFGS on the same
    objective from the same starts: the best values agree to 1e-6 relative
    (same algorithm, f64 objective round-off)."""
    jspec, spec, jcfg, xc, xk, y, params, mask, nm, pn, pk = _logp_case(0, n=40)
    la, lb = np.array([2.0, 2.0]), np.array([1.0, 1.0])
    u0s = {k: np.stack([np.log(v), np.log(v) + 0.3]) for k, v in params.items()}

    def obj_j(u):
        return ji.iter_map_neg_logp(jspec, u, _j(xc), _j(xk), _j(y), _j(la), _j(lb), _j(pn), _j(pk), jcfg)

    fj = min(float(jo.lbfgs_host_minimize(obj_j, {k: jnp.asarray(v[i]) for k, v in u0s.items()},
                                          maxiter=15, ftol=1e-9)[1]) for i in range(2))
    _, ft, aux = ti.fit_iter_map(spec, iter_config_from_reference(jcfg), _t(xc), _t(xk), _t(y), la, lb,
                                 _t(pn), _t(pk), _t(u0s), maxiter=15, tol=1e-9)
    assert aux["all_xs"]["ls_total"].shape == (2, 2)
    np.testing.assert_allclose(float(ft), fj, rtol=1e-6)


def test_cholqr2_survives_a_gram_that_is_not_positive_definite(monkeypatch):
    """A Krylov block that closed early leaves a Gram whose jittered Cholesky
    can fail at f32. The round then whitens by the Gram's eigenvectors: the
    result is finite, spans the same space and is orthonormal on a full-rank
    block; a rank-deficient block comes back finite too. Where the Cholesky
    succeeds the reference's route is taken unchanged."""
    rng = np.random.default_rng(3)
    W = torch.as_tensor(rng.normal(size=(400, 8)))
    by_cholesky = ti._cholqr2(W, 1e-12)
    L = torch.linalg.cholesky(W.T @ W)
    np.testing.assert_allclose(by_cholesky.numpy(), torch.linalg.solve_triangular(L, W.T, upper=False).T.numpy(),
                               rtol=0, atol=1e-9)

    monkeypatch.setattr(ti, "safe_cholesky", lambda A: torch.full_like(A, float("nan")))
    Q = ti._cholqr2(W, 1e-12)
    assert bool(torch.isfinite(Q).all())
    np.testing.assert_allclose((Q.T @ Q).numpy(), np.eye(8), atol=1e-9)
    np.testing.assert_allclose((Q @ (Q.T @ W)).numpy(), W.numpy(), atol=1e-9)  # same span

    deficient = torch.cat([W[:, :4], W[:, :4]], dim=1).float()
    Qd = ti._cholqr2(deficient, 1e-6)
    assert bool(torch.isfinite(Qd).all())
    np.testing.assert_allclose((Qd @ (Qd.T @ deficient))[:, :4].numpy(), deficient[:, :4].numpy(), atol=1e-3)
