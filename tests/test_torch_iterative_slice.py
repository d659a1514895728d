"""The large-N slice end to end at reduced size, against the JAX reference.

The slice is what ``chip_smoke.py`` runs on the card at N = 50,000: the
staged fit of ``GP._find_MAP_iterative`` (coarse Cholesky restarts on a
subsample → L-BFGS polish of the iterative objective → LOVE posterior
cache) and ``iter_predict_diag`` on a grid. Here it runs on the CPU at f64
through ``chip_smoke.run_iter_campaign`` itself, cut to N = 512, block 128,
a 128-row coarse subsample, 4 restarts, rank 32, 8 probes and LOVE rank
256 (so the block-LOVE path runs), and is held against the same chain
built from the reference's ops, with the reference's LOVE start block Ω
and its posterior cache solved to the port's target (``POSTERIOR_TOL``).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gumbi_tpu.ops.iterative as ji
import gumbi_tpu.ops.kernels as jk
import gumbi_tpu.ops.optimize as jo
import gumbi_tpu.ops.priors as jp
from gumbi_tpu_torch.convert import iter_cache_to_numpy, params_to_numpy
from gumbi_tpu_torch.ops import constrain
from gumbi_tpu_torch.ops.iterative import POSTERIOR_TOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

N, BLOCK, COARSE_N, RESTARTS, RANK, PROBES, LOVE, GRID = 512, 128, 128, 4, 32, 8, 256, 12
BASIN_TOL = 0.005  # nats/point, tests/test_bench_quality.py's tolerance


def _omega():
    return np.asarray(jax.random.normal(jax.random.PRNGKey(7), (N, 63), jnp.float64))


@pytest.fixture(scope="module")
def port_run():
    return chip_smoke.run_iter_campaign(
        "cpu", torch.float64, n=N, block=BLOCK, rank=RANK, probes=PROBES, love_rank=LOVE,
        coarse_n=COARSE_N, n_restarts=RESTARTS, grid=GRID, omega=torch.as_tensor(_omega()),
    )


@pytest.fixture(scope="module")
def ref_run(port_run):
    """The reference's chain on the port's data, starts and probes."""
    r = port_run
    jspec = jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2)
    c = r["cfg"]
    jcfg = ji.IterConfig(maxiter=c.maxiter, tol=c.tol, n_probes=c.n_probes, precond_rank=c.precond_rank,
                         quad_steps=c.quad_steps, block=c.block, love_rank=c.love_rank)
    xc, y = jnp.asarray(r["xc"].numpy()), jnp.asarray(r["y"].numpy())
    xk = jnp.zeros((N, 0), jnp.int32)
    la, lb = jnp.asarray(r["la"]), jnp.asarray(r["lb"])
    pn, pk = ji.draw_probes(0, N, jcfg, dtype=jnp.float64)
    u0s = jp.initial_params(jspec, r["la"], r["lb"], n_restarts=RESTARTS, seed=0)
    idx = jnp.asarray(r["idx"])

    def runner(u0):
        return jo.coarse_restart_map(jspec, xc[idx], xk[idx], y[idx], la, lb, u0,
                                     maxiter=chip_smoke.ITER_COARSE_ITERS, tol=chip_smoke.FIT_TOL)

    u_start, f_coarse, _ = jo.multi_restart_minimize_hostloop(None, u0s, runner=runner)

    def objective(u):
        return ji.iter_map_neg_logp(jspec, u, xc, xk, y, la, lb, pn, pk, jcfg)

    u_best, f_best, _ = jo.lbfgs_host_minimize(objective, u_start, maxiter=chip_smoke.ITER_POLISH_ITERS,
                                               ftol=chip_smoke.FIT_TOL)
    params = jp.constrain(u_best)
    # the port solves the posterior's α to min(tol, POSTERIOR_TOL) (a named
    # divergence of ops/iterative.py); the reference's cache at that target
    cache_cfg = dataclasses.replace(jcfg, tol=min(jcfg.tol, POSTERIOR_TOL))
    cache = ji.iter_posterior_cache(jspec, cache_cfg, params, xc, xk, y)
    xg = jnp.asarray(r["xg"].numpy())
    mean, var = ji.iter_predict_diag(jspec, jcfg, params, cache, xc, xk, xg, jnp.zeros((GRID * GRID, 0), jnp.int32),
                                     with_noise=False)
    return dict(jspec=jspec, jcfg=jcfg, f_best=float(f_best), f_coarse=float(f_coarse), u_best=u_best,
                mean=np.asarray(mean), var=np.asarray(var), xc=xc, xk=xk, y=y, xg=xg)


def test_campaign_outputs(port_run):
    r = port_run
    assert r["mean"].shape == (GRID * GRID,) and r["var"].shape == (GRID * GRID,)
    assert r["mean"].dtype == torch.float64  # the CPU model dtype
    assert torch.isfinite(r["mean"]).all() and (r["var"] >= 0).all()
    assert len(r["aux_c"]["all_values"]) == RESTARTS and r["aux_c"]["all_xs"]["σ"].shape == (RESTARTS,)
    assert r["polish_iters"] > 0 and len(r["evals"]) > r["polish_iters"]
    assert set(r["cache"]) == {"alpha", "L", "d", "W"} and r["cache"]["W"].shape == (N, LOVE)
    zero = {"rbf_gram": 0, "fused_stationary_matvec": 0, "fused_stationary_matvec_sym": 0}
    assert r["launches"] == {"fit": zero, "cache": zero, "predict": zero}  # no CUDA kernel on the CPU


def test_campaign_matches_reference_chain(port_run, ref_run):
    """The coarse winner to 1e-6 relative (the same host-loop L-BFGS on the
    same Cholesky objective); the polished objective within 0.005
    nats/point of the reference's (the same algorithm on an objective whose
    CG round-off differs)."""
    r, j = port_run, ref_run
    np.testing.assert_allclose(r["f_coarse"], j["f_coarse"], rtol=1e-6)
    assert abs(r["f_best"] - j["f_best"]) <= BASIN_TOL * N, (r["f_best"], j["f_best"])


def test_campaign_grid_matches_reference(port_run, ref_run):
    """Grid mean and variance against the reference chain's: mean to 1e-3
    and variance to 1e-3 of the prior variance η² (the two fits stop at
    optima a few 1e-4 apart in ls, and the LOVE basis at rank 256 runs past
    the kernel's numerical rank, where its last directions are round-off)."""
    r, j = port_run, ref_run
    eta2 = float(constrain(r["u_best"])["η_total"]) ** 2
    np.testing.assert_allclose(r["mean"].numpy(), j["mean"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(r["var"].numpy(), j["var"], rtol=0, atol=1e-3 * eta2)


def test_port_fit_predicts_in_reference(port_run, ref_run):
    """The port's fitted parameters and cache, carried across as numpy,
    give the port's grid in the reference's iter_predict_diag: rtol 1e-8
    (same cache, same formulas)."""
    r, j = port_run, ref_run
    p = {k: jnp.asarray(v) for k, v in params_to_numpy(constrain(r["u_best"])).items()}
    cache = {k: jnp.asarray(v) for k, v in iter_cache_to_numpy(r["cache"]).items()}
    mean, var = ji.iter_predict_diag(j["jspec"], j["jcfg"], p, cache, j["xc"], j["xk"], j["xg"],
                                     jnp.zeros((GRID * GRID, 0), jnp.int32), with_noise=False)
    np.testing.assert_allclose(r["mean"].numpy(), np.asarray(mean), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(r["var"].numpy(), np.asarray(var), rtol=1e-8, atol=1e-12)
