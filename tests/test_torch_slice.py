"""The port's slice end to end at reduced size, against the JAX reference.

The slice is what ``bench.py`` times and ``chip_smoke.py`` runs on the
card: a 2-output LMC fitted coarse → mid → polish through ``fit_kron_map``,
then ``kron_cache`` and ``kron_predict_diag`` on a grid. Here it runs on the
CPU at f64 with the stage sizes scaled down (256 locations instead of
5,120, stage ratios kept), through ``chip_smoke.run_slice`` itself.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gumbi_tpu.ops.kernels as jk
import gumbi_tpu.ops.kronecker as jkr
import gumbi_tpu.ops.priors as jp
from gumbi_tpu.ops.optimize import lbfgs_backtracking_minimize
from gumbi_tpu_torch.convert import params_to_numpy
from gumbi_tpu_torch.ops import constrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

N_LOCS, COARSE_N, MID_N, GRID, N_RESTARTS = 256, 32, 51, 12, 4  # bench: 5120, 640, 1024, 100, 8
BASIN_TOL = 0.005  # nats/point, tests/test_bench_quality.py's tolerance


@pytest.fixture(scope="module")
def port_run():
    return chip_smoke.run_slice("cpu", torch.float64, n_locs=N_LOCS, coarse_n=COARSE_N, mid_n=MID_N,
                                grid=GRID, n_restarts=N_RESTARTS)


def _jax_spec():
    out = jk.CoregTerm(name="Parameter", col=0, d_out=2)
    return jk.GPSpec(
        terms=(jk.GPTerm(suffix="total", kernel="ExpQuad", coregs=(out,)),),
        d_cont=2,
        ard=True,
        noise_coreg=jk.CoregTerm(name="Output_noise", col=0, d_out=2),
    )


def test_slice_outputs(port_run):
    r = port_run
    assert r["mean"].shape == (2, GRID * GRID) and r["var"].shape == (2, GRID * GRID)
    assert torch.isfinite(r["mean"]).all() and (r["var"] >= 0).all()
    assert r["mean"].dtype == torch.float64  # CPU default model dtype
    assert [len(i) for i in r["iters"]] == [N_RESTARTS, 1, 1]
    assert r["launches"] == {"fit": 0, "predict": 0, "total": 0}  # no CUDA kernel on the CPU


def test_slice_matches_reference_bench_chain(port_run):
    """bench.py's chain (optax backtracking L-BFGS, lax.map restarts) on the
    same data and starts reaches the same basin: |Δ neg_logp| within
    0.005 nats/point."""
    r = port_run
    spec = _jax_spec()
    X, Y = jnp.asarray(r["xc"].numpy()), jnp.asarray(r["Y"].numpy())
    la, lb = r["la"], r["lb"]
    u0s = jp.initial_params(spec, la, lb, n_restarts=N_RESTARTS, seed=0)
    rng = np.random.default_rng(1)
    sub_c = np.sort(rng.choice(N_LOCS, COARSE_N, replace=False))
    sub_m = np.sort(rng.choice(N_LOCS, MID_N, replace=False))

    def stage(x, y, maxiter, ftol=1e-6):
        def objective(u):
            return jkr.kron_neg_logp(spec, u, x, y, la, lb)

        return lambda u0: lbfgs_backtracking_minimize(objective, u0, maxiter=maxiter, ftol=ftol)

    xs, fs, _ = jax.jit(lambda u: jax.lax.map(stage(X[sub_c], Y[sub_c], 20), u))(u0s)
    best = int(jnp.argmin(jnp.where(jnp.isfinite(fs), fs, jnp.inf)))
    u = jax.tree_util.tree_map(lambda leaf: leaf[best], xs)
    u, _, _ = jax.jit(stage(X[sub_m], Y[sub_m], 12))(u)
    _, f_ref, _ = jax.jit(stage(X, Y, 20, 1e-4))(u)
    n_points = 2 * N_LOCS
    assert abs(r["f_best"] - float(f_ref)) <= BASIN_TOL * n_points, (r["f_best"], float(f_ref))


def test_port_fit_predicts_identically_in_reference(port_run):
    """The port's fitted parameters, carried across with params_to_numpy,
    give the port's grid mean/variance in the reference's kron_cache +
    kron_predict_diag: rtol 1e-8 at f64 (same formulas, BLAS round-off)."""
    r = port_run
    spec = _jax_spec()
    p = {k: jnp.asarray(v) for k, v in params_to_numpy(constrain(r["u_best"])).items()}
    kc = jkr.kron_cache(spec, p, jnp.asarray(r["xc"].numpy()), jnp.asarray(r["Y"].numpy()))
    mean, var = jkr.kron_predict_diag(spec, p, kc, jnp.asarray(r["xc_grid"].numpy()), with_noise=True)
    np.testing.assert_allclose(r["mean"].numpy(), np.asarray(mean), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(r["var"].numpy(), np.asarray(var), rtol=1e-8, atol=1e-12)


def test_port_imports_neither_jax_nor_pandas():
    code = (
        "import sys, gumbi_tpu_torch, chip_smoke\n"
        "bad = [m for m in ('jax', 'pandas', 'gumbi_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_refuses_to_run_without_cuda():
    """Without a card the smoke script exits nonzero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run the whole slice")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
