"""Port parity: gumbi_tpu_torch.ops.ess against gumbi_tpu.ops.ess.

The Bernoulli likelihood, one elliptical-slice step (one chain and two
chains batched) and a short ``ess_gpc_sample`` run given JAX's own draws
(replayed through ``test_torch_hmc.JaxStream``), the non-finite-factor cap
of tests/test_extras.py, ``latent_conditional_proba``, and the named f32
divergence of the prior factor's floor with a test that shows the
reference failing. f64 on the CPU; tolerances are stated per test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gumbi_tpu.ops.ess as je
import gumbi_tpu.ops.kernels as jk
import gumbi_tpu.ops.priors as jp
import gumbi_tpu_torch.ops.ess as te
from gumbi_tpu_torch.convert import params_from_numpy, spec_from_reference
from gumbi_tpu_torch.ops.kernels import gram
from gumbi_tpu_torch.ops.priors import constrain
from gumbi_tpu_torch.utils.torch_utils import TorchStream
from test_torch_hmc import CHAIN_RTOL, JaxStream, _close_tree

torch.set_num_threads(2)

RTOL = 1e-9
N, N_NEW, N_PAD = 24, 7, 4


def _problem(n=N, seed=0):
    """Labels from a smooth latent surface over 2 dims; the last N_PAD rows
    are bucket padding (mask 0)."""
    rng = np.random.default_rng(seed)
    jspec = jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2, likelihood="bernoulli")
    xc = rng.uniform(-2, 2, size=(n, 2))
    f = 2.0 * np.sin(1.3 * xc[:, 0]) * np.cos(0.9 * xc[:, 1])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-f))).astype(float)
    mask = np.ones(n)
    mask[-N_PAD:] = 0.0
    la, lb = jp.ls_prior_params([0.1, 0.1], [4.0, 4.0])
    u0 = {k: np.asarray(v[0]) for k, v in jp.initial_params(jspec, la, lb, 1, seed=seed).items()}
    new_c = rng.uniform(-2, 2, size=(N_NEW, 2))
    return dict(jspec=jspec, spec=spec_from_reference(jspec), xc=xc, y=y, mask=mask, la=la, lb=lb, u0=u0,
                new_c=new_c)


@pytest.fixture(scope="module")
def prob():
    return _problem()


def _zk(n, torch_side):
    return torch.zeros((n, 0), dtype=torch.long) if torch_side else jnp.zeros((n, 0), jnp.int32)


def _one_chain(u):
    """Parameters with a leading chain axis of 1, as ``_chol_K`` takes them."""
    return {k: v[None] for k, v in u.items()}


def _L(pr, u=None, dtype=np.float64):
    """The reference's prior factor at ``u`` (default: the start), as numpy."""
    u = pr["u0"] if u is None else u
    xc = jnp.asarray(pr["xc"], dtype)
    return np.asarray(je._chol_K(pr["jspec"], {k: jnp.asarray(v, dtype) for k, v in u.items()}, xc,
                                 _zk(len(xc), False), 1e-6))


@pytest.mark.parametrize("masked", [False, True])
def test_bernoulli_loglik(prob, masked):
    f = np.random.default_rng(1).normal(scale=3.0, size=N)
    mj = jnp.asarray(prob["mask"]) if masked else None
    mt = torch.tensor(prob["mask"]) if masked else None
    lj = je.bernoulli_loglik(jnp.asarray(f), jnp.asarray(prob["y"]), mj)
    lt = te.bernoulli_loglik(torch.tensor(f), torch.tensor(prob["y"]), mt)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-14)
    # leading chain axis: one value per chain
    lt2 = te.bernoulli_loglik(torch.tensor(np.stack([f, -f])), torch.tensor(prob["y"]), mt)
    assert lt2.shape == (2,) and float(lt2[0]) == float(lt)


def test_chol_K_equals_the_reference_at_f64(prob):
    """At f64 the floor max(jitter, N·eps·mean diag K) is the reference's
    jitter, so the prior factor is the reference's (rtol 1e-12)."""
    Lt = te._chol_K(prob["spec"], _one_chain(params_from_numpy(prob["u0"], dtype=torch.float64, device="cpu")),
                    torch.tensor(prob["xc"]), _zk(N, True), 1e-6)[0]
    np.testing.assert_allclose(Lt.numpy(), _L(prob), rtol=1e-12, atol=1e-14)


def test_ess_step_replays_the_reference(prob):
    """One slice step on one chain given the reference's key: the new ν
    equals the reference's (rtol 1e-12: the same angle, the GEMVs' last
    bits)."""
    L = _L(prob)
    nu = np.random.default_rng(2).normal(size=N)
    key = jax.random.PRNGKey(3)
    ref = jax.jit(je._ess_step, static_argnums=4)(key, jnp.asarray(nu), jnp.asarray(L), jnp.asarray(prob["y"]),
                                                 je.bernoulli_loglik)
    counts = {}
    out = te._ess_step(JaxStream(key), torch.tensor(nu), torch.tensor(L), torch.tensor(prob["y"]),
                       te.bernoulli_loglik, counts)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)
    assert 1 <= int(counts["trials"]) < te.ESS_MAX_TRIALS and counts["syncs"] == int(counts["trials"])


def test_ess_step_two_chains_batched_replay_the_vmapped_reference(prob):
    """Two chains in one batched step (different factors, states and keys)
    against the reference vmapped over them; the finished chain holds its
    state while the other shrinks on."""
    L = np.stack([_L(prob), _L(prob, {k: v + 0.4 for k, v in prob["u0"].items()})])
    nu = np.random.default_rng(4).normal(size=(2, N))
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    y = jnp.asarray(prob["y"])
    ref = jax.jit(jax.vmap(lambda k, n, l: je._ess_step(k, n, l, y, je.bernoulli_loglik)))(
        keys, jnp.asarray(nu), jnp.asarray(L))
    counts = {}
    out = te._ess_step(JaxStream(keys), torch.tensor(nu), torch.tensor(L), torch.tensor(prob["y"]),
                       te.bernoulli_loglik, counts)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)
    assert counts["trials"].shape == (2,) and counts["syncs"] == int(counts["trials"].max())


def test_ess_step_terminates_on_nonfinite_factor():
    """tests/test_extras.py's cap test on the port: a NaN factor reads −inf
    everywhere, the loop stops at the 200-trial cap, and the step keeps ν."""
    n = 8
    nu = torch.randn(n, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    y = torch.tensor(np.arange(n) % 2, dtype=torch.float64)
    L_bad = torch.full((n, n), torch.nan, dtype=torch.float64)
    counts = {}
    out = te._ess_step(TorchStream(torch.Generator().manual_seed(0), torch.float64, "cpu"), nu, L_bad, y,
                       te.bernoulli_loglik, counts)
    np.testing.assert_array_equal(out.numpy(), nu.numpy())
    assert int(counts["trials"]) == te.ESS_MAX_TRIALS


def test_ess_step_nonfinite_factor_replays_the_reference():
    """The same cap given the reference's key: both keep ν exactly."""
    n = 8
    nu = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (n,)))
    y = np.arange(n) % 2.0
    L_bad = np.full((n, n), np.nan)
    ref = jax.jit(je._ess_step, static_argnums=4)(jax.random.PRNGKey(0), jnp.asarray(nu), jnp.asarray(L_bad),
                                                 jnp.asarray(y), je.bernoulli_loglik)
    out = te._ess_step(JaxStream(jax.random.PRNGKey(0)), torch.tensor(nu), torch.tensor(L_bad), torch.tensor(y),
                       te.bernoulli_loglik)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_ess_step_normal_operation_moves():
    n = 8
    nu = torch.randn(n, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    y = torch.tensor(np.arange(n) % 2, dtype=torch.float64)
    out = te._ess_step(TorchStream(torch.Generator().manual_seed(2), torch.float64, "cpu"), nu,
                       torch.eye(n, dtype=torch.float64), y, te.bernoulli_loglik)
    assert bool(torch.isfinite(out).all()) and not torch.allclose(out, nu)


@pytest.fixture(scope="module", params=[False, True], ids=["unmasked", "masked"])
def ess_pair(prob, request):
    masked = request.param
    kw = dict(draws=8, tune=12, chains=2, ess_sweeps=2)
    ref = je.ess_gpc_sample(prob["jspec"], {k: jnp.asarray(v) for k, v in prob["u0"].items()},
                            jnp.asarray(prob["xc"]), _zk(N, False), jnp.asarray(prob["y"]), jnp.asarray(prob["la"]),
                            jnp.asarray(prob["lb"]), jax.random.PRNGKey(9),
                            mask=jnp.asarray(prob["mask"]) if masked else None, **kw)
    port = te.ess_gpc_sample(prob["spec"], prob["u0"], torch.tensor(prob["xc"]), _zk(N, True),
                             torch.tensor(prob["y"]), prob["la"], prob["lb"], stream=JaxStream(jax.random.PRNGKey(9)),
                             mask=prob["mask"] if masked else None, **kw)
    return ref, port


def test_ess_gpc_sample_replays_the_reference_draw_by_draw(ess_pair):
    """Hyperparameter and latent draws, MH acceptance and the adapted step
    size, draw by draw (CHAIN_RTOL, relative to each array's largest
    entry), with and without a bucket mask."""
    (uj, fj, sj), (ut, ft, st) = ess_pair
    assert ft.shape == (2, 8, N) and ut["ls_total"].shape == (2, 8, 2)
    _close_tree(ut, uj, CHAIN_RTOL)
    _close_tree({"f": ft}, {"f": fj}, CHAIN_RTOL)
    _close_tree({k: st[k] for k in ("accept_rate", "step_size")}, {k: sj[k] for k in ("accept_rate", "step_size")},
                CHAIN_RTOL)
    assert st["ess_trials"].shape == (2, 20, 2) and int(st["ess_trials"].max()) < te.ESS_MAX_TRIALS
    assert st["host_syncs"] >= 20 * 2


def test_latent_conditional_proba(prob):
    """Probabilities integrated over 5 (θ, f) draws against the reference at
    rtol 1e-9."""
    rng = np.random.default_rng(6)
    S = 5
    u = {k: np.asarray(v) + 0.2 * rng.normal(size=(S, *np.shape(v))) for k, v in prob["u0"].items()}
    params = jp.constrain({k: jnp.asarray(v) for k, v in u.items()})
    f = rng.normal(scale=2.0, size=(S, N))
    xc, new = jnp.asarray(prob["xc"]), jnp.asarray(prob["new_c"])
    pj = je.latent_conditional_proba(prob["jspec"], params, jnp.asarray(f), xc, _zk(N, False), new,
                                     _zk(N_NEW, False))
    pt = te.latent_conditional_proba(prob["spec"], params_from_numpy(params, dtype=torch.float64, device="cpu"),
                                     torch.tensor(f), torch.tensor(prob["xc"]), _zk(N, True),
                                     torch.tensor(prob["new_c"]), _zk(N_NEW, True))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=RTOL)


# ------------------------------------------------------------------
# The named f32 divergence: the prior factor's floor
# ------------------------------------------------------------------


def _smooth_problem(n=400):
    """An ExpQuad prior at a long lengthscale over many rows: its spectrum
    falls far below f32's rounding of the factorization."""
    pr = _problem(n, seed=7)
    pr["u0"] = dict(pr["u0"], ls_total=np.log(np.array([1.5, 1.5])), η_total=np.log(np.array(3.0)))
    return pr


def test_prior_factor_floor_factors_at_f32_where_the_reference_does_not():
    """The reference's K + 1e-6·I at f32 (N = 400, ls 1.5, η 3) does not
    factor; the port's floor max(1e-6, N·eps·mean diag K) does, and the
    factor reproduces K + floor·I to f32 rounding."""
    pr = _smooth_problem()
    assert np.isnan(_L(pr, dtype=np.float32)).any()
    xc = torch.tensor(pr["xc"], dtype=torch.float32)
    u = params_from_numpy(pr["u0"], dtype=torch.float32, device="cpu")
    L = te._chol_K(pr["spec"], _one_chain(u), xc, _zk(400, True), 1e-6)[0]
    assert bool(torch.isfinite(L).all())
    K = te._floored(gram(pr["spec"], constrain(u), xc, _zk(400, True), xc, _zk(400, True)), 1e-6)
    assert float((L @ L.T - K).abs().max()) <= 1e-4 * float(K.abs().max())


def test_slice_steps_move_at_f32_where_the_reference_factor_is_nan():
    """With the reference's NaN factor every slice trial reads −inf, so each
    step runs to the cap and keeps ν; with the port's floor the steps accept
    within a few trials and move."""
    pr = _smooth_problem()
    xc = torch.tensor(pr["xc"], dtype=torch.float32)
    y = torch.tensor(pr["y"], dtype=torch.float32)
    nu = torch.randn(400, generator=torch.Generator().manual_seed(0), dtype=torch.float32)
    stream = TorchStream(torch.Generator().manual_seed(1), torch.float32, "cpu")
    L_ref = torch.tensor(_L(pr, dtype=np.float32))
    counts = {}
    assert torch.equal(te._ess_step(stream, nu, L_ref, y, te.bernoulli_loglik, counts), nu)
    assert int(counts["trials"]) == te.ESS_MAX_TRIALS
    L = te._chol_K(pr["spec"], _one_chain(params_from_numpy(pr["u0"], dtype=torch.float32, device="cpu")), xc,
                   _zk(400, True), 1e-6)[0]
    out = te._ess_step(stream, nu, L, y, te.bernoulli_loglik, counts)
    assert int(counts["trials"]) < 50 and not torch.equal(out, nu)


def test_latent_conditional_proba_is_finite_at_f32_where_the_reference_is_nan():
    pr = _smooth_problem()
    params = jp.constrain({k: jnp.asarray(v, jnp.float32)[None] for k, v in pr["u0"].items()})
    f = np.random.default_rng(8).normal(size=(1, 400)).astype(np.float32)
    xc = jnp.asarray(pr["xc"], jnp.float32)
    new = jnp.asarray(pr["new_c"], jnp.float32)
    pj = je.latent_conditional_proba(pr["jspec"], params, jnp.asarray(f), xc, _zk(400, False), new,
                                     _zk(N_NEW, False))
    assert np.isnan(np.asarray(pj)).all()
    pt = te.latent_conditional_proba(pr["spec"], params_from_numpy(params, dtype=torch.float32, device="cpu"),
                                     torch.tensor(f), torch.tensor(pr["xc"], dtype=torch.float32), _zk(400, True),
                                     torch.tensor(pr["new_c"], dtype=torch.float32), _zk(N_NEW, True))
    assert bool(torch.isfinite(pt).all()) and bool(((pt > 0) & (pt < 1)).all())


def test_sampler_and_optimizer_entry_points_run_on_cuda_or_raise(prob):
    """With numpy inputs and no ``device``, ``ess_gpc_sample`` and
    ``optimize_acqf`` go to the CUDA card; on a host without one they raise
    instead of carrying on on the CPU. CPU tensors, or ``device="cpu"``,
    run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from gumbi_tpu_torch.ops.acquisition import optimize_acqf

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        te.ess_gpc_sample(prob["spec"], prob["u0"], prob["xc"], np.zeros((N, 0)), prob["y"], prob["la"], prob["lb"],
                          draws=1, tune=1)
    bounds = (np.zeros(2), np.ones(2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        optimize_acqf(lambda X: -(X**2).sum((-2, -1)), bounds, raw_samples=4, num_restarts=1, maxiter=2)
    x, _ = optimize_acqf(lambda X: -(X**2).sum((-2, -1)), bounds, raw_samples=4, num_restarts=1, maxiter=2,
                         device="cpu")
    assert x.device.type == "cpu" and x.dtype == torch.float64
    us, fs, _ = te.ess_gpc_sample(prob["spec"], prob["u0"], prob["xc"], np.zeros((N, 0)), prob["y"], prob["la"],
                                  prob["lb"], torch.Generator().manual_seed(0), draws=1, tune=1, device="cpu")
    assert fs.device.type == "cpu" and fs.dtype == torch.float64
