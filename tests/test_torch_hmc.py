"""Port parity: gumbi_tpu_torch.ops.hmc against gumbi_tpu.ops.hmc.

The building blocks (dual averaging, the leapfrog integrator, the Halton
sequence) against the reference's; short ``hmc_sample`` and
``chees_sample`` chains on a small GP hyperparameter posterior given JAX's
own draws, replayed through :class:`JaxStream` from the same key splits, held
draw by draw; the reference's standard-normal moment tests on the port with a
``torch.Generator``; and the chain-batched objective against per-chain
evaluation. f64 on the CPU; tolerances are stated per test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

import gumbi_tpu.ops.hmc as jh
import gumbi_tpu.ops.kernels as jk
import gumbi_tpu.ops.priors as jp
import gumbi_tpu_torch.ops.hmc as th
from gumbi_tpu.ops.mll import map_neg_logp as j_map_neg_logp
from gumbi_tpu_torch.convert import params_from_numpy, spec_from_reference
from gumbi_tpu_torch.ops.mll import map_neg_logp, map_neg_logp_chains
from gumbi_tpu_torch.ops.priors import log_prior, log_prior_chains
from gumbi_tpu_torch.utils.torch_utils import TorchStream, ravel_tree

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
# Draw by draw, relative to each parameter's largest entry (some entries
# cross zero): the two packages' f64 gradients differ in the last bits, and
# the warmup's step-size adaptation carries that into the draws (with no
# warmup the port's HMC draws equal the reference's to the last bit).
CHAIN_RTOL = 1e-8


class JaxStream:
    """The port's random-stream interface over JAX keys (leading axes are
    chains): ``split``, ``split_chains``, ``fold_in``, ``normal`` and
    ``uniform`` call ``jax.random`` as the reference's samplers do, so a
    port sampler given this stream draws the reference's numbers."""

    def __init__(self, keys):
        self.keys = jnp.asarray(keys)

    def _flat(self):
        return self.keys.reshape(-1, 2)

    def _lead(self):
        return self.keys.shape[:-1]

    def split(self, n):
        ks = _split(self._flat(), n)
        return tuple(JaxStream(ks[:, i].reshape(*self._lead(), 2)) for i in range(n))

    def split_chains(self, n):
        assert self._lead() == ()
        return JaxStream(jax.random.split(self.keys, n))

    def fold_in(self, data):
        return JaxStream(_fold_in(self._flat(), data).reshape(self.keys.shape))

    def normal(self, shape=()):
        return torch.from_numpy(np.array(_normal(self._flat(), tuple(shape))).reshape((*self._lead(), *shape)))

    def uniform(self, shape=()):
        return torch.from_numpy(np.array(_uniform(self._flat(), tuple(shape))).reshape((*self._lead(), *shape)))


_split = jax.jit(lambda ks, n: jax.vmap(lambda k: jax.random.split(k, n))(ks), static_argnums=1)
_fold_in = jax.jit(lambda ks, d: jax.vmap(lambda k: jax.random.fold_in(k, d))(ks), static_argnums=1)
_normal = jax.jit(lambda ks, s: jax.vmap(lambda k: jax.random.normal(k, s, dtype=jnp.float64))(ks), static_argnums=1)
_uniform = jax.jit(lambda ks, s: jax.vmap(lambda k: jax.random.uniform(k, s, dtype=jnp.float64))(ks),
                   static_argnums=1)


# ------------------------------------------------------------------
# A small GP hyperparameter posterior in both packages
# ------------------------------------------------------------------


def _gp_problem(n=16, seed=3):
    rng = np.random.default_rng(seed)
    jspec = jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2)
    xc = rng.uniform(-2, 2, size=(n, 2))
    y = np.sin(1.3 * xc[:, 0]) * np.cos(0.9 * xc[:, 1]) + rng.normal(0, 0.1, n)
    la, lb = jp.ls_prior_params([0.3, 0.3], [4.0, 4.0])
    u0 = {k: np.asarray(v[0]) for k, v in jp.initial_params(jspec, la, lb, 1, seed=seed).items()}
    return dict(jspec=jspec, spec=spec_from_reference(jspec), xc=xc, y=y, la=la, lb=lb, u0=u0)


@pytest.fixture(scope="module")
def gp():
    return _gp_problem()


def _jax_logp(pr):
    xc, y = jnp.asarray(pr["xc"]), jnp.asarray(pr["y"])
    xk = jnp.zeros((len(xc), 0), jnp.int32)
    la, lb = jnp.asarray(pr["la"]), jnp.asarray(pr["lb"])
    return lambda u: -j_map_neg_logp(pr["jspec"], u, xc, xk, y, la, lb)


def _torch_logp(pr, batched):
    xc, y = torch.tensor(pr["xc"]), torch.tensor(pr["y"])
    xk = torch.zeros((len(xc), 0), dtype=torch.long)
    la, lb = torch.tensor(pr["la"]), torch.tensor(pr["lb"])
    fn = map_neg_logp_chains if batched else map_neg_logp
    return lambda u: -fn(pr["spec"], u, xc, xk, y, la, lb)


def _close_tree(t, j, rtol):
    assert set(t) == set(j)
    for k in j:
        ref = np.asarray(j[k])
        np.testing.assert_allclose(t[k].numpy(), ref, rtol=rtol, atol=rtol * np.abs(ref).max(), err_msg=k)


# ------------------------------------------------------------------
# Building blocks
# ------------------------------------------------------------------


def test_ravel_tree_matches_ravel_pytree_order():
    """The port's flat order is ravel_pytree's (keys sorted), and unravel
    keeps leading (chain, draw) axes."""
    rng = np.random.default_rng(0)
    tree = {"σ": rng.normal(), "ls_total": rng.normal(size=3), "W_Parameter": rng.normal(size=(2, 2)),
            "η_total": rng.normal()}
    flat_j, unravel_j = ravel_pytree({k: jnp.asarray(v) for k, v in tree.items()})
    flat_t, unravel_t = ravel_tree({k: torch.tensor(v, dtype=torch.float64) for k, v in tree.items()})
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    batch = rng.normal(size=(3, 5, flat_t.shape[0]))
    out = unravel_t(torch.tensor(batch))
    for c in range(3):
        for d in range(5):
            ref = unravel_j(jnp.asarray(batch[c, d]))
            for k in tree:
                np.testing.assert_array_equal(out[k][c, d].numpy(), np.asarray(ref[k]))


def test_da_update_matches_the_reference():
    """Dual averaging, step by step over 50 updates, to the last bit or one
    ulp (the reference's pow and sqrt run in XLA, the port's in C)."""
    rng = np.random.default_rng(1)
    js = jh._DAState(*(jnp.asarray(v) for v in (np.log(0.05), 0.0, 0.0, np.log(0.5))))
    ts = th._DAState(*(torch.tensor(v, dtype=torch.float64) for v in (np.log(0.05), 0.0, 0.0, np.log(0.5))))
    for t in range(50):
        a = float(rng.uniform())
        js = jh._da_update(js, jnp.asarray(a), jnp.asarray(float(t)), 0.8)
        ts = th._da_update(ts, torch.tensor(a, dtype=torch.float64), float(t), 0.8)
        for tv, jv in zip(ts, js):
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=4e-16, atol=0.0)


def test_leapfrog_matches_the_reference():
    """n steps of the integrator on a non-quadratic target: positions and
    momenta within 1e-13 (autograd and jax.grad differ in the last bits);
    the port makes one gradient evaluation a step, the reference two."""
    scale = np.array([0.5, 1.0, 2.0])

    def logp_j(q):
        return -0.5 * jnp.sum(q**2 / scale**2) + jnp.sum(jnp.sin(q))

    calls = []

    def vg_t(q):
        calls.append(1)
        qq = q.detach().requires_grad_(True)
        v = -0.5 * (qq**2 / torch.tensor(scale) ** 2).sum(-1) + torch.sin(qq).sum(-1)
        (g,) = torch.autograd.grad(v.sum(), qq)
        return v.detach(), g

    rng = np.random.default_rng(2)
    q, p = rng.normal(size=3), rng.normal(size=3)
    inv_mass = rng.uniform(0.5, 2.0, size=3)
    qj, pj = jh._leapfrog(jax.grad(logp_j), jnp.asarray(q), jnp.asarray(p), 0.13, jnp.asarray(inv_mass), 12)
    qt, pt, _, _ = th._leapfrog(vg_t, torch.tensor(q), torch.tensor(p), 0.13, torch.tensor(inv_mass), 12)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-13)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-13)
    assert len(calls) == 13


def test_halton2_is_the_reference_sequence():
    np.testing.assert_array_equal(th._halton2(1000), jh._halton2(1000))


# ------------------------------------------------------------------
# The chain-batched objective
# ------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_chain_batched_value_and_grad_equals_per_chain(gp, masked):
    """``map_neg_logp_chains`` at C = 5 points against ``map_neg_logp`` at
    each: values and gradients at rtol 1e-12 (one batched factor and solve
    against C separate ones), with and without a bucket mask and a per-row
    noise factor; ``log_prior_chains`` against ``log_prior``."""
    rng = np.random.default_rng(4)
    n = len(gp["y"])
    xc, y = torch.tensor(gp["xc"]), torch.tensor(gp["y"])
    xk = torch.zeros((n, 0), dtype=torch.long)
    la, lb = torch.tensor(gp["la"]), torch.tensor(gp["lb"])
    mask = torch.tensor((np.arange(n) < n - 3).astype(float)) if masked else None
    nm = torch.tensor(rng.uniform(0.5, 2.0, n)) if masked else None
    u = {k: torch.tensor(np.asarray(v) + 0.3 * rng.normal(size=(5, *np.shape(v))), requires_grad=True)
         for k, v in gp["u0"].items()}
    vb = map_neg_logp_chains(gp["spec"], u, xc, xk, y, la, lb, mask=mask, noise_mult=nm)
    gb = torch.autograd.grad(vb.sum(), list(u.values()))
    for c in range(5):
        uc = {k: v[c].detach().requires_grad_(True) for k, v in u.items()}
        vc = map_neg_logp(gp["spec"], uc, xc, xk, y, la, lb, mask=mask, noise_mult=nm)
        gc = torch.autograd.grad(vc, list(uc.values()))
        np.testing.assert_allclose(float(vb[c].detach()), float(vc.detach()), rtol=1e-12)
        for a, b in zip(gb, gc):
            np.testing.assert_allclose(a[c].numpy(), b.numpy(), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(float(log_prior_chains(gp["spec"], u, la, lb)[c].detach()),
                                   float(log_prior(gp["spec"], uc, la, lb).detach()), rtol=1e-14)


def test_per_chain_and_batched_contracts_give_the_same_chain(gp):
    """``hmc_sample`` with the per-point log density (chains evaluated one
    after another) and with the chain-batched one, on the same generator
    seed: the same draws to rtol 1e-12."""
    q0 = params_from_numpy(gp["u0"], **F64)
    runs = [th.hmc_sample(_torch_logp(gp, b), q0, torch.Generator().manual_seed(5), draws=5, tune=5, n_leapfrog=6,
                          chain_batched=b)[0] for b in (False, True)]
    _close_tree(runs[1], {k: v.numpy() for k, v in runs[0].items()}, 1e-12)


# ------------------------------------------------------------------
# Short chains on JAX's replayed draws
# ------------------------------------------------------------------


@pytest.fixture(scope="module")
def hmc_pair(gp):
    kw = dict(draws=10, tune=20, n_leapfrog=8, chains=2)
    sj, stj = jh.hmc_sample(_jax_logp(gp), {k: jnp.asarray(v) for k, v in gp["u0"].items()}, jax.random.PRNGKey(7),
                            **kw)
    st, stt = th.hmc_sample(_torch_logp(gp, True), params_from_numpy(gp["u0"], **F64), stream=JaxStream(
        jax.random.PRNGKey(7)), chain_batched=True, **kw)
    return (sj, stj), (st, stt)


def test_hmc_sample_replays_the_reference_draw_by_draw(hmc_pair):
    (sj, stj), (st, stt) = hmc_pair
    assert st["ls_total"].shape == (2, 10, 2)
    _close_tree(st, sj, CHAIN_RTOL)
    np.testing.assert_allclose(stt["accept_prob"].numpy(), np.asarray(stj["accept_prob"]), rtol=CHAIN_RTOL, atol=1e-12)
    assert 0.0 < float(stt["mean_accept"]) <= 1.0


@pytest.fixture(scope="module")
def chees_pair(gp):
    kw = dict(draws=10, tune=20, chains=4)
    sj, stj = jh.chees_sample(_jax_logp(gp), {k: jnp.asarray(v) for k, v in gp["u0"].items()},
                              jax.random.PRNGKey(11), **kw)
    st, stt = th.chees_sample(_torch_logp(gp, True), params_from_numpy(gp["u0"], **F64),
                              stream=JaxStream(jax.random.PRNGKey(11)), chain_batched=True, **kw)
    return (sj, stj), (st, stt)


def test_chees_sample_replays_the_reference_draw_by_draw(chees_pair):
    """Draws, acceptance and the adapted step size, trajectory length and
    mean leapfrog count (integers: equal)."""
    (sj, stj), (st, stt) = chees_pair
    assert st["ls_total"].shape == (4, 10, 2)
    _close_tree(st, sj, CHAIN_RTOL)
    np.testing.assert_allclose(stt["accept_prob"].numpy(), np.asarray(stj["accept_prob"]), rtol=CHAIN_RTOL, atol=1e-12)
    for k in ("trajectory_length", "step_size", "mean_accept"):
        np.testing.assert_allclose(float(stt[k]), float(stj[k]), rtol=CHAIN_RTOL, err_msg=k)
    assert float(stt["mean_leapfrog"]) == float(stj["mean_leapfrog"])
    assert len(stt["n_leapfrog"]) == 30 and stt["n_leapfrog"].min() >= 1


def test_chees_keeps_non_finite_proposals_out_of_its_criterion():
    """A named divergence: on a density whose value and gradient are NaN
    outside |x| < 1 (as an f32 factorization fails outside a region),
    trajectories that leave it are rejected in both packages, but in the
    reference their 0·NaN enters the ChEES criterion and makes the
    trajectory length NaN; the port keeps them out, and its adaptation and
    draws stay finite and inside the support."""

    def logp_j(q):
        return jnp.sum(jnp.log(jnp.sqrt(1.0 - q["x"] ** 2)))

    def logp_t(q):
        return torch.log(torch.sqrt(1.0 - q["x"] ** 2)).sum(-1)

    kw = dict(draws=50, tune=100, chains=8)
    _, stj = jh.chees_sample(logp_j, {"x": jnp.zeros(2)}, jax.random.PRNGKey(0), **kw)
    assert np.isnan(float(stj["trajectory_length"]))
    st, stt = th.chees_sample(logp_t, {"x": torch.zeros(2, dtype=torch.float64)}, torch.Generator().manual_seed(0),
                              chain_batched=True, **kw)
    assert np.isfinite(float(stt["trajectory_length"])) and 0.0 < float(stt["step_size"]) < 10.0
    assert bool((st["x"].abs() < 1.0).all()) and 0.5 < float(stt["mean_accept"]) <= 1.0


def test_hmc_keeps_unit_mass_where_a_chain_has_not_moved():
    """A named divergence: on a narrow Gaussian (sd 0.002) the first warmup
    steps are unstable and rejected, so each chain's Welford variance is
    exactly 0 at the third step; the reference then sets the inverse mass
    to 0, its momentum is infinite, and its chains never move again. The
    port keeps unit mass there, the step size adapts, and the draws recover
    the scale (within 20%)."""
    sd = 0.002

    def logp_j(q):
        return -0.5 * jnp.sum((q["x"] / sd) ** 2)

    def logp_t(q):
        return -0.5 * ((q["x"] / sd) ** 2).sum(-1)

    kw = dict(draws=300, tune=200, chains=2, n_leapfrog=16)
    _, stj = jh.hmc_sample(logp_j, {"x": jnp.zeros(3)}, jax.random.PRNGKey(0), **kw)
    assert float(stj["mean_accept"]) == 0.0
    st, stt = th.hmc_sample(logp_t, {"x": torch.zeros(3, dtype=torch.float64)}, torch.Generator().manual_seed(0),
                            chain_batched=True, **kw)
    assert float(stt["mean_accept"]) > 0.5
    np.testing.assert_allclose(st["x"].reshape(-1, 3).std(0).numpy(), sd, rtol=0.2)


# ------------------------------------------------------------------
# The reference's moment tests (tests/test_extras.py), on the port
# ------------------------------------------------------------------


def _anisotropic(q):
    return -0.5 * (q["x"] ** 2).sum(-1) - 0.5 * ((q["z"] - 2.0) ** 2 / 4.0).sum(-1)


def _moments(samples):
    xs = samples["x"].reshape(-1, 3).numpy()
    zs = samples["z"].reshape(-1, 2).numpy()
    assert np.allclose(xs.mean(0), 0.0, atol=0.15)
    assert np.allclose(xs.std(0), 1.0, atol=0.2)
    assert np.allclose(zs.mean(0), 2.0, atol=0.3)
    assert np.allclose(zs.std(0), 2.0, atol=0.4)


def test_hmc_standard_normal():
    """tests/test_extras.py's HMC moment test (same sizes and bounds) with a
    torch.Generator and the per-point contract."""
    q0 = {"x": torch.zeros(3, dtype=torch.float64), "z": torch.zeros(2, dtype=torch.float64)}
    samples, stats = th.hmc_sample(_anisotropic, q0, torch.Generator().manual_seed(0), draws=800, tune=400, chains=2,
                                   n_leapfrog=16)
    assert float(stats["mean_accept"]) > 0.5
    _moments(samples)


def test_chees_standard_normal():
    """tests/test_extras.py's ChEES moment test (same sizes and bounds) with a
    torch.Generator and the chain-batched contract."""
    q0 = {"x": torch.zeros(3, dtype=torch.float64), "z": torch.zeros(2, dtype=torch.float64)}
    samples, stats = th.chees_sample(_anisotropic, q0, torch.Generator().manual_seed(0), draws=800, tune=600,
                                     chains=16, chain_batched=True)
    assert 0.5 < float(stats["mean_accept"]) < 1.0
    assert float(stats["trajectory_length"]) > 0.0
    assert float(stats["step_size"]) > 0.0
    _moments(samples)


def test_torch_stream_draws_in_the_sampler_shapes():
    """The generator-backed stream: a split only names the draw, chains add
    a leading axis, and the same seed gives the same draws."""
    s = TorchStream(torch.Generator().manual_seed(3), torch.float64, "cpu")
    c = s.split_chains(4)
    a, b = c.split(2)
    assert a.normal((3,)).shape == (4, 3) and b.uniform().shape == (4,)
    assert s.fold_in(1).normal((2, 5)).shape == (2, 5)
    s1, s2 = (TorchStream(torch.Generator().manual_seed(9), torch.float64, "cpu") for _ in range(2))
    np.testing.assert_array_equal(s1.normal((6,)).numpy(), s2.normal((6,)).numpy())
