"""The port's heteroskedastic-input ``GP`` against the JAX reference.

At f64 on the CPU, on ``tests/test_het.py``'s generator (sin(1.2x), noise
sd 0.05 left of 0 and 0.5 right of it) at N = 120:

* one reference fit and one port fit (``het_iters=1``, ``tol=1e-12`` so that
  both L-BFGS stop at the optimum, not ~√tol along a flat direction): their
  MAPs, noise-GP parameters, ``noise_stats`` and ``noise_mult`` within the
  fit rule (values 1e-6, MAPs 1e-5), and the noise shape recovered;
* the reference's save loaded in the port, and the port's save loaded in
  the reference: ``predict`` with and without noise, ``draw_point_samples``
  on JAX's normal blocks (``test_torch_hmc.JaxStream``) and ``sample``'s
  objective at a point, each equal at 1e-8 (only the reference's predictor
  compiles);
* noisy draws add the homoskedastic noise diagonal, as the reference's do,
  where ``predict`` adds the heteroskedastic one (ROADMAP queue 3 names the
  mismatch, a fault of the reference matched here).

The restriction raises are in ``tests/test_torch_gp.py``
(``test_reference_raises_are_kept``).
"""

import importlib

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import gumbi_tpu as gmb
import gumbi_tpu_torch as gmt
import gumbi_tpu_torch.models.gp as port_gp
from gumbi_tpu_torch.ops import predict_cov, unconstrain
from test_torch_hmc import JaxStream

jmll = importlib.import_module("gumbi_tpu.ops.mll")

torch.set_num_threads(2)

FIT_VALUE_RTOL = 1e-6
FIT_MAP_RTOL = 1e-5
RTOL = 1e-8
HET_FIT = dict(outputs=["y"], continuous_dims=["x"], heteroskedastic_inputs=True,
               MAP_kwargs=dict(n_restarts=2, maxiter=150, tol=1e-12, het_iters=1))


def _het_df(n=120, seed=0):
    """``tests/test_het.py``'s ``_het_df``."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-2, 2, n))
    f = np.sin(1.2 * x)
    sd = np.where(x > 0, 0.5, 0.05)
    y = f + rng.normal(0, sd)
    return pd.DataFrame({"x": x, "y": y})


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """(reference, port) fitted on one table, and each one's save loaded in
    the other package: (ref, port, port_from_ref, ref_from_port)."""
    df = _het_df()
    ds_r, ds_p = gmb.DataSet(df, outputs=["y"]), gmt.DataSet(df, outputs=["y"])
    ref = gmb.GP(ds_r).fit(**HET_FIT)
    port = gmt.GP(ds_p, device="cpu").fit(**HET_FIT)
    d = tmp_path_factory.mktemp("het")
    ref.save(d / "ref.npz")
    port.save(d / "port.npz")
    return ref, port, gmt.GP.load(d / "ref.npz", ds_p, device="cpu"), gmb.GP.load(d / "port.npz", ds_r)


def test_het_fit_matches_the_reference_fit(fits):
    ref, port, _, _ = fits
    assert port.heteroskedastic_inputs and port._structure == "Hadamard"
    np.testing.assert_allclose(port._neg_logp, ref._neg_logp, rtol=FIT_VALUE_RTOL)
    for k, v in ref.MAP.items():
        np.testing.assert_allclose(port.MAP[k], v, rtol=FIT_MAP_RTOL, err_msg=k)
    for k, v in ref._noise_params.items():
        np.testing.assert_allclose(_np(port._noise_params[k]), np.asarray(v), rtol=FIT_MAP_RTOL, err_msg=k)
    np.testing.assert_allclose(port._noise_stats, ref._noise_stats, rtol=FIT_VALUE_RTOL)
    np.testing.assert_allclose(_np(port._noise_mult), np.asarray(ref._noise_mult), rtol=FIT_MAP_RTOL)
    # the noise shape is recovered: loud right half, quiet left half
    pts = port.parray(x=np.array([-1.5, 1.5]))
    nv = port.predict_points(pts, with_noise=True).σ2 - port.predict_points(pts, with_noise=False).σ2
    assert nv[1] / nv[0] > 5.0, nv


def _predictions(gp, xs):
    pts = gp.parray(x=xs)
    return [(np.asarray(u.μ), np.asarray(u.σ2)) for u in (gp.predict_points(pts, with_noise=w) for w in (True, False))]


@pytest.mark.parametrize("direction", ["reference_save_in_the_port", "port_save_in_the_reference"])
def test_saves_load_across_packages_and_predict_alike(fits, direction):
    """One MAP and one noise GP in both packages: ``predict`` with and
    without noise at 1e-8; the loaded model keeps ``heteroskedastic_inputs``
    and rebuilds its noise cache from ``noise_zt``."""
    ref, port, port_from_ref, ref_from_port = fits
    a, b = (ref, port_from_ref) if direction == "reference_save_in_the_port" else (port, ref_from_port)
    assert b.heteroskedastic_inputs and b._noise_params is not None
    xs = np.linspace(-1.8, 1.8, 7)
    for (ma, va), (mb, vb) in zip(_predictions(a, xs), _predictions(b, xs)):
        np.testing.assert_allclose(mb, ma, rtol=RTOL)
        np.testing.assert_allclose(vb, va, rtol=RTOL)
    np.testing.assert_allclose(np.asarray(b._noise_stats), np.asarray(a._noise_stats), rtol=0)


@pytest.mark.parametrize("with_noise", [False, True])
def test_draws_on_jax_normal_blocks_match_the_reference(fits, with_noise):
    """``draw_point_samples`` of the reference's fit loaded in the port, on
    JAX's normal block: the reference's draws. With noise they carry the
    homoskedastic noise diagonal (the reference's ``predict_cov``), not the
    heteroskedastic shape ``predict`` adds: a matched fault (ROADMAP queue 3)."""
    ref, _, port, _ = fits
    pr, pp = ref.parray(x=np.linspace(-1.5, 1.5, 5)), port.parray(x=np.linspace(-1.5, 1.5, 5))
    yr = ref.draw_point_samples(pr, n_samples=3, seed=5, with_noise=with_noise)
    yp = port.draw_point_samples(pp, n_samples=3, seed=5, with_noise=with_noise,
                                 stream=JaxStream(jax.random.PRNGKey(5)))
    np.testing.assert_allclose(yp["y"].values(), yr["y"].values(), rtol=RTOL)


def test_noisy_draws_take_the_homoskedastic_noise_where_predict_takes_the_heteroskedastic(fits):
    """The mismatch itself, on the port: the draws' covariance adds σ² on its
    diagonal at every point, ``predict`` adds σ²·exp(l(x) − l̄), which at
    x = 1.5 is several times σ²."""
    _, _, port, _ = fits
    xs = np.array([-1.5, 1.5])
    arr, _, _ = port._prepare_points_for_prediction(port.parray(x=xs), output=port.outputs)
    xc, xk = port._split_X(np.asarray(arr))
    cache = port._ensure_dense_cache()
    with torch.no_grad():
        _, cov_n = predict_cov(port._spec, port._params, cache, xc, xk, with_noise=True)
        _, cov = predict_cov(port._spec, port._params, cache, xc, xk, with_noise=False)
    sigma2 = float(port._params["σ"]) ** 2
    np.testing.assert_allclose(_np(torch.diagonal(cov_n - cov)), sigma2, rtol=1e-10)
    mn, vn = port.predict(arr, with_noise=True)
    _, v = port.predict(arr, with_noise=False)
    het = vn - v
    np.testing.assert_allclose(het, sigma2 * _np(port._het_noise_mult_at(xc, xk)), rtol=1e-10)
    assert het[1] > 2 * sigma2 and het[0] < 0.5 * sigma2, (het, sigma2)


def test_sample_objective_carries_the_noise_shape(fits, monkeypatch):
    """``sample``'s chain objective passes the fitted ``noise_mult``: at the
    MAP it is the reference's ``map_neg_logp`` with the reference's
    ``noise_mult`` (1e-8), on the port's load of the reference's save."""
    ref, _, port, _ = fits
    calls = []
    real = port_gp.map_neg_logp_chains

    def recorded(spec, uparams, *args, **kwargs):
        calls.append((spec, args, kwargs))
        return real(spec, uparams, *args, **kwargs)

    monkeypatch.setattr(port_gp, "map_neg_logp_chains", recorded)
    port.sample(draws=1, tune=1, chains=1, sampler="hmc", n_leapfrog=1, seed=0)
    spec, args, kwargs = calls[0]
    assert kwargs["noise_mult"] is port._noise_mult
    with torch.no_grad():
        first = real(spec, {k: v[None] for k, v in unconstrain(port._params).items()}, *args, **kwargs)
    u = {k: jnp.asarray(_np(v)) for k, v in unconstrain(port._params).items()}
    f_ref = float(jmll.map_neg_logp(ref._spec, u, ref._xc, ref._xk, ref._yz, jnp.asarray(ref._ls_alpha),
                                    jnp.asarray(ref._ls_beta), noise_mult=ref._noise_mult))
    np.testing.assert_allclose(float(first[0]), f_ref, rtol=RTOL)


def test_chip_smoke_het_phase_runs_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 20 run at N = 256 and one alternation, f64 on
    the CPU: the noise shape and the NLPD margin hold, the f32 − f64 gaps
    read zero at f64, and save → load predicts bit-equal."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs

    r = cs.phase20_run(device="cpu", dtype=torch.float64, n=cs.HET_SMALL["n"], map_kw=cs.HET_SMALL["map_kw"],
                       tmp_dir=str(tmp_path))
    assert r["ratio"] > cs.HET_RATIO_MIN and abs(r["ratio0"] - 1.0) < 1e-3
    assert r["nlpd"] <= r["nlpd0"] - cs.HET_NLPD_MARGIN
    assert r["per_pt"] == 0.0 and max(max(v) for v in r["gaps"].values()) == 0.0
    assert r["loaded_equal"] and r["loaded_het"]
    assert [k for k in r["stages"] if k.startswith("het_")] == ["het_fit_0", "het_noise_1", "het_fit_1"]
