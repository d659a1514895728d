"""The port's framework-free model-layer modules against the JAX package's.

``gumbi_tpu_torch`` carries copies of ``gumbi_tpu``'s utils, arrays,
``Standardizer``, aggregation, data and ``Regressor`` (the reference
package imports JAX, so the port cannot import them). These tests hold:

* every copied class and function's source equal to the reference's, apart
  from import lines and the ``Standardizer``'s one substitution
  (``_is_series`` for ``isinstance(x, pd.Series)``);
* the ``Standardizer`` and the structured arrays giving the reference's
  numbers on the same inputs;
* ``import gumbi_tpu_torch`` (and its arrays, models and array table) free
  of pandas, with ``DataSet`` raising an ``ImportError`` that names it;
* ``tools/array_table.py``'s ``GP`` (the card's stand-in for the pandas
  front end) building the state and predictions of the ``DataSet`` path.
"""

import inspect
import os
import re
import subprocess
import sys
from dataclasses import asdict

import numpy as np
import pandas as pd
import pytest
import torch

import gumbi_tpu as gmb
import gumbi_tpu.aggregation
import gumbi_tpu.array_utils
import gumbi_tpu.arrays
import gumbi_tpu.data
import gumbi_tpu.models.base
import gumbi_tpu.utils.generic_utils
import gumbi_tpu.utils.gp_utils
import gumbi_tpu.utils.misc
import gumbi_tpu.utils.profiling
import gumbi_tpu_torch as gmt
import gumbi_tpu_torch.aggregation
import gumbi_tpu_torch.array_utils
import gumbi_tpu_torch.arrays
import gumbi_tpu_torch.data
import gumbi_tpu_torch.models.base
import gumbi_tpu_torch.standardizer
import gumbi_tpu_torch.utils.generic_utils
import gumbi_tpu_torch.utils.gp_utils
import gumbi_tpu_torch.utils.misc
import gumbi_tpu_torch.utils.profiling
from gumbi_tpu_torch.tools.array_table import ArrayTable, ArrayTableGP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)

_IMPORT = re.compile(r"^\s*(import \S|from \S+ import )")


def _body(obj, subs=()):
    """Source lines of ``obj`` without import lines or blank lines."""
    src = inspect.getsource(obj)
    for old, new in subs:
        src = src.replace(old, new)
    return [line for line in src.splitlines() if line.strip() and not _IMPORT.match(line)]


def _defined_in(module):
    return {
        name: obj
        for name, obj in vars(module).items()
        if (inspect.isclass(obj) or inspect.isfunction(obj)) and obj.__module__ == module.__name__
    }


# (reference module, port module, names the port does not carry as copies)
COPIES = {
    "utils.misc": (gumbi_tpu.utils.misc, gumbi_tpu_torch.utils.misc, ()),
    "utils.generic_utils": (gumbi_tpu.utils.generic_utils, gumbi_tpu_torch.utils.generic_utils, ()),
    "utils.gp_utils": (gumbi_tpu.utils.gp_utils, gumbi_tpu_torch.utils.gp_utils, ()),
    # profile_trace moves from jax.profiler to torch.profiler
    "utils.profiling": (gumbi_tpu.utils.profiling, gumbi_tpu_torch.utils.profiling, ("profile_trace",)),
    "arrays": (gumbi_tpu.arrays, gumbi_tpu_torch.arrays, ()),
    "array_utils": (gumbi_tpu.array_utils, gumbi_tpu_torch.array_utils, ()),
    # Standardizer moved to gumbi_tpu_torch.standardizer (held below)
    "aggregation": (gumbi_tpu.aggregation, gumbi_tpu_torch.aggregation, ("Standardizer",)),
    # the lazy example_dataset accessor replaces the reference's import-time write
    "data": (gumbi_tpu.data, gumbi_tpu_torch.data, ("_ExampleDatasetPath",)),
    "models.base": (gumbi_tpu.models.base, gumbi_tpu_torch.models.base, ()),
}


@pytest.mark.parametrize("name", list(COPIES))
def test_copied_sources_equal_the_reference(name):
    ref_mod, port_mod, skipped = COPIES[name]
    ref = {k: v for k, v in _defined_in(ref_mod).items() if k not in skipped}
    port = _defined_in(port_mod)
    assert ref, name
    missing = sorted(set(ref) - set(port))
    assert not missing, f"{name}: not carried into the port: {missing}"
    for attr, obj in ref.items():
        assert _body(obj) == _body(port[attr]), f"{name}.{attr} differs from the reference"


def test_standardizer_source_equals_the_reference_but_its_series_test():
    port = gumbi_tpu_torch.standardizer
    sub = [("isinstance(name, pd.Series)", "_is_series(name)")]
    assert _body(gumbi_tpu.aggregation.Standardizer, sub) == _body(port.Standardizer)
    assert port._is_series(pd.Series([1.0])) and not port._is_series(np.ones(2))
    assert gumbi_tpu_torch.aggregation.Standardizer is port.Standardizer


# ------------------------------------------------------------------
# Numbers: the Standardizer and the structured arrays on the same inputs
# ------------------------------------------------------------------

MOMENTS = {
    "a": {"μ": -0.762, "σ2": 1.258**2},
    "d": {"μ": -0.307, "σ2": 0.158**2},
    "e": {"μ": -1.056, "σ2": 0.398**2},
    "Y": {"μ": 4.48, "σ2": 0.75**2},
}
LOG, LOGIT = ["d", "Y"], ["e"]


def _stdzrs():
    return (
        gmb.Standardizer(**MOMENTS, log_vars=LOG, logit_vars=LOGIT),
        gmt.Standardizer(**MOMENTS, log_vars=LOG, logit_vars=LOGIT),
    )


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    np.testing.assert_array_equal(np.asarray(a, dtype=float), np.asarray(b, dtype=float))


def test_standardizer_round_trips_match_the_reference():
    ref, port = _stdzrs()
    rng = np.random.default_rng(0)
    values = {"a": rng.normal(size=7), "d": rng.uniform(0.1, 2, 7), "e": rng.uniform(0.05, 0.95, 7),
              "Y": rng.uniform(10, 800, 7), "unknown": rng.normal(size=7)}
    for name, x in values.items():
        for method in ("transform", "untransform", "stdz", "unstdz"):
            _same(getattr(ref, method)(name, x), getattr(port, method)(name, x))
            _same(getattr(ref, method)(name, x, 0.3), getattr(port, method)(name, x, 0.3))
        np.testing.assert_allclose(port.unstdz(name, port.stdz(name, x)), x, rtol=1e-12)
        s = pd.Series(x, name=name)
        _same(ref.stdz(s), port.stdz(s))
        _same(ref.unstdz(s), port.unstdz(s))
    frame = pd.DataFrame({k: v for k, v in values.items() if k != "unknown"})
    kw = dict(log_vars=LOG, logit_vars=LOGIT, isotropic_vars=["a"])
    r, p = gmb.Standardizer.from_DataFrame(frame, **kw), gmt.Standardizer.from_DataFrame(frame, **kw)
    assert dict(r) == dict(p) and r.log_vars == p.log_vars and r.logit_vars == p.logit_vars
    merged_r, merged_p = ref | {"z": {"μ": 1.0, "σ": 2.0}}, port | {"z": {"μ": 1.0, "σ": 2.0}}
    assert dict(merged_r) == dict(merged_p) and merged_p.transforms.keys() == merged_r.transforms.keys()


def test_arrays_arithmetic_matches_the_reference():
    sr, sp = _stdzrs()
    rng = np.random.default_rng(1)
    d, Y = rng.uniform(0.2, 1.5, 6), rng.uniform(20, 500, 6)

    pr, pp = gmb.parray(d=d, Y=Y, stdzr=sr), gmt.parray(d=d, Y=Y, stdzr=sp)
    for view in ("z", "t"):
        _same(getattr(pr, view).values(), getattr(pp, view).values())
    _same(pr.add_layers(a=np.ones(6)).z.values(), pp.add_layers(a=np.ones(6)).z.values())
    _same(gmb.parray.vstack([pr[:, None]] * 2).values(), gmt.parray.vstack([pp[:, None]] * 2).values())
    _same(gmb.vstack([pr, pr]).values(), gmt.vstack([pp, pp]).values())

    μ, σ2 = rng.uniform(0.2, 1.0, 6), rng.uniform(0.01, 0.1, 6)
    ur, up = gmb.uparray("d", μ, σ2, stdzr=sr), gmt.uparray("d", μ, σ2, stdzr=sp)
    for fn in (lambda u: u + 0.5, lambda u: u * 2.0, lambda u: u / 3.0, lambda u: u - u[0],
               lambda u: u.z, lambda u: u.t, lambda u: u.sum(), lambda u: u.mean()):
        a, b = fn(ur), fn(up)
        _same((a.μ, a.σ2), (b.μ, b.σ2))
    _same(ur.dist.ppf(0.9), up.dist.ppf(0.9))
    _same(ur.nlpd(d), up.nlpd(d))
    _same(ur.vEI(0.5, 0.1), up.vEI(0.5, 0.1))
    _same(ur.KLD(ur[::-1]), up.KLD(up[::-1]))

    cor = np.array([[1.0, 0.6], [0.6, 1.0]])
    ua_r, ua_p = gmb.uparray("Y", Y, σ2, stdzr=sr), gmt.uparray("Y", Y, σ2, stdzr=sp)
    mr, mp = gmb.mvuparray(ur, ua_r, cor=cor, stdzr=sr), gmt.mvuparray(up, ua_p, cor=cor, stdzr=sp)
    _same(mr[2].cov(), mp[2].cov())
    _same(mr.μ.values(), mp.μ.values())
    _same(mr.z.σ2.values(), mp.z.σ2.values())
    target_r, target_p = gmb.parray(d=d, Y=Y, stdzr=sr), gmt.parray(d=d, Y=Y, stdzr=sp)
    _same(mr.nlpd(target_r), mp.nlpd(target_p))
    _same(mr[0].mahalanobis(target_r[0]), mp[0].mahalanobis(target_p[0]))
    _same(mr[1].outlier_pval(target_r[1]), mp[1].outlier_pval(target_p[1]))
    _same(gmb.make_deltas_parray(stdzr=sr, scale="natural", d=[0.1, None]).values(),
          gmt.make_deltas_parray(stdzr=sp, scale="natural", d=[0.1, None]).values())


# ------------------------------------------------------------------
# The pandas line
# ------------------------------------------------------------------

def test_package_imports_without_pandas():
    """With pandas blocked, the package, its arrays, models and the array
    table import and fit; ``DataSet`` raises an ImportError naming pandas."""
    code = """
import sys
sys.modules["pandas"] = None
import numpy as np
import gumbi_tpu_torch as gmt
import gumbi_tpu_torch.arrays, gumbi_tpu_torch.models, gumbi_tpu_torch.tools.array_table as at
assert gmt.GP is gumbi_tpu_torch.models.GP and gmt.parray is gumbi_tpu_torch.arrays.ParameterArray
assert gmt.uparray and gmt.mvuparray and gmt.Standardizer
rng = np.random.default_rng(0)
x = rng.uniform(-2, 2, 12)
table = at.ArrayTable({"x": x, "y": np.sin(x) + 0.1 * rng.normal(size=12)}, outputs=["y"])
gp = at.ArrayTableGP(table, device="cpu").fit(continuous_dims=["x"], MAP_kwargs=dict(n_restarts=1, maxiter=5))
gp.prepare_grid(resolution=5)
assert gp.predict_grid().shape == (5,)
try:
    gmt.DataSet
except ImportError as e:
    assert "pandas" in str(e), e
else:
    raise AssertionError("DataSet imported without pandas")
assert not any(m == "jax" or m.startswith(("jax.", "gumbi_tpu.")) for m in sys.modules)
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]


# ------------------------------------------------------------------
# tools/array_table.py against the DataSet path
# ------------------------------------------------------------------

def _cars_table(n=96):
    df = gmt.data.cars(n=n).drop(columns=["name"])
    kw = dict(outputs=["mpg", "acceleration"], log_vars=["mpg", "acceleration", "horsepower"])
    cols = {c: df[c].to_numpy() for c in df.columns}
    cols["origin"] = df["origin"].to_numpy(dtype=object)
    return gmt.DataSet(df, **kw), ArrayTable(cols, **kw)


def _bench_table(n=96):
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, size=(n, 2))
    f1 = np.sin(1.3 * X[:, 0]) * np.cos(0.9 * X[:, 1])
    cols = {"x1": X[:, 0], "x2": X[:, 1], "y1": f1 + rng.normal(0, 0.1, n),
            "y2": 0.7 * f1 + 0.3 * np.cos(1.1 * X[:, 0]) + rng.normal(0, 0.15, n)}
    return gmt.DataSet(pd.DataFrame(cols), outputs=["y1", "y2"]), ArrayTable(cols, outputs=["y1", "y2"])


TABLE_CASES = {
    # 2 outputs × categorical origin: Hadamard; the categorical coordinates go through the coercion
    "cars_hadamard_categorical": (_cars_table, dict(outputs=["mpg", "acceleration"],
                                                    continuous_dims=["horsepower", "weight"],
                                                    categorical_dims=["origin"]), {"origin": "japan"}),
    # one output: the names column becomes a filter dim
    "cars_single_output": (_cars_table, dict(outputs=["mpg"], continuous_dims=["horsepower"]), None),
    # bench.py's layout: Kronecker auto-selected
    "bench_kronecker": (_bench_table, dict(outputs=["y1", "y2"], continuous_dims=["x1", "x2"]), None),
}


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_array_table_gp_equals_the_dataset_path(case):
    make, fit_kw, cat_levels = TABLE_CASES[case]
    ds, table = make()
    map_kw = dict(n_restarts=2, maxiter=30)
    gd = gmt.GP(ds, device="cpu").fit(**fit_kw, MAP_kwargs=map_kw)
    gt = ArrayTableGP(table, device="cpu").fit(**fit_kw, MAP_kwargs=map_kw)

    assert dict(gd.stdzr) == dict(gt.stdzr) and gd.stdzr.log_vars == gt.stdzr.log_vars
    for attr in ("dims", "levels", "coords", "filter_dims", "outputs", "_structure"):
        assert getattr(gd, attr) == getattr(gt, attr), attr
    assert asdict(gd._spec) == asdict(gt._spec)
    Xd, yd = gd.get_shaped_data()
    Xt, yt = gt.get_shaped_data()
    np.testing.assert_array_equal(Xd, Xt)
    np.testing.assert_array_equal(yd, yt)
    for attr in ("_xc", "_xk", "_yz"):
        assert torch.equal(getattr(gd, attr), getattr(gt, attr)), attr
    if gd._structure == "Kronecker":
        assert torch.equal(gd._Y, gt._Y)
    np.testing.assert_array_equal(gd._ls_alpha, gt._ls_alpha)
    np.testing.assert_array_equal(gd._ls_beta, gt._ls_beta)
    for k in gd.MAP:
        np.testing.assert_allclose(gt.MAP[k], gd.MAP[k], rtol=1e-12, atol=0)

    gd.prepare_grid(resolution=7)
    gt.prepare_grid(resolution=7)
    levels = None if cat_levels is None else cat_levels
    yd_, yt_ = gd.predict_grid(categorical_levels=levels), gt.predict_grid(categorical_levels=levels)
    names = fit_kw["outputs"]
    pairs = [(yd_, yt_)] if len(names) == 1 else [(yd_.get(o), yt_.get(o)) for o in names]
    for a, b in pairs:
        np.testing.assert_allclose(b.μ, a.μ, rtol=1e-12)
        np.testing.assert_allclose(b.σ2, a.σ2, rtol=1e-12)


def test_array_table_rejects_malformed_tables():
    with pytest.raises(ValueError, match="one length"):
        ArrayTable({"x": np.zeros(3), "y": np.zeros(4)}, outputs=["y"])
    with pytest.raises(ValueError, match="missing from columns"):
        ArrayTable({"x": np.zeros(3)}, outputs=["y"])
    ds, _ = _bench_table(8)
    with pytest.raises(TypeError, match="ArrayTable"):
        ArrayTableGP(ds, device="cpu")


def test_chip_smoke_model_phase_runs_on_the_cpu():
    """chip_smoke.py's phase 15 drivers at 96 locations, f64 on the CPU:
    each structure fits and predicts through the array table, the f32 − f64
    gaps read zero at f64, and the grid tracks the noise-free surface."""
    sys.path.insert(0, REPO)
    import chip_smoke

    table = chip_smoke.bench_table(96)
    kw = dict(map_kwargs=dict(n_restarts=2, maxiter=20), grid=6)
    runs = {mk: chip_smoke.run_model_fit(table, "cpu", torch.float64, multitask_kernel=mk, **kw)
            for mk in (None, "Hadamard", "Independent")}
    assert [r["gp"]._structure for r in runs.values()] == ["Kronecker", "Hadamard", "Independent"]
    for r in runs.values():
        assert r["y"].shape == (6, 6) and r["evals"] > 0
        assert r["launches"] == {"fit": 0, "predict": 0}  # no CUDA kernel on the CPU
        assert set(r["stages"]) == {"specify_model", "build_model", "find_MAP", "predict"}
        chip_smoke._check_cor("cpu", r["y"].cor)
    r = runs[None]
    _, _, per_pt, dmean, dvar = chip_smoke.kron_f64_gaps(r["gp"])
    assert per_pt < 1e-12 and dmean < 1e-10 and dvar < 1e-10
    rmse = chip_smoke.model_grid_errors(r["gp"], r["y"], table)
    assert max(rmse.values()) < 0.3, rmse
