"""The port's ``GP`` (``gumbi_tpu_torch/models/gp.py``) against the JAX reference.

At f64 on the CPU, on the bundled cars table:

* ``build_model`` builds the reference's state (spec, structure, engine
  arrays, priors) over a matrix of structures; it compiles nothing in JAX,
  so the matrix is cheap;
* the port fits and saves, and the reference's ``GP.load`` predicts the
  port's grid (rtol 1e-9) for the Kronecker, Hadamard-with-categorical and
  Independent structures, with no reference fit;
* one reference fit (the cars quickstart) loads in the port and predicts
  the reference's grid, and the port's own fit of it lands within the
  basin tolerance of the reference's objective;
* additive sublevel predictions match the reference's, and both raise
  alike where sublevels are undefined;
* the structures the reference refuses (heteroskedastic inputs with sparse,
  bucket, Kronecker, Independent or a mesh; ``shard_data`` with a bucket; a
  sparse ``predict(mesh=)``) raise in both packages, a ``mesh`` that is not
  a ``DeviceMesh`` raises ``TypeError``, and the entry points without
  ``device=`` run on CUDA or raise.
"""

from dataclasses import asdict

import numpy as np
import pandas as pd
import pytest
import torch

import gumbi_tpu as gmb
import gumbi_tpu_torch as gmt
from gumbi_tpu_torch.tools.array_table import ArrayTable, ArrayTableGP, ArrayTableGPC
from gumbi_tpu_torch.utils.profiling import timings

torch.set_num_threads(2)

BASIN_TOL = 0.005  # nats/point, tests/test_bench_quality.py's tolerance
OUTPUTS = ["mpg", "acceleration"]
LOG_VARS = ["mpg", "acceleration", "horsepower", "weight"]
MAP_KW = dict(n_restarts=2, maxiter=40)


def _frame(n):
    return gmb.data.cars(n=n).drop(columns=["name"])


def _datasets(n=60):
    df = _frame(n)
    return (gmb.DataSet(df, outputs=OUTPUTS, log_vars=LOG_VARS),
            gmt.DataSet(df, outputs=OUTPUTS, log_vars=LOG_VARS))


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _period(gp):
    return gp.parray(horsepower=60.0, weight=400.0, stdzd=False)


# name → (specify_model kwargs, build_model kwargs); ``period`` is filled per package
STRUCTURES = {
    "hadamard_categorical": (dict(outputs=OUTPUTS, continuous_dims=["horsepower", "weight"],
                                  categorical_dims=["origin"]), {}),
    "hadamard_forced": (dict(outputs=OUTPUTS, continuous_dims=["horsepower"]), dict(multitask_kernel="Hadamard")),
    "kronecker": (dict(outputs=OUTPUTS, continuous_dims=["horsepower", "weight"]), {}),
    "independent": (dict(outputs=OUTPUTS, continuous_dims=["horsepower"], categorical_dims=["origin"]),
                    dict(multitask_kernel="Independent")),
    "additive": (dict(outputs=["mpg"], continuous_dims=["horsepower"], categorical_dims=["origin"], additive=True),
                 {}),
    "linear_dims": (dict(outputs=["mpg"], continuous_dims=["horsepower", "weight"], linear_dims=["weight"]), {}),
    "periodic": (dict(outputs=["mpg"], continuous_dims=["horsepower", "weight"]),
                 dict(continuous_kernel="ExpQuad+Periodic", period=_period)),
    "ard_off": (dict(outputs=OUTPUTS, continuous_dims=["horsepower", "weight"]), dict(ARD=False)),
    "bucket": (dict(outputs=OUTPUTS, continuous_dims=["horsepower"]), dict(bucket=64)),
}


def _build(gp, name):
    spec_kw, build_kw = STRUCTURES[name]
    build_kw = {k: (v(gp) if callable(v) else v) for k, v in build_kw.items()}
    gp.specify_model(**spec_kw)
    gp.build_model(**build_kw)
    return gp


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_build_model_state_matches_the_reference(name):
    ds_ref, ds_port = _datasets()
    ref = _build(gmb.GP(ds_ref), name)
    port = _build(gmt.GP(ds_port, device="cpu"), name)

    assert port._dtype == torch.float64
    assert asdict(port._spec) == asdict(ref._spec)
    assert port._structure == ref._structure
    for attr in ("dims", "levels", "coords", "filter_dims"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    for attr in ("_xc", "_xk", "_yz"):
        np.testing.assert_array_equal(_np(getattr(port, attr)), _np(getattr(ref, attr)), err_msg=attr)
    np.testing.assert_array_equal(port._ls_alpha, ref._ls_alpha)
    np.testing.assert_array_equal(port._ls_beta, ref._ls_beta)
    assert (port._mask is None) == (ref._mask is None)
    if ref._mask is not None:
        np.testing.assert_array_equal(_np(port._mask), _np(ref._mask))
    if ref._structure == "Kronecker":
        np.testing.assert_array_equal(_np(port._Y), _np(ref._Y))
        np.testing.assert_array_equal(_np(port._xc_locs), _np(ref._xc_locs))
    if ref._structure == "Independent":
        assert len(port._ind_data) == len(ref._ind_data)
        for pj, rj in zip(port._ind_data, ref._ind_data):
            for a, b in zip(pj, rj):
                np.testing.assert_array_equal(_np(a), _np(b))
    expected = {"hadamard_categorical": "Hadamard", "hadamard_forced": "Hadamard", "kronecker": "Kronecker",
                "independent": "Independent", "ard_off": "Kronecker", "bucket": "Hadamard"}
    assert port._structure == expected.get(name, "Hadamard")


def _grid_pairs(y_ref, y_port, outputs):
    if len(outputs) == 1:
        return [(y_ref, y_port)]
    return [(y_ref.get(o), y_port.get(o)) for o in outputs]


def _assert_grids_close(y_ref, y_port, outputs, rtol=1e-9):
    for a, b in _grid_pairs(y_ref, y_port, outputs):
        np.testing.assert_allclose(b.μ, a.μ, rtol=rtol)
        np.testing.assert_allclose(b.σ2, a.σ2, rtol=rtol)
    if len(outputs) > 1:
        np.testing.assert_allclose(y_port.cor, y_ref.cor, rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("name", ["kronecker", "hadamard_categorical", "independent"])
def test_reference_loads_the_port_save_and_predicts_its_grid(name, tmp_path):
    ds_ref, ds_port = _datasets()
    spec_kw, build_kw = STRUCTURES[name]
    port = gmt.GP(ds_port, device="cpu").fit(**spec_kw, **build_kw, MAP_kwargs=MAP_KW)
    path = tmp_path / "port.npz"
    port.save(path)
    ref = gmb.GP.load(path, ds_ref)
    assert ref._structure == port._structure
    levels = {"origin": "usa"} if spec_kw.get("categorical_dims") else None
    for gp in (port, ref):
        gp.prepare_grid(resolution=9)
    y_port = port.predict_grid(categorical_levels=levels)
    y_ref = ref.predict_grid(categorical_levels=levels)
    _assert_grids_close(y_ref, y_port, spec_kw["outputs"])


def test_reference_fit_loads_in_the_port_and_the_port_fit_meets_it(tmp_path):
    """The cars quickstart: a reference fit, saved and loaded by the port,
    predicts the reference's grid; the port's own fit lands within
    BASIN_TOL nats/point of the reference's objective."""
    df = gmb.data.cars()
    kw = dict(outputs=["mpg", "acceleration"], log_vars=["mpg", "acceleration", "horsepower"])
    fit_kw = dict(outputs=["mpg"], continuous_dims=["horsepower"], MAP_kwargs=dict(n_restarts=2, maxiter=50))
    ref = gmb.GP(gmb.DataSet(df, **kw)).fit(**fit_kw)
    path = tmp_path / "ref.npz"
    ref.save(path)
    port = gmt.GP.load(path, gmt.DataSet(df, **kw), device="cpu")
    for k, v in ref.MAP.items():
        np.testing.assert_array_equal(port.MAP[k], np.asarray(v))
    ref.prepare_grid()
    port.prepare_grid()
    _assert_grids_close(ref.predict_grid(), port.predict_grid(), ["mpg"])

    own = gmt.GP(gmt.DataSet(df, **kw), device="cpu").fit(**fit_kw)
    assert set(timings.last()) >= {"specify_model", "build_model", "find_MAP"}
    n = own._yz.shape[0]
    assert abs(own._neg_logp - ref._neg_logp) <= BASIN_TOL * n, (own._neg_logp, ref._neg_logp)
    own.prepare_grid()
    y = own.predict_grid()
    assert y.μ[0] > y.μ[-1]  # mpg falls with horsepower, as the reference quickstart checks


def test_additive_levels_match_the_reference(tmp_path):
    ds_ref, ds_port = _datasets()
    spec_kw, build_kw = STRUCTURES["additive"]
    port = gmt.GP(ds_port, device="cpu").fit(**spec_kw, **build_kw, MAP_kwargs=MAP_KW)
    path = tmp_path / "additive.npz"
    port.save(path)
    ref = gmb.GP.load(path, ds_ref)
    for gp in (port, ref):
        gp.prepare_grid(resolution=9)
    points = port.append_categorical_points(port.grid_points, categorical_levels={"origin": "europe"})
    points_array, _, _ = port._prepare_points_for_prediction(points, output=["mpg"])
    for level in ("total", "global", "origin"):
        m_p, v_p = port.predict(points_array, additive_level=level)
        m_r, v_r = ref.predict(points_array, additive_level=level)
        np.testing.assert_allclose(m_p, np.asarray(m_r), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(v_p, np.asarray(v_r), rtol=1e-9, atol=1e-12)
    for gp in (port, ref):
        with pytest.raises(ValueError, match="not among"):
            gp.predict(points_array, additive_level="model_year")


@pytest.mark.parametrize("name,error", [("kronecker", ValueError), ("independent", NotImplementedError)])
def test_additive_level_raises_as_the_reference(name, error, tmp_path):
    ds_ref, ds_port = _datasets()
    spec_kw, build_kw = STRUCTURES[name]
    if name == "independent":
        spec_kw = {**spec_kw, "additive": True}
    port = gmt.GP(ds_port, device="cpu").fit(**spec_kw, **build_kw, MAP_kwargs=dict(n_restarts=1, maxiter=5))
    path = tmp_path / "m.npz"
    port.save(path)
    ref = gmb.GP.load(path, ds_ref)
    points = np.zeros((2, len(port.dims)))
    for gp in (port, ref):
        with pytest.raises(error):
            gp.predict(points, additive_level="global")


def _fitted_port(n=40):
    _, ds = _datasets(n)
    return gmt.GP(ds, device="cpu").fit(outputs=["mpg"], continuous_dims=["horsepower"],
                                        MAP_kwargs=dict(n_restarts=1, maxiter=5))


def _het_frame(n=30):
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-2, 2, n))
    return pd.DataFrame({"x": x, "y": np.sin(1.2 * x) + rng.normal(0, np.where(x > 0, 0.5, 0.05)),
                         "y2": np.cos(x) + 0.1 * rng.normal(size=n)})


def _het_build(**kw):
    def build(pkg):
        ds = pkg.DataSet(_het_frame(), outputs=["y", "y2"])
        gp = pkg.GP(ds, device="cpu") if pkg is gmt else pkg.GP(ds)
        gp.specify_model(outputs=["y", "y2"] if kw.get("multitask_kernel") else ["y"], continuous_dims=["x"])
        gp.build_model(heteroskedastic_inputs=True, **kw)
    return build


def _fitted(pkg, **build_kw):
    ds = pkg.DataSet(_het_frame(), outputs=["y"])
    gp = pkg.GP(ds, device="cpu") if pkg is gmt else pkg.GP(ds)
    gp.specify_model(outputs=["y"], continuous_dims=["x"])
    gp.build_model(**build_kw)
    return gp


def _het_mesh(pkg):
    _fitted(pkg, heteroskedastic_inputs=True).find_MAP(mesh=object(), n_restarts=1, maxiter=2)


def _shard_data_bucket(pkg):
    _fitted(pkg, bucket=64).find_MAP(mesh=object(), shard_data=True, n_restarts=1, maxiter=2)


def _sparse_predict_mesh(pkg):
    gp = _fitted(pkg, sparse=True, n_u=5)
    gp.find_MAP(n_restarts=1, maxiter=2)
    gp.predict(np.zeros((2, 1)), mesh=object())


# name → (call on a package, whether the reference raises NotImplementedError there too)
KEPT_RAISES = {
    "het_sparse": (_het_build(sparse=True), True),
    "het_bucket": (_het_build(bucket=64), True),
    "het_kronecker": (_het_build(multitask_kernel="Kronecker"), True),
    "het_independent": (_het_build(multitask_kernel="Independent"), True),
    "het_mesh": (_het_mesh, True),
    "shard_data_bucket": (_shard_data_bucket, True),
    "sparse_predict_mesh": (_sparse_predict_mesh, True),
}


@pytest.mark.parametrize("name", list(KEPT_RAISES))
def test_reference_raises_are_kept(name):
    """The structures the reference refuses, refused alike: heteroskedastic
    inputs with sparse, bucket, Kronecker or Independent, and with a mesh;
    ``shard_data`` with bucket padding; a sparse model's ``predict(mesh=)``.
    Each raises ``NotImplementedError`` before the mesh is used, in both
    packages."""
    call, _ = KEPT_RAISES[name]
    for pkg in (gmt, gmb):
        with pytest.raises(NotImplementedError):
            call(pkg)


NOT_A_MESH = {
    "gp_find_map": lambda: _fitted(gmt).find_MAP(mesh=object(), n_restarts=1, maxiter=2),
    "gp_find_map_shard_data": lambda: _fitted(gmt).find_MAP(mesh=object(), shard_data=True, n_restarts=1,
                                                             maxiter=2),
    "gp_predict": lambda: _fitted_port().predict(np.zeros((1, 1)), mesh=object()),
}


@pytest.mark.parametrize("name", list(NOT_A_MESH))
def test_a_mesh_that_is_not_a_device_mesh_raises_type_error(name):
    with pytest.raises(TypeError, match="DeviceMesh"):
        NOT_A_MESH[name]()


def test_entry_points_without_device_run_on_cuda_or_raise(tmp_path):
    """With no ``device``, ``GP``, ``GP.load``, the classifier ``GPC`` and
    ``GPC.load`` and the array table's GP and GPC go to the CUDA card; on a
    host without one they raise instead of carrying on on the CPU. The CPU
    is used when asked for, at f64."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    gp = _fitted_port()
    assert gp._xc.device.type == "cpu" and gp._xc.dtype == torch.float64
    path = tmp_path / "m.npz"
    gp.save(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gmt.GP(gp.data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gmt.GP.load(path, gp.data)
    table = ArrayTable({"x": np.arange(4.0), "y": np.arange(4.0) ** 2}, outputs=["y"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ArrayTableGP(table)
    loaded = gmt.GP.load(path, gp.data, device="cpu")
    assert loaded._xc.device.type == "cpu" and loaded._dtype == torch.float64
    f32 = gmt.GP(gp.data, device="cpu", dtype="float32")
    assert f32._dtype == torch.float32

    labels = {"x": np.linspace(-2, 2, 12), "hit": (np.linspace(-2, 2, 12) > 0).astype(float)}
    gpc_ds = gmt.DataSet(pd.DataFrame(labels), outputs=["hit"])
    gpc = gmt.GPC(gpc_ds, device="cpu").fit(outputs=["hit"], continuous_dims=["x"], heteroskedastic_outputs=False,
                                            MAP_kwargs=dict(n_restarts=1, maxiter=3))
    assert gpc._xc.device.type == "cpu" and gpc._xc.dtype == torch.float64
    gpc_path = tmp_path / "gpc.npz"
    gpc.save(gpc_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gmt.GPC(gpc_ds)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gmt.GPC.load(gpc_path, gpc_ds)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ArrayTableGPC(ArrayTable(labels, outputs=["hit"]))
    loaded = gmt.GPC.load(gpc_path, gpc_ds, device="cpu")
    assert isinstance(loaded, gmt.GPC) and loaded._xc.device.type == "cpu" and loaded._dtype == torch.float64
