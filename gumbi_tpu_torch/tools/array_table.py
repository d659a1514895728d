"""The port's ``GP`` over a wide table of numpy columns, in place of a ``DataSet``.

``GP`` reaches its data only through ``Regressor``'s data-access methods
(``__init__``, ``_parse_dimensions``, ``_parse_levels``,
``_make_coordinates``, ``get_filtered_data``, ``get_structured_data``, and
``specify_model``'s reads of ``data.outputs`` and ``data.wide.shape``).
Everything after ``get_shaped_data`` works on numpy arrays and parrays. A
machine without pandas (the CUDA card's) cannot build a ``DataSet``, so
:class:`ArrayTableGP` overrides exactly those methods to read an
:class:`ArrayTable`, a dict of numpy columns with the same wide layout: one
row per observation, one column per input and per output. Its
``Standardizer`` is estimated as ``Standardizer.from_DataFrame`` estimates a
``DataSet``'s: the moments of every float64 column after its transform, the
variance with ddof = 1 and NaNs skipped, as pandas computes them. Every
other method is ``GP``'s, so a fit through the table is the fit a
``DataSet`` user runs (``tests/test_torch_model_layer.py`` holds the two
equal at f64).

    table = ArrayTable({"x1": x1, "x2": x2, "y1": y1, "y2": y2}, outputs=["y1", "y2"])
    gp = ArrayTableGP(table, outputs=["y1", "y2"]).fit(continuous_dims=["x1", "x2"])
    gp.prepare_grid(); y = gp.predict_grid()

:class:`ArrayTableGPC` is the classifier over the same table: ``GPC`` for
everything but the data access.
"""

from __future__ import annotations

import numpy as np

from ..models.base import Regressor
from ..models.gp import GP
from ..models.gpc import GPC
from ..standardizer import Standardizer
from ..utils import assert_in, assert_is_subset, listify

__all__ = ["ArrayTable", "ArrayTableGP", "ArrayTableGPC", "table_stdzr"]


def table_stdzr(columns, log_vars=None, logit_vars=None) -> Standardizer:
    """``Standardizer.from_DataFrame`` over a dict of numpy columns: mean and
    sample variance (ddof = 1, NaNs skipped) of each float64 column after
    its forward transform."""
    new = Standardizer(log_vars=log_vars, logit_vars=logit_vars)
    moments = {}
    for name, values in columns.items():
        if values.dtype == np.float64:
            t = new.transform(name, values)
            moments[name] = {"μ": float(np.nanmean(t)), "σ2": float(np.nanvar(t, ddof=1))}
    return new | moments


def _unique(values) -> list:
    """Distinct values in order of first appearance (pandas' ``unique``)."""
    _, first = np.unique(values, return_index=True)
    return list(values[np.sort(first)])


class ArrayTable:
    """A wide table as a dict of equal-length numpy columns, with its outputs
    and a :class:`Standardizer` (estimated from the columns unless given)."""

    names_column = "Variable"
    values_column = "Value"

    def __init__(self, columns: dict, outputs, log_vars=None, logit_vars=None, stdzr=None):
        self.columns = {name: np.asarray(values) for name, values in columns.items()}
        rows = {len(v) for v in self.columns.values()}
        if len(rows) != 1:
            raise ValueError(f"Columns must have one length, got lengths {sorted(rows)}")
        self.outputs = listify(outputs)
        assert_is_subset("columns", self.outputs, self.columns)
        self.stdzr = table_stdzr(self.columns, log_vars, logit_vars) if stdzr is None else stdzr

    @property
    def inputs(self) -> list:
        """Columns not listed as outputs."""
        return [name for name in self.columns if name not in self.outputs]

    @property
    def shape(self) -> tuple:
        return (len(next(iter(self.columns.values()))), len(self.columns))

    @property
    def wide(self) -> ArrayTable:
        """The table is wide already (``specify_model`` reads ``data.wide.shape``)."""
        return self


class _TableData(Regressor):
    """``Regressor``'s data-access methods over an :class:`ArrayTable`."""

    def __init__(self, table: ArrayTable, outputs=None, seed=2021):
        if not isinstance(table, ArrayTable):
            raise TypeError("ArrayTableGP must be initialized with an ArrayTable")

        self.data = table
        self.stdzr = table.stdzr
        self.out_col = table.names_column
        self.seed = seed
        if outputs is None:
            outputs = table.outputs
        self.outputs = outputs if isinstance(outputs, list) else [outputs]

        for name in self._SPEC_LIST_ATTRS:
            setattr(self, name, [])
        for name in self._SPEC_DICT_ATTRS:
            setattr(self, name, {})
        self.additive = False
        for name in self._STATE_ATTRS:
            setattr(self, name, None)

    def _parse_dimensions(self, dims) -> list:
        if dims is None:
            return []
        assert self.out_col not in dims
        dims = dims if isinstance(dims, list) else [dims]
        tidy_columns = self.data.inputs + [self.data.names_column, self.data.values_column]
        assert_is_subset("columns", dims, tidy_columns)
        return dims

    def _parse_levels(self, dims: list, levels) -> dict:
        if len(dims) == 0:
            return {}
        cols = self.data.columns
        if levels is None:
            return {dim: _unique(cols[dim]) for dim in dims}
        if isinstance(levels, (str, list)):
            assert len(dims) == 1, "Non-dict argument for `levels` only allowed if `len(dims)==1`"
            levels = levels if isinstance(levels, list) else [levels]
            levels = {dims[0]: levels}
        elif isinstance(levels, dict):
            for d, v in levels.items():
                if not isinstance(v, list):
                    levels[d] = [v]
            bad = [dim for dim in levels.keys() if dim not in dims]
            if bad:
                raise KeyError(f"Dimensions {bad} specified in *levels not found in *dims")
            bad = {k: v for k, vs in levels.items() for v in vs if v not in _unique(cols[k])}
            if bad:
                raise ValueError(f"Values specified in *levels not found in tidy: {bad}")
            levels.update({dim: _unique(cols[dim]) for dim in dims if dim not in levels})
        else:
            raise TypeError("`levels` must be of type str, list, or dict")

        for dim in dims:
            assert_is_subset(f"data[{dim}]", levels[dim], cols[dim].tolist())
        return levels

    def _make_coordinates(self, dim: str, levels_list: list) -> dict:
        # The tidy names column holds the output names.
        outputs = np.asarray(self.data.outputs, dtype=object)
        col = outputs if dim == self.out_col else self.data.columns[dim]
        col = col[np.isin(col, levels_list)]
        if col.dtype in [np.float32, np.float64, np.int32, np.int64]:
            return {level: level for level in levels_list}
        categories = sorted(set(col.tolist()))
        return {level: categories.index(level) for level in levels_list}

    def get_filtered_data(self, standardized=False, metric="mean") -> dict:
        """The table's rows (and output columns) matching filters and levels,
        as a dict of columns in natural units."""
        if standardized:
            raise NotImplementedError("the array table filters in natural units only")
        cols = self.data.columns
        rows = np.ones(self.data.shape[0], dtype=bool)
        if "Metric" in cols and metric == "mean":
            assert_in("Metric", metric, _unique(cols["Metric"]))
            rows &= cols["Metric"] == metric
        elif "Metric" not in cols and metric != "mean":
            raise KeyError(f"No 'Metric' column found in dataset. Cannot filter by {metric}")
        elif metric != "mean":
            raise ValueError(f"Only 'mean' is supported for 'metric'. Got {metric}")
        outputs = list(self.data.outputs)
        for dim, levels in [*self.filter_dims.items(), *self.levels.items()]:
            if dim == self.out_col:
                outputs = [o for o in outputs if o in levels]
            else:
                rows &= np.isin(cols[dim], levels)
        return {name: cols[name][rows] for name in self.data.inputs + outputs}

    def get_structured_data(self, metric="mean"):
        """Input coordinates and observations as parrays (X, y)."""
        data = self.get_filtered_data(standardized=False, metric=metric)
        coercions = self._coercion_coords()
        dims = [dim for dim in self.dims if dim != self.out_col]
        dim_values = {}
        for dim in dims:
            col = data[dim]
            if dim in coercions:
                col = np.array([coercions[dim].get(v, v) for v in col.tolist()], dtype=object)
            dim_values[dim] = col.astype(float).tolist()
        X = self.parray(**dim_values, stdzd=False)
        y = self.parray(**{output: data[output] for output in self.outputs}, stdzd=False)
        return X, y


class ArrayTableGP(GP, _TableData):
    """The port's :class:`GP` over an :class:`ArrayTable`: ``GP(table,
    outputs=None, seed=2021, dtype=None, device=None)``. Only the data
    access differs; fitting, prediction and ``save``/``load`` are ``GP``'s."""


class ArrayTableGPC(GPC, _TableData):
    """The port's :class:`GPC` over an :class:`ArrayTable` whose output
    column holds 0/1 labels: ``GPC(table, outputs=None, seed=2021,
    dtype=None, device=None)``. Only the data access differs."""
