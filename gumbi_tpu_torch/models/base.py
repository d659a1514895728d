"""Abstract Regressor: all model-independent surface-learning logic.

A copy of ``gumbi_tpu/models/base.py``'s ``Regressor``: dimension, level and
coordinate parsing, data extraction, grid construction, prediction
packaging, grid-based proposals, cross-validation and conditional slicing.
Subclasses supply ``build_model`` / ``fit`` / ``predict``.

Two imports move into the methods that use them, so that the module imports
without pandas: the ``DataSet`` check of ``__init__`` imports
:mod:`..aggregation` there, and ``cross_validate``, the one method that
builds frames, imports pandas and ``DataSet`` itself. Everything from
``get_shaped_data`` on works on numpy arrays and parrays.
"""

from __future__ import annotations

import warnings
from abc import ABC, abstractmethod
from itertools import product

import numpy as np
from scipy.interpolate import interpn

from ..arrays import MVUncertainParameterArray as mvuparray
from ..arrays import ParameterArray as parray
from ..arrays import UncertainParameterArray as uparray
from ..utils import assert_in, assert_is_subset

__all__ = ["Regressor"]


class Regressor(ABC):
    r"""Surface learning and prediction over a :class:`DataSet`.

    Dimensions fall into several categories:

    * Filter dimensions (single level) subset the data but are not model inputs.
    * Continuous dimensions are explicit coordinates with a stationary kernel;
      linear dimensions (⊆ continuous) add a linear kernel.
    * Categorical dimensions get a coregion kernel: one correlated output per
      level. With multiple outputs, the dataset's names column is itself
      treated as a categorical dimension.
    """

    # Public attribute groups (names are API contract, shared with the
    # reference Regressor). Split by lifecycle: specification state is
    # (re)set by specify_model; the rest is filled by fitting/prediction.
    _SPEC_LIST_ATTRS = ("continuous_dims", "linear_dims", "categorical_dims")
    _SPEC_DICT_ATTRS = (
        "continuous_levels",
        "continuous_coords",
        "categorical_levels",
        "categorical_coords",
        "filter_dims",
        "model_specs",
    )
    _STATE_ATTRS = (
        "X",
        "y",
        "grid_vectors",
        "grid_parray",
        "grid_points",
        "ticks",
        "predictions",
        "predictions_X",
    )

    def __init__(self, dataset: DataSet, outputs=None, seed=2021):
        from ..aggregation import DataSet

        if not isinstance(dataset, DataSet):
            raise TypeError("Learner instance must be initialized with a DataSet object")

        self.data = dataset
        self.stdzr = dataset.stdzr
        self.out_col = dataset.names_column
        self.seed = seed
        if outputs is None:
            outputs = dataset.outputs
        self.outputs = outputs if isinstance(outputs, list) else [outputs]

        for name in self._SPEC_LIST_ATTRS:
            setattr(self, name, [])
        for name in self._SPEC_DICT_ATTRS:
            setattr(self, name, {})
        self.additive = False
        for name in self._STATE_ATTRS:
            setattr(self, name, None)

    # ------------------------- Abstract interface -------------------------

    @abstractmethod
    def fit(self, *args, **kwargs):
        """Parse inputs, build the model, and learn hyperparameters."""

    @abstractmethod
    def build_model(self, *args, **kwargs):
        """Compile the model for the current specification."""

    @abstractmethod
    def predict(self, points_array, with_noise=True, **kwargs):
        """Predict (mean, variance) at a tall array of standardized points.

        Prefer :meth:`predict_points` / :meth:`predict_grid`, which format
        inputs correctly before dispatching here.
        """

    def output_correlation(self, param_coords) -> np.ndarray:
        """Correlation matrix between the requested outputs.

        Backends with a learned output coregion override this; the default is
        independence.
        """
        return np.eye(len(param_coords))

    # ------------------------- Convenience constructors / properties -------------------------

    def parray(self, **kwargs) -> parray:
        """parray sharing this instance's Standardizer."""
        return parray(stdzr=self.stdzr, **kwargs)

    def uparray(self, name, μ, σ2, **kwargs) -> uparray:
        """uparray sharing this instance's Standardizer."""
        return uparray(name, μ, σ2, stdzr=self.stdzr, **kwargs)

    def mvuparray(self, *uparrays, cor, **kwargs) -> mvuparray:
        """mvuparray sharing this instance's Standardizer."""
        return mvuparray(*uparrays, cor=cor, stdzr=self.stdzr, **kwargs)

    @property
    def dims(self) -> list:
        """All model dimensions (continuous then categorical)."""
        return self.continuous_dims + self.categorical_dims

    @property
    def levels(self) -> dict:
        """Levels considered within each dimension."""
        return {**self.continuous_levels, **self.categorical_levels}

    @property
    def coords(self) -> dict:
        """Numerical coordinate of each level within each dimension."""
        return {**self.continuous_coords, **self.categorical_coords}

    # ------------------------- Model specification -------------------------

    def specify_model(
        self,
        outputs=None,
        linear_dims=None,
        continuous_dims=None,
        continuous_levels=None,
        continuous_coords=None,
        categorical_dims=None,
        categorical_levels=None,
        additive=False,
    ):
        """Validate and normalize the dimension/level/coordinate configuration."""
        outputs = outputs if outputs is not None else self.outputs
        assert_is_subset(self.out_col, outputs, self.data.outputs)
        self.outputs = outputs if isinstance(outputs, list) else [outputs]

        self.continuous_dims = self._parse_dimensions(continuous_dims)
        self.linear_dims = self._parse_dimensions(linear_dims)
        self.categorical_dims = self._parse_dimensions(categorical_dims)
        if set(self.categorical_dims) & set(self.continuous_dims):
            raise ValueError("Overlapping items in categorical_dims and continuous_dims")

        self.continuous_levels = self._parse_levels(self.continuous_dims, continuous_levels)
        self.categorical_levels = self._parse_levels(self.categorical_dims, categorical_levels)

        # The output column always participates as a categorical dimension
        self.categorical_dims = self.categorical_dims + [self.out_col]
        self.categorical_levels[self.out_col] = self.outputs

        # Single-level dims become filters rather than model inputs
        self.filter_dims = {}
        if self.data.wide.shape[0] > 1:
            for dim in list(self.dims):
                levels = self.levels[dim]
                if len(levels) == 1:
                    self.filter_dims[dim] = levels
                    self.continuous_dims = [d for d in self.continuous_dims if d != dim]
                    self.categorical_dims = [d for d in self.categorical_dims if d != dim]
                    self.continuous_levels = {
                        d: l for d, l in self.continuous_levels.items() if d != dim
                    }
                    self.categorical_levels = {
                        d: l for d, l in self.categorical_levels.items() if d != dim
                    }

        self.continuous_coords = self._parse_coordinates(
            self.continuous_dims, self.continuous_levels, continuous_coords
        )
        self.categorical_coords = self._parse_coordinates(
            self.categorical_dims, self.categorical_levels, None
        )

        assert_is_subset("continuous dimensions", self.linear_dims, self.continuous_dims)
        self.additive = additive
        return self

    def _parse_dimensions(self, dims) -> list:
        if dims is None:
            return []
        assert self.out_col not in dims
        dims = dims if isinstance(dims, list) else [dims]
        assert_is_subset("columns", dims, self.data.tidy.columns)
        return dims

    def _parse_levels(self, dims: list, levels) -> dict:
        if len(dims) == 0:
            return {}
        if levels is None:
            return {dim: list(self.data.tidy[dim].unique()) for dim in dims}
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
            bad = {k: v for k, vs in levels.items() for v in vs if v not in self.data.tidy[k].unique()}
            if bad:
                raise ValueError(f"Values specified in *levels not found in tidy: {bad}")
            levels.update(
                {dim: list(self.data.tidy[dim].unique()) for dim in dims if dim not in levels}
            )
        else:
            raise TypeError("`levels` must be of type str, list, or dict")

        for dim in dims:
            assert_is_subset(f"data[{dim}]", levels[dim], self.data.tidy[dim])
        return levels

    def _parse_coordinates(self, dims: list, levels: dict, coords) -> dict:
        if coords is not None:
            if isinstance(coords, dict):
                level_tuples = [(dim, lvl) for dim, lst in levels.items() for lvl in lst]
                coord_tuples = [(dim, lvl) for dim, cd in coords.items() for lvl in cd.keys()]
                assert_is_subset("coordinates", coord_tuples, level_tuples)
                assert_is_subset("coordinates", level_tuples, coord_tuples)
            elif isinstance(coords, list):
                assert (
                    len(levels.keys()) == 1
                ), "Non-dict argument for `continuous_coords` only allowed if `len(continuous_dims)==1`"
                dim = dims[0]
                assert len(coords) == len(levels[dim])
                coords = {dim: dict(zip(levels[dim], coords))}
            else:
                raise TypeError("Coordinates must be of type list or dict")
            if not all(
                isinstance(coord, (int, float)) for cd in coords.values() for coord in cd.values()
            ):
                raise TypeError("Coordinates must be numeric")
            return coords
        if dims is not None and levels is not None:
            return {dim: self._make_coordinates(dim, lst) for dim, lst in levels.items()}
        return {}

    def _make_coordinates(self, dim: str, levels_list: list) -> dict:
        df = self.data.tidy
        col = df[df[dim].isin(levels_list)][dim]
        if col.dtype in [np.float32, np.float64, np.int32, np.int64]:
            return {level: level for level in levels_list}
        categories = col.astype("category").cat.categories.to_list()
        return {level: categories.index(level) for level in levels_list}

    # ------------------------- Data extraction -------------------------

    def get_filtered_data(self, standardized=False, metric="mean"):
        """Subset of the tidy data matching filters and levels."""
        df = self.data.tidy
        allowed = df.isin(self.filter_dims)[self.filter_dims.keys()].all(axis=1)
        if "Metric" in df.columns and metric == "mean":
            assert_in("Metric", metric, self.data.tidy["Metric"].unique())
            allowed &= df["Metric"] == metric
        elif "Metric" not in df.columns and metric != "mean":
            raise KeyError(f"No 'Metric' column found in dataset. Cannot filter by {metric}")
        elif metric != "mean":
            raise ValueError(f"Only 'mean' is supported for 'metric'. Got {metric}")
        for dim, levels in self.levels.items():
            allowed &= df[dim].isin(levels)
        return df[allowed] if not standardized else self.data.tidy.z[allowed]

    def _coercion_coords(self):
        """`self.coords` minus identity mappings.

        Continuous dimensions carry value→itself coordinate maps (one entry
        per unique observation); feeding those to ``DataFrame.replace`` is a
        no-op that pandas nevertheless executes one masked scan per entry —
        23 s at N=50k (measured; it was the whole cost of ``prepare_grid``
        at scale). Only categorical level→code maps actually coerce.
        """
        return {
            dim: mapping
            for dim, mapping in self.coords.items()
            if any(k is not v and k != v for k, v in mapping.items())
        }

    def get_structured_data(self, metric="mean"):
        """Input coordinates and observations as parrays (X, y)."""
        df = self.get_filtered_data(standardized=False, metric=metric)

        # Every output must be observed the same number of times
        assert len({int((df[self.out_col] == output).sum()) for output in self.outputs}) == 1

        inputs = df[df[self.out_col] == self.outputs[0]]
        coercions = self._coercion_coords()
        if coercions:
            inputs = inputs.replace(coercions)

        dims = [dim for dim in self.dims if dim != self.out_col]
        dim_values = {dim: inputs[dim].astype(float).to_list() for dim in dims}
        X = self.parray(**dim_values, stdzd=False)

        values_col = self.data.values_column
        outputs = {
            output: df[df[self.out_col] == output][values_col].values for output in self.outputs
        }
        y = self.parray(**outputs, stdzd=False)
        return X, y

    def get_shaped_data(self, metric="mean", dropna=True):
        """Tall numpy arrays for the engine: X (n_obs, n_dims), y (n_obs,).

        Continuous columns hold z-space values; categorical columns hold raw
        integer level coordinates (deliberate fix vs the reference, which
        z-transformed coordinate columns; see module docstring).
        """
        self.X, self.y = self.get_structured_data(metric=metric)

        def col(dim, pa):
            if dim in self.continuous_dims:
                return pa[dim].z.values().squeeze()
            return pa[dim].values().squeeze()

        if self.out_col in self.dims:
            ordered_outputs = dict(
                sorted(self.coords[self.out_col].items(), key=lambda item: item[1])
            )
            y = np.hstack([self.y.z[output + "_z"].values() for output in ordered_outputs])
            Xt = self.X[:, None]
            from ..arrays import ParameterArray

            Xt = ParameterArray.vstack(
                [Xt.add_layers(**{self.out_col: coord}) for coord in ordered_outputs.values()]
            )
            X = np.atleast_2d(np.column_stack([col(dim, Xt) for dim in self.dims]))
        else:
            y = self.y.z.values().squeeze()
            X = np.atleast_2d(np.column_stack([col(dim, self.X) for dim in self.dims]))

        if dropna:
            nans = np.isnan(y)
            return X[~nans], y[~nans]
        return X, y

    # ------------------------- Prediction plumbing -------------------------

    def _check_has_prediction(self):
        if self.predictions is None:
            raise ValueError("No predictions found. Run self.predict_grid or related method first.")

    def _parse_prediction_output(self, output):
        if self.out_col in self.categorical_dims:
            if output is None:
                output = self.categorical_levels[self.out_col]
            elif isinstance(output, list):
                assert_is_subset("Outputs", output, self.categorical_levels[self.out_col])
            elif isinstance(output, str):
                output = [output]
                assert_is_subset("Outputs", output, self.categorical_levels[self.out_col])
            else:
                raise ValueError('"output" must be list, string, or None')
        else:
            output = self.filter_dims[self.out_col]
        return output

    def _prepare_points_for_prediction(self, points: parray, output):
        points = np.atleast_1d(points)
        assert points.ndim == 1
        assert set(self.dims) - {self.out_col} == set(
            points.names
        ), 'All model dimensions must be present in "points" parray.'

        if self.out_col in self.categorical_dims:
            param_coords = [self.categorical_coords[self.out_col][p] for p in output]
            from ..arrays import ParameterArray

            tall_points = ParameterArray.vstack(
                [points.add_layers(**{self.out_col: coord})[:, None] for coord in param_coords]
            )
        else:
            param_coords = None
            tall_points = points[:, None]

        # Continuous dims standardized, categorical dims as raw coordinates
        def col(dim):
            if dim in self.continuous_dims:
                return tall_points[dim].z.values()
            return tall_points[dim].values()

        points_array = np.hstack([col(dim) for dim in self.dims])
        return points_array, tall_points, param_coords

    def predict_points(self, points, output=None, with_noise=True, **kwargs):
        """Predict at a 1-D parray of coordinates (one layer per dim).

        Returns a uparray for one output, an mvuparray (with backend-supplied
        output correlation) for several.
        """
        output = self._parse_prediction_output(output)
        points_array, tall_points, param_coords = self._prepare_points_for_prediction(
            points, output=output
        )

        pred_mean, pred_variance = self.predict(points_array, with_noise=with_noise, **kwargs)
        self.predictions_X = points

        if len(output) == 1:
            self.predictions = self.uparray(output[0], pred_mean, pred_variance, stdzd=True)
        else:
            uparrays = []
            for i, name in enumerate(output):
                idx = (tall_points[self.out_col].values() == param_coords[i]).squeeze()
                uparrays.append(self.uparray(name, pred_mean[idx], pred_variance[idx], stdzd=True))
            cor = self.output_correlation(param_coords)
            self.predictions = self.mvuparray(*uparrays, cor=cor)

        return self.predictions

    def prepare_grid(self, limits=None, at=None, resolution=100):
        """Build prediction grids over the continuous dimensions.

        Default per-dim limits are the data's z-range clipped to at least
        [-2, 2] and padded by 10% (reference base.py:646-655).
        """
        self.predictions = None
        self.predictions_X = None

        if at is None:
            at = self.parray(none=[])
        elif not isinstance(at, parray):
            raise TypeError('"at" must be a ParameterArray')
        elif at.ndim != 0:
            raise ValueError('"at" must be single point, potentially with multiple layers')

        at_dims = set(at.names)
        continuous_dims = set(self.continuous_dims)
        limit_dims = continuous_dims - at_dims
        if limit_dims == set():
            raise ValueError("At least one dimension must be non-degenerate to generate grid.")

        X, _ = self.get_structured_data("mean")
        X_values = np.atleast_2d(X.z.values()).T

        default_values = np.stack(
            [np.minimum(X_values.min(0), -2.0), np.maximum(X_values.max(0), 2.0)]
        ).T
        padding = np.diff(default_values, axis=1) * 0.1
        default_values += np.concatenate([-padding, padding], axis=1)

        cont_dims_no_out = [d for d in self.dims if d != self.out_col]
        default_parray = self.parray(
            **{
                dim: default
                for dim, default in zip(cont_dims_no_out, default_values)
                if dim in limit_dims
            },
            stdzd=True,
        )

        if limits is None:
            limits = default_parray
        else:
            if not isinstance(limits, parray):
                raise TypeError('"limits" must be a ParameterArray')
            remaining_dims = limit_dims - set(limits.names)
            if remaining_dims:
                limits = limits.add_layers(**default_parray.get(list(remaining_dims)).as_dict())

        limit_dims = set(limits.names)
        if limit_dims.intersection(at_dims):
            raise ValueError('Dimensions specified via "limits" and in "at" must not overlap.')
        if not continuous_dims.issubset(at_dims.union(limit_dims) - {"none"}):
            raise ValueError('Not all continuous dimensions are specified by "limits" or "at".')

        if isinstance(resolution, int):
            resolution = {dim: resolution for dim in self.continuous_dims}
        elif not isinstance(resolution, dict):
            raise TypeError('"resolution" must be a dictionary or an integer')
        else:
            assert_is_subset("continuous dimensions", resolution.keys(), self.continuous_dims)

        # Axis vectors: one single-layer (r, 1) parray per gridded dimension,
        # linearly spaced in z-space between that dimension's limits.
        def _axis_vector(dim):
            z_lo, z_hi = limits[dim].z.values()
            ticks = np.linspace(z_lo, z_hi, resolution[dim])
            return self.parray(**{dim: ticks[:, None]}, stdzd=True)

        grid_vectors = {dim: _axis_vector(dim) for dim in limit_dims}

        # Dense product grid, dimension order following self.dims; any
        # dimensions pinned via `at` become constant layers over the grid.
        ordered_dims = [dim for dim in self.dims if dim in limit_dims]
        mesh = np.meshgrid(*(grid_vectors[dim] for dim in ordered_dims), indexing="ij")
        layers = {dim: axes.values() for dim, axes in zip(ordered_dims, mesh)}
        grid_parray = self.parray(**layers)
        if at.names != ["none"]:
            pinned = {dim: np.full(grid_parray.shape, v) for dim, v in at.as_dict().items()}
            grid_parray = grid_parray.add_layers(**pinned)

        self.prediction_dims = ordered_dims
        self.grid_vectors = grid_vectors
        self.grid_parray = grid_parray
        self.grid_points = grid_parray.ravel()
        return grid_parray

    def marginal_grids(self, *dims):
        """Grids over only the named subset of prediction dimensions."""
        if self.grid_points is None:
            raise ValueError("Grid must first be specified with `prepare_grid`")
        assert_is_subset("GP dims", dims, self.prediction_dims)
        ordered_dims = [dim for dim in self.dims if dim in dims]
        grids = np.meshgrid(*[self.grid_vectors[dim] for dim in ordered_dims], indexing="ij")
        return [grids[ordered_dims.index(dim)] for dim in dims]

    def predict_grid(self, output=None, categorical_levels=None, with_noise=True, **kwargs):
        """Predict at the prepared grid and reshape into grid form."""
        if self.grid_points is None:
            raise ValueError("Grid must first be specified with `prepare_grid`")

        points = self.grid_points
        if self.categorical_dims:
            points = self.append_categorical_points(points, categorical_levels=categorical_levels)

        self.predict_points(points, output=output, with_noise=with_noise, **kwargs)
        self.predictions = self.predictions.reshape(self.grid_parray.shape)
        self.predictions_X = self.predictions_X.reshape(self.grid_parray.shape)
        return self.predictions

    def append_categorical_points(self, continuous_parray, categorical_levels):
        """Add fixed categorical coordinates to a tall array of continuous points."""
        if categorical_levels is not None:
            if set(categorical_levels.keys()) != (set(self.categorical_dims) - {self.out_col}):
                raise AttributeError("Must specify level for every categorical dimension")
            points = continuous_parray.fill_with(
                **{
                    dim: self.categorical_coords[dim][level]
                    for dim, level in categorical_levels.items()
                }
            )
        else:
            points = continuous_parray
        return points

    # ------------------------- Proposals (grid-based acquisition over existing predictions) -------------------------

    def propose(self, target, acquisition="EI"):
        """Propose the grid point optimizing an acquisition toward ``target``."""
        if self.predictions is None:
            raise ValueError("No predictions to make proposal from!")
        assert_in("acquisition", acquisition, ["EI", "PD"])
        output = self.predictions.name

        df = self.get_filtered_data(standardized=False)
        df = df[df[self.out_col] == output]
        observed = self.parray(**{output: df[self.data.values_column]}, stdzd=False)

        target = self.parray(**{output: target}, stdzd=False)
        best_yet = np.min(np.sqrt(np.mean(np.square(observed.z.values() - target.z.values()))))

        if acquisition == "EI":
            self.proposal_surface = self.predictions.z.vEI(target.z.values(), best_yet)
        elif acquisition == "PD":
            self.proposal_surface = self.predictions.z.nlpd(target.z.values())

        self.proposal_idx = np.argmax(self.proposal_surface)
        self.proposal = self.predictions_X.ravel()[self.proposal_idx]
        return self.proposal

    # ------------------------- Evaluation -------------------------

    def cross_validate(
        self,
        unit=None,
        *,
        n_train=None,
        pct_train=None,
        train_only=None,
        warm_start=True,
        seed=None,
        errors="natural",
        **MAP_kws,
    ):
        """Fit on a random subset and evaluate on held-out observations.

        Returns nested dicts 'train'/'test' with 'data' (DataSet), 'NLPDs',
        and 'errors' in the requested space. Reproducibly random via ``seed``.
        """
        import pandas as pd

        from ..aggregation import DataSet

        if not (n_train is None) ^ (pct_train is None):
            raise ValueError('Exactly one of "n_train" and "pct_train" must be specified')
        if unit is not None and not isinstance(unit, str):
            raise TypeError('Keyword "unit" must be a single string.')
        assert_in('Keyword "errors"', errors, ["natural", "standardized", "transformed"])

        seed = self.seed if seed is None else seed
        rg = np.random.default_rng(seed)

        df = self.data.wide

        n_entities = len(set(df.index)) if unit is None else len(set(df.set_index(unit).index))
        n_train = n_train if n_train is not None else int(np.floor(n_entities * pct_train))
        if n_train <= 0:
            raise ValueError("Size of training set must be strictly greater than zero.")
        if n_train > n_entities:
            raise ValueError(
                "Size of training set must be not exceed number of observations or entities in dataset."
            )

        train_list = []

        if train_only is not None:
            # (Reference base.py:936 took `.index` of the boolean frame —
            # selecting every row; here only matching rows are pinned.)
            criteria = [df[dim] == level for dim, level in train_only.items()]
            match = pd.concat(criteria, axis=1).all(axis=1)
            train_only_idxs = df.index[match]
            train_only_df = (
                df.loc[train_only_idxs] if unit is None else df.loc[train_only_idxs].set_index(unit)
            )
            n_train -= len(set(train_only_df.index))
            if n_train < 0:
                raise ValueError("Adding `train_only` observations exceeded specified size of training set")
            train_list.append(train_only_df)
            df = df.drop(index=train_only_idxs)

        if unit is not None:
            df = df.set_index(unit)
            remaining = set(df.index)
            if train_list:
                train_only_entities = set(train_list[-1].index)
                if train_only_entities & remaining:
                    raise ValueError(
                        "Criteria in `train_only` partially sliced an entity specified by `unit`, "
                        "which makes interpretation of `n_train` ambiguous."
                    )

        if n_train > len(df.index.unique()):
            raise ValueError(
                "Specified size of training set exceeds number of unique combinations found in `dims`"
            )

        warm_cat_dims = [d for d in self.categorical_dims if d != self.out_col]
        if warm_start and len(warm_cat_dims) > 0:
            # One random observation per categorical level combination. The
            # output column is excluded: it is a tidy-only construct (wide
            # rows carry all outputs), so grouping by it raises KeyError on
            # any multi-output model (reference bug, ref base.py:967); the
            # reference's filter condition is also inverted for tuple group
            # names — the intent is to KEEP groups in the specified levels.
            level_combinations = set(
                product(*(self.categorical_levels[d] for d in warm_cat_dims))
            )

            def _grp_key(name):
                return (name,) if len(warm_cat_dims) == 1 else tuple(name)

            cat_grps = (
                df.groupby(warm_cat_dims)
                .filter(lambda grp: _grp_key(grp.name) in level_combinations)
                .groupby(warm_cat_dims)
            )
            if cat_grps.ngroups == 0:
                raise ValueError(
                    "None of the combinations of categorical levels were found in data."
                    f"\nCombinations:\n{level_combinations}"
                )
            warm_idxs = cat_grps.sample(1, random_state=seed).index
            if len(set(warm_idxs)) != len(warm_idxs):
                warnings.warn(
                    "Duplicate entities specified by `unit` were selected during `warm_start`. "
                    "This may lead to unexpected behavior."
                )
            n_train -= len(set(warm_idxs))
            if n_train < 0:
                raise ValueError("Adding `warm_start` observations exceeded specified size of training set")
            train_list.append(df.loc[warm_idxs])
            df = df.drop(index=warm_idxs)

        train_idxs = rg.choice(df.index.unique(), n_train, replace=False)
        train_list.append(df.loc[train_idxs])
        train_df = pd.concat(train_list).reset_index()
        test_df = df.drop(train_idxs).reset_index()

        categorical_dims = [dim for dim in self.categorical_dims if dim != self.out_col]

        # Re-specification template: the current model spec, minus the
        # out_col pseudo-dimension (specify_model re-appends it).
        _SPEC_FIELDS = (
            "outputs",
            "linear_dims",
            "continuous_dims",
            "continuous_levels",
            "continuous_coords",
            "categorical_levels",
            "additive",
        )
        specifications = {field: getattr(self, field) for field in _SPEC_FIELDS}
        specifications["categorical_dims"] = categorical_dims

        def _subset_specs(sub_df):
            # The out_col is tidy-only (wide rows carry all outputs at once),
            # so its levels — the outputs — are kept verbatim rather than
            # probed against the wide frame's columns.
            return {
                **specifications,
                "continuous_levels": {
                    dim: [lvl for lvl in lvls if lvl in sub_df[dim].values]
                    for dim, lvls in self.continuous_levels.items()
                },
                "categorical_levels": {
                    dim: (
                        lvls
                        if dim == self.out_col
                        else [lvl for lvl in lvls if lvl in sub_df[dim].values]
                    )
                    for dim, lvls in self.categorical_levels.items()
                },
                "continuous_coords": {
                    dim: {lvl: coord for lvl, coord in coords.items() if lvl in sub_df[dim].values}
                    for dim, coords in self.continuous_coords.items()
                },
            }

        train_specs = _subset_specs(train_df)
        test_specs = _subset_specs(test_df)

        # Sibling DataSets inherit the parent's construction kwargs —
        # including the parent stdzr, so train/test share one z-space.
        train_ds = DataSet(train_df, **self.data.specs)
        test_ds = DataSet(test_df, **self.data.specs)

        train_obj = self.__class__(train_ds, outputs=self.outputs, seed=seed)
        train_specs["categorical_dims"] = categorical_dims
        train_obj.specify_model(**train_specs)
        train_obj.filter_dims = self.filter_dims
        train_obj.build_model(**self.model_specs)
        train_obj.find_MAP(**MAP_kws)

        def _error(y, predictions):
            # Multi-output predictions carry μ as a multi-layer parray —
            # compare plain values stacked in output order (y shares it).
            yv, mu = {
                "natural": lambda: (y.values(), predictions.μ),
                "transformed": lambda: (y.t.values(), predictions.t.μ),
                "standardized": lambda: (y.z.values(), predictions.z.μ),
            }[errors]()
            if isinstance(mu, parray):
                mu = mu.values()
            return yv - np.asarray(mu)

        train_X, train_y = train_obj.get_structured_data()
        train_predictions = train_obj.predict_points(train_X)
        train_nlpd = train_predictions.nlpd(train_y.values())
        train_error = _error(train_y, train_predictions)

        if len(test_df.index.unique()) > 0:
            test_obj = self.__class__(test_ds, outputs=self.outputs, seed=seed)
            test_specs["categorical_dims"] = categorical_dims
            test_obj.specify_model(**test_specs)
            test_obj.filter_dims = self.filter_dims

            test_X, test_y = test_obj.get_structured_data()
            test_predictions = train_obj.predict_points(test_X)
            test_nlpd = test_predictions.nlpd(test_y.values())
            test_error = _error(test_y, test_predictions)
        else:
            test_nlpd = np.nan
            test_error = np.nan

        return {
            "train": {"data": train_ds, "NLPDs": train_nlpd, "errors": train_error},
            "test": {"data": test_ds, "NLPDs": test_nlpd, "errors": test_error},
        }

    # ------------------------- Conditional slices -------------------------

    def get_conditional_prediction(self, **dim_values):
        """Slice of the prediction grid conditioned on fixed dim values.

        Interpolates the grid's mean and variance separately at the given
        values of the specified dims over the original values of the rest.
        """
        self._check_has_prediction()
        all_dims = self.prediction_dims

        all_margins = {
            dim: vec.squeeze() for dim, vec in self.grid_vectors.items() if dim in all_dims
        }

        keep = set(all_dims) - set(dim_values.keys())
        kept_margins = [all_margins[dim] for dim in self.prediction_dims if dim in keep]

        conditional_grid = self.parray(
            **{
                array.names[0]: array.values()
                for array in np.meshgrid(*kept_margins, indexing="ij")
            }
        )
        xi_parray = conditional_grid.add_layers(
            **{dim: np.full(conditional_grid.shape, value) for dim, value in dim_values.items()}
        ).ravel()

        xi_pts = np.column_stack(
            [xi_parray[dim].z.values() for dim in self.dims if dim in xi_parray.names]
        )

        margins = [all_margins[dim].z.values() for dim in self.dims if dim in all_dims]
        μi = interpn(margins, self.predictions.μ, xi_pts)
        σ2i = interpn(margins, self.predictions.σ2, xi_pts)

        conditional_prediction = self.uparray(self.predictions.name, μ=μi, σ2=σ2i).reshape(
            *conditional_grid.shape
        )
        return conditional_grid.squeeze(), conditional_prediction.squeeze()
