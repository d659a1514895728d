"""Per-variable transforms and standardization moments, without pandas.

:class:`Standardizer` is a copy of ``gumbi_tpu/aggregation.py``'s, moved to
a module of its own so that the arrays and the model layer import it
without pandas (the card's machine has none). Its one change: the
reference's ``isinstance(x, pd.Series)`` tests go through :func:`_is_series`,
which answers False while pandas is not imported (no Series can exist then)
and otherwise runs the same test. :meth:`Standardizer.from_DataFrame` is
called with a frame in hand and needs no pandas of its own.
"""

from __future__ import annotations

import sys

import numpy as np
from scipy.special import expit, logit

from .utils import listify, skip

__all__ = ["Standardizer"]


def _is_series(x) -> bool:
    """``isinstance(x, pandas.Series)``, False while pandas is not imported."""
    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(x, pd.Series)


# Forward/inverse transform pairs. ``skip`` is the identity sentinel; the
# structured-array layer compares against these exact function objects.
_TRANSFORM_PAIRS = {
    "identity": (skip, skip),
    "log": (np.log, np.exp),
    "logit": (logit, expit),
}


class Standardizer(dict):
    r"""Per-variable transform registry plus transformed-space moments (μ, σ2).

    Maps values of each named variable between three spaces:

    * natural      — the units the data arrived in
    * transformed  — after the variable's forward transform (log / logit / identity)
    * standardized — transformed, mean-centered, and scaled to unit variance

    The mapping for a value ``x`` of variable ``v`` is
    ``z = (f_v(x) - μ_v) / σ_v`` with ``f_v`` the registered forward transform
    and ``(μ_v, σ2_v)`` the stored moments *of the transformed variable*.

    Moments are supplied as keyword arguments (``v={'μ': m, 'σ2': s2}`` or
    ``{'μ': m, 'σ': s}``) or estimated from a wide DataFrame via
    :meth:`from_DataFrame`. Distribution (μ, σ2) pairs are converted between
    spaces following scipy's lognorm/logit-normal conventions: the "mean" moves
    through the transform while the variance is interpreted as the
    transformed-space variance and passes through unchanged.

    Parity: reference gumbi/aggregation.py:17-485.
    """

    def __init__(self, log_vars=None, logit_vars=None, isotropic_vars=None, **kwargs):
        self.validate(kwargs)
        cleaned = {}
        for name, stats in kwargs.items():
            stats = dict(stats)
            if "σ2" not in stats:
                stats["σ2"] = stats.pop("σ") ** 2
            cleaned[name] = stats
        super().__init__(**cleaned)

        self._transforms = {var: list(_TRANSFORM_PAIRS["identity"]) for var in cleaned}
        self._log_vars = []
        self._logit_vars = []
        self._isotropic_vars = listify(isotropic_vars)
        if log_vars is not None:
            self.log_vars = log_vars
        if logit_vars is not None:
            self.logit_vars = logit_vars

    # ------------------------------------------------------------------
    # Registry management
    # ------------------------------------------------------------------

    @property
    def log_vars(self) -> list:
        """Variables treated as log-normal."""
        return self._log_vars

    @log_vars.setter
    def log_vars(self, var_list):
        var_list = [var_list] if isinstance(var_list, str) else var_list
        if not isinstance(var_list, list):
            raise TypeError("log_vars must be a list or str")
        self._log_vars = var_list
        for var in var_list:
            self._transforms[var] = list(_TRANSFORM_PAIRS["log"])

    @property
    def logit_vars(self) -> list:
        """Variables treated as logit-normal."""
        return self._logit_vars

    @logit_vars.setter
    def logit_vars(self, var_list):
        var_list = [var_list] if isinstance(var_list, str) else var_list
        if not isinstance(var_list, list):
            raise TypeError("logit_vars must be a list or str")
        self._logit_vars = var_list
        for var in var_list:
            self._transforms[var] = list(_TRANSFORM_PAIRS["logit"])

    @property
    def transforms(self) -> dict:
        """Forward/inverse transform pair for each variable."""
        return self._transforms

    @transforms.setter
    def transforms(self, dct):
        # Copy: assigning a dict shared with another Standardizer (e.g. the
        # result of `a | b`) must not alias their registries — later
        # log_vars/logit_vars edits on one would silently retune the other.
        self._transforms = {k: list(v) for k, v in dct.items()}
        self._log_vars = [v for v, pair in dct.items() if pair[0] is np.log]
        self._logit_vars = [v for v, pair in dct.items() if pair[0] is logit]

    @classmethod
    def validate(cls, dct: dict):
        """Ensure every entry carries a mean and a variance (or sd)."""
        assert all("μ" in sub for sub in dct.values())
        assert all(("σ" in sub or "σ2" in sub) for sub in dct.values())

    def __or__(self, other) -> Standardizer:
        merged = {**self, **other}
        new = Standardizer(**merged)
        if isinstance(other, Standardizer):
            new.transforms = {**self.transforms, **other.transforms}
        else:
            new.transforms = self.transforms
        return new

    def __ror__(self, other) -> Standardizer:
        merged = {**other, **self}
        new = Standardizer(**merged)
        new.transforms = self.transforms
        return new

    def __repr__(self):
        head = "\n\t".join(
            ["Standardizer:", f"log_vars: {self.log_vars}", f"logit_vars: {self.logit_vars}"]
        )
        return head + "\n\n" + str({**self})

    @classmethod
    def from_DataFrame(cls, df: pd.DataFrame, log_vars=None, logit_vars=None, isotropic_vars=None):
        """Estimate transformed-space moments of every float64 column of ``df``.

        Anisotropic columns get independent (pandas sample) moments; columns in
        ``isotropic_vars`` share pooled (numpy population) moments, as in the
        reference (gumbi/aggregation.py:224-258).
        """
        isotropic_vars = listify(isotropic_vars)
        float_cols = [c for c in df.columns if df[c].dtype == "float64"]
        anis_cols = [c for c in float_cols if c not in isotropic_vars]

        new = cls(log_vars=log_vars, logit_vars=logit_vars)

        anis_dct = {}
        if anis_cols:
            anis_dct = (
                df[anis_cols]
                .apply(new.transform)
                .agg(["mean", "var"])
                .rename(index={"mean": "μ", "var": "σ2"})
                .to_dict()
            )

        iso_dct = {}
        if isotropic_vars:
            pooled = df[isotropic_vars].apply(new.transform).values
            iso_dct = {
                col: {"μ": pooled.mean(), "σ2": pooled.var()} for col in isotropic_vars
            }

        return new | anis_dct | iso_dct

    # ------------------------------------------------------------------
    # Space conversions — values, (μ, σ2) distributions, and pd.Series
    # ------------------------------------------------------------------

    def _dispatch(self, value_fn, dist_fn, name, μ, σ2):
        if _is_series(name):
            return value_fn(name.name, name)
        if μ is None:
            raise ValueError("μ cannot be None")
        if σ2 is None:
            return value_fn(name, μ)
        return dist_fn(name, μ, σ2)

    def transform(self, name, μ=None, σ2=None):
        """Natural → transformed for a value, (μ, σ2) pair, or Series."""
        if _is_series(name):
            return self._transform_value(name.name, name)
        if μ is None:
            raise ValueError("μ cannot be None")
        return self._dispatch(self._transform_value, self._transform_dist, name, μ, σ2)

    def untransform(self, name, μ=None, σ2=None):
        """Transformed → natural for a value, (μ, σ2) pair, or Series."""
        if _is_series(name):
            return self._untransform_value(name.name, name)
        if σ2 is None:
            return self._untransform_value(name, μ)
        return self._untransform_dist(name, μ, σ2)

    def stdz(self, name, μ=None, σ2=None):
        """Natural → standardized for a value, (μ, σ2) pair, or Series."""
        return self._dispatch(self._stdz_value, self._stdz_dist, name, μ, σ2)

    def unstdz(self, name, μ=None, σ2=None):
        """Standardized → natural for a value, (μ, σ2) pair, or Series."""
        if _is_series(name):
            return self._unstdz_value(name.name, name)
        if σ2 is None:
            return self._unstdz_value(name, μ)
        return self._unstdz_dist(name, μ, σ2)

    # -- value-space internals ------------------------------------------------

    def _fwd(self, name):
        return self.transforms.get(name, _TRANSFORM_PAIRS["identity"])[0]

    def _inv(self, name):
        return self.transforms.get(name, _TRANSFORM_PAIRS["identity"])[1]

    def _moments(self, name):
        μ = self.get(name, {"μ": 0})["μ"]
        σ2 = self.get(name, {"σ2": 1})["σ2"]
        return μ, σ2

    def _transform_value(self, name, x):
        return self._fwd(name)(x)

    def _untransform_value(self, name, x):
        return self._inv(name)(x)

    def _stdz_value(self, name, x):
        μ, σ2 = self._moments(name)
        x_t = self.transform(name, x)
        if isinstance(x_t, (list, tuple)):  # identity transform leaves lists as-is
            x_t = np.asarray(x_t)
        return np.divide(x_t - μ, np.sqrt(σ2))

    def _unstdz_value(self, name, z):
        μ, σ2 = self._moments(name)
        return self.untransform(name, np.multiply(z, np.sqrt(σ2)) + μ)

    # -- distribution-space internals ------------------------------------------
    #
    # Following scipy conventions (reference gumbi/aggregation.py:402-448): a
    # lognorm(scale=μ, s=σ) in natural space is norm(loc=log μ, scale=σ) in log
    # space — the "mean" descriptor moves through the transform, the variance
    # (transformed-space variance) is unchanged.

    @property
    def mean_transforms(self):
        """Distribution-mean conversion rules keyed by forward transform."""
        return {
            skip: [lambda μ, σ2: μ, lambda μ, σ2: μ],
            np.log: [lambda μ, σ2: np.log(μ), lambda μ, σ2: np.exp(μ)],
            logit: [lambda μ, σ2: logit(μ), lambda μ, σ2: expit(μ)],
        }

    @property
    def var_transforms(self):
        """Distribution-variance conversion rules keyed by forward transform."""
        passthrough = [lambda μ, σ2: σ2, lambda μ, σ2: σ2]
        return {skip: passthrough, np.log: passthrough, logit: passthrough}

    def _transform_dist(self, name, mean, var):
        f = self._fwd(name)
        return self.mean_transforms[f][0](mean, var), self.var_transforms[f][0](mean, var)

    def _untransform_dist(self, name, mean, var):
        f = self._fwd(name)
        return self.mean_transforms[f][1](mean, var), self.var_transforms[f][1](mean, var)

    def _stdz_dist(self, name, mean, var):
        mean_t, var_t = self.transform(name, mean, var)
        μ, σ2 = self._moments(name)
        return (mean_t - μ) / np.sqrt(σ2), var_t / σ2

    def _unstdz_dist(self, name, z_mean, z_var):
        μ, σ2 = self._moments(name)
        return self.untransform(name, z_mean * np.sqrt(σ2) + μ, z_var * σ2)
