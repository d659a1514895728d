"""Structured arrays carrying names, transforms, and analytic uncertainty.

A copy of ``gumbi_tpu/arrays.py`` (same classes and bodies). These are the
host-side input/output currency of the model layer:

* :class:`LayeredArray` — one or more named values at every index
* :class:`ParameterArray` (``parray``) — layers + a Standardizer (``.z``/``.t``)
* :class:`UncertainArray` (``uarray``) — (μ, σ2) normal at every index
* :class:`UncertainParameterArray` (``uparray``) — (μ, σ2) + transform semantics
* :class:`MVUncertainParameterArray` (``mvuparray``) — joint multi-output
  marginals plus a shared correlation matrix

The Standardizer comes from :mod:`.standardizer`, so this module imports
without pandas.
"""

from __future__ import annotations

import warnings

import numpy as np
from scipy.special import expit, logit
from scipy.stats import chi2, lognorm, multivariate_normal, ncx2, norm, rv_continuous

from .standardizer import Standardizer
from .utils import assert_in, skip

__all__ = [
    "LayeredArray",
    "ParameterArray",
    "UncertainArray",
    "UncertainParameterArray",
    "MVUncertainParameterArray",
]


################################################################################
# First-order (delta-method) uncertainty propagation on (μ, σ2) pairs.
# Operands are treated as independent; correlations between them are not
# tracked (documented reference behavior, gumbi/arrays.py:538-544).
################################################################################


def _as_pair(x):
    """Coerce an operand to a (mean, variance) pair."""
    if isinstance(x, tuple):
        return x
    return np.asarray(x, dtype=float), 0.0


def _u_add(a, b):
    (μa, va), (μb, vb) = _as_pair(a), _as_pair(b)
    return μa + μb, va + vb


def _u_sub(a, b):
    (μa, va), (μb, vb) = _as_pair(a), _as_pair(b)
    return μa - μb, va + vb


def _u_mul(a, b):
    (μa, va), (μb, vb) = _as_pair(a), _as_pair(b)
    return μa * μb, μb**2 * va + μa**2 * vb


def _u_div(a, b):
    (μa, va), (μb, vb) = _as_pair(a), _as_pair(b)
    return μa / μb, va / μb**2 + (μa**2 / μb**4) * vb


def _u_pow(a, b):
    (μa, va), (μb, vb) = _as_pair(a), _as_pair(b)
    f = μa**μb
    dfda = μb * μa ** (μb - 1)
    var = dfda**2 * va
    if np.any(vb != 0):
        var = var + (f * np.log(μa)) ** 2 * vb
    return f, var


def _u_sum(μ, σ2, axis=None, keepdims=False):
    return np.sum(μ, axis=axis, keepdims=keepdims), np.sum(σ2, axis=axis, keepdims=keepdims)


def _u_mean(μ, σ2, axis=None, keepdims=False):
    n = μ.size if axis is None else np.prod([μ.shape[ax] for ax in np.atleast_1d(axis)])
    m = np.mean(μ, axis=axis, keepdims=keepdims)
    v = np.sum(σ2, axis=axis, keepdims=keepdims) / n**2
    return m, v


################################################################################
# Distribution helpers
################################################################################


class LogitNormal(rv_continuous):
    r"""Logit-normal random variable.

    Parameterized by the mean ``loc`` (in natural 0–1 space) and standard
    deviation ``scale`` of the underlying normal variable X with expit(X) = Y.
    Parity: reference gumbi/arrays.py:26-56.
    """

    def __init__(self, loc=0.5, scale=1):
        super().__init__(self)
        self.scale = scale
        self.loc = logit(loc)

    def _normal(self):
        return norm(loc=self.loc, scale=self.scale)

    def _pdf(self, x):
        return self._normal().pdf(logit(x)) / (x * (1 - x))

    def _cdf(self, x):
        return self._normal().cdf(logit(x))

    def ppf(self, q):
        return expit(self._normal().ppf(q))

    def rvs(self, size=None, random_state=None):
        return expit(self._normal().rvs(size=size, random_state=random_state))


class MultivariateNormalish:
    r"""Frozen multivariate normal taking/returning :class:`ParameterArray`.

    The distribution itself lives in standardized space; arguments are
    standardized internally and samples are returned in natural space.
    Parity: reference gumbi/arrays.py:59-171 (with its pdf/logcdf raw-input
    quirks corrected: all densities standardize their inputs).

    Parameters
    ----------
    mean : ParameterArray
        0-d ParameterArray holding the distribution mean.
    cov : float or np.ndarray
        Covariance matrix in standardized space.
    """

    def __init__(self, mean: ParameterArray, cov, **kwargs):
        assert isinstance(mean, ParameterArray), "Mean must be a ParameterArray"
        if mean.ndim != 0:
            raise NotImplementedError(
                "Multidimensional multivariate distributions are not yet supported."
            )
        self._names = mean.names
        self._stdzr = mean.stdzr
        self._frozen = multivariate_normal(mean=mean.z.values(), cov=cov, **kwargs)

    @property
    def mean(self):
        return self._frozen.mean

    @property
    def cov(self):
        return self._frozen.cov

    def _z(self, x):
        if isinstance(x, ParameterArray):
            return x.z.dstack()
        return x

    def pdf(self, x) -> float:
        """Probability density function (input standardized if a parray)."""
        return self._frozen.pdf(self._z(x))

    def logpdf(self, x) -> float:
        """Log probability density function."""
        return self._frozen.logpdf(self._z(x))

    def cdf(self, x) -> float:
        """Cumulative distribution function."""
        return self._frozen.cdf(self._z(x))

    def logcdf(self, x) -> float:
        """Log cumulative distribution function."""
        return self._frozen.logcdf(self._z(x))

    def rvs(self, size=1, random_state=None) -> ParameterArray:
        """Draw correlated samples, returned as a natural-space ParameterArray."""
        samples = self._frozen.rvs(size=size, random_state=random_state)
        return ParameterArray(
            **{p: samples[..., i] for i, p in enumerate(self._names)},
            stdzd=True,
            stdzr=self._stdzr,
        )


################################################################################
# LayeredArray
################################################################################


def _layered_dtype(arrays: dict) -> np.dtype:
    return np.dtype([(name, np.asarray(arr).dtype) for name, arr in arrays.items()])


def _build_structured(arrays: dict):
    arrays = {name: np.asarray(arr) for name, arr in arrays.items() if arr is not None}
    proto = np.empty(next(iter(arrays.values())).shape, dtype=_layered_dtype(arrays))
    for name, arr in arrays.items():
        proto[name] = arr
    return proto


def _unwrap(la):
    """Single-layer array → plain ndarray of the field.

    Numerics are cast to float; bools are kept intact so comparison/logical
    ufuncs keep working under numpy 2.
    """
    if len(la.names) > 1:
        raise ValueError("Cannot operate on array with multiple layer names")
    field = np.asarray(la.view(np.ndarray)[la.names[0]])
    if field.dtype != np.bool_:
        field = field.astype(float)
    return field


class LayeredArray(np.ndarray):
    """ndarray subclass with one or more named "layers" at every index.

    Parity: reference gumbi/arrays.py:174-307.
    """

    # `cls, /` keeps the class argument positional-only so a data column
    # named "cls" (e.g. classification labels) lands in **arrays instead of
    # colliding with it.
    def __new__(cls, /, stdzr=None, **arrays):
        if not arrays:
            raise ValueError("Must supply at least one array")
        la = _build_structured(arrays).view(cls)
        la.names = list(la.dtype.fields.keys())
        la.stdzr = stdzr
        return la

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.names = getattr(obj, "names", None)
        self.stdzr = getattr(obj, "stdzr", None)

    def __array_ufunc__(self, ufunc, method, *inputs, out=None, **kwargs):
        layer_names = {la.names[0] for la in inputs if isinstance(la, LayeredArray)}
        if len(layer_names) > 1:
            warnings.warn(
                "Operating on arrays with different layer names, results may be unexpected."
            )
        args = [_unwrap(arg) if isinstance(arg, LayeredArray) else arg for arg in inputs]

        # ``out`` arrives as the named parameter (NOT in kwargs — reading
        # kwargs here silently dropped every out= request, including the one
        # behind augmented assignment). LayeredArray targets are passed as
        # genuine field VIEWS so the ufunc writes through to their buffers
        # (_unwrap's astype would copy).
        outputs = out
        if outputs:

            def _out_view(o):
                if len(o.names) > 1:
                    raise ValueError("Cannot operate on array with multiple layer names")
                return o.view(np.ndarray)[o.names[0]]

            kwargs["out"] = tuple(
                _out_view(o) if isinstance(o, LayeredArray) else o for o in outputs
            )
        else:
            outputs = (None,) * ufunc.nout

        results = super().__array_ufunc__(ufunc, method, *args, **kwargs)
        if results is NotImplemented:
            return NotImplemented
        if ufunc.nout == 1:
            results = (results,)
        wrapped = tuple(
            LayeredArray(**{self.names[0]: res}) if output is None else output
            for res, output in zip(results, outputs)
        )
        return wrapped[0] if len(wrapped) == 1 else wrapped

    # numpy 2 refuses to compare structured arrays to plain ones directly, so
    # route comparisons through the single-layer unwrap explicitly.
    def _compare(self, other, op):
        a = _unwrap(self)
        b = _unwrap(other) if isinstance(other, LayeredArray) else other
        return op(a, b)

    def __eq__(self, other):
        return self._compare(other, np.equal)

    def __ne__(self, other):
        return self._compare(other, np.not_equal)

    def __lt__(self, other):
        return self._compare(other, np.less)

    def __le__(self, other):
        return self._compare(other, np.less_equal)

    def __gt__(self, other):
        return self._compare(other, np.greater)

    def __ge__(self, other):
        return self._compare(other, np.greater_equal)

    def __hash__(self):
        return object.__hash__(self)

    @staticmethod
    def _getitem_arrays(default, item):
        """Classify an indexing result into a rebuildable dict of layers, or None."""
        if isinstance(item, str):
            return {item: default}
        if isinstance(item, (int, np.int32, np.int64)) or (
            isinstance(item, tuple) and all(isinstance(v, int) for v in item)
        ):
            return {name: value for name, value in zip(default.dtype.names, default)}
        if isinstance(item, slice):
            return {la.names[0]: la.values() for la in default.as_list()}
        return None

    def __getitem__(self, item):
        default = super().__getitem__(item)
        arrays = self._getitem_arrays(default, item)
        if arrays is None:
            return default
        return LayeredArray(**arrays)

    def __repr__(self):
        return f"{tuple(self.names)}: {np.asarray(self)}"

    def __str__(self):
        return repr(self)

    def get(self, name, default=None):
        """Layer by name, or a default wrapped as a LayeredArray."""
        if name in self.names:
            return self[name]
        if default is None:
            return None
        return LayeredArray(**{name: default})

    def drop(self, name, missing_ok=True):
        """Remove a layer by name."""
        if name in self.names:
            return LayeredArray(**{p: arr for p, arr in self.as_dict().items() if p != name})
        if missing_ok:
            return self
        raise KeyError(f"Name {name} not found in array.")

    def values(self) -> np.ndarray:
        """Layers stacked into a plain float ndarray (leading axis if >1 layer)."""
        stacked = np.stack([self[name].astype(float) for name in self.names])
        return stacked if len(self.names) > 1 else stacked[0]

    def dstack(self) -> np.ndarray:
        """Layers stacked along a third (depth) axis."""
        return np.dstack([la.values() for la in self.as_list()])

    def as_list(self, order=None) -> list:
        order = self.names if order is None else order
        assert all(name in order for name in self.names)
        return [self[name] for name in order]

    def as_dict(self) -> dict:
        """Layer values keyed by name."""
        return {name: self[name].values() for name in self.names}

    def add_layers(self, **arrays):
        """Return a new array with additional layers at each index."""
        new = arrays.as_dict() if isinstance(arrays, LayeredArray) else arrays
        return LayeredArray(**{**self.as_dict(), **new})


################################################################################
# ParameterArray
################################################################################


class ParameterArray(LayeredArray):
    """LayeredArray that knows its Standardizer: ``.z``/``.t`` views per layer.

    Construct with ``stdzd=True`` to supply standardized values. Also
    accessible through the alias ``parray``. Parity: reference
    gumbi/arrays.py:310-483.
    """

    def __new__(cls, /, stdzr: Standardizer, stdzd=False, **arrays):
        if not arrays:
            raise ValueError("Must supply at least one array")
        if stdzd:
            arrays = {
                name: stdzr.unstdz(name, np.array(arr)) for name, arr in arrays.items()
            }
        pa = LayeredArray.__new__(cls, **arrays)
        pa.stdzr = stdzr
        return pa

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        result = super().__array_ufunc__(ufunc, method, *inputs, **kwargs)
        if result is NotImplemented:
            return NotImplemented
        # Repack raw field arrays (no float cast — bool results stay bool).
        raw = {
            name: np.asarray(result.view(np.ndarray)[name]) for name in result.names
        }
        return ParameterArray(**raw, stdzr=self.stdzr, stdzd=False)

    def __getitem__(self, item):
        default = super(LayeredArray, self).__getitem__(item)
        arrays = self._getitem_arrays(default, item)
        if arrays is None:
            return default
        return ParameterArray(**arrays, stdzr=self.stdzr, stdzd=False)

    def get(self, name, default=None):
        """Layer (or list of layers) by name, wrapped as a ParameterArray."""
        if name in self.names:
            return self[name]
        if isinstance(name, (list, tuple)):
            return self.parray(**{p: arr for p, arr in self.as_dict().items() if p in name})
        if default is None:
            return None
        return self.parray(**{name: default})

    def drop(self, name, missing_ok=True):
        if name in self.names:
            return self.parray(**{p: arr for p, arr in self.as_dict().items() if p != name})
        if missing_ok:
            return self
        raise KeyError(f"Name {name} not found in array.")

    @property
    def z(self) -> LayeredArray:
        """Standardized values (layer names suffixed ``_z``)."""
        zdct = {name + "_z": self.stdzr.stdz(name, self[name].values()) for name in self.names}
        return LayeredArray(**zdct, stdzr=self.stdzr)

    @property
    def t(self) -> LayeredArray:
        """Transformed values (layer names suffixed ``_t``)."""
        tdct = {
            name + "_t": self.stdzr.transform(name, self[name].values()) for name in self.names
        }
        return LayeredArray(**tdct, stdzr=self.stdzr)

    def add_layers(self, stdzd=False, **arrays):
        """Return a new parray with additional layers.

        With ``stdzd=True``, the *new* layers are interpreted as standardized
        values and unstandardized on entry.
        """
        if stdzd:
            arrays = {name: self.stdzr.unstdz(name, np.asarray(arr)) for name, arr in arrays.items()}
        merged = LayeredArray.add_layers(self, **arrays)
        return self.parray(**merged.as_dict(), stdzd=False)

    def fill_with(self, **params):
        """Broadcast scalar values for new layers at every index."""
        assert all(isinstance(v, (float, int)) for v in params.values())
        assert all(isinstance(k, str) for k in params.keys())
        return self.add_layers(**{k: np.full(self.shape, v) for k, v in params.items()})

    def parray(self, *args, **kwargs) -> ParameterArray:
        """New ParameterArray sharing this instance's Standardizer."""
        return ParameterArray(*args, **kwargs, stdzr=self.stdzr)

    @classmethod
    def _combine(cls, np_op, parray_list, **kwargs):
        all_names = [pa.names for pa in parray_list]
        if not all(names == all_names[0] for names in all_names):
            raise ValueError("Arrays do not have the same names!")
        new = np_op(parray_list, **kwargs)
        stdzr = parray_list[0].stdzr
        return cls(**{dim: new[dim] for dim in new.dtype.names}, stdzr=stdzr)

    @classmethod
    def stack(cls, parray_list, axis=0, **kwargs):
        return cls._combine(lambda lst, **kw: np.stack(lst, axis=axis, **kw), parray_list, **kwargs)

    @classmethod
    def vstack(cls, parray_list, **kwargs):
        return cls._combine(np.vstack, parray_list, **kwargs)

    @classmethod
    def hstack(cls, parray_list, **kwargs):
        return cls._combine(np.hstack, parray_list, **kwargs)


################################################################################
# UncertainArray
################################################################################


class UncertainArray(np.ndarray):
    """Structured array of (μ, σ2) of a normal distribution at each point.

    Arithmetic propagates uncertainty to first order, treating operands as
    independent. Also accessible through the alias ``uarray``. Parity:
    reference gumbi/arrays.py:486-858.
    """

    def __new__(cls, /, name: str, μ, σ2, stdzr=None, **kwargs):
        μ_ = np.asarray(μ)
        σ2_ = np.asarray(σ2)
        assert μ_.shape == σ2_.shape
        extras = {dim: np.asarray(arr) for dim, arr in kwargs.items() if arr is not None}
        dtype = np.dtype(
            [("μ", μ_.dtype), ("σ2", σ2_.dtype)] + [(d, a.dtype) for d, a in extras.items()]
        )
        proto = np.empty(μ_.shape, dtype=dtype)
        proto["μ"] = μ_
        proto["σ2"] = σ2_
        for dim, arr in extras.items():
            proto[dim] = arr
        ua = proto.view(cls)
        ua.name = name
        ua.stdzr = stdzr
        ua.fields = list(dtype.fields.keys())
        return ua

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.name = getattr(obj, "name", None)
        self.stdzr = getattr(obj, "stdzr", None)
        self.fields = getattr(obj, "fields", None)

    # -- field access -----------------------------------------------------------

    @property
    def μ(self) -> np.ndarray:
        """Mean at each point."""
        return self["μ"]

    @μ.setter
    def μ(self, val):
        self["μ"] = val

    @property
    def σ2(self) -> np.ndarray:
        """Variance at each point."""
        return self["σ2"]

    @σ2.setter
    def σ2(self, val):
        self["σ2"] = val

    @property
    def σ(self) -> np.ndarray:
        """Standard deviation at each point."""
        return np.sqrt(self.σ2)

    @σ.setter
    def σ(self, val):
        self["σ2"] = val**2

    # -- (μ, σ2) pair used for propagation ---------------------------------------

    @property
    def _pair(self):
        return np.asarray(self.μ, dtype=float), np.asarray(self.σ2, dtype=float)

    def _from_pair(self, name, pair, **extra):
        μ, σ2 = pair
        return type(self)(name=name, μ=μ, σ2=σ2, **extra)

    def _extra_means(self):
        return {dim: np.mean(self[dim]) for dim in self.fields if dim not in ("μ", "σ2")}

    @property
    def dist(self) -> rv_continuous:
        """Frozen scipy normal distribution at each point."""
        return norm(loc=self.μ, scale=self.σ)

    @staticmethod
    def stack(uarray_list, axis=0) -> UncertainArray:
        names = [ua.name for ua in uarray_list]
        if not all(name == names[0] for name in names):
            raise ValueError("Arrays do not have the same name!")
        new = np.stack(uarray_list, axis=axis)
        return UncertainArray(names[0], **{dim: new[dim] for dim in new.dtype.names})

    # -- information metrics ------------------------------------------------------

    def nlpd(self, target) -> float:
        """Negative log posterior density of ``target``."""
        return -np.log(self.dist.pdf(target))

    def vEI(self, target, best_yet, k=1) -> float:
        """Vector expected improvement (noncentral-χ² formulation).

        After the target-vector-estimation acquisition of Uhrenholt & Jensen;
        parity: reference gumbi/arrays.py:672-697.
        """
        nc = ((target - self.μ) ** 2) / self.σ2
        h1 = ncx2.cdf(best_yet / self.σ2, k, nc)
        h2 = ncx2.cdf(best_yet / self.σ2, k + 2, nc)
        h3 = ncx2.cdf(best_yet / self.σ2, k + 4, nc)
        return best_yet * h1 - self.σ2 * (k * h2 + nc * h3)

    def KLD(self, other) -> float:
        """Kullback–Leibler divergence KL(self ‖ other)."""
        assert isinstance(other, UncertainArray)
        return (
            np.log(other.σ / self.σ)
            + (self.σ2 + (self.μ - other.μ) ** 2) / (2 * other.σ2)
            - 1 / 2
        )

    def BD(self, other) -> float:
        """Bhattacharyya distance."""
        assert isinstance(other, UncertainArray)
        return 1 / 4 * np.log(1 / 4 * (self.σ2 / other.σ2 + other.σ2 / self.σ2 + 2)) + 1 / 4 * (
            (self.μ - other.μ) ** 2 / (self.σ2 + other.σ2)
        )

    def BC(self, other) -> float:
        """Bhattacharyya coefficient."""
        return np.exp(-self.BD(other))

    def HD(self, other) -> float:
        """Hellinger distance."""
        return np.sqrt(1 - self.BC(other))

    # -- indexing / display ---------------------------------------------------------

    def __repr__(self):
        return f"{self.name}{self.fields}: {np.asarray(self)}"

    def __str__(self):
        return repr(self)

    def __getitem__(self, item):
        default = super().__getitem__(item)
        if isinstance(item, (int, np.int32, np.int64)) or (
            isinstance(item, tuple) and all(isinstance(v, int) for v in item)
        ):
            arrays = {name: value for name, value in zip(default.dtype.names, default)}
            return UncertainArray(self.name, **arrays)
        if isinstance(item, slice):
            return default
        return default.view(np.ndarray)

    # -- reductions and arithmetic ---------------------------------------------------

    def sum(self, axis=None, dtype=None, out=None, keepdims=False, **kwargs) -> UncertainArray:
        """Summation with first-order uncertainty propagation."""
        μ, σ2 = self._pair
        extra = {dim: np.sum(self[dim]) for dim in self.fields if dim not in ("μ", "σ2")}
        return self._from_pair(self.name, _u_sum(μ, σ2, axis=axis, keepdims=keepdims), **extra)

    def mean(self, axis=None, dtype=None, out=None, keepdims=False, **kwargs) -> UncertainArray:
        """Mean with first-order uncertainty propagation."""
        μ, σ2 = self._pair
        return self._from_pair(
            self.name, _u_mean(μ, σ2, axis=axis, keepdims=keepdims), **self._extra_means()
        )

    def _binary(self, op, other, symbol, reverse=False):
        if isinstance(other, UncertainArray):
            rhs = other._pair
            name = (
                self.name
                if self.name == other.name
                else (
                    f"({other.name}{symbol}{self.name})"
                    if reverse
                    else f"({self.name}{symbol}{other.name})"
                )
            )
        else:
            rhs = other
            name = self.name if symbol != "**" else f"({self.name}**{other})"
        a, b = (rhs, self._pair) if reverse else (self._pair, rhs)
        return self._from_pair(name, op(a, b), **self._extra_means())

    def __add__(self, other):
        return self._binary(_u_add, other, "+")

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return self._binary(_u_sub, other, "-")

    def __rsub__(self, other):
        return self._binary(_u_sub, other, "-", reverse=True)

    def __mul__(self, other):
        return self._binary(_u_mul, other, "*")

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        return self._binary(_u_div, other, "/")

    def __pow__(self, other):
        return self._binary(_u_pow, other, "**")


################################################################################
# UncertainParameterArray
################################################################################


class UncertainParameterArray(UncertainArray):
    r"""(μ, σ2) array with transform-aware semantics.

    The stored μ/σ2 live in natural space but follow the scipy lognorm /
    logit-normal convention: for a log variable, ``μ = exp(t.μ)`` and
    ``σ2 = t.σ2``. Arithmetic and means are performed in transformed space
    (where the variable is normal) and mapped back. Also accessible through
    the alias ``uparray``. Parity: reference gumbi/arrays.py:861-1188.
    """

    def __new__(cls, name: str, μ, σ2, stdzr: Standardizer, stdzd=False):
        μ_ = np.asarray(μ)
        σ2_ = np.asarray(σ2)
        assert μ_.shape == σ2_.shape
        if stdzd:
            μ_, σ2_ = stdzr.unstdz(name, μ_, σ2_)
        dtype = np.dtype([("μ", μ_.dtype), ("σ2", σ2_.dtype)])
        proto = np.empty(μ_.shape, dtype=dtype)
        proto["μ"] = μ_
        proto["σ2"] = σ2_
        upa = proto.view(cls)
        upa.name = name
        upa.stdzr = stdzr
        upa.fields = list(dtype.fields.keys())
        return upa

    @property
    def z(self) -> UncertainArray:
        """Standardized (μ, σ2) as an UncertainArray named ``<name>_z``."""
        zμ, zσ2 = self.stdzr.stdz(self.name, self.μ, self.σ2)
        return UncertainArray(f"{self.name}_z", zμ, zσ2, stdzr=self.stdzr)

    @property
    def t(self) -> UncertainArray:
        """Transformed (μ, σ2) as an UncertainArray named ``<name>_t``."""
        tμ, tσ2 = self.stdzr.transform(self.name, self.μ, self.σ2)
        return UncertainArray(f"{self.name}_t", tμ, tσ2, stdzr=self.stdzr)

    @property
    def _ftransform(self):
        return self.stdzr.transforms.get(self.name, [skip, skip])[0]

    @property
    def _pair(self):
        # Propagation happens in standardized space.
        zu = self.z
        return np.asarray(zu.μ, dtype=float), np.asarray(zu.σ2, dtype=float)

    def _from_pair(self, name, pair, **extra):
        z = UncertainArray(name, pair[0], pair[1], **extra)
        return self._from_z(z)

    @property
    def dist(self) -> rv_continuous:
        """Frozen scipy distribution: norm / lognorm / logit-normal by transform."""
        dists = {
            skip: norm(loc=self.μ, scale=self.σ),
            np.log: lognorm(scale=self.μ, s=self.σ),
            logit: LogitNormal(loc=self.μ, scale=self.σ),
        }
        return dists[self._ftransform]

    def sum(self, axis=None, dtype=None, out=None, keepdims=False, **kwargs):
        """Sum in standardized space, mapped back to natural parameters."""
        self._warn_if_poorly_defined()
        return self._from_z(self.z.sum(axis=axis, keepdims=keepdims))

    def mean(self, axis=None, dtype=None, out=None, keepdims=False, **kwargs):
        """Mean of transformed-space distributions, as natural parameters."""
        return self._from_z(self.z.mean(axis=axis, keepdims=keepdims))

    def _from_z(self, z) -> UncertainParameterArray:
        name = z.name.replace("_z", "")
        return UncertainParameterArray(
            name, **{dim: z[dim] for dim in z.fields}, stdzr=self.stdzr, stdzd=True
        )

    def _from_t(self, t) -> UncertainParameterArray:
        name = t.name.replace("_t", "")
        μ, σ2 = self.stdzr.untransform(name, t.μ, t.σ2)
        return UncertainParameterArray(name, μ=μ, σ2=σ2, stdzr=self.stdzr, stdzd=False)

    def _warn_if_dissimilar(self, other):
        if isinstance(other, UncertainParameterArray) and not self.stdzr == other.stdzr:
            warnings.warn("uparrays have dissimilar Standardizers")

    def _warn_if_poorly_defined(self):
        if self._ftransform is not skip:
            warnings.warn(
                f"Transform is poorly defined for {self._ftransform}; results may be unexpected."
            )

    def extract(self, field) -> ParameterArray:
        """A single field (μ, σ2, or σ) as a ParameterArray."""
        assert_in("field", field, self.fields + ["σ"])
        vals = getattr(self, field)
        return ParameterArray(**{self.name: vals}, stdzr=self.stdzr, stdzd=False)

    def __getitem__(self, item):
        default = super(UncertainArray, self).__getitem__(item)
        if isinstance(item, (int, np.int32, np.int64)) or (
            isinstance(item, tuple) and all(isinstance(v, int) for v in item)
        ):
            arrays = {name: value for name, value in zip(default.dtype.names, default)}
            return UncertainParameterArray(self.name, stdzr=self.stdzr, stdzd=False, **arrays)
        if isinstance(item, slice):
            return default
        return default.view(np.ndarray)

    def _t_space_binary(self, op_name, other):
        new = self._from_t(getattr(self.t, op_name)(other.t))
        new.stdzr = Standardizer(**{**self.stdzr, **other.stdzr})
        return new

    def __add__(self, other):
        self._warn_if_dissimilar(other)
        self._warn_if_poorly_defined()
        if isinstance(other, UncertainParameterArray):
            return self._t_space_binary("__add__", other)
        return super().__add__(other)

    def __sub__(self, other):
        self._warn_if_dissimilar(other)
        self._warn_if_poorly_defined()
        if isinstance(other, UncertainParameterArray):
            return self._t_space_binary("__sub__", other)
        return super().__sub__(other)

    def __rsub__(self, other):
        self._warn_if_dissimilar(other)
        self._warn_if_poorly_defined()
        if isinstance(other, UncertainParameterArray):
            return self._t_space_binary("__rsub__", other)
        return super().__rsub__(other)


################################################################################
# MVUncertainParameterArray
################################################################################


class MVUncertainParameterArray(np.ndarray):
    r"""Joint multi-output container: per-output marginals plus correlation.

    Stores per-output marginal (μ, σ2) from a set of equally-shaped
    :class:`UncertainParameterArray` objects and a shared correlation matrix
    ``cor``; the joint covariance in standardized space is
    ``diag(σ) @ cor @ diag(σ)``. Also accessible through the alias
    ``mvuparray``. Parity: reference gumbi/arrays.py:1191-1461.
    """

    def __new__(cls, *uparrays, cor, stdzr=None):
        shape = uparrays[0].shape
        assert all(upa.shape == shape for upa in uparrays)
        assert cor.shape[0] == len(uparrays)
        stdzr = uparrays[0].stdzr if stdzr is None else stdzr

        μ_ = ParameterArray(**{upa.name: upa.μ for upa in uparrays}, stdzr=stdzr)
        σ2_ = ParameterArray(**{upa.name: upa.σ2 for upa in uparrays}, stdzr=stdzr)

        dtype = np.dtype([("μ", μ_.dtype), ("σ2", σ2_.dtype)])
        proto = np.empty(shape, dtype=dtype)
        proto["μ"] = μ_
        proto["σ2"] = σ2_

        mvup = proto.view(cls)
        mvup.names = [upa.name for upa in uparrays]
        mvup.stdzr = stdzr
        mvup.fields = list(dtype.fields.keys())
        mvup.cor = cor
        return mvup

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.names = getattr(obj, "names", None)
        self.fields = getattr(obj, "fields", None)
        self.stdzr = getattr(obj, "stdzr", None)
        self.cor = getattr(obj, "cor", None)

    def __repr__(self):
        return f"{tuple(self.names)}{self.fields}: {np.asarray(self)}"

    def __getitem__(self, item):
        default = super().__getitem__(item)
        if isinstance(item, (int, np.int32, np.int64)) or (
            isinstance(item, tuple) and all(isinstance(v, int) for v in item)
        ):
            arrays = [self.get(name)[item] for name in self.names]
            return self.mvuparray(*arrays)
        if isinstance(item, slice):
            return default
        return default.view(ParameterArray)

    def get(self, name, default=None):
        """One output as a uparray, or a named subset as an mvuparray."""
        if isinstance(name, str):
            if name in self.names:
                return self.uparray(name, self["μ"][name].values(), self["σ2"][name].values())
            return default
        if isinstance(name, list):
            idxs = [self.names.index(n) for n in name]
            return self.mvuparray(
                *[self.get(n) for n in name], cor=self.cor[np.ix_(idxs, idxs)]
            )

    @property
    def μ(self) -> ParameterArray:
        """Marginal means."""
        return self["μ"]

    @μ.setter
    def μ(self, val):
        self["μ"] = val

    @property
    def σ2(self) -> ParameterArray:
        """Marginal variances."""
        return self["σ2"]

    @σ2.setter
    def σ2(self, val):
        self["σ2"] = val

    @property
    def σ(self) -> ParameterArray:
        """Marginal standard deviations."""
        return self.parray(**{k: np.sqrt(v) for k, v in self["σ2"].as_dict().items()})

    @property
    def t(self) -> MVUncertainParameterArray:
        """Transformed values with identity-transform moments (names ``_t``)."""
        stdzr = Standardizer(**{k + "_t": v for k, v in self.stdzr.items()})
        return self.mvuparray(*[self.get(name).t for name in self.names], stdzr=stdzr)

    @property
    def z(self) -> MVUncertainParameterArray:
        """Standardized values with default moments (names ``_z``)."""
        stdzr = Standardizer(**{k + "_z": {"μ": 0, "σ2": 1} for k in self.names})
        return self.mvuparray(*[self.get(name).z for name in self.names], stdzr=stdzr)

    def parray(self, *args, **kwargs) -> ParameterArray:
        """New ParameterArray sharing this instance's Standardizer."""
        kwargs.setdefault("stdzr", self.stdzr)
        return ParameterArray(*args, **kwargs)

    def uparray(self, *args, **kwargs) -> UncertainParameterArray:
        """New UncertainParameterArray sharing this instance's Standardizer."""
        kwargs.setdefault("stdzr", self.stdzr)
        return UncertainParameterArray(*args, **kwargs)

    def mvuparray(self, *args, **kwargs) -> MVUncertainParameterArray:
        """New MVUncertainParameterArray sharing this Standardizer and cor."""
        kwargs.setdefault("stdzr", self.stdzr)
        kwargs.setdefault("cor", self.cor)
        return MVUncertainParameterArray(*args, **kwargs)

    def cov(self, stdzd=True, whiten=1e-10) -> np.ndarray:
        """Covariance matrix (0-d arrays only): ``diag(σ) @ cor @ diag(σ)``."""
        if self.ndim != 0:
            raise NotImplementedError(
                "Multidimensional multivariate covariance calculations are not yet supported."
            )
        σ = self.z.σ.values() if stdzd else self.t.σ.values()
        cov = np.diag(σ) @ self.cor @ np.diag(σ)
        if whiten:
            cov += whiten * np.eye(*cov.shape)
        return cov

    @property
    def dist(self) -> MultivariateNormalish:
        """Joint distribution (0-d arrays only)."""
        if self.ndim != 0:
            raise NotImplementedError(
                "Multidimensional multivariate distributions are not yet supported."
            )
        return MultivariateNormalish(mean=self.μ, cov=self.cov(stdzd=True))

    def nlpd(self, target) -> np.ndarray:
        """Marginal negative log posterior density of ``target`` per output.

        ``target`` is a structured array (or LayeredArray/dict) carrying one
        field per output name. Returns an array stacked over outputs — the
        joint (correlated) density is available via ``.dist`` for 0-d arrays.
        Reference parity note: the reference defines nlpd only on
        UncertainArray (ref arrays.py:668), so its multi-output
        cross-validation path crashes here; this method makes multi-output
        cross_validate work.
        """
        if isinstance(target, LayeredArray):
            # Match layers by NAME: .values() stacks in the target's own layer
            # order, which silently mispairs outputs when the target was built
            # with layers in a different order than self.names.
            target = target.as_dict()
        if isinstance(target, np.ndarray) and target.dtype.names:
            target = {name: target[name] for name in target.dtype.names}
        elif isinstance(target, np.ndarray):
            # LayeredArray.values() stacks layers on the leading axis in
            # name order — accept that layout directly.
            if target.shape[0] != len(self.names):
                raise ValueError(
                    f"target leading axis ({target.shape[0]}) must match the "
                    f"number of outputs ({len(self.names)})"
                )
            target = {name: target[i] for i, name in enumerate(self.names)}
        if not isinstance(target, dict):
            raise TypeError(
                "mvuparray.nlpd needs a structured target with one field per output"
            )
        return np.stack([self.get(name).nlpd(np.asarray(target[name])) for name in self.names])

    def mahalanobis(self, parray: ParameterArray) -> float:
        """Mahalanobis distance between this distribution and a point."""
        cov_inv = np.linalg.inv(self.cov(stdzd=True))
        points = np.stack([parray.z.get(p + "_z").values() for p in self.names])
        μ = np.stack([self.z.μ.get(p + "_z").values() for p in self.names])
        diff = points - μ
        return np.sqrt(diff.T @ cov_inv @ diff)

    def outlier_pval(self, parray: ParameterArray) -> float:
        """χ²-test p-value that a point is an outlier from this distribution."""
        MD = self.mahalanobis(parray)
        return 1 - chi2.cdf(MD**2, df=len(self.names))
