"""Unit-aware plotting: feed parray/uparray values to any matplotlib callable.

A copy of ``gumbi_tpu/plotting.py`` (its class and function sources are held
equal to the reference's by ``tests/test_torch_plotting.py``); matplotlib and
seaborn are imported inside the methods that draw, so importing this module
needs neither.
"""

from __future__ import annotations

import warnings
from typing import Callable, Tuple

import numpy as np
from scipy.special import logit

from .standardizer import Standardizer
from .arrays import (
    LayeredArray,
    ParameterArray,
    UncertainArray,
    UncertainParameterArray,
)
from .utils import round_to_n

__all__ = ["ParrayPlotter"]

_SPACES = ("natural", "transformed", "standardized")


def _strip_suffix(label: str) -> str:
    if label.endswith("_z") or label.endswith("_t"):
        return label[:-2]
    return label


def _parse_parray(pa, scale) -> Tuple[object, str, str]:
    """Extract array/label/space from a (possibly layered) coordinate array."""
    if isinstance(pa, ParameterArray):
        array = {"standardized": pa.z, "transformed": pa.t}.get(scale, pa)
        label = pa.names[0]
    elif isinstance(pa, LayeredArray):
        array = pa
        label = pa.names[0]
        if label.endswith("_z"):
            scale = "standardized"
        elif label.endswith("_t"):
            scale = "transformed"
    else:
        array = pa
        label = ""
    return array, label, scale


def _parse_uparray(upa, scale) -> Tuple[object, str, str]:
    """Extract array/label/space from an uncertain array."""
    if isinstance(upa, UncertainParameterArray):
        array = {"standardized": upa.z, "transformed": upa.t}.get(scale, upa)
    elif isinstance(upa, UncertainArray):
        if upa.name.endswith("_z"):
            scale = "standardized"
        elif upa.name.endswith("_t"):
            scale = "transformed"
        array = upa
    else:
        raise TypeError("Array must be either an UncertainParameterArray or an UncertainArray.")
    return array, upa.name, scale


def _parse_array(array, scale) -> Tuple[np.ndarray, str, str]:
    if isinstance(array, (UncertainParameterArray, UncertainArray)):
        array, label, scale = _parse_uparray(array, scale)
        array = array.μ
    elif isinstance(array, (ParameterArray, LayeredArray)):
        array, label, scale = _parse_parray(array, scale)
        array = array.values()
    else:
        array, label, scale = _parse_parray(array, scale)
    return array, label, scale


class ParrayPlotter:
    r"""Wraps a matplotlib plotting callable with space-aware values and ticks.

    Passes x/y(/z) values extracted in the chosen space ('natural',
    'transformed', 'standardized') as positional args to the wrapped function,
    then relabels ticks according to the ``*_tick_scale`` settings. Passing a
    ``.t`` / ``.z`` child array overrides the respective scale automatically
    (detected from the ``_t`` / ``_z`` name suffix).

    Parameters
    ----------
    x, y : ParameterArray | LayeredArray | UncertainParameterArray | np.ndarray
    z : optional third array for 2-D plots
    stdzr : Standardizer, optional — required only if no array carries one.
    x_scale, y_scale, z_scale : space in which to plot each array
    x_tick_scale, y_tick_scale, z_tick_scale : space in which to label ticks
    """

    def __init__(
        self,
        x,
        y,
        z=None,
        stdzr: Standardizer = None,
        x_scale="natural",
        x_tick_scale="natural",
        y_scale="natural",
        y_tick_scale="natural",
        z_scale="natural",
        z_tick_scale="natural",
    ):
        self.x = x
        self.y = y
        self.z = z
        self.stdzr = stdzr
        self.x_scale, self.x_tick_scale = x_scale, x_tick_scale
        self.y_scale, self.y_tick_scale = y_scale, y_tick_scale
        self.z_scale, self.z_tick_scale = z_scale, z_tick_scale

        self.update()

        for arr in (self.z, self.y, self.x):
            if self.stdzr is None:
                self.stdzr = getattr(arr, "stdzr", None)
        if self.stdzr is None:
            raise ValueError(
                "Standardizer must be provided if none of the arrays contain a Standardizer."
            )

    def update(self):
        """Re-extract plotting arrays from the stored inputs."""
        self.x_, self.xlabel, self.x_scale = _parse_array(self.x, self.x_scale)
        self.y_, self.ylabel, self.y_scale = _parse_array(self.y, self.y_scale)
        if self.z is not None:
            self.z_, self.zlabel, self.z_scale = _parse_array(self.z, self.z_scale)
        else:
            self.z_, self.zlabel = None, None

    def __call__(self, plotter: Callable, **kwargs):
        """Call ``plotter(x, y[, z], **kwargs)`` then fix tick labels."""
        import matplotlib.pyplot as plt

        args = [arg for arg in (self.x_, self.y_, self.z_) if arg is not None]
        out = plotter(*args, **kwargs)
        ax = kwargs.get("ax", plt.gca())
        _format_parray_plot_labels(
            ax,
            self.stdzr,
            self.xlabel,
            self.x_scale,
            self.x_tick_scale,
            self.ylabel,
            self.y_scale,
            self.y_tick_scale,
        )
        return out

    def colorbar(self, mappable=None, cax=None, ax=None, **kwargs):
        """Add a colorbar with ticks/labels converted per the z settings."""
        import matplotlib.pyplot as plt

        cbar = plt.colorbar(mappable=mappable, cax=cax, ax=ax, **kwargs)
        self.zlabel = _strip_suffix(self.zlabel)
        _reformat_tick_labels(cbar, "c", self.zlabel, self.z_scale, self.z_tick_scale, self.stdzr)
        cbar.set_label(_augment_label(self.stdzr, self.zlabel, self.z_tick_scale))
        return cbar

    def plot(self, ci=0.95, ax=None, palette=None, line_kws=None, ci_kws=None):
        """Line plot of y vs x with an optional ppf-based confidence band."""
        import matplotlib.pyplot as plt

        if self.z is not None:
            raise NotImplementedError('Method "plot" not implemented when z_pa is present.')

        palette = _resolve_palette(palette)
        line_kws = {"lw": 2, "color": palette[-2], "zorder": 0, **(line_kws or {})}
        ci_kws = {"lw": 2, "facecolor": palette[1], "zorder": -1, "alpha": 0.5, **(ci_kws or {})}

        ax = plt.gca() if ax is None else ax
        ax.plot(self.x_, self.y_, **line_kws)
        if ci is not None and hasattr(self.y, "σ2"):
            self.plot_ci(ci=ci, ax=ax, **ci_kws)

        _format_parray_plot_labels(
            ax,
            self.stdzr,
            self.xlabel,
            self.x_scale,
            self.x_tick_scale,
            self.ylabel,
            self.y_scale,
            self.y_tick_scale,
        )
        return ax

    def plot_ci(self, ci=0.95, ci_style="fill", center="median", ax=None, **kwargs):
        """Confidence interval band/errorbars from the y-array's distribution."""
        import matplotlib.pyplot as plt

        if self.z is not None:
            raise NotImplementedError('Method "plot_ci" not supported when z_pa is present.')
        if not hasattr(self.y, "σ2"):
            raise NotImplementedError(
                'Method "plot_ci" only supported when y_pa has the "σ2" attribute.'
            )

        ax = plt.gca() if ax is None else ax
        y, *_ = _parse_uparray(self.y, self.y_scale)

        lo = y.dist.ppf((1 - ci) / 2)
        mid = y.dist.ppf(0.5) if center == "median" else y.μ
        hi = y.dist.ppf((1 + ci) / 2)

        if ci_style in ("fill", "band"):
            ax.fill_between(self.x_, lo, hi, **kwargs)
        elif ci_style in ("errorbar", "bar"):
            # Asymmetric vertical CI: (2, N) yerr. The reference passes
            # hi−mid as the 4th positional arg — matplotlib's XERR — drawing
            # spurious horizontal bars (ref plotting.py:261).
            ax.errorbar(self.x_, mid, yerr=np.stack([mid - lo, hi - mid]), **kwargs)
        else:
            raise ValueError("ci_style must be one of ['fill', 'band', 'errorbar', 'bar']")
        return ax


def _resolve_palette(palette):
    import seaborn as sns

    if palette is None:
        return sns.cubehelix_palette()
    if isinstance(palette, str):
        return sns.color_palette(palette)
    return palette


def _format_parray_plot_labels(ax, stdzr, xlabel, x_scale, x_tick_scale, ylabel, y_scale, y_tick_scale):
    xlabel = _strip_suffix(xlabel)
    ylabel = _strip_suffix(ylabel)
    _reformat_tick_labels(ax, "x", xlabel, x_scale, x_tick_scale, stdzr)
    _reformat_tick_labels(ax, "y", ylabel, y_scale, y_tick_scale, stdzr)
    ax.set_xlabel(_augment_label(stdzr, xlabel, x_tick_scale))
    ax.set_ylabel(_augment_label(stdzr, ylabel, y_tick_scale))


def _augment_label(stdzr, label, tick_scale):
    prefixes = {np.log: "log ", logit: "logit "}
    transform = stdzr.transforms.get(label, [None])[0]
    prefix = prefixes.get(transform, "") if tick_scale in ("transformed", "standardized") else ""
    suffix = " (standardized)" if tick_scale == "standardized" else ""
    return f"{prefix}{label}{suffix}"


def _reformat_tick_labels(ax, axis, name, current, new, stdzr, sigfigs=3):
    """Convert tick labels between spaces (only →natural conversions supported)."""
    converters = {
        ("standardized", "natural"): stdzr.unstdz,
        ("transformed", "natural"): stdzr.untransform,
    }
    if current == new:
        return
    key = (current, new)
    if key not in converters:
        raise ValueError("Cannot convert ticks between {0} and {1}".format(*key))
    ticks, set_labels = _get_ticks_setter(ax, axis)
    new_ticks = round_to_n(converters[key](name, ticks), sigfigs)
    set_labels(new_ticks)


def _get_ticks_setter(ax, axis):
    getters = {
        "x": (lambda: ax.get_xticks(), lambda *a, **k: ax.set_xticklabels(*a, **k)),
        "y": (lambda: ax.get_yticks(), lambda *a, **k: ax.set_yticklabels(*a, **k)),
        "z": (lambda: ax.get_zticks(), lambda *a, **k: ax.set_zticklabels(*a, **k)),
        "c": (lambda: ax.get_ticks(), lambda *a, **k: ax.set_ticklabels(*a, **k)),
    }
    get_ticks, set_labels = getters[axis]
    ticks = get_ticks()

    def setter(*args, **kwargs):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            set_labels(*args, **kwargs)

    return ticks, setter
