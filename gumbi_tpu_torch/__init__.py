"""Gumbi-TPU on PyTorch: the GP engine ported to CUDA (NVIDIA Hopper).

A second package beside the JAX reference ``gumbi_tpu``. It carries the
engine that ``GP.fit`` and ``predict_grid`` drive: kernels, Cholesky
likelihoods with analytic backward, priors, the Kronecker MLL, L-BFGS with
multi-restart, and posterior prediction; and the model layer on top of it
(``GP``, the classifier ``GPC``, ``Regressor``, the structured arrays and
the ``Standardizer``, with the reference's ``regression`` aliases),
with ``ParrayPlotter`` and the matplotlib styles of ``style``.
The hand kernels are CUDA C++ for ``sm_90a`` (``csrc/``), built with nvcc
at first use.

``import gumbi_tpu_torch`` imports torch, numpy and scipy only; never JAX or
``gumbi_tpu``, and pandas only when ``DataSet`` (or :mod:`.aggregation`,
:mod:`.data`) is asked for. The model layer's names (``GP``, ``parray``,
``uparray``, ``mvuparray``, ``Standardizer``, ``DataSet``, ``ParrayPlotter``,
``__version__``, ...) resolve on first access; matplotlib is imported only
when a plot is drawn.
"""

import torch as _torch

# GP linear algebra needs true f32: a TF32 product keeps ~3 decimal digits,
# which makes N×N RBF Grams indefinite. Mirrors the reference's
# ``jax_default_matmul_precision = "highest"`` (gumbi_tpu/__init__.py).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from . import convert, ops, utils  # noqa: E402,F401

# Top-level names of the model layer, as ``gumbi_tpu`` exposes them, each
# imported on first access: name → (module, attribute).
_LAZY = {
    "GP": ("models", "GP"),
    "GPC": ("models", "GPC"),
    "Regressor": ("models", "Regressor"),
    "Standardizer": ("standardizer", "Standardizer"),
    "LayeredArray": ("arrays", "LayeredArray"),
    "ParameterArray": ("arrays", "ParameterArray"),
    "UncertainArray": ("arrays", "UncertainArray"),
    "UncertainParameterArray": ("arrays", "UncertainParameterArray"),
    "MVUncertainParameterArray": ("arrays", "MVUncertainParameterArray"),
    "parray": ("arrays", "ParameterArray"),
    "uarray": ("arrays", "UncertainArray"),
    "uparray": ("arrays", "UncertainParameterArray"),
    "mvuparray": ("arrays", "MVUncertainParameterArray"),
    "make_deltas_parray": ("array_utils", "make_deltas_parray"),
    "stack": ("array_utils", "stack"),
    "vstack": ("array_utils", "vstack"),
    "hstack": ("array_utils", "hstack"),
    "DataSet": ("aggregation", "DataSet"),
    "TidyData": ("aggregation", "TidyData"),
    "WideData": ("aggregation", "WideData"),
    "ParrayPlotter": ("plotting", "ParrayPlotter"),
    "__version__": ("versions", "__version__"),
}
_LAZY_MODULES = ("models", "regression", "arrays", "array_utils", "standardizer", "aggregation", "data", "plotting",
                 "style", "versions")


def __getattr__(name):
    import importlib

    if name in _LAZY:
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(f".{module}", __name__), attr)
    if name in _LAZY_MODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
