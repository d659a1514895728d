"""Import-path compatibility with the reference package layout.

The reference exposes ``gumbi.regression`` with ``Regressor``, ``GP``, ``GPC``
(reference gumbi/regression/__init__.py:1-4); models live in
:mod:`gumbi_tpu_torch.models` here, re-exported for drop-in familiarity.
"""

from ..models import GP, GPC, Regressor  # noqa: F401

__all__ = ["Regressor", "GP", "GPC"]
