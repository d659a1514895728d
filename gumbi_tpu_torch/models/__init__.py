"""Models on the port's engine: the ``Regressor`` base, ``GP`` and ``GPC``.

Neither imports pandas: the ``DataSet`` check of ``Regressor.__init__``
imports :mod:`gumbi_tpu_torch.aggregation` when a model is made from a
``DataSet``.
"""

from .base import Regressor  # noqa: F401
from .gp import GP  # noqa: F401
from .gpc import GPC  # noqa: F401

__all__ = ["Regressor", "GP", "GPC"]
