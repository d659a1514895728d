"""Import-path compatibility with the reference's PyMC backend layout.

The reference exposes ``gumbi.regression.pymc`` with ``GP``/``GPC`` (aliases
of ``PymcGP``/``PymcGPC``, reference gumbi/regression/pymc/__init__.py:1-2).
The port has a single engine, so both spellings resolve to the same models.
"""

from ..models import GP, GPC  # noqa: F401

PymcGP = GP
PymcGPC = GPC

__all__ = ["GP", "GPC", "PymcGP", "PymcGPC"]
