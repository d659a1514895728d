"""Import-path compatibility with the reference's BoTorch backend layout.

The reference exposes ``gumbi.regression.botorch`` with ``GP`` (an alias of
``BotorchGP``, reference gumbi/regression/botorch/__init__.py:1). The port's
:class:`~gumbi_tpu_torch.models.GP` carries the full BotorchGP surface
(multitask structures, gradients, propose), so both spellings resolve to it.
"""

from ..models import GP  # noqa: F401

BotorchGP = GP

__all__ = ["GP", "BotorchGP"]
