"""Gumbi-TPU on PyTorch: the GP engine ported to CUDA (NVIDIA Hopper).

A second package beside the JAX reference ``gumbi_tpu``. It carries the
engine that ``GP.fit`` and ``predict_grid`` drive for the multi-output LMC:
kernels, Cholesky likelihoods with analytic backward, priors, the Kronecker
MLL, L-BFGS with multi-restart, and posterior prediction. The one hand
kernel on that path, the fused RBF Gram, is CUDA C++ for ``sm_90a``
(``csrc/rbf_gram.cu``), built with nvcc at first use.

The package imports torch, numpy and scipy only; never JAX, pandas or
``gumbi_tpu``.
"""

import torch as _torch

# GP linear algebra needs true f32: a TF32 product keeps ~3 decimal digits,
# which makes N×N RBF Grams indefinite. Mirrors the reference's
# ``jax_default_matmul_precision = "highest"`` (gumbi_tpu/__init__.py).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from . import convert, ops, utils  # noqa: E402,F401

__version__ = "0.1.0"
