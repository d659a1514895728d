"""Device/dtype defaults and reparameterization helpers.

Port of ``gumbi_tpu/utils/jax_utils.py``.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "default_model_dtype",
    "resolve_device",
    "nc_normal",
    "nc_normal_logp",
    "sc_exponential",
    "sc_exponential_logp",
]


def default_model_dtype(device) -> torch.dtype:
    """Default dtype for model arrays on ``device``: f32 on CUDA, f64 on CPU.

    The reference defaults to f32 on its accelerator and f64 elsewhere, and
    uses its hand kernels only at f32. The port keeps that rule with CUDA as
    the accelerator, so the hand ``rbf_gram`` carries every CUDA fit, while
    CPU runs (the parity tests) stay at f64. Pass ``dtype=`` explicitly to
    override.
    """
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def resolve_device(device=None, ref=None) -> torch.device:
    """Where an entry point runs: ``device`` if given, else ``ref``'s device
    when ``ref`` is a tensor, else the CUDA card.

    The CPU is used only when the caller asks for it (``device="cpu"`` or
    CPU tensors). Asking for CUDA where there is none raises; nothing
    carries on on the CPU instead.
    """
    if device is None:
        device = ref.device if isinstance(ref, torch.Tensor) else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gumbi_tpu_torch runs on a CUDA card unless asked for the CPU, and CUDA "
            "is not available here; pass device='cpu' (or CPU tensors) to run on the CPU"
        )
    return device


def nc_normal(z, mu, sigma):
    """Non-centered Normal: z ~ N(0, 1) → x = μ + σ·z."""
    return mu + sigma * z


def nc_normal_logp(z):
    """Log-density of the underlying standard-normal variable."""
    return torch.sum(-0.5 * math.log(2.0 * math.pi) - 0.5 * z**2)


def sc_exponential(e, mu):
    """Scaled Exponential: e ~ Exponential(1) → x = μ·e."""
    return mu * e


def sc_exponential_logp(e):
    """Log-density of the underlying unit-rate exponential variable."""
    return torch.sum(-e)
