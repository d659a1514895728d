"""Device/dtype defaults and reparameterization helpers.

Port of ``gumbi_tpu/utils/jax_utils.py``.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "default_model_dtype",
    "resolve_device",
    "TorchStream",
    "ravel_tree",
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


class TorchStream:
    """Standard-normal and uniform draws from one ``torch.Generator``, called
    the way the reference walks its JAX key tree.

    The samplers are written against this interface: ``split(n)`` gives n
    streams (``key, k1, k2 = jax.random.split(key, 3)``), ``split_chains(n)``
    gives one stream with a leading chain axis (``jax.random.split(key, n)``
    mapped over by ``vmap``), ``fold_in(d)`` one derived stream, and
    ``normal(shape)``/``uniform(shape)`` draw a tensor of shape
    ``(*batch, *shape)``. Here every stream shares the one generator, so a
    split only names the draw; an object with the same methods that holds
    JAX keys replays the reference's own draws (the parity tests do that).
    """

    def __init__(self, generator, dtype, device, batch=()):
        self.generator, self.dtype, self.device, self.batch = generator, dtype, torch.device(device), tuple(batch)

    def _like(self, batch=None):
        return TorchStream(self.generator, self.dtype, self.device, self.batch if batch is None else batch)

    def split(self, n):
        return tuple(self._like() for _ in range(n))

    def split_chains(self, n):
        return self._like((n, *self.batch))

    def fold_in(self, data):
        return self._like()

    def normal(self, shape=()):
        return torch.randn((*self.batch, *shape), generator=self.generator, dtype=self.dtype, device=self.device)

    def uniform(self, shape=()):
        return torch.rand((*self.batch, *shape), generator=self.generator, dtype=self.dtype, device=self.device)


def ravel_tree(tree):
    """(flat, unravel) for a dict of tensors, in ``jax.flatten_util.ravel_pytree``'s
    order (keys sorted): ``flat`` is 1-D, and ``unravel(v)`` maps a tensor of
    shape (..., dim) back to a dict whose tensors keep the leading axes."""
    names = sorted(tree)
    shapes = [tuple(tree[k].shape) for k in names]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.cat([tree[k].reshape(-1) for k in names])

    def unravel(v):
        lead = v.shape[:-1]
        return {k: p.reshape(*lead, *s) for k, p, s in zip(names, torch.split(v, sizes, dim=-1), shapes)}

    return flat, unravel


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
