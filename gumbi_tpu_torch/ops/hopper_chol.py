"""Hand-written blocked Cholesky for Hopper and its plain PyTorch version.

Port of ``gumbi_tpu/ops/pallas_chol.py``: the lower Cholesky factor of a
batched SPD matrix (D, N, N) at f32, right-looking and blocked. On a CUDA
tensor :func:`hopper_cholesky` runs the CUDA C++ kernels of
``csrc/blocked_chol.cu`` (built by nvcc for ``sm_90a`` at first use, see
:mod:`._build`): strip and trailing update are 128-wide tile products on the
tensor cores (three TF32 passes, ``csrc/tf32x3.cuh``), and each panel's
diagonal step runs as one CTA of the kernel that applies the previous
panel's update, two launches a panel on the caller's stream. On a CPU
tensor it runs :func:`cholesky_plain`, the same algorithm in torch ops.
:func:`cholesky` is the reference's dispatcher: a 3-D f32 input whose N is a
multiple of 256 takes the hand kernel, every other input the library
factorization.

As in the reference, use is opt-in: the objectives factorize through
:func:`.linalg.safe_cholesky`, and a caller who wants the hand kernel there
puts :func:`seam_cholesky` in its place (``chip_smoke.py`` does, and
measures both). A matrix that is not positive definite gives NaN in that batch entry
(the square root of a negative pivot), never an exception.

``BlockedChol.launches`` counts calls that reached the kernel (CPU calls do
not count).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library
from .linalg import safe_cholesky as _library_cholesky  # bound here: a swapped seam cannot recurse

__all__ = ["BLOCK", "BlockedChol", "cholesky", "cholesky_plain", "hopper_cholesky", "seam_cholesky",
           "tile_product_check"]

BLOCK = 256  # N must be a multiple of this to take the hand kernel (the reference's BLOCK)
PANEL = 128  # panel width of the factorization; csrc/blocked_chol.cu NB


class BlockedChol:
    """Launch counter of the blocked Cholesky kernel."""

    launches = 0  # only _launch_blocked_chol adds to it


def cholesky_plain(A, panel=PANEL, matmul=torch.matmul):
    """Right-looking blocked lower Cholesky of (D, N, N) ``A`` in torch ops.

    Per panel: the diagonal block's factor, the column strip below it by a
    triangular solve, and the trailing update A_ij −= L_ik·L_jkᵀ; the same
    algorithm as the CUDA kernel, at any dtype and on any device. A panel
    that is not positive definite gives NaN from there on in that batch
    entry. The result has a clean upper triangle. ``matmul`` forms the
    trailing product (the tests put :func:`.tf32x3.matmul_3xtf32_plain`
    there to rehearse the kernel's split product on the CPU).
    """
    L = torch.tril(A)
    n = A.shape[-1]
    for k in range(0, n, panel):
        e = min(k + panel, n)
        Lkk = _library_cholesky(L[:, k:e, k:e])
        L[:, k:e, k:e] = Lkk
        if e < n:
            # L_ik = A_ik·L_kk⁻ᵀ, i.e. L_kk·L_ikᵀ = A_ikᵀ
            Lik = torch.linalg.solve_triangular(Lkk, L[:, e:, k:e].transpose(-1, -2), upper=False).transpose(-1, -2)
            L[:, e:, k:e] = Lik
            L[:, e:, e:] -= matmul(Lik, Lik.transpose(-1, -2))
    return torch.tril(L)


@functools.lru_cache(maxsize=None)
def _chol_lib():
    lib = load_library("blocked_chol")
    lib.blocked_chol_f32.argtypes = [
        ctypes.c_void_p,  # L (D, N, N): lower triangle of A in, factor out
        ctypes.c_void_p,  # winv scratch (D, PANEL, PANEL)
        ctypes.c_longlong,  # D
        ctypes.c_longlong,  # N
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.blocked_chol_f32.restype = ctypes.c_int
    lib.blocked_chol_panel.argtypes = []
    lib.blocked_chol_panel.restype = ctypes.c_int
    lib.blocked_chol_product_test_f32.argtypes = [ctypes.c_void_p] * 4  # a, b, c (128 x 128 each), stream
    lib.blocked_chol_product_test_f32.restype = ctypes.c_int
    if lib.blocked_chol_panel() != PANEL:
        raise RuntimeError("csrc/blocked_chol.cu NB disagrees with hopper_chol.PANEL")
    return lib


def _launch_blocked_chol(A):
    D, n, _ = A.shape
    # The kernel reads only the lower triangle and factors in place, so the
    # output starts as tril(A): its upper triangle is already clean.
    L = torch.tril(A)
    if D == 0:
        return L
    winv = torch.empty((D, PANEL, PANEL), dtype=torch.float32, device=A.device)
    lib = _chol_lib()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.blocked_chol_f32(L.data_ptr(), winv.data_ptr(), D, n, stream)
    if err != 0:
        raise RuntimeError(f"blocked Cholesky kernel launch failed with CUDA error {err}")
    BlockedChol.launches += 1
    return L


def tile_product_check(a, b):
    """``a @ b.T`` for CUDA float32 (PANEL, PANEL) ``a`` and ``b`` through the
    factorization's own 3xTF32 tile product: the product alone, for checks
    against :func:`.tf32x3.matmul_3xtf32_plain`. Not a launch of the
    Cholesky kernel, so it does not count as one."""
    for t in (a, b):
        if t.device.type != "cuda" or t.dtype != torch.float32 or tuple(t.shape) != (PANEL, PANEL):
            raise TypeError(f"tile_product_check takes CUDA float32 ({PANEL}, {PANEL}) tensors")
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty_like(a)
    with torch.cuda.device(a.device):
        err = _chol_lib().blocked_chol_product_test_f32(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"blocked Cholesky tile-product check failed to launch with CUDA error {err}")
    return c


def hopper_cholesky(A):
    """Lower Cholesky factor of batched SPD ``A`` (D, N, N), f32, contiguous,
    N a positive multiple of 256: the CUDA kernel for a CUDA tensor,
    :func:`cholesky_plain` for a CPU tensor. Raises on any other input.
    Forward-only: the objectives never differentiate a factorization."""
    if A.dim() != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"hopper_cholesky takes a (D, N, N) tensor, got {tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise TypeError(f"hopper_cholesky takes float32, got {A.dtype}")
    n = A.shape[-1]
    if n == 0 or n % BLOCK != 0:
        raise ValueError(f"hopper_cholesky: N = {n} must be a positive multiple of {BLOCK}")
    if A.shape[0] > 65535:
        raise ValueError(f"hopper_cholesky: batch {A.shape[0]} exceeds 65535")
    if not A.is_contiguous():
        raise ValueError("hopper_cholesky takes a contiguous tensor")
    if torch.is_grad_enabled() and A.requires_grad:
        raise RuntimeError("hopper_cholesky is forward-only; call it under torch.no_grad()")
    if A.device.type == "cpu":
        return cholesky_plain(A)
    if A.device.type != "cuda":
        raise TypeError(f"hopper_cholesky takes a CUDA or CPU tensor, got {A.device}")
    return _launch_blocked_chol(A)


def cholesky(A):
    """Batched lower Cholesky: the hand kernel when eligible (3-D, f32, N a
    multiple of 256), the library factorization otherwise; NaN where ``A``
    is not positive definite. Eligibility is by shape and dtype alone: an
    eligible CUDA input launches the kernel or raises."""
    if A.dim() == 3 and A.dtype == torch.float32 and A.shape[-1] > 0 and A.shape[-1] % BLOCK == 0:
        return hopper_cholesky(A.contiguous())
    return _library_cholesky(A)


def seam_cholesky(A):
    """:func:`cholesky` for the ``linalg.safe_cholesky`` seam. The dense
    objective factorizes a single (N, N) Gram, which the dispatcher sends to
    the library, so a 2-D input gets a leading batch axis of 1 here and loses
    it again; a batched input goes to the dispatcher as it is.

    Forward-only where the hand kernel is eligible: the objectives factorize
    inside their own ``autograd.Function``, but ``mll.cholesky_factor``,
    ``posterior_cache`` and ``draw_samples`` on parameters that require grad
    must run under ``torch.no_grad()`` with this at the seam (the library
    factorization is differentiable there; this one raises)."""
    return cholesky(A[None])[0] if A.dim() == 2 else cholesky(A)
