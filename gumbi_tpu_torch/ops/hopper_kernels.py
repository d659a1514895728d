"""Hand-written Hopper kernels and their plain PyTorch versions.

``rbf_gram``: the fused RBF Gram K = η²·exp(−½‖(x1ᵢ−x2ⱼ)/ls‖²), the port of
``gumbi_tpu/ops/pallas_kernels.py`` ``rbf_gram``. The forward on a CUDA
tensor is the CUDA C++ kernel in ``csrc/rbf_gram.cu`` (built by nvcc for
``sm_90a`` at first use, see :mod:`._build`); on a CPU tensor it is
:func:`rbf_gram_plain`, the same exact elementwise formula in torch. The
backward is the reference's ``_rbf_gram_bwd``: torch ops on the saved K,
so it runs on both devices and is tested on the CPU.

``RbfGram.launches`` counts kernel launches (CPU calls do not count), so a
run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library

__all__ = ["RbfGram", "rbf_gram", "rbf_gram_plain"]


def rbf_gram_plain(x1, x2, ls, eta):
    """η²·exp(−½ Σ_d ((x1−x2)/ls)²) with exact elementwise distances.

    Divides by ls first, as the reference kernel's wrapper does, then sums
    the squared coordinate differences in order d = 0, 1, … — the same
    arithmetic as the CUDA kernel. Works at any dtype, on any device.
    """
    d = x1.shape[1]
    ls_b = ls.expand(d)
    a = x1 / ls_b
    b = x2 / ls_b
    sq = torch.zeros((x1.shape[0], x2.shape[0]), dtype=a.dtype, device=a.device)
    for k in range(d):
        diff = a[:, k : k + 1] - b[:, k : k + 1].T
        sq = sq + diff * diff
    return eta**2 * torch.exp(-0.5 * sq)


@functools.lru_cache(maxsize=None)
def _rbf_lib():
    lib = load_library("rbf_gram")
    fn = lib.rbf_gram_f32
    fn.argtypes = [
        ctypes.c_void_p,  # a
        ctypes.c_void_p,  # b
        ctypes.c_void_p,  # eta2 (device scalar)
        ctypes.c_void_p,  # out
        ctypes.c_longlong,  # n
        ctypes.c_longlong,  # m
        ctypes.c_int,  # d
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch_rbf_gram(x1, x2, ls, eta):
    """Run the CUDA kernel; raise on anything it does not take."""
    for name, t in (("x1", x1), ("x2", x2), ("ls", ls), ("eta", eta)):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise TypeError(
                f"rbf_gram kernel takes CUDA float32 tensors; {name} is "
                f"{t.dtype} on {t.device}"
            )
        if t.device != x1.device:
            raise ValueError(f"rbf_gram: {name} is on {t.device}, x1 on {x1.device}")
    if x1.dim() != 2 or x2.dim() != 2 or x1.shape[1] != x2.shape[1]:
        raise ValueError(f"rbf_gram: x1 {tuple(x1.shape)} and x2 {tuple(x2.shape)} must be (n,d), (m,d)")
    if not (x1.is_contiguous() and x2.is_contiguous()):
        raise ValueError("rbf_gram kernel takes contiguous x1 and x2")
    n, d = x1.shape
    m = x2.shape[0]
    if ls.numel() not in (1, d) or eta.numel() != 1:
        raise ValueError(f"rbf_gram: ls {tuple(ls.shape)} must have 1 or {d} entries, eta 1")
    out = torch.empty((n, m), dtype=torch.float32, device=x1.device)
    if n == 0 or m == 0:
        return out
    ls_b = ls.reshape(-1).expand(d)
    a = (x1 / ls_b).contiguous()
    b = (x2 / ls_b).contiguous()
    eta2 = (eta.reshape(1) ** 2).contiguous()
    fn = _rbf_lib()
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), eta2.data_ptr(), out.data_ptr(), n, m, d, stream)
    if err != 0:
        raise RuntimeError(f"rbf_gram kernel launch failed with CUDA error {err}")
    RbfGram.launches += 1
    return out


def _rbf_gram_bwd(x1, x2, ls, eta, K, gbar, needs):
    """Exact cotangents from the saved output (reference ``_rbf_gram_bwd``).

    With G = ḡ ∘ K (elementwise), rs/cs its row/column sums:
      dη    = (2/η)·ΣG
      dls_d = (Σ_i x1²_id·rs_i + Σ_j x2²_jd·cs_j − 2·x1_dᵀ G x2_d) / ls_d³
      dx1   = −(x1 ∘ rs[:,None] − G @ x2) / ls²
      dx2   = −(x2 ∘ cs[:,None] − Gᵀ @ x1) / ls²
    A shared lengthscale (one entry) gets the sum over d.
    """
    ls_b = ls.reshape(-1).expand(x1.shape[1]).to(K.dtype)
    G = gbar * K
    rs = G.sum(1)
    cs = G.sum(0)
    x1l = x1 / ls_b
    x2l = x2 / ls_b
    d_x1 = d_x2 = d_ls = d_eta = None
    if needs[0] or needs[2]:
        Gx2 = G @ x2l  # (n, d)
    if needs[0]:
        d_x1 = -(x1l * rs[:, None] - Gx2) / ls_b
    if needs[1]:
        d_x2 = -(x2l * cs[:, None] - G.T @ x1l) / ls_b
    if needs[2]:
        d_ls_full = (
            (x1l**2 * rs[:, None]).sum(0)
            + (x2l**2 * cs[:, None]).sum(0)
            - 2.0 * (x1l * Gx2).sum(0)
        ) / ls_b
        if ls.numel() != d_ls_full.numel():
            d_ls_full = d_ls_full.sum()
        d_ls = d_ls_full.reshape(ls.shape).to(ls.dtype)
    if needs[3]:
        d_eta = (2.0 / eta * G.sum()).reshape(eta.shape).to(eta.dtype)
    return d_x1, d_x2, d_ls, d_eta


class RbfGram(torch.autograd.Function):
    """Fused RBF Gram with the reference's analytic backward.

    Forward: the CUDA kernel for a CUDA tensor, :func:`rbf_gram_plain` for
    a CPU tensor. The backward reuses the saved K and never recomputes it.
    """

    launches = 0  # kernel launches; only _launch_rbf_gram adds to it

    @staticmethod
    def forward(ctx, x1, x2, ls, eta):
        if x1.device.type == "cpu":
            K = rbf_gram_plain(x1, x2, ls, eta)
        else:
            K = _launch_rbf_gram(x1, x2, ls, eta)
        ctx.save_for_backward(x1, x2, ls, eta, K)
        return K

    @staticmethod
    def backward(ctx, gbar):
        x1, x2, ls, eta, K = ctx.saved_tensors
        return _rbf_gram_bwd(x1, x2, ls, eta, K, gbar, ctx.needs_input_grad)


def rbf_gram(x1, x2, ls, eta):
    """η²·exp(−½ Σ_d ((x1−x2)/ls)²): the hand kernel on CUDA, plain on CPU."""
    return RbfGram.apply(x1, x2, ls, eta)
