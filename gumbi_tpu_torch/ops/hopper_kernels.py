"""Hand-written Hopper kernels and their plain PyTorch versions.

``rbf_gram``: the fused RBF Gram K = η²·exp(−½‖(x1ᵢ−x2ⱼ)/ls‖²), the port of
``gumbi_tpu/ops/pallas_kernels.py`` ``rbf_gram``. The forward on a CUDA
tensor is the CUDA C++ kernel in ``csrc/rbf_gram.cu`` (built by nvcc for
``sm_90a`` at first use, see :mod:`._build`): one launch per call, which
divides by ls and squares η itself, over a persistent grid whose tiling
:func:`rbf_tile_config` gives (a row strip for n ≤ 8). On a CPU tensor it
is :func:`rbf_gram_plain`, the same exact elementwise formula in torch.
The backward is the reference's ``_rbf_gram_bwd``: torch ops on the saved
K, so it runs on both devices and is tested on the CPU.

``fused_stationary_matvec`` / ``fused_stationary_matvec_sym``: K(x1, x2)·V
and K(x, x)·V for a unit-amplitude stationary kernel with K never stored,
the ports of the reference's fused Pallas matvecs. On a CUDA f32 tensor
they are the CUDA C++ kernels in ``csrc/fused_matvec.cu``; on a CPU tensor
both are :func:`fused_matvec_plain`. They are forward-only, as in the
reference: the iterative engine never differentiates through them. Both
multiply K's tiles with V on the tensor cores (three TF32 passes,
``csrc/tf32x3.cuh``) against V split once per call; each wrapper hands its
kernel a buffer for that split, padded copy and a scratch buffer. The
symmetric kernel builds each 64×64 tile of K once and uses it both ways
(scratch layout: :func:`sym_scratch_shape`); the general one builds each
128×64 tile once per column group of up to 144 columns and splits x2 into
segments with one slot each (:func:`general_split`).

``RbfGram.launches``, ``FusedMatvec.launches`` and
``FusedMatvecSym.launches`` count kernel launches (CPU calls do not count),
so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library

__all__ = [
    "RbfGram",
    "rbf_gram",
    "rbf_gram_plain",
    "rbf_tile_config",
    "FUSABLE_KERNELS",
    "FusedMatvec",
    "FusedMatvecSym",
    "fused_matvec_plain",
    "fused_stationary_matvec",
    "fused_stationary_matvec_sym",
    "general_split",
    "sym_band_split",
    "sym_matvec_fits",
    "sym_padded_cols",
    "sym_scratch_shape",
    "sym_product_check",
]


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


# csrc/rbf_gram.cu's launch configuration: 32×256 tiles, or for n ≤ 8 rows a
# strip of n×1024 tiles, over at most 264 CTAs (two per SM on 132 SMs).
RBF_TILE = (32, 256)
RBF_STRIP_MAX_ROWS = 8
RBF_STRIP_COLS = 1024
RBF_TARGET_CTAS = 264


def rbf_tile_config(n, m, d):
    """(strip, tile_rows, tile_cols, tiles, ctas) of the ``rbf_gram`` kernel
    for an (n, m) output over d coordinates; all zero when n, m or d is
    below 1. Tiles of ``tile_rows`` × ``tile_cols`` cover K in row-major
    tile order (the last row and column tiles ragged), and CTA c of
    ``ctas`` walks tiles ``tiles·c // ctas`` to ``tiles·(c+1) // ctas − 1``.
    n ≤ 8 takes the row strip (``strip`` 1): one tile of all n rows and
    1,024 columns. ``csrc/rbf_gram.cu``'s ``rbf_gram_config`` is the same
    arithmetic; d does not change the tiling."""
    n, m, d = int(n), int(m), int(d)
    if n < 1 or m < 1 or d < 1:
        return (0, 0, 0, 0, 0)
    strip = n <= RBF_STRIP_MAX_ROWS
    rows, cols = (n, RBF_STRIP_COLS) if strip else RBF_TILE
    tiles = -(-n // rows) * -(-m // cols)
    return (int(strip), rows, cols, tiles, min(tiles, RBF_TARGET_CTAS))


@functools.lru_cache(maxsize=None)
def _rbf_lib():
    lib = load_library("rbf_gram")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    # x1, x2, ls, ls_stride, eta, out, n, m, d, stream
    lib.rbf_gram_f32.argtypes = [ptr, ptr, ptr, i64, ptr, ptr, i64, i64, i32, ptr]
    lib.rbf_gram_f32.restype = i32
    lib.rbf_gram_config.argtypes = [i64, i64, i32, ctypes.POINTER(i64)]
    lib.rbf_gram_config.restype = None
    for n, m, d in ((0, 5, 2), (1, 1, 1), (1, 50_000, 2), (8, 1025, 3), (9, 23, 17), (37, 23, 1),
                    (2_500, 50_000, 2), (5_120, 10_000, 2), (16_384, 16_384, 2), (100_000, 100_000, 40)):
        c_cfg = (i64 * 5)()
        lib.rbf_gram_config(n, m, d, c_cfg)
        if tuple(c_cfg) != rbf_tile_config(n, m, d):
            raise RuntimeError("csrc/rbf_gram.cu's launch configuration disagrees with hopper_kernels.rbf_tile_config")
    return lib.rbf_gram_f32


def _launch_rbf_gram(x1, x2, ls, eta):
    """Run the CUDA kernel (one launch, no other device op); raise on
    anything it does not take."""
    if x1.dim() != 2 or x2.dim() != 2 or x1.shape[1] != x2.shape[1]:
        raise ValueError(f"rbf_gram: x1 {tuple(x1.shape)} and x2 {tuple(x2.shape)} must be (n,d), (m,d)")
    if not (x1.is_contiguous() and x2.is_contiguous()):
        raise ValueError("rbf_gram kernel takes contiguous x1 and x2")
    for name, t in (("x1", x1), ("x2", x2), ("ls", ls), ("eta", eta)):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise TypeError(
                f"rbf_gram kernel takes CUDA float32 tensors; {name} is "
                f"{t.dtype} on {t.device}"
            )
        if t.device != x1.device:
            raise ValueError(f"rbf_gram: {name} is on {t.device}, x1 on {x1.device}")
    n, d = x1.shape
    m = x2.shape[0]
    if ls.numel() not in (1, d) or eta.numel() != 1:
        raise ValueError(f"rbf_gram: ls {tuple(ls.shape)} must have 1 or {d} entries, eta 1")
    out = torch.empty((n, m), dtype=torch.float32, device=x1.device)
    if n == 0 or m == 0:
        return out
    ls_v = ls.reshape(-1)  # a view: ls is 1-D, or one entry, on every path
    ls_stride = ls_v.stride(0) if ls_v.numel() > 1 else 0  # 0 for a shared or expanded lengthscale
    fn = _rbf_lib()
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x1.data_ptr(), x2.data_ptr(), ls_v.data_ptr(), ls_stride, eta.data_ptr(), out.data_ptr(),
                 n, m, d, stream)
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


# ------------------------------------------------------------------
# Fused stationary Gram-matvec (the iterative engine's matvec)
# ------------------------------------------------------------------

# Stationary kernels the fused matvec evaluates from a scaled squared
# distance alone (the reference's FUSABLE_KERNELS), with their code in
# csrc/fused_matvec.cu.
FUSABLE_KERNELS = ("ExpQuad", "RBF", "Matern12", "Matern32", "Matern52", "Exponential")
_KIND = {"ExpQuad": 0, "RBF": 0, "Matern12": 1, "Exponential": 2, "Matern32": 3, "Matern52": 4}

# The symmetric kernel's deterministic reduction keeps one padded (n, r) slot
# per band and per band-walker; past this much scratch the engine takes the
# general kernel (the reference gated on its 32 MB VMEM accumulator instead).
SYM_SCRATCH_BYTES_MAX = 1 << 30
SYM_TILE = 384  # band-grid block rows; csrc/fused_matvec.cu SYM_T
SYM_SUBTILE = 64  # K tile edge; V's rows are padded to a multiple of it
SYM_CHUNK = 72  # widest column chunk of the symmetric kernel (nine 8-column mma tiles)
SYM_TARGET_CTAS = 396  # about three waves of one CTA per SM on 132 SMs
GEN_ROWS = 128  # rows of x1 per CTA of the general kernel; csrc/fused_matvec.cu GEN_ROWS
GEN_GROUP = 2  # column chunks (of up to 72 columns) per CTA of the general kernel
GEN_TARGET_CTAS = 352  # 8/3 waves of one CTA per SM on 132 SMs

# Rows of K the plain version forms at once: ~2^28 entries (1 GiB at f32).
_PLAIN_ENTRIES = 1 << 28


def fused_matvec_plain(x1, x2, v, ls, kernel="ExpQuad"):
    """K(x1, x2) @ v with unit amplitude, in plain torch, any dtype and device.

    The same arithmetic as the CUDA kernels: divide by ls first, sum the
    squared coordinate differences in order d = 0, 1, …, apply the
    stationary kernel (:func:`.kernels._stationary`), then one matmul. K is
    formed in row chunks of about 2^28 entries, never whole at large n·m.
    """
    from .kernels import _stationary

    n, d = x1.shape
    m = x2.shape[0]
    ls_b = ls.reshape(-1).expand(d)
    a = x1 / ls_b
    b = x2 / ls_b
    out = torch.empty((n, v.shape[1]), dtype=v.dtype, device=v.device)
    step = max(1, _PLAIN_ENTRIES // max(m, 1))
    for s in range(0, n, step):
        sq = torch.zeros((min(step, n - s), m), dtype=a.dtype, device=a.device)
        for k in range(d):
            diff = a[s : s + step, k : k + 1] - b[:, k : k + 1].T
            sq = sq + diff * diff
        out[s : s + step] = _stationary(kernel, sq) @ v
    return out


def sym_padded_cols(r):
    """Columns of the padded V and scratch for ``r`` columns: full chunks of
    72, then the remainder's chunk of 8, 16, 32, 64 or 72 columns."""
    full, rem = divmod(int(r), SYM_CHUNK)
    rem_cols = 0 if rem == 0 else next(c for c in (8, 16, 32, 64, SYM_CHUNK) if rem <= c)
    return full * SYM_CHUNK + rem_cols


def general_split(n, m, r):
    """(s, n_pad, m_pad, r_pad) of the general kernel for K(x1, x2)·V with
    x1 of n rows, x2 of m rows and V of r columns: x1's rows padded to 128
    (a CTA's row block), x2's to 64 (a tile), V's columns to the chunk
    widths (:func:`sym_padded_cols`); s is the number of x2 segments, the
    least that makes row blocks × column groups (two chunks each) × s at
    least 352 CTAs, never more than there are x2 tiles. At s > 1 the
    scratch is s slots of (n_pad, r_pad) f32; V's split is 2·m_pad·r_pad
    f32 either way. ``csrc/fused_matvec.cu``'s
    ``fused_matvec_general_split`` is the same arithmetic."""
    n, m = int(n), int(m)
    n_pad = -(-n // GEN_ROWS) * GEN_ROWS
    m_pad = -(-m // SYM_SUBTILE) * SYM_SUBTILE
    rp = sym_padded_cols(r)
    chunks = -(-rp // SYM_CHUNK)
    groups = -(-chunks // GEN_GROUP)
    ctas = (n_pad // GEN_ROWS) * groups
    return min(m_pad // SYM_SUBTILE, -(-GEN_TARGET_CTAS // ctas)), n_pad, m_pad, rp


def sym_band_split(n):
    """Band walkers per row block for an (n, n) self-Gram: with
    nb = ⌈n / 384⌉ row blocks the band grid has nb // 2 + 1 bands, CTA (I, s)
    walks bands s, s + n_split, …, and n_split is the least number that
    makes nb · n_split CTAs about three waves on the card (never more than
    there are bands)."""
    nb = -(-int(n) // SYM_TILE)
    return min(nb // 2 + 1, max(1, -(-SYM_TARGET_CTAS // nb)))


def sym_scratch_shape(n, r):
    """(slots, n_pad, r_pad) of the symmetric kernel's f32 scratch for an
    (n, n) self-Gram against r columns: one own slot per band walker (rows
    I, summed over its bands; these come first), then one slot per band but
    the diagonal one for the transposed partials, each of (n padded to 64)
    × (r padded to the chunk widths)."""
    n = int(n)
    nb = -(-n // SYM_TILE)
    n_pad = -(-n // SYM_SUBTILE) * SYM_SUBTILE
    return sym_band_split(n) + nb // 2, n_pad, sym_padded_cols(r)


def sym_matvec_fits(n, r):
    """Whether the symmetric kernel's scratch (:func:`sym_scratch_shape`)
    stays within 1 GiB for an (n, n) self-Gram against r columns."""
    slots, n_pad, rp = sym_scratch_shape(n, r)
    return slots * n_pad * rp * 4 <= SYM_SCRATCH_BYTES_MAX


@functools.lru_cache(maxsize=None)
def _fused_lib():
    lib = load_library("fused_matvec")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.fused_matvec_f32.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i32, i32, i32, ptr]
    lib.fused_matvec_f32.restype = i32
    lib.fused_matvec_general_split.argtypes = [i64, i64, i64, ctypes.POINTER(i64)]
    lib.fused_matvec_general_split.restype = None
    lib.fused_matvec_sym_f32.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, i32, i32, i32, ptr]
    lib.fused_matvec_sym_f32.restype = i32
    lib.fused_matvec_sym_tile.argtypes = []
    lib.fused_matvec_sym_tile.restype = i32
    lib.fused_matvec_sym_padded_cols.argtypes = [i64]
    lib.fused_matvec_sym_padded_cols.restype = i64
    lib.fused_matvec_product_test_f32.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.fused_matvec_product_test_f32.restype = i32
    if lib.fused_matvec_sym_tile() != SYM_TILE:
        raise RuntimeError("csrc/fused_matvec.cu SYM_T disagrees with hopper_kernels.SYM_TILE")
    for r in (1, 8, 9, 33, 64, 65, 72, 73, 513):
        if lib.fused_matvec_sym_padded_cols(r) != sym_padded_cols(r):
            raise RuntimeError("csrc/fused_matvec.cu's column chunks disagree with hopper_kernels.sym_padded_cols")
    for n, m, r in ((1, 1, 1), (23, 300, 65), (300, 23, 513), (10_000, 50_000, 513), (50_000, 50_000, 65),
                    (10_000, 50_000, 1), (100_000, 100_000, 65)):
        c_split = (i64 * 4)()
        lib.fused_matvec_general_split(n, m, r, c_split)
        if tuple(c_split) != general_split(n, m, r):
            raise RuntimeError("csrc/fused_matvec.cu's general split disagrees with hopper_kernels.general_split")
    return lib


def _check_fused(name, tensors):
    """Raise on anything the fused kernels do not take (no fallback)."""
    if torch.is_grad_enabled() and any(t.requires_grad for _, t in tensors):
        raise RuntimeError(f"{name} is forward-only; call it under torch.no_grad()")
    dev = tensors[0][1].device
    for label, t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes CUDA float32 tensors; {label} is {t.dtype} on {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: {label} is on {t.device}, {tensors[0][0]} on {dev}")


def _scaled(x, ls):
    d = x.shape[1]
    if ls.numel() not in (1, d):
        raise ValueError(f"ls {tuple(ls.shape)} must have 1 or {d} entries")
    return (x / ls.reshape(-1).expand(d)).contiguous()


class FusedMatvec:
    """Launch counter of the general fused-matvec kernel."""

    launches = 0  # only _launch_fused_matvec adds to it


class FusedMatvecSym:
    """Launch counter of the symmetric fused-matvec kernel."""

    launches = 0  # only _launch_fused_matvec_sym adds to it


def _launch_fused_matvec(x1, x2, v, ls, kernel):
    """Run the general kernel: V split once (2·m_pad·r_pad f32), then the
    matvec over every 128-row block, column group and x2 segment, and at
    s > 1 the ordered sum of the segments' slots (s·n_pad·r_pad f32), all
    sized by :func:`general_split`. Raises on anything it does not take."""
    _check_fused("fused_stationary_matvec", [("x1", x1), ("x2", x2), ("v", v), ("ls", ls)])
    if x1.dim() != 2 or x2.dim() != 2 or v.dim() != 2 or x1.shape[1] != x2.shape[1] or v.shape[0] != x2.shape[0]:
        raise ValueError(
            f"fused_stationary_matvec: x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)}, v {tuple(v.shape)} "
            "must be (n,d), (m,d), (m,r)"
        )
    n, d = x1.shape
    m, r = v.shape
    out = torch.empty((n, r), dtype=torch.float32, device=x1.device)
    if n == 0 or r == 0:
        return out
    if m == 0 or d == 0:
        raise ValueError("fused_stationary_matvec kernel needs m >= 1 and d >= 1")
    s, n_pad, m_pad, rp = general_split(n, m, r)
    vsplit = torch.empty((2, m_pad, rp), dtype=torch.float32, device=x1.device)  # V's TF32 hi and lo, padded
    slots = torch.empty((s if s > 1 else 0, n_pad, rp), dtype=torch.float32, device=x1.device)
    a, b, vc = _scaled(x1, ls), _scaled(x2, ls), v.contiguous()
    lib = _fused_lib()
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_matvec_f32(a.data_ptr(), b.data_ptr(), vc.data_ptr(), vsplit.data_ptr(), slots.data_ptr(),
                                   out.data_ptr(), n, m, r, d, _KIND[kernel], s, stream)
    if err != 0:
        raise RuntimeError(f"fused_stationary_matvec kernel launch failed with CUDA error {err}")
    FusedMatvec.launches += 1
    return out


def _launch_fused_matvec_sym(x, v, ls, kernel):
    _check_fused("fused_stationary_matvec_sym", [("x", x), ("v", v), ("ls", ls)])
    if x.dim() != 2 or v.dim() != 2 or v.shape[0] != x.shape[0]:
        raise ValueError(
            f"fused_stationary_matvec_sym: x {tuple(x.shape)}, v {tuple(v.shape)} must be (n,d), (n,r)"
        )
    n, d = x.shape
    r = v.shape[1]
    out = torch.empty((n, r), dtype=torch.float32, device=x.device)
    if n == 0 or r == 0:
        return out
    if d == 0:
        raise ValueError("fused_stationary_matvec_sym kernel needs d >= 1")
    if not sym_matvec_fits(n, r):
        raise ValueError(
            f"fused_stationary_matvec_sym scratch for n={n}, r={r} exceeds "
            f"{SYM_SCRATCH_BYTES_MAX} bytes; use fused_stationary_matvec"
        )
    n_slots, n_pad, rp = sym_scratch_shape(n, r)
    scratch = torch.empty((n_slots, n_pad, rp), dtype=torch.float32, device=x.device)
    vsplit = torch.empty((2, n_pad, rp), dtype=torch.float32, device=x.device)  # V's TF32 hi and lo, padded
    a, vc = _scaled(x, ls), v.contiguous()
    lib = _fused_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_matvec_sym_f32(a.data_ptr(), vc.data_ptr(), vsplit.data_ptr(), scratch.data_ptr(),
                                       out.data_ptr(), n, r, d, _KIND[kernel], sym_band_split(n), stream)
    if err != 0:
        raise RuntimeError(f"fused_stationary_matvec_sym kernel launch failed with CUDA error {err}")
    FusedMatvecSym.launches += 1
    return out


def sym_product_check(t, v, trans=False):
    """``t @ v`` (``trans`` false, t of shape (m, k)) or ``t.T @ v`` (``trans``
    true, t of shape (k, m)) for CUDA float32 ``t`` and ``v`` (k, r ≤ 72)
    through the symmetric kernel's own 3xTF32 warpgroup product on zero-padded
    64×64 tiles: the product alone, for checks against
    :func:`.tf32x3.matmul_3xtf32_plain`. Not a launch of a matvec kernel."""
    for x in (t, v):
        if x.device.type != "cuda" or x.dtype != torch.float32 or x.dim() != 2:
            raise TypeError("sym_product_check takes 2-D CUDA float32 tensors")
    t, v = t.contiguous(), v.contiguous()
    k, m = t.shape if trans else t.shape[::-1]
    if v.shape[0] != k or not 1 <= v.shape[1] <= SYM_CHUNK:
        raise ValueError(f"sym_product_check: t {tuple(t.shape)} and v {tuple(v.shape)} do not fit")
    out = torch.empty((m, v.shape[1]), dtype=torch.float32, device=t.device)
    with torch.cuda.device(t.device):
        err = _fused_lib().fused_matvec_product_test_f32(t.data_ptr(), v.data_ptr(), out.data_ptr(), m, k,
                                                         v.shape[1], int(trans),
                                                         torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused matvec product check failed to launch with CUDA error {err}")
    return out


def fused_stationary_matvec(x1, x2, v, ls, kernel="ExpQuad"):
    """K(x1, x2) @ v, unit amplitude: the CUDA kernel for CUDA tensors
    (f32 only; anything else raises), :func:`fused_matvec_plain` on the CPU.
    On the card each 128×64 tile of K is built once per column group (up to
    144 columns of v) and multiplied as three TF32 passes on the tensor
    cores; x2 is split into :func:`general_split`'s segments, summed in a
    fixed order, so two calls on the same inputs agree bitwise."""
    if kernel not in FUSABLE_KERNELS:
        raise ValueError(f"fused_stationary_matvec: kernel {kernel!r} is not one of {FUSABLE_KERNELS}")
    if x1.device.type == "cpu":
        return fused_matvec_plain(x1, x2, v, ls, kernel)
    return _launch_fused_matvec(x1, x2, v, ls, kernel)


def fused_stationary_matvec_sym(x, v, ls, kernel="ExpQuad"):
    """K(x, x) @ v through the symmetric band-grid kernel for CUDA tensors
    (f32 only, within :func:`sym_matvec_fits`), plain on the CPU. Agrees
    with :func:`fused_stationary_matvec` to f32 round-off, not bitwise;
    two calls on the same inputs agree bitwise."""
    if kernel not in FUSABLE_KERNELS:
        raise ValueError(f"fused_stationary_matvec_sym: kernel {kernel!r} is not one of {FUSABLE_KERNELS}")
    if x.device.type == "cpu":
        return fused_matvec_plain(x, x, v, ls, kernel)
    return _launch_fused_matvec_sym(x, v, ls, kernel)
