"""Port parity: the fused Gram-matvec plain versions vs the Pallas kernels.

``fused_matvec_plain`` is what a CPU tensor takes through
``fused_stationary_matvec`` and ``fused_stationary_matvec_sym``, and what
``chip_smoke.py`` holds the CUDA kernels against on the card. Here it is
held against the reference's Pallas kernels run in interpret mode at f32,
at rtol 1e-5 and atol 1e-5·max|ref| (the reference's 3-pass bf16 hi/lo
product drops the lo·lo term, ~2^-16 of each product), and against an f64
numpy oracle. The symmetric reference runs with 128-row tiles at n = 512
and 896, its even and odd band grids (nb = 4 and 7).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gumbi_tpu.ops.pallas_kernels import fused_stationary_matvec as ref_matvec
from gumbi_tpu.ops.pallas_kernels import fused_stationary_matvec_sym as ref_matvec_sym
from gumbi_tpu.ops.pallas_kernels import FUSABLE_KERNELS as REF_FUSABLE
from gumbi_tpu_torch.ops import hopper_kernels as hk

torch.set_num_threads(2)

KERNELS = ["ExpQuad", "RBF", "Matern12", "Matern32", "Matern52", "Exponential"]


def _inputs(n, m, d, r, seed):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-2, 2, (n, d)).astype(np.float32)
    x2 = rng.uniform(-2, 2, (m, d)).astype(np.float32)
    v = rng.normal(size=(m, r)).astype(np.float32)
    ls = rng.uniform(0.5, 1.5, d).astype(np.float32)
    return x1, x2, v, ls


def _oracle(x1, x2, v, ls, kernel):
    """f64 numpy: K from exact distances, then K @ v."""
    a = x1.astype(np.float64) / ls
    b = x2.astype(np.float64) / ls
    r2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    r = np.sqrt(r2 + 1e-36)
    K = {
        "ExpQuad": np.exp(-0.5 * r2),
        "RBF": np.exp(-0.5 * r2),
        "Matern12": np.exp(-r),
        "Exponential": np.exp(-0.5 * r),
        "Matern32": (1 + np.sqrt(3) * r) * np.exp(-np.sqrt(3) * r),
        "Matern52": (1 + np.sqrt(5) * r + 5 * r2 / 3) * np.exp(-np.sqrt(5) * r),
    }[kernel]
    return K @ v.astype(np.float64), np.abs(K) @ np.abs(v.astype(np.float64))


def _plain(x1, x2, v, ls, kernel):
    return hk.fused_matvec_plain(torch.as_tensor(x1), torch.as_tensor(x2), torch.as_tensor(v),
                                 torch.as_tensor(ls), kernel).numpy()


def _check(port, ref, exact, scale):
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    # the plain f32 version against f64: a few f32 ulps of Σ|K||v| per entry
    assert np.all(np.abs(port - exact) <= 1e-6 * scale + 1e-30)


def test_fusable_kernels_match_reference():
    assert hk.FUSABLE_KERNELS == tuple(REF_FUSABLE)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("d", [1, 2, 3])
def test_plain_matches_general_pallas(kernel, d):
    """Ragged 37 × 23 with r = 5 (the reference pads to 128-row tiles)."""
    x1, x2, v, ls = _inputs(37, 23, d, 5, seed=d)
    ref = np.asarray(ref_matvec(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(v), jnp.asarray(ls), kernel,
                                interpret=True))
    exact, scale = _oracle(x1, x2, v, ls, kernel)
    _check(_plain(x1, x2, v, ls, kernel), ref, exact, scale)


@pytest.mark.parametrize("n,m,r", [(300, 130, 1), (129, 300, 65)])
def test_plain_matches_general_pallas_ragged(n, m, r):
    x1, x2, v, ls = _inputs(n, m, 2, r, seed=n + m)
    ref = np.asarray(ref_matvec(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(v), jnp.asarray(ls), "Matern52",
                                interpret=True))
    exact, scale = _oracle(x1, x2, v, ls, "Matern52")
    _check(_plain(x1, x2, v, ls, "Matern52"), ref, exact, scale)


@pytest.mark.parametrize("n,kernel", [(512, "ExpQuad"), (896, "Matern32"), (300, "Exponential")],
                         ids=["nb4", "nb7", "nb3-ragged"])
def test_plain_matches_symmetric_pallas(n, kernel):
    """The symmetric reference at 128-row tiles (even nb = 4, odd nb = 7 and
    a ragged nb = 3), through the port's symmetric wrapper on CPU tensors."""
    x, _, v, ls = _inputs(n, n, 2, 5, seed=n)
    ref = np.asarray(ref_matvec_sym(jnp.asarray(x), jnp.asarray(v), jnp.asarray(ls), kernel, bm=128,
                                    interpret=True))
    before = (hk.FusedMatvec.launches, hk.FusedMatvecSym.launches)
    port = hk.fused_stationary_matvec_sym(torch.as_tensor(x), torch.as_tensor(v), torch.as_tensor(ls), kernel).numpy()
    assert (hk.FusedMatvec.launches, hk.FusedMatvecSym.launches) == before  # CPU tensors never launch
    exact, scale = _oracle(x, x, v, ls, kernel)
    _check(port, ref, exact, scale)


def test_wrappers_on_cpu_take_plain_and_shared_lengthscale():
    """The general wrapper on CPU tensors is the plain version; a shared
    (one-entry) lengthscale broadcasts over d; f64 stays f64."""
    x1, x2, v, ls = _inputs(20, 17, 3, 4, seed=9)
    ls1 = ls[:1]
    out = hk.fused_stationary_matvec(torch.as_tensor(x1).double(), torch.as_tensor(x2).double(),
                                     torch.as_tensor(v).double(), torch.as_tensor(ls1).double(), "Matern12")
    assert out.dtype == torch.float64
    exact, _ = _oracle(x1, x2, v, np.repeat(ls1, 3), "Matern12")
    np.testing.assert_allclose(out.numpy(), exact, rtol=1e-12, atol=1e-12)


def test_plain_row_chunks_agree(monkeypatch):
    """Chunking K by rows (what keeps the plain version off N×N at 50k)
    changes nothing: 7-row chunks equal one chunk bit for bit."""
    x1, x2, v, ls = _inputs(40, 33, 2, 3, seed=4)
    whole = _plain(x1, x2, v, ls, "ExpQuad")
    monkeypatch.setattr(hk, "_PLAIN_ENTRIES", 7 * 33)
    np.testing.assert_array_equal(_plain(x1, x2, v, ls, "ExpQuad"), whole)


def test_kernel_launchers_refuse_what_they_cannot_take():
    """The CUDA route never falls back: CPU or f64 tensors raise at the
    launcher, an unknown kernel raises, and so does a gradient request."""
    x = torch.zeros(8, 2)
    v = torch.zeros(8, 3)
    with pytest.raises(TypeError, match="CUDA float32"):
        hk._launch_fused_matvec(x, x, v, torch.ones(2), "ExpQuad")
    with pytest.raises(TypeError, match="CUDA float32"):
        hk._launch_fused_matvec_sym(x, v, torch.ones(2), "Matern52")
    with pytest.raises(ValueError, match="not one of"):
        hk.fused_stationary_matvec(x, x, v, torch.ones(2), "Periodic")
    with pytest.raises(RuntimeError, match="forward-only"):
        hk._launch_fused_matvec(x, x, v, torch.ones(2, requires_grad=True), "ExpQuad")


def test_sym_matvec_fits_gate():
    """1 GiB of scratch: N = 50,000 at r = 65 (PCG) and 64 (LOVE) fit,
    r = 129 does not; small n always fits. The scratch is the own slots of
    the band walkers plus one slot per band but the diagonal one, each
    (n padded to 64) × (r padded to the column chunks)."""
    assert hk.sym_matvec_fits(50_000, 65) and hk.sym_matvec_fits(50_000, 64) and hk.sym_matvec_fits(50_000, 1)
    assert not hk.sym_matvec_fits(50_000, 129)
    assert hk.sym_matvec_fits(300, 513)
    nb = -(-50_000 // hk.SYM_TILE)
    slots, n_pad, rp = hk.sym_scratch_shape(50_000, 65)
    n_split = hk.sym_band_split(50_000)
    assert slots == n_split + nb // 2
    assert (n_pad, rp) == (50_048, 72) and n_pad % hk.SYM_SUBTILE == 0
    assert 1 <= n_split <= nb // 2 + 1 and nb * n_split >= hk.SYM_TARGET_CTAS
    assert slots * n_pad * rp * 4 <= hk.SYM_SCRATCH_BYTES_MAX


@pytest.mark.parametrize("r, padded", [(1, 8), (8, 8), (9, 16), (17, 32), (33, 64), (64, 64), (65, 72), (72, 72),
                                       (73, 80), (100, 104), (513, 520)])
def test_sym_padded_cols_follow_the_column_chunks(r, padded):
    """Full chunks of 72 columns, then the remainder's chunk of 8, 16, 32,
    64 or 72: the widths csrc/fused_matvec.cu builds."""
    assert hk.sym_padded_cols(r) == padded


@pytest.mark.parametrize("n", [1, 300, 2048, 2085, 6139, 16_384])
def test_sym_scratch_shape_small_and_ragged(n):
    """One own slot per band walker, never more walkers than bands, rows
    padded to the 64-row tile."""
    nb = -(-n // hk.SYM_TILE)
    slots, n_pad, rp = hk.sym_scratch_shape(n, 5)
    n_split = hk.sym_band_split(n)
    assert slots == n_split + nb // 2
    assert 1 <= n_split <= nb // 2 + 1
    assert n <= n_pad < n + hk.SYM_SUBTILE and rp == 8


# ------------------------------------------------------------------
# The general kernel's split and summation order (csrc/fused_matvec.cu
# fused_matvec_gen_kernel), rehearsed on the CPU
# ------------------------------------------------------------------

FUSED_TOL = 1e-5  # chip_smoke.py's bound on |kernel − f64| in units of |K|·|V|
ULP32 = 2.0**-23


@pytest.mark.parametrize("r", [1, 65, 513])
@pytest.mark.parametrize("m", [1, 23, 300, 10_000, 50_000, 100_000])
@pytest.mark.parametrize("n", [1, 23, 300, 10_000, 50_000, 100_000])
def test_general_split(n, m, r):
    """Rows padded to the 128-row block, x2 to the 64-row tile, V's columns
    to the chunk widths; s the least number of x2 segments that makes at
    least 352 CTAs, never more than there are x2 tiles; the scratch (V's
    split, and s slots at s > 1) stays small."""
    s, n_pad, m_pad, rp = hk.general_split(n, m, r)
    assert n_pad % hk.GEN_ROWS == 0 and n <= n_pad < n + hk.GEN_ROWS
    assert m_pad % hk.SYM_SUBTILE == 0 and m <= m_pad < m + hk.SYM_SUBTILE
    assert rp == hk.sym_padded_cols(r)
    chunks = -(-rp // hk.SYM_CHUNK)
    groups = -(-chunks // hk.GEN_GROUP)
    assert groups == {1: 1, 65: 1, 513: 4}[r]
    ctas = n_pad // hk.GEN_ROWS * groups
    tiles = m_pad // hk.SYM_SUBTILE
    assert 1 <= s <= tiles
    assert ctas * s >= hk.GEN_TARGET_CTAS or s == tiles
    assert s == 1 or ctas * (s - 1) < hk.GEN_TARGET_CTAS
    slot_bytes = (s * n_pad * rp * 4) if s > 1 else 0
    assert slot_bytes <= 2 * hk.GEN_TARGET_CTAS * hk.GEN_ROWS * hk.GEN_GROUP * hk.SYM_CHUNK * 4  # < 52 MB
    assert 2 * m_pad * rp * 4 <= 2 * 100_032 * 520 * 4  # V's split: 416 MB at the largest shape here


@pytest.mark.parametrize("n, m, r, split", [
    (10_000, 50_000, 513, (2, 10_112, 50_048, 520)),  # the grid predict against [α | W]
    (50_000, 50_000, 65, (1, 50_048, 50_048, 72)),  # a PCG sweep past the symmetric gate
    (10_000, 50_000, 1, (5, 10_112, 50_048, 8)),  # iter_predict_mean
    (100_000, 100_000, 65, (1, 100_096, 100_032, 72)),
])
def test_general_split_at_the_main_path_shapes(n, m, r, split):
    assert hk.general_split(n, m, r) == split


def _gram_f32(x1, x2, ls, kernel):
    """K as the kernel builds it: exact f32 distances in coordinate order."""
    from gumbi_tpu_torch.ops.kernels import _stationary

    a, b = torch.as_tensor(x1) / torch.as_tensor(ls), torch.as_tensor(x2) / torch.as_tensor(ls)
    sq = torch.zeros((a.shape[0], b.shape[0]))
    for k in range(a.shape[1]):
        diff = a[:, k : k + 1] - b[:, k : k + 1].T
        sq = sq + diff * diff
    return _stationary(kernel, sq)


def _emulate_general(x1, x2, v, ls, kernel):
    """The general kernel's arithmetic in plain torch: per x2 segment of
    general_split, per 64-row x2 tile, each 8-deep step's 3xTF32 product
    summed from zero, the tile's steps summed apart, the tile's partial
    added to the segment's running sum; then the segments' slots in order."""
    from gumbi_tpu_torch.ops.tf32x3 import matmul_3xtf32_plain

    n, m, r = x1.shape[0], x2.shape[0], v.shape[1]
    s, _, m_pad, _ = hk.general_split(n, m, r)
    K = torch.zeros((n, m_pad))
    K[:, :m] = _gram_f32(x1, x2, ls, kernel)
    V = torch.zeros((m_pad, r))
    V[:m] = torch.as_tensor(v)
    tiles = m_pad // 64
    out = torch.zeros((n, r))
    for z in range(s):
        acc = torch.zeros((n, r))
        for t in range(z * tiles // s, (z + 1) * tiles // s):
            part = torch.zeros((n, r))
            for k0 in range(64 * t, 64 * t + 64, 8):
                part = part + matmul_3xtf32_plain(K[:, k0 : k0 + 8].contiguous(), V[k0 : k0 + 8].contiguous())
            acc = acc + part
        out = out + acc
    return out.numpy(), s


@pytest.mark.parametrize("n, m, r", [(150, 300, 5), (37, 23, 73)], ids=["s5", "s1-two-chunks"])
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("d", [1, 2, 3])
def test_general_summation_order_holds_the_2x_rule(n, m, r, kernel, d):
    """The accuracy argument for the card: the kernel's summation order
    (per-step 3xTF32 partials from zero, the per-tile two-level sum, the s
    slots in a fixed order) against the reference's Pallas kernel in
    interpret mode and against f64: |emulation − f64| ≤ FUSED_TOL·(|K|·|V|)
    and at most twice the plain f32 version's error (never under one f32
    ulp), chip_smoke.py's rule for the kernel."""
    x1, x2, v, ls = _inputs(n, m, d, r, seed=100 * d + n)
    emu, s = _emulate_general(x1, x2, v, ls, kernel)
    assert s == (5 if n == 150 else 1)
    ref = np.asarray(ref_matvec(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(v), jnp.asarray(ls), kernel,
                                interpret=True))
    np.testing.assert_allclose(emu, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    exact, scale = _oracle(x1, x2, v, ls, kernel)
    e_emu = float((np.abs(emu - exact) / scale).max())
    e_plain = float((np.abs(_plain(x1, x2, v, ls, kernel) - exact) / scale).max())
    assert e_emu <= FUSED_TOL
    assert e_emu <= 2.0 * max(e_plain, ULP32), (e_emu, e_plain)
