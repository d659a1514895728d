"""Port parity: gumbi_tpu_torch.ops.kernels and the rbf_gram wrapper vs JAX.

The same numpy inputs (seeded) go through the JAX reference and the torch
port. Gram assembly is compared at f64 for all 13 continuous kernels; the
fused RBF Gram is compared at f32 against the reference's Pallas kernel run
in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gumbi_tpu.ops.kernels as jk
import gumbi_tpu_torch.ops.kernels as tk
from gumbi_tpu_torch.convert import params_from_numpy, spec_from_reference
from gumbi_tpu_torch.ops.hopper_kernels import RbfGram, _launch_rbf_gram, rbf_gram, rbf_gram_plain, rbf_tile_config

torch.set_num_threads(2)  # the suite runs several workers at once

F64 = dict(dtype=torch.float64, device="cpu")


def _spec(kernel, ard):
    out = jk.CoregTerm(name="Parameter", col=0, d_out=3)
    code = jk.CoregTerm(name="Code", col=1, d_out=2, rank=1)
    return jk.GPSpec(
        terms=(
            jk.GPTerm(suffix="total", kernel=kernel, linear_idx=(0,), coregs=(out,)),
            jk.GPTerm(suffix="Code", kernel="Matern52", coregs=(out, code)),
        ),
        d_cont=2,
        ard=ard,
        noise_coreg=jk.CoregTerm(name="Output_noise", col=0, d_out=3),
        period=(1.5, 2.5),
    )


def _params(spec, rng):
    n_ls = spec.n_ls
    return {
        "ls_total": rng.uniform(0.5, 1.5, n_ls),
        "η_total": np.asarray(rng.uniform(0.8, 1.5)),
        "c_total": rng.normal(size=1),
        "τ_total": np.asarray(0.3),
        "ls_Code": rng.uniform(0.5, 1.5, n_ls),
        "η_Code": np.asarray(rng.uniform(0.3, 0.8)),
        "W_Parameter": rng.normal(size=(3, 2)),
        "κ_Parameter": rng.uniform(0.5, 1.5, 3),
        "W_Code": rng.normal(size=(2, 1)),
        "κ_Code": rng.uniform(0.5, 1.5, 2),
        "σ": np.asarray(0.3),
        "W_Output_noise": rng.normal(size=(3, 2)),
        "κ_Output_noise": rng.uniform(0.5, 1.5, 3),
    }


def _points(rng, n):
    xc = rng.uniform(-2, 2, size=(n, 2))
    xk = np.stack([rng.integers(0, 3, n), rng.integers(0, 2, n)], axis=1).astype(np.int32)
    return xc, xk


@pytest.mark.parametrize("ard", [True, False])
@pytest.mark.parametrize("kernel", jk.CONTINUOUS_KERNELS)
def test_gram_family_matches_jax_f64(kernel, ard):
    """gram, gram_diag, noise_diag, coreg_matrix, output_correlation at f64.

    rtol 1e-10: both sides evaluate the same f64 formulas; only summation
    order (matmul vs elementwise) differs, at ~1e-15 relative.
    """
    rng = np.random.default_rng(hash((kernel, ard)) % 2**32)
    jspec = _spec(kernel, ard)
    spec = spec_from_reference(jspec)
    p = _params(jspec, rng)
    xc1, xk1 = _points(rng, 20)
    xc2, xk2 = _points(rng, 15)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = params_from_numpy(p, **F64)
    t = lambda a: torch.as_tensor(a, device="cpu")  # noqa: E731

    K_j = jk.gram(jspec, jp, jnp.asarray(xc1), jnp.asarray(xk1), jnp.asarray(xc2), jnp.asarray(xk2))
    K_t = tk.gram(spec, tp, t(xc1), t(xk1), t(xc2), t(xk2))
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), rtol=1e-10, atol=1e-12)

    d_j = jk.gram_diag(jspec, jp, jnp.asarray(xc1), jnp.asarray(xk1))
    d_t = tk.gram_diag(spec, tp, t(xc1), t(xk1))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-10)

    n_j = jk.noise_diag(jspec, jp, jnp.asarray(xk1), dtype=jnp.float64)
    n_t = tk.noise_diag(spec, tp, t(xk1), dtype=torch.float64)
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), rtol=1e-10)

    for name in ("Parameter", "Code", "Output_noise"):
        W, κ = p[f"W_{name}"], p[f"κ_{name}"]
        np.testing.assert_allclose(
            tk.coreg_matrix(t(W), t(κ)).numpy(),
            np.asarray(jk.coreg_matrix(jnp.asarray(W), jnp.asarray(κ))), rtol=1e-10,
        )
        np.testing.assert_allclose(
            tk.output_correlation(t(W), t(κ)).numpy(),
            np.asarray(jk.output_correlation(jnp.asarray(W), jnp.asarray(κ))), rtol=1e-10,
        )


def test_spec_round_trip_and_kernel_list():
    jspec = _spec("Matern32+Periodic", True)
    spec = spec_from_reference(jspec)
    assert spec == tk.GPSpec(
        terms=tuple(
            tk.GPTerm(t.suffix, t.kernel, t.linear_idx,
                      tuple(tk.CoregTerm(c.name, c.col, c.d_out, c.rank) for c in t.coregs))
            for t in jspec.terms
        ),
        d_cont=2, ard=True, noise_coreg=tk.CoregTerm("Output_noise", 0, 3), period=(1.5, 2.5),
    )
    assert spec.n_ls == jspec.n_ls
    assert tk.CONTINUOUS_KERNELS == jk.CONTINUOUS_KERNELS


# ------------------------------------------------------------------
# rbf_gram: plain version and the autograd wrapper (CPU route) against the
# reference Pallas kernel in interpret mode.
# ------------------------------------------------------------------


@pytest.fixture()
def interpreted_rbf(monkeypatch):
    """Force interpret mode so the reference Pallas kernel runs on CPU."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", jax.default_backend() != "tpu")
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    from gumbi_tpu.ops.pallas_kernels import rbf_gram as jax_rbf_gram

    return jax_rbf_gram


def _rbf_inputs(seed, n, m, d, n_ls):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=(n, d)).astype(np.float32)
    x2 = rng.normal(size=(m, d)).astype(np.float32)
    ls = rng.uniform(0.6, 1.3, n_ls).astype(np.float32)
    if d > 3:  # keep K away from 0 over many coordinates
        ls = ls * np.float32(np.sqrt(d / 2))
    eta = np.float32(rng.uniform(0.8, 1.5))
    return x1, x2, ls, eta


# (n, m, d, n_ls): the first four are the original cases at 37×23; then the
# kernel's row strip (n ≤ 8) at ragged m, and d = 17, which takes three of
# the kernel's 8-coordinate staging passes, with ARD and shared lengthscales.
_RBF_CASES = [
    pytest.param(37, 23, 1, 1, id="1-1"),
    pytest.param(37, 23, 2, 2, id="2-2"),
    pytest.param(37, 23, 3, 3, id="3-3"),
    pytest.param(37, 23, 3, 1, id="3-1"),
    pytest.param(1, 300, 2, 2, id="1x300-2-2"),
    pytest.param(1, 300, 2, 1, id="1x300-2-1"),
    pytest.param(3, 257, 3, 3, id="3x257-3-3"),
    pytest.param(3, 257, 3, 1, id="3x257-3-1"),
    pytest.param(5, 1001, 2, 2, id="5x1001-2-2"),
    pytest.param(5, 1001, 1, 1, id="5x1001-1-1"),
    pytest.param(37, 23, 17, 17, id="37x23-17-17"),
    pytest.param(37, 23, 17, 1, id="37x23-17-1"),
]


@pytest.mark.parametrize("fn", [rbf_gram_plain, rbf_gram], ids=["plain", "RbfGram"])
@pytest.mark.parametrize("n,m,d,n_ls", _RBF_CASES)
def test_rbf_gram_forward_matches_pallas(interpreted_rbf, fn, n, m, d, n_ls):
    """Forward at f32: atol 1e-6·η² (exact elementwise distances on both
    sides; only exp's last-ulp rounding may differ)."""
    x1, x2, ls, eta = _rbf_inputs(d if (n, m) == (37, 23) and d <= 3 else n + m + d, n, m, d, n_ls)
    K_j = np.asarray(interpreted_rbf(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ls), jnp.asarray(eta)))
    before = RbfGram.launches
    K_t = fn(torch.as_tensor(x1), torch.as_tensor(x2), torch.as_tensor(ls), torch.tensor(eta))
    assert RbfGram.launches == before  # CPU tensors never launch the kernel
    assert K_t.dtype == torch.float32 and K_t.shape == (n, m)
    np.testing.assert_allclose(K_t.numpy(), K_j, rtol=0, atol=1e-6 * float(eta) ** 2)


@pytest.mark.parametrize(
    "n,m,d,n_ls",
    [
        pytest.param(12, 9, 2, 2, id="ard"),
        pytest.param(12, 9, 2, 1, id="shared"),
        pytest.param(1, 300, 2, 2, id="1x300-ard"),
        pytest.param(3, 257, 3, 1, id="3x257-shared"),
        pytest.param(37, 23, 17, 17, id="37x23-d17-ard"),
    ],
)
def test_rbf_gram_vjp_matches_pallas(interpreted_rbf, n, m, d, n_ls):
    """The wrapper's analytic backward vs the reference custom VJP, f32,
    rtol/atol 2e-4 as tests/test_pallas.py holds the reference itself."""
    x1, x2, ls, eta = _rbf_inputs(10 + n_ls if (n, m) == (12, 9) else n + m + d, n, m, d, n_ls)
    gbar = np.random.default_rng(5).normal(size=(n, m)).astype(np.float32)

    def loss_j(a, b, l, e):
        return jnp.sum(interpreted_rbf(a, b, l, e) * gbar)

    g_j = jax.grad(loss_j, argnums=(0, 1, 2, 3))(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ls), jnp.asarray(eta)
    )
    ts = [torch.tensor(v, requires_grad=True) for v in (x1, x2, ls, eta)]
    (rbf_gram(*ts) * torch.as_tensor(gbar)).sum().backward()
    for t, g in zip(ts, g_j):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=2e-4, atol=2e-4)


def test_rbf_gram_backward_matches_autograd_of_plain_f64():
    """Analytic backward vs autograd through the plain formula at f64
    (rtol 1e-10: two exact f64 routes to the same derivative)."""
    rng = np.random.default_rng(3)
    vals = [rng.normal(size=(7, 3)), rng.normal(size=(5, 3)), rng.uniform(0.5, 1.5, 3), np.asarray(1.2)]
    gbar = torch.as_tensor(rng.normal(size=(7, 5)))
    a = [torch.tensor(v, requires_grad=True) for v in vals]
    b = [torch.tensor(v, requires_grad=True) for v in vals]
    (rbf_gram(*a) * gbar).sum().backward()
    (rbf_gram_plain(*b) * gbar).sum().backward()
    for u, v in zip(a, b):
        np.testing.assert_allclose(u.grad.numpy(), v.grad.numpy(), rtol=1e-10, atol=1e-12)


def test_kernel_launch_refuses_non_cuda_tensors():
    """The CUDA route never falls back: a CPU tensor handed to the launcher raises."""
    x = torch.zeros(4, 2)
    with pytest.raises(TypeError, match="CUDA float32"):
        _launch_rbf_gram(x, x, torch.ones(2), torch.tensor(1.0))


@pytest.mark.parametrize(
    "x1,err,match",
    [
        pytest.param(torch.zeros(4, 2, dtype=torch.float64), TypeError, "CUDA float32.*float64", id="f64"),
        pytest.param(torch.zeros(2, 4).T, ValueError, "contiguous", id="non-contiguous"),
        pytest.param(torch.zeros(4, 3), ValueError, "must be", id="d-mismatch"),
    ],
)
def test_kernel_launch_refuses_what_it_does_not_take(x1, err, match):
    """f64, non-contiguous or mismatched input raises; nothing is launched."""
    before = RbfGram.launches
    with pytest.raises(err, match=match):
        _launch_rbf_gram(x1, torch.zeros(5, 2), torch.ones(2), torch.tensor(1.0))
    assert RbfGram.launches == before


# Output shapes of the kernel: chip_smoke's checks and the three paths'
# calls (Kronecker 640², 1,024², 5,120², 5,120×10,000; iterative pivoted
# Cholesky rows (1, 50,000), gradient blocks (2,500, 50,000), coarse 2,048²,
# grid 10,000×50,000; dense 1,024², 16,384², grid 10,000×16,384 and draws
# 1,024×16,384), plus edges of the strip and the tiles.
_TILED_SHAPES = [
    (1, 1, 1), (1, 23, 2), (1, 300, 2), (3, 257, 3), (5, 1001, 2), (5, 10_001, 3), (4, 50_000, 2),
    (1, 50_000, 2), (8, 1025, 1), (9, 23, 17), (37, 23, 1), (640, 640, 2), (1024, 1024, 2), (2048, 2048, 2),
    (5120, 5120, 2), (5120, 10_000, 2), (10_000, 5120, 2), (2500, 50_000, 2), (10_000, 50_000, 2),
    (16_384, 16_384, 2), (10_000, 16_384, 2), (1024, 16_384, 2),
]


@pytest.mark.parametrize("n,m,d", _TILED_SHAPES, ids=[f"{n}x{m}-d{d}" for n, m, d in _TILED_SHAPES])
def test_rbf_tile_config_covers_every_entry_once(n, m, d):
    """The kernel's tiles, walked as csrc/rbf_gram.cu walks them (CTA c takes
    tiles T·c//C … T·(c+1)//C − 1 in row-major tile order), cover every
    entry of K exactly once; n ≤ 8 takes the row strip with no masked row."""
    strip, rows, cols, tiles, ctas = rbf_tile_config(n, m, d)
    assert strip == (n <= 8)
    if strip:
        assert rows == n  # one tile row: every row of x1, none masked
    tiles_n, tiles_m = -(-n // rows), -(-m // cols)
    assert tiles == tiles_n * tiles_m and 1 <= ctas <= tiles and ctas <= 264
    # each tile index belongs to exactly one CTA's run
    bounds = [tiles * c // ctas for c in range(ctas + 1)]
    assert bounds[0] == 0 and bounds[-1] == tiles and all(a < b for a, b in zip(bounds, bounds[1:]))
    # tile t is rows [rb·rows, …) × columns [cb·cols, …) with rb, cb = divmod(t, tiles_m);
    # the row and column blocks partition [0, n) and [0, m)
    t = np.arange(tiles)
    rb, cb = np.divmod(t, tiles_m)
    assert np.array_equal(np.unique(rb * tiles_m + cb), t)
    assert (tiles_n - 1) * rows < n <= tiles_n * rows and (tiles_m - 1) * cols < m <= tiles_m * cols
    if n * m <= 1 << 22:  # count every entry
        count = np.zeros((n, m), np.int32)
        for c in range(ctas):
            for tt in range(bounds[c], bounds[c + 1]):
                r0, c0 = (tt // tiles_m) * rows, (tt % tiles_m) * cols
                count[r0 : r0 + rows, c0 : c0 + cols] += 1
        assert (count == 1).all()


def test_rbf_tile_config_degenerate():
    assert rbf_tile_config(0, 5, 2) == rbf_tile_config(5, 0, 2) == rbf_tile_config(5, 5, 0) == (0, 0, 0, 0, 0)


def test_gram_dispatch_on_cpu_f32_uses_matmul_formula():
    """On CPU the Gram takes the reference's XLA (matmul-identity) formula,
    as the reference does off-TPU; f32 tolerance 1e-5 (cancellation in the
    identity at unit scale)."""
    jspec = jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2)
    spec = spec_from_reference(jspec)
    x1, x2, ls, eta = _rbf_inputs(9, 11, 6, 2, 2)
    p = {"ls_total": ls, "η_total": eta, "σ": np.float32(0.1)}
    xk1, xk2 = np.zeros((11, 0), np.int32), np.zeros((6, 0), np.int32)
    K_j = jk.gram(jspec, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x1), jnp.asarray(xk1),
                  jnp.asarray(x2), jnp.asarray(xk2))
    before = RbfGram.launches
    tp = params_from_numpy(p, device="cpu", dtype=torch.float32)
    K_t = tk.gram(spec, tp, torch.as_tensor(x1), torch.as_tensor(xk1), torch.as_tensor(x2), torch.as_tensor(xk2))
    assert RbfGram.launches == before
    assert K_t.dtype == torch.float32
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), atol=1e-5)
