"""Port parity: the blocked Cholesky of gumbi_tpu_torch vs gumbi_tpu.

On the CPU the port's wrapper runs the kernel's plain version
(``cholesky_plain``, the same right-looking blocked algorithm in torch
ops); the CUDA kernel itself is held against it on the card by
``chip_smoke.py``. Here the plain version and the dispatcher are held
against the reference's Pallas kernel in interpret mode and against
``jnp.linalg.cholesky`` on the same seeded numpy input, at the tolerance of
``tests/test_pallas_chol.py``: atol 5e-5·max(|L|, 1) at f32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gumbi_tpu.ops.kernels as jk
import gumbi_tpu.ops.priors as jp
import gumbi_tpu_torch.ops.kronecker as tkr
import gumbi_tpu_torch.ops.linalg as tlinalg
from gumbi_tpu.ops.pallas_chol import pallas_cholesky
from gumbi_tpu_torch.convert import spec_from_reference
from gumbi_tpu_torch.ops import hopper_chol
from gumbi_tpu_torch.ops.hopper_chol import (
    BLOCK,
    BlockedChol,
    cholesky,
    cholesky_plain,
    hopper_cholesky,
    seam_cholesky,
)

torch.set_num_threads(2)


def _spd(n, d=2, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(d, n, 32)).astype(dtype)
    return X @ np.swapaxes(X, 1, 2) / 32 + 2.0 * np.eye(n, dtype=dtype)


@pytest.mark.parametrize("n", [BLOCK, 2 * BLOCK])
def test_plain_and_dispatcher_match_pallas_and_xla(n):
    A = _spd(n)
    L_pallas = np.asarray(jnp.tril(pallas_cholesky(jnp.asarray(A), interpret=True)))
    L_xla = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    atol = 5e-5 * max(float(np.abs(L_xla).max()), 1.0)
    before = BlockedChol.launches
    for fn in (cholesky_plain, cholesky, hopper_cholesky):
        L = fn(torch.tensor(A)).numpy()
        assert L.dtype == np.float32 and not np.triu(L, 1).any()
        np.testing.assert_allclose(L, L_pallas, atol=atol, rtol=0)
        np.testing.assert_allclose(L, L_xla, atol=atol, rtol=0)
    assert BlockedChol.launches == before  # CPU calls never count as kernel launches


def test_plain_takes_a_ragged_last_panel():
    A = _spd(300, d=1, dtype=np.float64)
    np.testing.assert_allclose(cholesky_plain(torch.tensor(A)).numpy(), np.linalg.cholesky(A), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("n,dtype,rtol", [(100, np.float32, 1e-6), (BLOCK, np.float64, 1e-12)],
                         ids=["n100_f32", "n256_f64"])
def test_ineligible_inputs_take_the_library_route(n, dtype, rtol, monkeypatch):
    """A non-multiple N and an f64 input never reach the blocked algorithm
    (its plain version is made to fail here) and agree with the reference's
    dispatcher."""
    def refuse(A):
        raise AssertionError("the blocked route was taken")

    monkeypatch.setattr(hopper_chol, "hopper_cholesky", refuse)
    A = _spd(n, dtype=dtype)
    L_ref = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    np.testing.assert_allclose(cholesky(torch.tensor(A)).numpy(), L_ref, rtol=rtol, atol=rtol)
    # a single (N, N) matrix is ineligible too, as in the reference
    np.testing.assert_allclose(cholesky(torch.tensor(A[0])).numpy(), L_ref[0], rtol=rtol, atol=rtol)


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    A = torch.tensor(_spd(BLOCK))
    with pytest.raises(ValueError):
        hopper_cholesky(A[0])  # not batched
    with pytest.raises(ValueError):
        hopper_cholesky(torch.tensor(_spd(100)))  # N not a multiple of 256
    with pytest.raises(TypeError):
        hopper_cholesky(A.double())
    with pytest.raises(ValueError):
        hopper_cholesky(A.transpose(1, 2))  # not contiguous
    with pytest.raises(RuntimeError):
        hopper_cholesky(A.clone().requires_grad_(True))
    # the dispatcher makes an eligible strided input contiguous instead
    np.testing.assert_allclose(cholesky(A.transpose(1, 2)).numpy(), cholesky(A).numpy(), atol=1e-5)


def test_seam_function_lifts_a_single_matrix_to_the_blocked_route(monkeypatch):
    """``seam_cholesky`` is what goes at ``linalg.safe_cholesky``: the dense
    path's single (N, N) f32 Gram reaches the blocked algorithm as
    (1, N, N), where the bare dispatcher would send it to the library; a
    batched or ineligible input is the dispatcher's. It is forward-only
    where eligible."""
    seen = []
    blocked = hopper_chol.hopper_cholesky

    def spy(A):
        seen.append(tuple(A.shape))
        return blocked(A)

    monkeypatch.setattr(hopper_chol, "hopper_cholesky", spy)
    A = torch.tensor(_spd(BLOCK, d=2))
    ref = torch.linalg.cholesky(A)
    L2 = seam_cholesky(A[0])
    assert seen == [(1, BLOCK, BLOCK)] and L2.shape == (BLOCK, BLOCK)
    np.testing.assert_allclose(L2.numpy(), ref[0].numpy(), atol=5e-5 * max(float(ref.abs().max()), 1.0), rtol=0)
    np.testing.assert_allclose(seam_cholesky(A).numpy(), cholesky(A).numpy(), atol=0, rtol=0)
    assert seen[1:] == [(2, BLOCK, BLOCK)] * 2
    seen.clear()
    np.testing.assert_allclose(seam_cholesky(A[0].double()).numpy(), torch.linalg.cholesky(A[0].double()).numpy(),
                               rtol=1e-12)
    assert seen == []  # f64 is the library's, 2-D or not
    with pytest.raises(RuntimeError):
        seam_cholesky(A[0].clone().requires_grad_(True))


def test_non_pd_batch_entry_is_nan_and_the_others_are_right():
    A = _spd(2 * BLOCK, d=3)
    A[1, 300, 300] = -5.0
    L = cholesky(torch.tensor(A)).numpy()  # never raises
    assert np.isnan(L[1]).any() and np.isnan(np.diagonal(L[1])).any()
    for i in (0, 2):
        ref = np.linalg.cholesky(A[i])
        np.testing.assert_allclose(L[i], ref, atol=5e-5 * max(float(np.abs(ref).max()), 1.0), rtol=0)


def _kron_problem(n=256, seed=0):
    rng = np.random.default_rng(seed)
    out = jk.CoregTerm(name="Parameter", col=0, d_out=2)
    jspec = jk.GPSpec(
        terms=(jk.GPTerm(suffix="total", kernel="ExpQuad", coregs=(out,)),),
        d_cont=2,
        noise_coreg=jk.CoregTerm(name="Output_noise", col=0, d_out=2),
    )
    xc = rng.uniform(-2, 2, size=(n, 2)).astype(np.float32)
    f1 = np.sin(1.3 * xc[:, 0]) * np.cos(0.9 * xc[:, 1])
    Y = np.stack([f1 + rng.normal(0, 0.1, n), 0.7 * f1 + rng.normal(0, 0.15, n)], axis=1).astype(np.float32)
    la, lb = jp.ls_prior_params([0.05, 0.05], [4.0, 4.0])
    u = {k: np.asarray(v[0], dtype=np.float32) for k, v in jp.initial_params(jspec, la, lb, 1, seed=seed).items()}
    return spec_from_reference(jspec), xc, Y, la, lb, u


def test_kron_objective_with_the_seam_swapped(monkeypatch):
    """With ``hopper_chol.cholesky`` at the ``linalg.safe_cholesky`` seam the
    Kronecker objective's value and gradient at 256 locations (f32) match
    the stock ones to rtol 1e-5, and the factorization really went through
    the swapped function."""
    spec, xc, Y, la, lb, u = _kron_problem()
    la_t, lb_t = torch.tensor(la, dtype=torch.float32), torch.tensor(lb, dtype=torch.float32)

    def vg():
        ut = {k: torch.tensor(v, requires_grad=True) for k, v in u.items()}
        f = tkr.kron_neg_logp(spec, ut, torch.tensor(xc), torch.tensor(Y), la_t, lb_t)
        f.backward()
        return f.item(), {k: v.grad.numpy() for k, v in ut.items()}

    f_stock, g_stock = vg()
    calls = []

    def seam(A):
        calls.append(tuple(A.shape))
        return cholesky(A)

    monkeypatch.setattr(tlinalg, "safe_cholesky", seam)
    f_hand, g_hand = vg()
    assert calls == [(2, 256, 256)]
    np.testing.assert_allclose(f_hand, f_stock, rtol=1e-5)
    for k in g_stock:
        np.testing.assert_allclose(g_hand[k], g_stock[k], rtol=1e-3, atol=1e-3 * np.abs(g_stock[k]).max(), err_msg=k)
    with torch.no_grad():  # kron_cache factorizes through the same seam
        calls.clear()
        params = {k: torch.tensor(np.exp(v) if k.startswith(("ls_", "η_", "κ_", "σ")) else v) for k, v in u.items()}
        tkr.kron_cache(spec, params, torch.tensor(xc), torch.tensor(Y))
    assert calls == [(2, 256, 256)]
