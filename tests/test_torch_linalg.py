"""Port parity: gumbi_tpu_torch.ops.linalg vs gumbi_tpu.ops.linalg at f64.

Both sides factorize once and use the same analytic backward
(∂quad/∂A = −ααᵀ, ∂logdet/∂A = A⁻¹), so values and gradients agree to f64
round-off: rtol 1e-10 throughout.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gumbi_tpu.ops.linalg as jl
import gumbi_tpu_torch.ops.linalg as tl

torch.set_num_threads(2)


def _spd(rng, batch, n):
    M = rng.normal(size=batch + (n, n))
    return M @ np.swapaxes(M, -1, -2) + n * np.eye(n)


@pytest.mark.parametrize("batch", [(), (3,), (2, 2)])
def test_quad_and_logdet_value_and_grad(batch):
    rng = np.random.default_rng(len(batch))
    A = _spd(rng, batch, 9)
    z = rng.normal(size=batch + (9,))
    wq = rng.normal(size=batch)  # cotangents, so every batch entry is weighted
    wl = rng.normal(size=batch)

    def loss_j(A, z):
        q, l = jl.quad_and_logdet(A, z)
        return jnp.sum(wq * q + wl * l)

    (q_j, l_j) = jl.quad_and_logdet(jnp.asarray(A), jnp.asarray(z))
    gA_j, gz_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(z))

    At = torch.tensor(A, requires_grad=True)
    zt = torch.tensor(z, requires_grad=True)
    q_t, l_t = tl.quad_and_logdet(At, zt)
    (torch.as_tensor(wq) * q_t + torch.as_tensor(wl) * l_t).sum().backward()

    np.testing.assert_allclose(q_t.detach().numpy(), np.asarray(q_j), rtol=1e-10)
    np.testing.assert_allclose(l_t.detach().numpy(), np.asarray(l_j), rtol=1e-10)
    np.testing.assert_allclose(At.grad.numpy(), np.asarray(gA_j), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(gz_j), rtol=1e-10, atol=1e-13)

    # The value-only primal (one triangular solve) equals the differentiable one.
    with torch.no_grad():
        q0, l0 = tl.quad_and_logdet(At, zt)
    np.testing.assert_allclose(q0.numpy(), q_t.detach().numpy(), rtol=1e-12)
    np.testing.assert_allclose(l0.numpy(), l_t.detach().numpy(), rtol=1e-12)


def test_quad_and_logdet_gradient_finite_differences():
    """torch.autograd.gradcheck: central differences at f64 (its default
    eps 1e-6 / atol 1e-5), on a symmetric perturbation of A."""
    rng = np.random.default_rng(7)
    A = torch.tensor(_spd(rng, (2,), 6))
    z = torch.tensor(rng.normal(size=(2, 6)), requires_grad=True)
    S = torch.tensor(rng.normal(size=(2, 6, 6)), requires_grad=True)

    def f(S, z):
        q, l = tl.quad_and_logdet(A + 0.1 * (S + S.transpose(-1, -2)), z)
        return q, l

    assert torch.autograd.gradcheck(f, (S, z))


@pytest.mark.parametrize("batch", [(), (3,)])
def test_spd_solve_value_and_grad(batch):
    rng = np.random.default_rng(11 + len(batch))
    A = _spd(rng, batch, 8)
    B = rng.normal(size=batch + (8, 3))
    W = rng.normal(size=batch + (8, 3))

    X_j = jl.spd_solve(jnp.asarray(A), jnp.asarray(B))
    gA_j, gB_j = jax.grad(lambda A, B: jnp.sum(W * jl.spd_solve(A, B)), argnums=(0, 1))(
        jnp.asarray(A), jnp.asarray(B)
    )
    At = torch.tensor(A, requires_grad=True)
    Bt = torch.tensor(B, requires_grad=True)
    X_t = tl.spd_solve(At, Bt)
    (torch.as_tensor(W) * X_t).sum().backward()
    np.testing.assert_allclose(X_t.detach().numpy(), np.asarray(X_j), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(At.grad.numpy(), np.asarray(gA_j), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(Bt.grad.numpy(), np.asarray(gB_j), rtol=1e-10, atol=1e-13)

    S = torch.tensor(rng.normal(size=batch + (8, 8)), requires_grad=True)
    Bg = torch.tensor(B, requires_grad=True)
    A0 = torch.tensor(A)
    assert torch.autograd.gradcheck(lambda S, B: tl.spd_solve(A0 + 0.1 * (S + S.transpose(-1, -2)), B), (S, Bg))


def test_non_pd_gives_nan_without_raising():
    """A non-PD batch entry is NaN (as jnp.linalg.cholesky gives), the
    others are untouched, and nothing raises (no host read of ``info``)."""
    rng = np.random.default_rng(3)
    A = _spd(rng, (3,), 5)
    A[1] = -A[1]
    z = rng.normal(size=(3, 5))
    q, l = tl.quad_and_logdet(torch.tensor(A), torch.tensor(z))
    q_j, l_j = jl.quad_and_logdet(jnp.asarray(A), jnp.asarray(z))
    assert np.isnan(q[1].item()) and np.isnan(l[1].item())
    assert np.isnan(np.asarray(q_j)[1])  # the reference agrees
    np.testing.assert_allclose(q[[0, 2]].numpy(), np.asarray(q_j)[[0, 2]], rtol=1e-10)
    X = tl.spd_solve(torch.tensor(A), torch.tensor(z[..., None]))
    assert torch.isnan(X[1]).all() and torch.isfinite(X[[0, 2]]).all()
