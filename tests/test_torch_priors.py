"""Port parity: gumbi_tpu_torch.ops.priors vs gumbi_tpu.ops.priors."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gumbi_tpu.ops.kernels as jk
import gumbi_tpu.ops.priors as jp
import gumbi_tpu_torch.ops.priors as tp
from gumbi_tpu_torch.convert import params_to_numpy, spec_from_reference

torch.set_num_threads(2)


def _specs():
    out = jk.CoregTerm(name="Parameter", col=0, d_out=2)
    code = jk.CoregTerm(name="Code", col=1, d_out=3)
    return [
        jk.GPSpec(
            terms=(jk.GPTerm(suffix="total", kernel="ExpQuad", coregs=(out,)),),
            d_cont=2,
            noise_coreg=jk.CoregTerm(name="Output_noise", col=0, d_out=2),
        ),
        jk.GPSpec(
            terms=(
                jk.GPTerm(suffix="total", kernel="Matern52", linear_idx=(0, 2), coregs=(out,)),
                jk.GPTerm(suffix="Code", kernel="RBF", coregs=(out, code)),
            ),
            d_cont=3,
            ard=False,
        ),
        jk.GPSpec(terms=(jk.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=1, likelihood="bernoulli"),
    ]


SPECS = _specs()
IDS = ["kron", "additive_linear_shared_ls", "bernoulli"]


@pytest.mark.parametrize("jspec", SPECS, ids=IDS)
def test_param_info_matches(jspec):
    assert tp.param_info(spec_from_reference(jspec)) == {
        k: tp.ParamInfo(v.shape, v.prior, v.positive) for k, v in jp.param_info(jspec).items()
    }


@pytest.mark.parametrize("jspec", SPECS, ids=IDS)
def test_initial_params_same_seed_same_arrays(jspec):
    la, lb = np.array([1.5, 2.0, 3.0])[: jspec.n_ls], np.array([0.5, 1.0, 2.0])[: jspec.n_ls]
    ref = jp.initial_params(jspec, la, lb, n_restarts=5, seed=3)
    port = tp.initial_params(spec_from_reference(jspec), la, lb, n_restarts=5, seed=3, device="cpu")
    assert list(port) == list(ref)
    for k in ref:
        assert port[k].dtype == torch.float64
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]))
    f32 = tp.initial_params(spec_from_reference(jspec), la, lb, 5, 3, dtype=torch.float32, device="cpu")
    assert all(v.dtype == torch.float32 for v in f32.values())


@pytest.mark.parametrize("jspec", SPECS, ids=IDS)
def test_log_prior_value_and_grad(jspec):
    """rtol 1e-12: the same closed-form log-densities at f64 (lgamma of the
    shape parameters via math/torch vs jax.scipy differ only in the last ulp)."""
    la, lb = np.array([1.5, 2.5, 3.0])[: jspec.n_ls], np.array([0.5, 1.0, 2.0])[: jspec.n_ls]
    u = {k: np.asarray(v[2]) for k, v in jp.initial_params(jspec, la, lb, 4, seed=1).items()}
    val_j, g_j = jax.value_and_grad(lambda u: jp.log_prior(jspec, u, la, lb))(
        {k: jnp.asarray(v) for k, v in u.items()}
    )
    ut = {k: torch.tensor(v, requires_grad=True) for k, v in u.items()}
    val_t = tp.log_prior(spec_from_reference(jspec), ut, la, lb)
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-12)
    for k in u:
        np.testing.assert_allclose(ut[k].grad.numpy(), np.asarray(g_j[k]), rtol=1e-12, atol=1e-14)

    # f32 parameters keep an f32 prior even with f64 numpy shape parameters
    u32 = {k: torch.tensor(v, dtype=torch.float32) for k, v in u.items()}
    assert tp.log_prior(spec_from_reference(jspec), u32, la, lb).dtype == torch.float32


def test_constrain_round_trip():
    u = {"ls_total": torch.tensor([0.1, -0.3]), "W_Parameter": torch.tensor([[1.0, -2.0]]),
         "σ": torch.tensor(-1.0), "κ_Parameter": torch.tensor([0.2])}
    p = tp.constrain(u)
    ref = jp.constrain({k: jnp.asarray(v.numpy()) for k, v in u.items()})
    for k in u:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(ref[k]), rtol=1e-6)
    back = tp.unconstrain(p)
    for k in u:
        np.testing.assert_allclose(back[k].numpy(), u[k].numpy(), rtol=1e-6, atol=1e-7)
    assert set(params_to_numpy(p)) == set(u)


def test_ls_prior_params_and_inverse_gamma_match():
    lowers, uppers = [0.05, 0.2, 0.01], [4.0, 3.0, 0.5]
    a_t, b_t = tp.ls_prior_params(lowers, uppers)
    a_j, b_j = jp.ls_prior_params(lowers, uppers)
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(b_t, b_j)
    assert tp.fit_inverse_gamma(0.1, 2.0, 0.9) == jp.fit_inverse_gamma(0.1, 2.0, 0.9)
