"""GP classifier: latent GP + logit link + Bernoulli likelihood.

Port of ``gumbi_tpu/models/gpc.py``. Hyperparameters are learned by
maximizing the Laplace-approximate marginal likelihood (Newton mode-finding,
``ops/laplace.py``; ``ops/fitc_laplace.py`` for ``sparse=True``), and class
probabilities come from the probit approximation to the logistic-Gaussian
integral.

The output column must be binary (0/1). Predictions are latent-space (μ, σ2)
plus :meth:`GPC.predict_proba` for class probabilities; posterior
probability draws register as logit-normal variables for transform-aware
plotting, as the reference registers them.

As ``GP``, the model lives on the CUDA card unless the caller passes
``device="cpu"``, at f32 there and f64 on the CPU, and its random draws come
from ``torch.Generator`` objects seeded as the reference seeds its JAX keys
(``stream=`` replays any other stream). ``sample(latent=False)`` runs its
chains in lockstep on the chain-batched Laplace evidence
(``laplace_neg_logp_chains``: one batched Newton loop and one analytic
backward for all chains a leapfrog step) where the reference ``vmap``s
``laplace_neg_logp``; the sparse classifier's chains evaluate
``fitc_laplace_neg_logp`` one after another.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import (
    chees_sample,
    constrain,
    ess_gpc_sample,
    fit_fitc_laplace_map,
    fit_laplace_map,
    fitc_laplace_draw_latent,
    fitc_laplace_neg_logp,
    fitc_laplace_predict,
    hmc_sample,
    initial_params,
    laplace_draw_latent,
    laplace_neg_logp_chains,
    laplace_predict,
    latent_conditional_proba,
    select_inducing,
    unconstrain,
)
from ..ops.kernels import CONTINUOUS_KERNELS
from ..utils import assert_in
from ..utils.torch_utils import TorchStream
from .gp import GP, _numpy

__all__ = ["GPC"]


class GPC(GP):
    """Gaussian-Process classifier on the port's Laplace engine."""

    def build_model(
        self,
        seed=None,
        continuous_kernel="ExpQuad",
        period=None,
        heteroskedastic_inputs=False,
        heteroskedastic_outputs=False,
        sparse=False,
        n_u=100,
        ARD=True,
        ls_bounds=None,
        mass=0.98,
        multitask_kernel=None,
        bucket=None,
    ):
        """Build the latent-GP covariance structure for classification."""
        if heteroskedastic_inputs:
            raise NotImplementedError("The GPC does not support heteroskedastic inputs.")
        if heteroskedastic_outputs:
            raise NotImplementedError("The GPC does not support heteroskedastic outputs.")
        if sparse and bucket:
            raise NotImplementedError(
                "sparse + bucket is unnecessary for the GPC: the FITC-Laplace "
                "fit is O(N·m²), so refits are cheap without padding."
            )
        if multitask_kernel not in (None, "Hadamard"):
            raise NotImplementedError(
                "The GPC latent model is always the tall Hadamard structure "
                "(Kronecker/Independent reformulations assume a Gaussian "
                "likelihood)."
            )
        assert_in("Continuous kernel", continuous_kernel, CONTINUOUS_KERNELS)

        # The regression build makes the spec, data and priors; the latent
        # likelihood then drops the noise and takes the raw binary targets.
        # (sparse=False here: inducing points are placed below, after the
        # finite-row filter, so the centers see the real data.)
        super().build_model(
            seed=seed,
            continuous_kernel=continuous_kernel,
            period=period,
            heteroskedastic_inputs=False,
            heteroskedastic_outputs=False,
            sparse=False,
            n_u=n_u,
            ARD=ARD,
            ls_bounds=ls_bounds,
            mass=mass,
            multitask_kernel="Hadamard",
        )
        self.latent = True
        # Bernoulli likelihood: no σ and no noise coregion in the parameters
        self._spec = dataclasses.replace(self._spec, likelihood="bernoulli", noise_coreg=None)
        self.model = self._spec

        # Targets: raw 0/1 labels, not z-scores
        _, y_raw = self.get_structured_data("mean")
        y = np.asarray(y_raw.values(), dtype=float).squeeze()
        uniq = set(np.unique(y[np.isfinite(y)]))
        if not uniq <= {0.0, 1.0}:
            raise ValueError(f"GPC requires binary 0/1 outputs; found values {sorted(uniq)}")
        finite = np.isfinite(y)
        y = y[finite]
        xc = _numpy(self._xc)[finite]
        xk = _numpy(self._xk)[finite]

        # Bucket padding in host numpy: padded rows carry zero likelihood,
        # so the masked evidence is exact (ops/laplace.laplace_mode).
        self._mask = None
        if bucket:
            n = int(xc.shape[0])
            n_pad = (-n) % int(bucket)
            if n_pad:
                xc = np.concatenate([xc, np.zeros((n_pad, xc.shape[1]), dtype=xc.dtype)])
                xk = np.concatenate([xk, np.zeros((n_pad, xk.shape[1]), dtype=xk.dtype)])
                y = np.concatenate([y, np.zeros(n_pad)])
            self._mask = self._tensor(np.concatenate([np.ones(n), np.zeros(n_pad)]))
        self._yz = self._tensor(y)
        self._xc = self._tensor(xc)
        self._xk = self._index(xk)

        # Sparse FITC classifier: k-means inducing points over the filtered
        # rows, as the sparse regressor places them.
        self.sparse = bool(sparse)
        if sparse:
            self._xu_c, self._xu_k = select_inducing(
                xc, xk, n_u, self._spec.d_cont, self.seed if seed is None else seed, self._dtype,
                mask=self._mask, device=self._device,
            )
        return self

    def find_MAP(self, n_restarts=8, maxiter=300, tol=1e-6, seed=None, mesh=None, **kwargs):
        """Learn hyperparameters by maximizing the Laplace marginal likelihood.

        Multi-restart L-BFGS on the model's device through ``fit_laplace_map``
        (the evidence's analytic gradient, never the Newton loop's) or, for a
        sparse model, ``fit_fitc_laplace_map`` (autograd through the
        O(N·m²) Newton loop). With ``mesh`` (a ``DeviceMesh``,
        :func:`gumbi_tpu_torch.parallel.make_mesh`) the restarts shard over
        the ranks, every rank calling ``find_MAP`` alike; the result is the
        single-device fit's (the same objective, restarts and argmin).
        """
        assert self._spec is not None, "Call build_model first"
        seed = self.seed if seed is None else seed
        u0s = initial_params(
            self._spec, self._ls_alpha, self._ls_beta, n_restarts=n_restarts, seed=seed,
            dtype=self._dtype, device=self._device,
        )
        ls_alpha = self._tensor(self._ls_alpha)
        ls_beta = self._tensor(self._ls_beta)
        if mesh is not None:
            from ..parallel import sharded_fit_fitc_laplace_map, sharded_fit_laplace_map

            if self.sparse:
                params, f_best, aux = sharded_fit_fitc_laplace_map(
                    mesh, self._spec, self._xc, self._xk, self._xu_c, self._xu_k, self._yz, ls_alpha, ls_beta, u0s,
                    maxiter=maxiter, tol=tol, mask=self._mask,
                )
            else:
                params, f_best, aux = sharded_fit_laplace_map(
                    mesh, self._spec, self._xc, self._xk, self._yz, ls_alpha, ls_beta, u0s,
                    maxiter=maxiter, tol=tol, mask=self._mask,
                )
            u_best = unconstrain(params)
        elif self.sparse:
            u_best, f_best, aux = fit_fitc_laplace_map(
                self._spec, self._xc, self._xk, self._xu_c, self._xu_k, self._yz, ls_alpha, ls_beta, u0s,
                maxiter=maxiter, tol=tol, mask=self._mask, device=self._device,
            )
        else:
            u_best, f_best, aux = fit_laplace_map(
                self._spec, self._xc, self._xk, self._yz, ls_alpha, ls_beta, u0s,
                maxiter=maxiter, tol=tol, mask=self._mask, device=self._device,
            )
        self._params = constrain(u_best)
        self._neg_logp = float(f_best)
        self._fit_aux = _numpy(aux)
        self.MAP = _numpy(self._params)
        self._cache = None  # the classifier predicts through the Laplace predictor
        return self.MAP

    def sample(
        self,
        draws=500,
        tune=500,
        chains=None,
        seed=None,
        n_leapfrog=32,
        target_accept=None,
        latent=False,
        ess_sweeps=4,
        sampler="chees",
        *,
        stream=None,
        **kwargs,
    ):
        """Sample the classifier posterior on the model's device.

        * ``latent=False`` (default): ChEES-HMC (or ``sampler='hmc'``) over
          the hyperparameters under the Laplace-approximate marginal, the
          chains in lockstep: a dense model on the chain-batched
          ``laplace_neg_logp_chains``, a sparse one on
          ``fitc_laplace_neg_logp`` chain by chain.
        * ``latent=True``: the joint (latent field, hyperparameter)
          posterior by elliptical slice sampling on whitened latents with a
          random-walk Metropolis hyper move (``ops/ess.py``). The trace also
          carries ``_latent_f`` (chains, draws, N), which
          :meth:`predict_proba` integrates over when passed as ``source``.

        Chains default to 2 with ``latent=True``, else 16 for ChEES and 2 for
        HMC; ``target_accept`` to 0.3 for the Metropolis hyper move, 0.75 for
        ChEES and 0.8 for HMC. Draws come from a ``torch.Generator`` seeded
        with ``seed``; ``stream=`` takes any object with
        :class:`~gumbi_tpu_torch.utils.torch_utils.TorchStream`'s interface
        instead.
        """
        assert self._spec is not None, "Call build_model first"
        seed = self.seed if seed is None else seed
        ls_alpha = self._tensor(self._ls_alpha)
        ls_beta = self._tensor(self._ls_beta)

        if self._params is not None:
            q0 = unconstrain(self._params)
        else:
            u0s = initial_params(
                self._spec, self._ls_alpha, self._ls_beta, 1, seed, dtype=self._dtype, device=self._device
            )
            q0 = {k: v[0] for k, v in u0s.items()}

        if chains is None:
            chains = 2 if latent else (16 if sampler == "chees" else 2)
        generator = torch.Generator(device=self._device).manual_seed(seed)
        if latent:
            if self.sparse:
                raise NotImplementedError(
                    "sample(latent=True) runs on the dense latent field; the "
                    "sparse FITC classifier samples hyperparameters only "
                    "(latent=False)."
                )
            usamples, f_draws, stats = ess_gpc_sample(
                self._spec, q0, self._xc, self._xk, self._yz, ls_alpha, ls_beta, generator,
                draws=draws, tune=tune, chains=chains, ess_sweeps=ess_sweeps,
                target_accept=0.3 if target_accept is None else float(target_accept),
                mask=self._mask, stream=stream, device=self._device,
            )
            self.trace = _numpy(constrain(usamples))
            self.trace["_latent_f"] = _numpy(f_draws)
            self.trace["_stats"] = _numpy(stats)
            return self.trace

        if sampler not in ("chees", "hmc"):
            raise ValueError(f"sampler must be 'chees' or 'hmc', got {sampler!r}")
        if self.sparse:
            def logp(uparams):
                return -fitc_laplace_neg_logp(
                    self._spec, uparams, self._xc, self._xk, self._xu_c, self._xu_k, self._yz,
                    ls_alpha, ls_beta, mask=self._mask,
                )
        else:
            def logp(uparams):
                return -laplace_neg_logp_chains(
                    self._spec, uparams, self._xc, self._xk, self._yz, ls_alpha, ls_beta, mask=self._mask
                )

        common = dict(draws=draws, tune=tune, chains=chains, stream=stream, chain_batched=not self.sparse)
        if sampler == "chees":
            usamples, stats = chees_sample(
                logp, q0, generator,
                target_accept=0.75 if target_accept is None else float(target_accept), **common,
            )
        else:
            usamples, stats = hmc_sample(
                logp, q0, generator, n_leapfrog=n_leapfrog,
                target_accept=0.8 if target_accept is None else float(target_accept), **common,
            )
        self.trace = _numpy(constrain(usamples))
        self.trace["_stats"] = _numpy(stats)
        return self.trace

    @torch.no_grad()
    def predict(self, points_array, with_noise=True, additive_level="total", **kwargs):
        """Latent-function (mean, variance) at a tall dims-ordered points array."""
        if additive_level != "total":
            raise NotImplementedError("Prediction for additive sublevels is not yet supported.")
        assert self._params is not None, "Model must be fit before predicting"
        xc, xk = self._split_X(np.asarray(points_array))
        if self.sparse:
            mean, var, prob = fitc_laplace_predict(
                self._spec, self._params, self._xc, self._xk, self._xu_c, self._xu_k, self._yz, xc, xk,
                mask=self._mask,
            )
        else:
            mean, var, prob = laplace_predict(
                self._spec, self._params, self._xc, self._xk, self._yz, xc, xk, mask=self._mask
            )
        self._last_prob = _numpy(prob)
        return _numpy(mean), _numpy(var)

    def draw_point_samples(
        self, points, n_samples=1, output=None, with_noise=False, seed=None, source=None,
        additive_level="total", var_name="posterior_samples", increment_var=True, *, stream=None,
    ):
        """Posterior probability draws at supplied points.

        Latent-function draws from the Laplace posterior pushed through the
        logistic link; the sampled variable registers as a logit-normal for
        transform-aware downstream use. ``var_name``/``increment_var`` follow
        the reference bookkeeping (stored in :attr:`sample_vars`); sublevel
        draws of the latent field are not implemented. The standard-normal
        block comes from a ``torch.Generator`` seeded with ``seed``, or from
        ``stream``.
        """
        if additive_level != "total":
            raise NotImplementedError(
                "Sublevel draws of the classifier's latent field are not "
                "implemented (the Laplace cache factorizes the total kernel)."
            )
        output = self._parse_prediction_output(output)
        points_array, _, _ = self._prepare_points_for_prediction(points, output=output)
        xc, xk = self._split_X(np.asarray(points_array))
        if stream is None:
            seed = self.seed if seed is None else seed
            stream = TorchStream(torch.Generator(device=self._device).manual_seed(seed), self._dtype, self._device)
        eps = stream.normal((n_samples, xc.shape[0])).to(dtype=self._dtype, device=self._device)
        with torch.no_grad():
            if self.sparse:
                f_draws = fitc_laplace_draw_latent(
                    self._spec, self._params, self._xc, self._xk, self._xu_c, self._xu_k, self._yz, xc, xk,
                    n_samples=n_samples, mask=self._mask, eps=eps,
                )
            else:
                f_draws = laplace_draw_latent(
                    self._spec, self._params, self._xc, self._xk, self._yz, xc, xk,
                    n_samples=n_samples, mask=self._mask, eps=eps,
                )
        p_draws = _numpy(torch.sigmoid(f_draws))
        name = output[0]
        if name not in self.stdzr.logit_vars:
            self.stdzr.logit_vars = self.stdzr.logit_vars + [name]
        self.predictions = self.parray(**{name: p_draws})
        self.predictions_X = points
        self._store_sample_var(var_name, increment_var, self.predictions)
        return self.predictions

    def predict_proba(self, points, output=None, source=None, max_draws=64, seed=None):
        """Class probability P(y=1) at a 1-D parray of coordinates.

        ``source=None`` uses the Laplace approximation at the MAP
        hyperparameters. A trace from :meth:`sample` with ``latent=True``
        integrates over the joint (latent, hyperparameter) posterior instead:
        for each of ``max_draws`` (θ, f) draws, subsampled by
        ``np.random.default_rng(seed)`` as in the reference, the exact
        Gaussian conditional at θ given f gives the f* marginals, pushed
        through the probit approximation and averaged.
        """
        output = self._parse_prediction_output(output)
        points_array, _, _ = self._prepare_points_for_prediction(points, output=output)
        if source is None:
            self.predict(points_array)
            return self._last_prob
        if "_latent_f" not in source:
            raise ValueError(
                "predict_proba(source=...) needs a trace from "
                "sample(latent=True) (no '_latent_f' in the supplied trace)."
            )
        xc, xk = self._split_X(np.asarray(points_array))
        f = np.asarray(source["_latent_f"])  # (chains, draws, N)
        S_all = f.shape[0] * f.shape[1]
        f_flat = f.reshape(S_all, -1)
        params_flat = {
            k: np.asarray(v).reshape(S_all, *np.asarray(v).shape[2:])
            for k, v in source.items()
            if not k.startswith("_")
        }
        rng = np.random.default_rng(self.seed if seed is None else seed)
        idx = rng.choice(S_all, max_draws, replace=False) if S_all > max_draws else np.arange(S_all)
        params_stack = {k: self._tensor(v[idx]) for k, v in params_flat.items()}
        with torch.no_grad():
            proba = latent_conditional_proba(
                self._spec, params_stack, self._tensor(f_flat[idx]), self._xc, self._xk, xc, xk
            )
        self._last_prob = _numpy(proba)
        return self._last_prob

    def predict_grid_proba(self, output=None, categorical_levels=None):
        """Class probability over the prepared grid."""
        if self.grid_points is None:
            raise ValueError("Grid must first be specified with `prepare_grid`")
        points = self.grid_points
        if self.categorical_dims:
            points = self.append_categorical_points(points, categorical_levels=categorical_levels)
        proba = self.predict_proba(points, output=output)
        return proba.reshape(self.grid_parray.shape)
