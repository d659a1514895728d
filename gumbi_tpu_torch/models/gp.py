"""GP surface learning on the port's engine — the user-facing model.

Port of ``gumbi_tpu/models/gp.py``'s ``GP`` on its dense, Kronecker and
Independent structures and its two large-N regressors: :meth:`GP.fit`
parses dimensions (:meth:`specify_model`), builds the covariance structure
(:meth:`build_model`, with k-means inducing points when ``sparse=True``) and
learns MAP hyperparameters (:meth:`find_MAP`) by multi-restart L-BFGS
through the port's ``fit_gp_map`` / ``fit_kron_map``, on the FITC evidence
for a sparse model, or through the iterative (mBCG + SLQ) engine with
``engine='iterative'``, staged coarse-to-fine past 16,384 rows;
``prepare_grid``/``predict_grid`` then answer from the posterior caches,
:meth:`draw_point_samples`/:meth:`draw_grid_samples` draw jointly from
them, the ``predict_grad`` family differentiates the posterior mean by
autograd, :meth:`sample` runs ChEES or HMC over the hyperparameters and
:meth:`propose` (``q=``) maximizes qLogNEI/qLogNEHVI; :meth:`save`/
:meth:`load` use the reference's npz format, so a file saved by either
package loads in the other (a classifier's save too: it loads as a latent
model, ``models/gpc.py``). The model family, the structure choice
(Hadamard, Kronecker auto-selection, Independent), the priors and the
starting points are the reference's.

The model's tensors live on one device: the CUDA card unless the caller
passes ``device="cpu"``, where CUDA must exist or the constructor raises. The
dtype follows the device (f32 on CUDA, f64 on the CPU) unless ``dtype=`` is
given. On CUDA at f32 every ExpQuad Gram goes through the hand ``rbf_gram``
kernel (``ops/kernels.py``). Random draws come from ``torch.Generator`` objects
seeded as the reference seeds its JAX keys: the same distributions, not the
same numbers (``stream=`` replays any other stream).

``heteroskedastic_inputs=True`` adds a noise GP over the log squared
residuals (:meth:`_find_MAP_het`). ``mesh=`` (a ``DeviceMesh`` from
:func:`gumbi_tpu_torch.parallel.make_mesh`) shards ``find_MAP``'s restarts,
with ``shard_data=True`` the dense Gram and its Cholesky, and with
``engine='iterative'`` the matvec, over ``torch.distributed`` ranks; and
``predict``'s points (:mod:`gumbi_tpu_torch.parallel`).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import warnings
from dataclasses import asdict

import numpy as np
import torch

from ..convert import spec_from_reference
from ..ops import (
    CoregTerm,
    GPSpec,
    GPTerm,
    IterConfig,
    chees_sample,
    coarse_restart_map,
    constrain,
    draw_probes,
    draw_samples,
    fit_gp_map,
    fit_iter_map,
    fit_kron_map,
    fitc_draw_samples,
    fitc_neg_logp,
    fitc_predict,
    gram,
    hmc_sample,
    initial_params,
    iter_map_neg_logp,
    iter_posterior_cache,
    iter_predict_diag,
    kron_cache,
    kron_predict_diag,
    lbfgs_backtracking_minimize,
    ls_prior_params,
    map_neg_logp_chains,
    multi_restart_minimize,
    optimize_acqf,
    optimize_qlog_nei,
    output_correlation,
    posterior_cache,
    predict_diag,
    predict_diag_chunked,
    predict_diag_level,
    qlog_nehvi_2d,
    qlog_nehvi_mc,
    qlog_nei,
    select_inducing,
    sobol_normal,
    sobol_uniform,
    unconstrain,
)
from ..ops.acquisition import make_indep_sample_fn, make_kron_sample_fn
from ..ops.kernels import CONTINUOUS_KERNELS, noise_diag
from ..utils import assert_in
from ..utils.profiling import phase
from ..utils.torch_utils import TorchStream, default_model_dtype, resolve_device
from .base import Regressor

__all__ = ["GP"]

# The staged iterative fit's polish escalates an unconverged CG cap ×4 up to
# this many iterations, the reference's default rungs. One 4,096-iteration
# CG value+grad at N = 50,000 would spend ~33 s in the symmetric matvec
# alone on an H100 (PERF.md §6), so the ceiling stays, as a constant.
POLISH_CG_CAP = 2048


def _numpy(v):
    """Tensors (and dicts of them) → numpy on the host."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, dict):
        return {k: _numpy(x) for k, x in v.items()}
    return np.asarray(v)


def _torch_dtype(dtype):
    """A torch dtype from a torch, numpy or string spelling."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


class GP(Regressor):
    r"""Gaussian-Process surface learner (PyTorch backend).

    Main entry point is :meth:`fit`, which parses dimensions
    (:meth:`specify_model`), builds the covariance structure
    (:meth:`build_model`), and learns MAP hyperparameters
    (:meth:`find_MAP`) by multi-restart L-BFGS on the model's device.

    Examples
    --------
    >>> import gumbi_tpu_torch as gmt
    >>> cars = gmt.data.cars()
    >>> ds = gmt.DataSet(cars, outputs=['mpg', 'acceleration'],
    ...                  log_vars=['mpg', 'acceleration', 'horsepower'])
    >>> gp = gmt.GP(ds, device='cpu').fit(outputs=['mpg'], continuous_dims=['horsepower'])
    >>> X = gp.prepare_grid()
    >>> y = gp.predict_grid()
    """

    def __init__(self, dataset, outputs=None, seed=2021, dtype=None, device=None):
        self._device = resolve_device(device)
        super().__init__(dataset, outputs, seed)

        self.model = None  # GPSpec once built
        self.MAP = None
        self.trace = None

        self.continuous_kernel = "ExpQuad"
        self.heteroskedastic_inputs = False
        self.heteroskedastic_outputs = True
        self.sparse = False
        self.latent = False
        self.n_u = 100

        # Engine state
        self._spec = None
        self._xc = None
        self._xk = None
        self._yz = None
        self._ls_alpha = None
        self._ls_beta = None
        self._params = None
        self._cache = None
        self._cat_maps = {}
        self._structure = "Hadamard"
        self._mask = None
        # Iterative-engine state; populated by _find_MAP_iterative
        self._iter_cache = None
        self._iter_state = None
        # Heteroskedastic-input (noise GP) state; populated by _find_MAP_het
        self._noise_params = None
        self._noise_cache = None
        self._noise_mult = None
        self._noise_stats = None
        self._noise_zt = None
        self._dtype = default_model_dtype(self._device) if dtype is None else _torch_dtype(dtype)

        self.model_specs = {
            "seed": self.seed,
            "continuous_kernel": self.continuous_kernel,
            "heteroskedastic_inputs": self.heteroskedastic_inputs,
            "heteroskedastic_outputs": self.heteroskedastic_outputs,
            "sparse": self.sparse,
            "n_u": self.n_u,
            "multitask_kernel": None,
            "ARD": True,
        }

    def _tensor(self, a):
        """Host array → the model's dtype on the model's device (the cast
        happens in numpy, before the copy)."""
        return torch.as_tensor(np.asarray(a), dtype=self._dtype, device=self._device)

    def _index(self, a):
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=self._device)

    ################################################################################
    # Fitting
    ################################################################################

    def fit(
        self,
        outputs=None,
        linear_dims=None,
        continuous_dims=None,
        continuous_levels=None,
        continuous_coords=None,
        categorical_dims=None,
        categorical_levels=None,
        additive=False,
        seed=None,
        continuous_kernel="ExpQuad",
        period=None,
        heteroskedastic_inputs=False,
        heteroskedastic_outputs=True,
        sparse=False,
        n_u=100,
        ARD=True,
        ls_bounds=None,
        mass=0.98,
        multitask_kernel=None,
        bucket=None,
        spec_kwargs=None,
        build_kwargs=None,
        MAP_kwargs=None,
    ):
        """Fit a GP surface: specify → build → MAP.

        See :meth:`build_model` for the model-structure arguments and
        :meth:`find_MAP` for optimizer controls (pass via ``MAP_kwargs``).
        """
        with phase("specify_model"):
            self.specify_model(
                outputs=outputs,
                linear_dims=linear_dims,
                continuous_dims=continuous_dims,
                continuous_levels=continuous_levels,
                continuous_coords=continuous_coords,
                categorical_dims=categorical_dims,
                categorical_levels=categorical_levels,
                additive=additive,
                **(spec_kwargs or {}),
            )
        with phase("build_model"):
            self.build_model(
                seed=seed,
                continuous_kernel=continuous_kernel,
                period=period,
                heteroskedastic_inputs=heteroskedastic_inputs,
                heteroskedastic_outputs=heteroskedastic_outputs,
                sparse=sparse,
                n_u=n_u,
                ARD=ARD,
                ls_bounds=ls_bounds,
                mass=mass,
                multitask_kernel=multitask_kernel,
                bucket=bucket,
                **(build_kwargs or {}),
            )
        with phase("find_MAP"):
            self.find_MAP(**(MAP_kwargs or {}))
        return self

    # ------------------------------------------------------------------
    # Model construction
    # ------------------------------------------------------------------

    def _split_X(self, X):
        """Split a tall dims-ordered matrix into continuous (float) and
        categorical (int index) blocks, remapping coords to 0..d_out-1."""
        d_cont = len(self.continuous_dims)
        xc = self._tensor(np.asarray(X[:, :d_cont], dtype=float))
        cat_cols = []
        for j, dim in enumerate(self.categorical_dims):
            raw = np.asarray(X[:, d_cont + j], dtype=float)
            sorted_coords = self._cat_maps[dim]
            cat_cols.append(np.searchsorted(sorted_coords, np.round(raw, 9)))
        xk = np.column_stack(cat_cols) if cat_cols else np.zeros((X.shape[0], 0), dtype=np.int64)
        return xc, self._index(xk)

    def _reduced_xk(self, xk_np):
        """Xk with the output column dropped (Independent sub-model layout)."""
        keep = self._ind_keep
        xk_np = np.asarray(xk_np)
        if not keep:
            return self._index(np.zeros((xk_np.shape[0], 0), dtype=np.int64))
        return self._index(xk_np[:, keep])

    def _split_ind_data(self):
        """Per-output data blocks: rows of output j, with the output column
        dropped from Xk (Independent sub-model coregs index the reduced Xk)."""
        out_idx = self.categorical_dims.index(self.out_col)
        self._ind_out_idx = out_idx
        self._ind_keep = [jj for jj in range(self._xk.shape[1]) if jj != out_idx]
        xk_np = _numpy(self._xk)
        self._ind_data = []
        for j in range(len(self.outputs)):
            rows = np.where(xk_np[:, out_idx] == j)[0]
            r = self._index(rows)
            self._ind_data.append((self._xc[r], self._reduced_xk(xk_np[rows]), self._yz[r]))

    def _ind_output_index(self, name):
        """Coregion code of output ``name`` (the index into _ind_params)."""
        sorted_coords = self._cat_maps[self.out_col]
        coord = float(self.categorical_coords[self.out_col][name])
        return int(np.searchsorted(sorted_coords, np.round(coord, 9)))

    def _build_cat_maps(self):
        self._cat_maps = {
            dim: np.sort(np.asarray(list(self.categorical_coords[dim].values()), dtype=float))
            for dim in self.categorical_dims
        }

    def _prepare_ls_bounds(self, X_s, ARD, ls_bounds):
        """Per-dimension (lower, upper) lengthscale bounds.

        Parses the optional user parray of z-space deltas (NaN entries keep
        the data-driven default), then delegates the pairwise-distance
        defaults to :func:`gumbi_tpu_torch.utils.gp_utils.parse_ls_limits` —
        the single implementation of the bound logic. Dimensions absent from ``ls_bounds`` fall
        back to the defaults.
        """
        from ..utils.gp_utils import parse_ls_limits

        n_sets = X_s.shape[1] if ARD else 1
        lowers = [None] * n_sets
        uppers = [None] * n_sets
        if ls_bounds is not None:
            # Assign bounds BY NAME, one slot per continuous dim: positional
            # packing (as in the reference, ref pymc/GP.py:634-640) silently
            # shifts a partial bound set onto the wrong dimensions.
            user = []
            for dim in self.continuous_dims:
                b = [None, None]
                if dim in ls_bounds.names:
                    vals = ls_bounds[dim].z.values().squeeze()
                    given = [None if np.isnan(v) else float(v) for v in np.atleast_1d(vals)]
                    b = (given + [None] * 2)[:2]
                user.append(b)
            named = [b for b in user if b != [None, None]]
            if not ARD:
                if len(named) != 1:
                    raise ValueError(
                        "Bounds must be specified for only a single dimension if ARD is False"
                    )
                user = named  # the one shared lengthscale set
            lowers = [b[0] for b in user[:n_sets]]
            uppers = [b[1] for b in user[:n_sets]]
        return parse_ls_limits(np.asarray(X_s), ARD=ARD, lower=lowers, upper=uppers)

    def build_model(
        self,
        seed=None,
        continuous_kernel="ExpQuad",
        period=None,
        heteroskedastic_inputs=False,
        heteroskedastic_outputs=True,
        sparse=False,
        n_u=100,
        ARD=True,
        ls_bounds=None,
        mass=0.98,
        multitask_kernel=None,
        bucket=None,
    ):
        r"""Build the covariance structure and priors for the current spec.

        Model (reference GP.py:61-94): y ~ N(μ, σ); μ ~ GP(K);
        K = (K_cont + K_lin)·K_coreg_outputs·∏ K_coreg_cat, with an additive
        per-category variant when ``additive=True``.

        ``bucket``: pad the training set to the next multiple of this size
        with masked rows (exact MLL; identity rows contribute zero). Forces
        the Hadamard structure.

        ``multitask_kernel``: None (auto), 'Kronecker', 'Hadamard' or
        'Independent'. When every output is observed at identical locations
        the Kronecker reformulation is numerically identical but ~D²
        cheaper (batched (D, N, N) Cholesky instead of one (ND, ND)); auto
        selects it whenever the structure allows. 'Hadamard' forces the
        tall path.

        ``sparse``: the FITC model on ``n_u`` inducing points, placed by
        k-means (host numpy, the reference's draws) over the real rows.

        ``heteroskedastic_inputs``: input-dependent observation noise by the
        most-likely heteroskedastic GP (Kersting et al. 2007): a second GP
        fit to the log expected squared residuals gives a per-row relative
        noise variance, and prediction adds the location-dependent noise at
        new points (:meth:`_find_MAP_het`). Dense Hadamard structure only;
        tune with ``MAP_kwargs=dict(het_iters=k)``.
        """
        if heteroskedastic_inputs:
            # The per-row noise diagonal breaks the Kronecker batching, FITC's
            # diagonal correction absorbs input-dependent slack already, the
            # Independent split would need one noise GP per output, and the
            # noise-GP targets are per observed row (no bucket padding).
            if sparse:
                raise NotImplementedError("heteroskedastic_inputs does not compose with sparse FITC.")
            if bucket:
                raise NotImplementedError(
                    "heteroskedastic_inputs does not compose with bucket padding "
                    "(the noise-GP targets are per observed row)."
                )
            if multitask_kernel in ("Kronecker", "Independent"):
                raise NotImplementedError(
                    "heteroskedastic_inputs requires the dense Hadamard structure "
                    "(per-row noise breaks the Kronecker/Independent batching)."
                )
            multitask_kernel = "Hadamard"
        assert_in("Continuous kernel", continuous_kernel, CONTINUOUS_KERNELS)

        X, y = self.get_shaped_data("mean")
        d_cont = len(self.continuous_dims)
        assert X.shape[1] == len(self.dims)

        seed = self.seed if seed is None else seed
        self.seed = seed
        self.continuous_kernel = continuous_kernel
        self.heteroskedastic_inputs = heteroskedastic_inputs
        self.heteroskedastic_outputs = heteroskedastic_outputs
        self.sparse = sparse
        self.n_u = n_u
        self.latent = False
        # Full build config, as the reference keeps it (cross_validate's
        # train-subset refits replay build_model(**model_specs)).
        self.model_specs = {
            "seed": seed,
            "continuous_kernel": continuous_kernel,
            "period": period,
            "heteroskedastic_inputs": heteroskedastic_inputs,
            "heteroskedastic_outputs": heteroskedastic_outputs,
            "sparse": sparse,
            "n_u": n_u,
            "ARD": ARD,
            "ls_bounds": ls_bounds,
            "mass": mass,
            "multitask_kernel": multitask_kernel,
            "bucket": bucket,
        }

        # Period (z-space) per continuous dim for periodic kernels
        period_z = None
        if "Periodic" in continuous_kernel:
            if continuous_kernel != "Periodic" and period is None:
                raise ValueError("Period must be specified for periodic kernel")
            if period is not None:
                zp = [float(period.z[d + "_z"].values()) for d in self.continuous_dims]
                period_z = tuple(zp)

        # Reset per-build padding state up front: the Independent branch
        # returns before the bucket block below.
        self._mask = None
        # A stale noise GP from a previous build would reshape the predictive noise.
        self._noise_params = None
        self._noise_cache = None
        self._noise_mult = None
        self._noise_stats = None
        self._noise_zt = None

        self._build_cat_maps()
        linear_idx = tuple(self.continuous_dims.index(d) for d in self.linear_dims)

        # Coregion factors per categorical dim (output column last)
        coreg_terms = {}
        for j, dim in enumerate(self.categorical_dims):
            coreg_terms[dim] = CoregTerm(name=dim, col=j, d_out=len(self.categorical_levels[dim]))
        out_cg = coreg_terms.get(self.out_col)

        if not self.additive:
            all_coregs = tuple(coreg_terms[d] for d in self.categorical_dims)
            terms = (
                GPTerm(suffix="total", kernel=continuous_kernel, linear_idx=linear_idx, coregs=all_coregs),
            )
        else:
            # Global term: continuous (+linear) × output coregion only
            global_coregs = (out_cg,) if out_cg is not None else ()
            terms = [
                GPTerm(suffix="total", kernel=continuous_kernel, linear_idx=linear_idx, coregs=global_coregs)
            ]
            for dim in self.categorical_dims:
                if dim == self.out_col:
                    continue
                coregs = (coreg_terms[dim],) + ((out_cg,) if out_cg is not None else ())
                terms.append(GPTerm(suffix=dim, kernel=continuous_kernel, linear_idx=linear_idx, coregs=coregs))
            terms = tuple(terms)

        noise_coreg = None
        if heteroskedastic_outputs and self.out_col in self.categorical_dims:
            out_j = self.categorical_dims.index(self.out_col)
            noise_coreg = CoregTerm(name="Output_noise", col=out_j, d_out=len(self.outputs))
            if sparse:
                warnings.warn(
                    "Heteroskedasticity over outputs is not yet implemented for sparse GP. "
                    "Reverting to scalar-valued noise."
                )
                noise_coreg = None

        self._spec = GPSpec(terms=terms, d_cont=d_cont, ard=ARD, noise_coreg=noise_coreg, period=period_z)
        self.model = self._spec

        self._xc, self._xk = self._split_X(X)
        self._yz = self._tensor(np.asarray(y, dtype=float))

        # Structure selection: Kronecker fast path when all outputs share the
        # same locations and the only categorical factor is the output column.
        if multitask_kernel is not None:
            multitask_kernel = multitask_kernel.capitalize()
            assert_in("multitask_kernel", multitask_kernel, ["Kronecker", "Hadamard", "Independent"])
        self._structure = "Hadamard"
        d_out = len(self.outputs)

        if multitask_kernel == "Independent" and d_out > 1:
            # Per-output single-task GPs: separate kernels, no learned
            # cross-output correlation. Each sub-model keeps every coregion
            # factor except the output column and the full additive terms.
            if sparse:
                raise NotImplementedError(
                    "Independent structure does not compose with sparse FITC "
                    "(the reference's ModelListGP is exact-only); fit per-output "
                    "sparse GPs directly or use the Hadamard structure."
                )
            if bucket:
                raise NotImplementedError(
                    "Bucket padding is not implemented for the Independent "
                    "structure (per-output blocks have their own shapes)."
                )
            self._structure = "Independent"
            sub_cats = [d for d in self.categorical_dims if d != self.out_col]
            # Coregion factors index the REDUCED Xk (output column dropped)
            sub_coreg = {
                d: CoregTerm(name=d, col=jj, d_out=len(self.categorical_levels[d]))
                for jj, d in enumerate(sub_cats)
            }
            if not self.additive:
                ind_terms = (
                    GPTerm(
                        suffix="total",
                        kernel=continuous_kernel,
                        linear_idx=linear_idx,
                        coregs=tuple(sub_coreg[d] for d in sub_cats),
                    ),
                )
            else:
                ind_terms = [GPTerm(suffix="total", kernel=continuous_kernel, linear_idx=linear_idx)]
                for dim in sub_cats:
                    ind_terms.append(
                        GPTerm(suffix=dim, kernel=continuous_kernel, linear_idx=linear_idx, coregs=(sub_coreg[dim],))
                    )
                ind_terms = tuple(ind_terms)
            self._ind_spec = GPSpec(
                terms=ind_terms,
                d_cont=d_cont,
                ard=ARD,
                period=period_z if "Periodic" in continuous_kernel else None,
            )
            self._spec = self._ind_spec
            self.model = self._spec
            self._split_ind_data()
            X_s = _numpy(self._xc)[:, :d_cont]
            lowers, uppers = self._prepare_ls_bounds(np.asarray(X_s, dtype=float), ARD, ls_bounds)
            self._ls_alpha, self._ls_beta = ls_prior_params(lowers, uppers, mass=mass)
            return self
        kron_structure_ok = (
            not self.additive
            and not sparse
            and bucket is None
            and d_out > 1
            and self.categorical_dims == [self.out_col]
            and multitask_kernel != "Hadamard"
        )
        if kron_structure_ok:
            n_tall = int(self._xc.shape[0])
            if n_tall % d_out == 0:
                n_loc = n_tall // d_out
                xc_np = _numpy(self._xc)
                xk_np = _numpy(self._xk[:, 0])
                blocks_equal = all(
                    np.array_equal(xc_np[:n_loc], xc_np[j * n_loc : (j + 1) * n_loc])
                    and np.all(xk_np[j * n_loc : (j + 1) * n_loc] == xk_np[j * n_loc])
                    for j in range(d_out)
                )
                if blocks_equal:
                    self._structure = "Kronecker"
                    self._xc_locs = self._xc[:n_loc]
                    # Column j of Y = output with coregion index j; tall blocks
                    # are output-major in index order already.
                    order = np.argsort(xk_np[::n_loc], kind="stable")
                    self._Y = self._tensor(_numpy(self._yz).reshape(d_out, n_loc)[order].T.copy())
        if multitask_kernel == "Kronecker" and self._structure != "Kronecker":
            raise ValueError(
                "Kronecker structure requested but outputs are not all observed "
                "at identical locations (or the model has extra categorical dims, "
                "or bucketing is enabled)."
            )

        # Bucket padding: masked zero rows up to a multiple of ``bucket``
        # (exact MLL via masked identity rows; see ops/mll.cholesky_factor).
        self._mask = None
        if bucket:
            n = int(self._xc.shape[0])
            n_pad = (-n) % int(bucket)
            if n_pad:
                self._xc = torch.cat([self._xc, self._xc.new_zeros((n_pad, self._xc.shape[1]))])
                self._xk = torch.cat([self._xk, self._xk.new_zeros((n_pad, self._xk.shape[1]))])
                self._yz = torch.cat([self._yz, self._yz.new_zeros(n_pad)])
            self._mask = self._tensor(np.concatenate([np.ones(n), np.zeros(n_pad)]))

        # Lengthscale priors from pairwise distances of the continuous block
        X_s = np.asarray(X[:, :d_cont], dtype=float)
        lowers, uppers = self._prepare_ls_bounds(X_s, ARD, ls_bounds)
        self._ls_alpha, self._ls_beta = ls_prior_params(lowers, uppers, mass=mass)

        if sparse:
            # k-means over the stacked (continuous z, categorical index)
            # matrix of the real rows, categorical columns snapped back to
            # valid level indices.
            self._xu_c, self._xu_k = select_inducing(
                self._xc, self._xk, n_u, d_cont, seed, self._dtype, mask=self._mask, device=self._device
            )
        return self

    @property
    def D_tasks(self):
        """Number of output tasks (reference gumbi/regression/botorch/GP.py:47-48)."""
        return len(self.outputs)

    @property
    def task_idxs(self):
        """Output-name → task-coordinate map (reference botorch/GP.py:50-55)."""
        from ..utils import one

        if self.D_tasks == 1:
            return {one(self.outputs): 0}
        return self.categorical_coords[self.out_col]

    def get_separated_data(self, metric="mean", dropna=True):
        """Per-output ``([X...], [y...])`` lists, split on the output
        coordinate column of the tall shaped data with that column removed
        (reference gumbi/regression/botorch/GP.py:283-294; numpy arrays here
        instead of torch tensors)."""
        X, y = self.get_shaped_data(metric=metric, dropna=dropna)
        if len(self.outputs) == 1:
            return [X], [y]
        j = self.dims.index(self.out_col)
        Xs, ys = [], []
        for i in np.unique(X[:, j]):
            idx = X[:, j] == i
            Xs.append(np.delete(X[idx], j, axis=1))
            ys.append(y[idx])
        return Xs, ys

    def fit_model(self, **kwargs):
        """Optimize hyperparameters of an already-built model (reference
        botorch/GP.py:387-392's ``fit_gpytorch_mll`` step); alias for
        :meth:`find_MAP` so BotorchGP-style call sites port unchanged."""
        return self.find_MAP(**kwargs)

    def build_latent(self, *args, **kwargs):
        """Latent-GP construction: the regressor always uses the marginal
        formulation (identical posterior for a Gaussian likelihood)."""
        raise NotImplementedError(
            "GP uses the marginal formulation (identical posterior for Gaussian "
            "likelihoods). For latent models with non-Gaussian likelihoods use GPC."
        )

    def find_MAP(
        self, n_restarts=8, maxiter=500, tol=1e-8, seed=None, mesh=None,
        shard_data=False, engine="cholesky", iter_config=None, **kwargs
    ):
        """Learn MAP hyperparameters by multi-restart L-BFGS on the model's device.

        Restart 0 starts from the prior moments (the PyMC starting point);
        the rest jitter in unconstrained space. The best finite optimum wins.
        Dense Hadamard and Independent fits go through ``fit_gp_map`` and
        keep a Cholesky posterior cache; Kronecker fits go through
        ``fit_kron_map`` and keep a ``kron_cache``; a sparse model's restarts
        minimize ``fitc_neg_logp`` and keep no cache (its predictions
        factor the M×M system each call).

        ``engine='iterative'`` (dense Hadamard) swaps the Cholesky marginal
        likelihood for the matrix-free mBCG + stochastic Lanczos engine
        (:mod:`gumbi_tpu_torch.ops.iterative`): O(N·block) memory, the
        fused Gram-matvec kernels on the card. ``iter_config`` takes an
        :class:`~gumbi_tpu_torch.ops.IterConfig`; the default picks a block
        size for large N. ``coarse_n`` and ``polish_maxiter`` (keywords)
        steer the staged fit of :meth:`_find_MAP_iterative`.

        ``mesh`` (a ('restart', 'data') ``DeviceMesh``,
        :func:`gumbi_tpu_torch.parallel.make_mesh`) shards the fit over
        ``torch.distributed`` ranks, every rank calling ``find_MAP`` alike:
        the restarts over the whole mesh for every structure (sparse,
        Kronecker, Independent output by output, dense), or with
        ``shard_data=True`` (dense Hadamard only) the N axis itself: Gram
        assembly and the blocked Cholesky over 'data', O(N²/P) memory a rank
        (:mod:`gumbi_tpu_torch.parallel.blocked`), and no eager posterior
        cache. With ``engine='iterative'`` the matvec's row blocks shard
        over 'data' (:mod:`gumbi_tpu_torch.parallel.iterative`), unstaged.
        A heteroskedastic-input fit takes ``het_iters`` (default 2) from the
        keywords and runs on one device.
        """
        assert self._spec is not None, "Call build_model first"
        seed = self.seed if seed is None else seed
        self._iter_cache = None
        self._iter_state = None

        if engine not in ("cholesky", "iterative"):
            raise ValueError("engine must be 'cholesky' or 'iterative'")
        if engine == "iterative":
            if self.sparse or self._structure in ("Kronecker", "Independent") or self.heteroskedastic_inputs:
                raise NotImplementedError(
                    "engine='iterative' supports the dense Hadamard "
                    "structure (the tall multi-output layout included)."
                )
            return self._find_MAP_iterative(
                iter_config, n_restarts=n_restarts, maxiter=maxiter, tol=tol, seed=seed, mesh=mesh,
                coarse_n=kwargs.pop("coarse_n", None), polish_maxiter=kwargs.pop("polish_maxiter", None),
            )

        u0s = initial_params(
            self._spec, self._ls_alpha, self._ls_beta, n_restarts=n_restarts, seed=seed,
            dtype=self._dtype, device=self._device,
        )
        ls_alpha = self._tensor(self._ls_alpha)
        ls_beta = self._tensor(self._ls_beta)

        if self.heteroskedastic_inputs:
            if mesh is not None:
                raise NotImplementedError(
                    "Mesh-sharded fitting is not implemented for heteroskedastic_inputs "
                    "(the noise-GP stage is a small second fit; run it on one device)."
                )
            return self._find_MAP_het(
                u0s, ls_alpha, ls_beta, n_restarts=n_restarts, maxiter=maxiter, tol=tol, seed=seed,
                n_iter=int(kwargs.pop("het_iters", 2)),
            )
        if mesh is not None:
            return self._find_MAP_mesh(mesh, shard_data, u0s, ls_alpha, ls_beta, n_restarts=n_restarts,
                                       maxiter=maxiter, tol=tol, seed=seed)

        if self.sparse:
            def objective(uparams):
                return fitc_neg_logp(
                    self._spec, uparams, self._xc, self._xk, self._xu_c, self._xu_k, self._yz,
                    ls_alpha, ls_beta, mask=self._mask,
                )

            u_best, neg_logp, aux = multi_restart_minimize(objective, u0s, maxiter=maxiter, tol=tol)
            params = constrain(u_best)
            self._cache = None
        elif self._structure == "Independent":
            # One single-task fit per output, each from its own seeded starts.
            self._ind_params = []
            self._ind_caches = []
            neg_total = 0.0
            aux = {}
            for j, (xc_j, xk_j, y_j) in enumerate(self._ind_data):
                u0s_j = initial_params(
                    self._spec, self._ls_alpha, self._ls_beta,
                    n_restarts=n_restarts, seed=seed + j, dtype=self._dtype, device=self._device,
                )
                p_j, neg_j, aux_j = fit_gp_map(
                    self._spec, xc_j, xk_j, y_j, ls_alpha, ls_beta, u0s_j, maxiter=maxiter, tol=tol,
                )
                self._ind_params.append(p_j)
                with torch.no_grad():
                    self._ind_caches.append(posterior_cache(self._spec, p_j, xc_j, xk_j, y_j))
                neg_total += float(neg_j)
                aux[f"output_{j}"] = _numpy(aux_j)
            self._params = self._ind_params[0]  # representative (for dtype etc.)
            self._neg_logp = neg_total
            self._fit_aux = aux
            self.MAP = {out: _numpy(self._ind_params[self._ind_output_index(out)]) for out in self.outputs}
            self._cache = None
            return self.MAP
        elif self._structure == "Kronecker":
            u_best, neg_logp, aux = fit_kron_map(
                self._spec, self._xc_locs, self._Y, ls_alpha, ls_beta, u0s, maxiter=maxiter, tol=tol,
            )
            params = constrain(u_best)
            with torch.no_grad():
                self._kron_cache = kron_cache(self._spec, params, self._xc_locs, self._Y)
            self._cache = None
        else:
            params, neg_logp, aux = fit_gp_map(
                self._spec, self._xc, self._xk, self._yz, ls_alpha, ls_beta, u0s,
                maxiter=maxiter, tol=tol, mask=self._mask,
            )
        self._set_fit(params, neg_logp, aux)
        if not self.sparse and self._structure != "Kronecker":
            with torch.no_grad():
                self._cache = posterior_cache(
                    self._spec, self._params, self._xc, self._xk, self._yz, mask=self._mask
                )
        return self.MAP

    def _set_fit(self, params, neg_logp, aux):
        """Store a fit's parameters, value and diagnostics; returns the MAP."""
        self._params = params
        self._neg_logp = float(neg_logp)
        self._fit_aux = _numpy(aux)
        self.MAP = _numpy(params)
        return self.MAP

    def _find_MAP_mesh(self, mesh, shard_data, u0s, ls_alpha, ls_beta, *, n_restarts, maxiter, tol, seed):
        """``find_MAP(mesh=)``'s branches, as the reference takes them."""
        from .. import parallel

        if self.sparse:
            # The FITC evidence is a pure function of the hyperparameters:
            # its restart sweep, which dominates sparse fits, spreads over the mesh.
            params, neg_logp, aux = parallel.sharded_fit_fitc_map(
                mesh, self._spec, self._xc, self._xk, self._xu_c, self._xu_k, self._yz,
                ls_alpha, ls_beta, u0s, maxiter=maxiter, tol=tol, mask=self._mask,
            )
            self._cache = None
            return self._set_fit(params, neg_logp, aux)
        if self._structure == "Kronecker":
            params, neg_logp, aux = parallel.sharded_fit_kron_map(
                mesh, self._spec, self._xc_locs, self._Y, ls_alpha, ls_beta, u0s, maxiter=maxiter, tol=tol,
            )
            with torch.no_grad():
                self._kron_cache = kron_cache(self._spec, params, self._xc_locs, self._Y)
            self._cache = None
        elif self._structure == "Independent":
            self._ind_params = []
            self._ind_caches = []
            neg_total = 0.0
            aux = {}
            for j, (xc_j, xk_j, y_j) in enumerate(self._ind_data):
                u0s_j = initial_params(
                    self._spec, self._ls_alpha, self._ls_beta,
                    n_restarts=n_restarts, seed=seed + j, dtype=self._dtype, device=self._device,
                )
                p_j, neg_j, aux_j = parallel.sharded_fit_gp_map(
                    mesh, self._spec, xc_j, xk_j, y_j, ls_alpha, ls_beta, u0s_j, maxiter=maxiter, tol=tol,
                )
                self._ind_params.append(p_j)
                with torch.no_grad():
                    self._ind_caches.append(posterior_cache(self._spec, p_j, xc_j, xk_j, y_j))
                neg_total += float(neg_j)
                aux[f"output_{j}"] = _numpy(aux_j)
            self._params = self._ind_params[0]
            self._neg_logp = neg_total
            self._fit_aux = aux
            self.MAP = {out: _numpy(self._ind_params[self._ind_output_index(out)]) for out in self.outputs}
            self._cache = None
            return self.MAP
        elif shard_data:
            if self._mask is not None:
                raise NotImplementedError(
                    "shard_data does not compose with bucket padding (the sharded "
                    "Gram pads to the mesh extent itself)."
                )
            params, neg_logp, aux = parallel.data_sharded_fit_gp_map(
                mesh, self._spec, self._xc, self._xk, self._yz, ls_alpha, ls_beta, u0s, maxiter=maxiter, tol=tol,
            )
            # No eager posterior cache: no rank holds the N×N factorization;
            # prediction builds it lazily (or shards the points with predict(mesh=)).
            self._cache = None
        else:
            params, neg_logp, aux = parallel.sharded_fit_gp_map(
                mesh, self._spec, self._xc, self._xk, self._yz, ls_alpha, ls_beta, u0s,
                maxiter=maxiter, tol=tol, mask=self._mask,
            )
            with torch.no_grad():
                self._cache = posterior_cache(self._spec, params, self._xc, self._xk, self._yz, mask=self._mask)
        return self._set_fit(params, neg_logp, aux)

    def _noise_spec(self):
        """The noise GP's spec: the model's kernel and coregion structure
        with its own homoskedastic white noise."""
        spec = self._spec
        return GPSpec(terms=spec.terms, d_cont=spec.d_cont, ard=spec.ard, period=spec.period)

    def _find_MAP_het(self, u0s, ls_alpha, ls_beta, *, n_restarts, maxiter, tol, seed, n_iter=2):
        """Most-likely heteroskedastic GP fit (Kersting et al. 2007, ICML).

        Alternates (1) a MAP fit of the main GP given a fixed per-row
        relative noise variance and (2) a noise GP fit to the log expected
        squared residuals z_i = log((y_i − μ_i)² + var_i), whose posterior
        mean gives the next round's noise shape exp(l(x) − l̄). The learnable
        σ² keeps the global noise scale (the shape has mean 1 in log space),
        so the homoskedastic model is recovered where the noise GP finds no
        signal. 2·n_iter + 1 fits; z's moments and l̄ are taken in f64 on the
        host, as the reference takes them.
        """
        if n_iter < 1:
            raise ValueError(
                "het_iters must be >= 1: zero alternations would leave no "
                "fitted noise GP (a plain homoskedastic fit is the model "
                "without heteroskedastic_inputs)."
            )
        spec = self._spec
        xc, xk, y = self._xc, self._xk, self._yz
        with phase("het_fit_0"):
            params, neg_logp, aux = fit_gp_map(spec, xc, xk, y, ls_alpha, ls_beta, u0s, maxiter=maxiter, tol=tol)
        noise_spec = self._noise_spec()
        noise_mult = None
        for it in range(n_iter):
            with torch.no_grad():
                cache = posterior_cache(spec, params, xc, xk, y, noise_mult=noise_mult)
                mu, var = predict_diag(spec, params, cache, xc, xk, with_noise=False)
            # E[(y − f)²] = squared residual + latent posterior variance
            r2 = _numpy((y - mu) ** 2 + var).astype(np.float64)
            z = np.log(np.maximum(r2, 1e-12))
            z_m = float(z.mean())
            z_s = float(max(z.std(), 1e-3))
            zt = self._tensor((z - z_m) / z_s)
            u0s_n = initial_params(
                noise_spec, self._ls_alpha, self._ls_beta, n_restarts=n_restarts, seed=seed + 7919 + it,
                dtype=self._dtype, device=self._device,
            )
            with phase(f"het_noise_{it + 1}"):
                nparams, _, _ = fit_gp_map(noise_spec, xc, xk, zt, ls_alpha, ls_beta, u0s_n, maxiter=maxiter, tol=tol)
            with torch.no_grad():
                ncache = posterior_cache(noise_spec, nparams, xc, xk, zt)
                g, _ = predict_diag(noise_spec, nparams, ncache, xc, xk, with_noise=False)
            log_noise = z_m + z_s * _numpy(g).astype(np.float64)
            lbar = float(log_noise.mean())
            noise_mult = self._tensor(np.exp(log_noise - lbar))
            with phase(f"het_fit_{it + 1}"):
                params, neg_logp, aux = fit_gp_map(
                    spec, xc, xk, y, ls_alpha, ls_beta, u0s, maxiter=maxiter, tol=tol, noise_mult=noise_mult,
                )
        self._noise_params = nparams
        self._noise_cache = ncache
        self._noise_mult = noise_mult
        self._noise_stats = (z_m, z_s, lbar)
        self._noise_zt = zt  # saved, so that load() can rebuild the noise cache
        self._set_fit(params, neg_logp, aux)
        with torch.no_grad():
            self._cache = posterior_cache(spec, params, xc, xk, y, noise_mult=noise_mult)
        return self.MAP

    def _het_noise_mult_at(self, xc_new, xk_new):
        """Relative noise variance exp(l(x) − l̄) at new points."""
        with torch.no_grad():
            g, _ = predict_diag(self._noise_spec(), self._noise_params, self._noise_cache, xc_new, xk_new,
                                with_noise=False)
        z_m, z_s, lbar = self._noise_stats
        return torch.exp(z_m + z_s * g - lbar)

    def _het_noise(self, var, xc, xk):
        """``var`` plus the heteroskedastic predictive noise: the learnable
        σ² (output-coregion scaled) times the noise GP's shape."""
        return var + noise_diag(self._spec, self._params, xk, dtype=var.dtype) * self._het_noise_mult_at(xc, xk)

    def _find_MAP_iterative(self, iter_config, *, n_restarts, maxiter, tol, seed, mesh=None, coarse_n=None,
                            polish_maxiter=None):
        """Dense-Hadamard MAP fit through the mBCG/SLQ engine.

        Data is bucket-padded (the engine's exact identity-row masking) to a
        multiple of the matvec block, probes are drawn once per fit
        (deterministic objective), and the posterior state is one PCG solve
        plus the rank-k pivoted-Cholesky and LOVE factors: never an (N, N)
        array.

        Large-N fits stage coarse-to-fine: the restart sweep triages
        hyperparameters on a ``coarse_n``-row subsample (default 4,096)
        through the exact Cholesky objective, and only the winner polishes
        at full N through the iterative objective. Staging activates for
        N > 16,384 or whenever ``coarse_n`` is given; ``polish_maxiter``
        bounds the full-N polish (default 100).

        The polish climbs a recovery ladder while its start evaluates
        non-finite (the engine returns +inf when CG exits at its cap above
        tolerance): the coarse winner at the configured CG cap, up to two
        runner-up coarse candidates at that cap, then the winner at caps
        ×4 up to :data:`POLISH_CG_CAP`; each rung's first evaluation is its
        probe. If no rung starts finite, the fit keeps the subsample MAP and
        flags it (``_fit_aux['polish_fallback']``). ``_fit_aux`` also holds
        the rung taken (``polish_rung``) and, per polish evaluation of that
        rung, its regime (``polish_exhausted``), CG iterations
        (``polish_cg_iters``) and Woodbury residual (``polish_woodbury_rel``,
        NaN where the factorization was not exhausted); and, for every
        iterative fit, the posterior solve's regime, CG iterations, residual
        and Woodbury residual (``cache_exhausted``, ``cache_cg_iters``,
        ``cache_rel_res``, ``cache_woodbury_rel``).

        With a ``mesh`` the matvec's row blocks shard over 'data'
        (:mod:`gumbi_tpu_torch.parallel.iterative`): the data are padded to a
        multiple of P·block, the fit is unstaged (restarts in a host loop of
        L-BFGS, no recovery ladder, as the reference's mesh path), and the
        posterior cache has the same contents, so prediction is the same.
        """
        n = int(self._xc.shape[0])
        if iter_config is None:
            # The dense matvec while the (N, N) Gram fits comfortably; blocked
            # streaming beyond that. LOVE rank scales to the data.
            iter_config = IterConfig(block=0 if n <= 16384 else 2048, love_rank=min(512, n))
        cfg = iter_config

        xc, xk, yz, mask = self._xc, self._xk, self._yz, self._mask
        if mesh is not None:
            from ..parallel import pad_for_dist_iter

            xc, xk, yz, mask = pad_for_dist_iter(mesh, cfg, xc, xk, yz, mask)
        elif cfg.block > 0 and n % cfg.block:
            pad = (-n) % cfg.block
            xc = torch.cat([xc, xc.new_zeros((pad, xc.shape[1]))])
            xk = torch.cat([xk, xk.new_zeros((pad, xk.shape[1]))])
            yz = torch.cat([yz, yz.new_zeros(pad)])
            base = self._mask if self._mask is not None else yz.new_ones(n)
            mask = torch.cat([base, yz.new_zeros(pad)])

        spec = self._spec
        u0s = initial_params(
            spec, self._ls_alpha, self._ls_beta, n_restarts=n_restarts, seed=seed,
            dtype=self._dtype, device=self._device,
        )
        ls_alpha = self._tensor(self._ls_alpha)
        ls_beta = self._tensor(self._ls_beta)
        pn, pk = draw_probes(seed, int(xc.shape[0]), cfg, dtype=self._dtype, device=self._device)

        if mesh is not None:
            from ..parallel import dist_iter_fit_gp_map, dist_iter_posterior_cache

            with phase("iter_dist_fit"):
                params, neg_logp, aux = dist_iter_fit_gp_map(
                    mesh, spec, cfg, xc, xk, yz, ls_alpha, ls_beta, u0s, pn, pk, mask, maxiter=maxiter, tol=tol,
                )
            self._set_fit(params, neg_logp, aux)
            self._cache = None
            self._iter_state = {"cfg": cfg, "xc": xc, "xk": xk, "yz": yz, "mask": mask}
            info = {}
            with phase("iter_cache"):
                self._iter_cache = dist_iter_posterior_cache(mesh, spec, cfg, params, xc, xk, yz, mask, info=info)
                if self._device.type == "cuda":
                    torch.cuda.synchronize(self._device)
            self._fit_aux.update(cache_exhausted=np.asarray(info["exhausted"]),
                                 cache_cg_iters=np.asarray(info["iters"]),
                                 cache_rel_res=np.asarray(float(info["rel_res"])),
                                 cache_woodbury_rel=np.asarray(info["woodbury_rel"]))
            return self.MAP

        if coarse_n is not None or n > 16384:
            cn = min(int(coarse_n) if coarse_n else 4096, n)
            rng = np.random.default_rng(seed)
            real = np.flatnonzero(_numpy(self._mask) > 0) if self._mask is not None else np.arange(n)
            idx = self._index(rng.choice(real, size=min(cn, real.size), replace=False))
            xc_c, xk_c, y_c = self._xc[idx], self._xk[idx], self._yz[idx]

            def coarse_runner(u0):
                return coarse_restart_map(spec, xc_c, xk_c, y_c, ls_alpha, ls_beta, u0, maxiter=maxiter, tol=tol)

            with phase("iter_coarse"):
                _, _, aux_c = multi_restart_minimize(None, u0s, runner=coarse_runner)
            pm_iter = int(polish_maxiter) if polish_maxiter else 100
            with phase("iter_polish"):
                u_best, neg_logp, polish_iters, cfg, rung, start_restart, evals = self._polish_ladder(
                    cfg, aux_c, pm_iter, tol, xc, xk, yz, mask, ls_alpha, ls_beta, pn, pk
                )
                u_start = {k: v[start_restart] for k, v in aux_c["all_xs"].items()}
                if not np.isfinite(float(neg_logp)) or int(polish_iters) == 0:
                    warnings.warn(
                        "Full-N polish could not improve on the coarse-stage "
                        "optimum (objective "
                        + ("never evaluated finite" if not np.isfinite(float(neg_logp))
                           else "converged immediately")
                        + "); the fit keeps the "
                        f"subsample ({int(idx.shape[0])}-point) MAP."
                    )
                polish_fallback = not np.isfinite(float(neg_logp))
                if polish_fallback:
                    # The stored value is the coarse-subsample Cholesky
                    # objective, not the full-N iterative one: flagged in
                    # _fit_aux so it is never mistaken for a full-N number.
                    u_best, neg_logp = u_start, aux_c["all_values"].min()
            aux = {
                "all_values": aux_c["all_values"],
                "iters": aux_c["iters"],
                "best_restart": aux_c["best_restart"],
                "polish_iters": polish_iters,
                "polish_fallback": np.asarray(polish_fallback),
                "polish_start_restart": np.asarray(start_restart),
                "polish_rung": np.asarray(rung),
                "polish_exhausted": np.asarray([e for e, _, _ in evals], dtype=bool),
                "polish_cg_iters": np.asarray([it for _, it, _ in evals], dtype=np.int64),
                "polish_woodbury_rel": np.asarray([w for _, _, w in evals], dtype=np.float64),
            }
        else:
            u_best, neg_logp, aux = fit_iter_map(
                spec, cfg, xc, xk, yz, ls_alpha, ls_beta, pn, pk, u0s, mask=mask, maxiter=maxiter, tol=tol,
            )
        params = constrain(u_best)
        self._set_fit(params, neg_logp, aux)
        self._cache = None  # never build the (N, N) Cholesky state
        self._iter_state = {"cfg": cfg, "xc": xc, "xk": xk, "yz": yz, "mask": mask}
        info = {}
        with phase("iter_cache"):
            self._iter_cache = iter_posterior_cache(spec, cfg, params, xc, xk, yz, mask=mask, info=info)
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
        self._fit_aux.update(cache_exhausted=np.asarray(info["exhausted"]), cache_cg_iters=np.asarray(info["iters"]),
                             cache_rel_res=np.asarray(float(info["rel_res"])),
                             cache_woodbury_rel=np.asarray(info["woodbury_rel"]))
        return self.MAP

    def _polish_ladder(self, cfg, aux_c, pm_iter, tol, xc, xk, yz, mask, ls_alpha, ls_beta, pn, pk):
        """The staged fit's full-N polish and its recovery ladder (see
        :meth:`_find_MAP_iterative`). Returns ``(u, f, iterations, cfg,
        rung, start restart, [(exhausted, CG iterations, Woodbury residual)]
        of the rung's evaluations)``; ``f`` is +inf and ``rung`` −1 when no
        rung started finite."""
        fs_c = np.asarray(aux_c["all_values"], dtype=np.float64)
        order = np.argsort(np.where(np.isfinite(fs_c), fs_c, np.inf))
        ladder = [(int(order[k]), cfg) for k in range(min(3, order.size))]
        c = cfg
        while c.maxiter < POLISH_CG_CAP:
            # max(·, 1): maxiter ≤ 0 would pin min(0·4, cap) at 0 and loop forever
            nxt = min(max(c.maxiter, 1) * 4, POLISH_CG_CAP)
            if nxt <= c.maxiter:
                break
            c = dataclasses.replace(c, maxiter=nxt)
            ladder.append((int(order[0]), c))
        cfg_p, start_restart, rung_taken = cfg, int(order[0]), -1

        for rung, (ridx, cfg_try) in enumerate(ladder):
            evals = []

            def objective(u, cfg_try=cfg_try, evals=evals):
                info = {}
                f = iter_map_neg_logp(
                    self._spec, u, xc, xk, yz, ls_alpha, ls_beta, pn, pk, cfg_try, mask=mask, info=info
                )
                evals.append((bool(info["exhausted"]), int(info["iters"]), info["woodbury_rel"]))
                return f

            u_try = {k: v[ridx] for k, v in aux_c["all_xs"].items()}
            u_best, neg_logp, polish_iters = lbfgs_backtracking_minimize(objective, u_try, maxiter=pm_iter, ftol=tol)
            if np.isfinite(float(neg_logp)):
                cfg_p, start_restart, rung_taken = cfg_try, ridx, rung
                break
            nxt = ladder[rung + 1] if rung + 1 < len(ladder) else None
            which = "the coarse-stage optimum" if ridx == int(order[0]) else f"coarse candidate {ridx}"
            if nxt is None:
                pass
            elif nxt[1].maxiter != cfg_try.maxiter:
                warnings.warn(
                    f"Iterative MLL did not converge at {which} "
                    f"within maxiter={cfg_try.maxiter} CG "
                    f"iterations; escalating the cap to "
                    f"{nxt[1].maxiter} for the full-N polish."
                )
            else:
                warnings.warn(
                    f"Iterative MLL did not converge at {which} "
                    f"within maxiter={cfg_try.maxiter} CG "
                    "iterations; trying the next coarse candidate."
                )
        return u_best, neg_logp, polish_iters, cfg_p, rung_taken, start_restart, evals

    def _ensure_dense_cache(self):
        """Dense tall-basis factorization, built lazily when a path needs
        full covariances the Kronecker cache lacks.

        As in the reference, a sparse or iterative model builds it too, from
        the unpadded rows, on the first call that needs it (``predict_grad``,
        ``propose(q=)``, the dense draws): the (N, N) factor the fit avoided
        (ROADMAP.md queue 3 records this as a matched fault).

        For a Kronecker model its α is the Kronecker solve's, laid out on the
        tall rows; L is the dense factor. A named divergence: the reference
        solves α through the dense factor too. At f64 the two agree; at f32
        the dense factor of bench.py's model (5,120 locations × 2 outputs)
        loses digits the Kronecker solve keeps, and every mean read from
        this cache (draws, gradients, acquisitions) would carry them
        (``chip_smoke.py`` phase 16 prints both).
        """
        if self._structure == "Independent":
            # There is no joint tall model: the sub-spec has no output
            # coregion and each output owns its own params/cache.
            raise RuntimeError(
                "Independent structure has no joint dense cache; "
                "use the per-output models (self._ind_params/_ind_caches)."
            )
        if self._cache is None:
            with torch.no_grad():
                cache = posterior_cache(self._spec, self._params, self._xc, self._xk, self._yz, mask=self._mask,
                                        noise_mult=self._noise_mult)
                if self._structure == "Kronecker":
                    cache = cache._replace(alpha=self._kron_alpha_tall())
                self._cache = cache
        return self._cache

    def _kron_alpha_tall(self):
        """The Kronecker cache's α (D, N) on the tall rows: row r of output
        index o at location r mod N takes α[o, r mod N]."""
        alpha = self._kron_cache.alpha
        n_loc = alpha.shape[1]
        rows = torch.arange(self._xk.shape[0], device=alpha.device)
        return alpha[self._xk[:, self.categorical_dims.index(self.out_col)], rows % n_loc]

    ################################################################################
    # Prediction
    ################################################################################

    def predict(self, points_array, with_noise=True, additive_level="total", mesh=None, **kwargs):
        """Predict (mean, variance) at a tall dims-ordered points array.

        ``additive_level`` selects one component of an additive model:
        ``'total'`` (default) is the full sum, ``'global'`` the shared
        continuous term, and a categorical dim name that dim's component.
        Component posteriors solve against the total-kernel factorization and
        carry no observation noise. Returns numpy arrays in the model dtype.

        ``mesh`` (a ``DeviceMesh``) shards the points over its 'data' axis,
        every rank predicting its block against the replicated cache
        (``parallel.sharded_predict_diag``); every rank returns all of them.
        A heteroskedastic-input model adds σ² times the noise GP's shape
        exp(l(x) − l̄) at the points, with or without a mesh.
        """
        assert self._params is not None, "Model must be fit before predicting"
        with torch.no_grad():
            if additive_level != "total":
                suffix = self._parse_additive_level(additive_level)
                xc, xk = self._split_X(np.asarray(points_array))
                mean, var = predict_diag_level(
                    self._spec, self._params, self._ensure_dense_cache(), xc, xk, level=suffix
                )
                return _numpy(mean), _numpy(var)

            xc, xk = self._split_X(np.asarray(points_array))
            het = self.heteroskedastic_inputs and self._noise_params is not None
            if mesh is not None:
                mean, var = self._predict_mesh(mesh, xc, xk, with_noise, het)
            elif self.sparse:
                mean, var = fitc_predict(
                    self._spec, self._params, self._xc, self._xk, self._xu_c, self._xu_k, self._yz, xc, xk,
                    with_noise=with_noise, mask=self._mask,
                )
            elif self._structure == "Kronecker":
                mean, var = self._kron_predict_tall(xc, xk, with_noise)
            elif self._structure == "Independent":
                mean, var = self._independent_predict_tall(xc, xk, with_noise)
            elif self._iter_cache is not None:
                # The fit ran through the iterative engine: no (N, N) array
                # (mean from the cached PCG solve, variance from the LOVE
                # factor, conservative).
                st = self._iter_state
                mean, var = iter_predict_diag(
                    self._spec, st["cfg"], self._params, self._iter_cache, st["xc"], st["xk"], xc, xk,
                    with_noise=with_noise, mask=st["mask"],
                )
            else:
                mean, var = predict_diag_chunked(
                    self._spec, self._params, self._ensure_dense_cache(), xc, xk,
                    with_noise=with_noise and not het, chunk=8192,
                )
                if het and with_noise:
                    var = self._het_noise(var, xc, xk)
        return _numpy(mean), _numpy(var)

    def _predict_mesh(self, mesh, xc, xk, with_noise, het):
        """``predict(mesh=)``: the points sharded over the mesh's 'data' axis."""
        from ..parallel import sharded_predict_diag

        if self.sparse:
            raise NotImplementedError(
                "Mesh-sharded prediction supports the dense path (sparse FITC "
                "prediction is cheap enough for one device)."
            )
        if self._structure == "Independent":
            xk_np = _numpy(xk)
            means, vars_ = [], []
            for j, i, end in self._ind_blocks(xk_np):
                m, v = sharded_predict_diag(
                    mesh, self._spec, self._ind_params[j], self._ind_caches[j], xc[i:end],
                    self._reduced_xk(xk_np[i:end]), with_noise=with_noise,
                )
                means.append(m)
                vars_.append(v)
            return torch.cat(means), torch.cat(vars_)
        mean, var = sharded_predict_diag(mesh, self._spec, self._params, self._ensure_dense_cache(), xc, xk,
                                         with_noise=with_noise and not het)
        if het and with_noise:
            var = self._het_noise(var, xc, xk)
        return mean, var

    def _ind_blocks(self, xk_np):
        """(output index, start, end) of each contiguous run of one output's
        rows in a tall points array (the Independent structure's blocks)."""
        out_colv = xk_np[:, self._ind_out_idx]
        i = 0
        while i < len(out_colv):
            j = int(out_colv[i])
            end = i
            while end < len(out_colv) and out_colv[end] == j:
                end += 1
            yield j, i, end
            i = end

    def _independent_predict_tall(self, xc, xk, with_noise):
        """Per-output prediction for tall (per-output block) point arrays."""
        xk_np = _numpy(xk)
        means, vars_ = [], []
        for j, i, end in self._ind_blocks(xk_np):
            m, v = predict_diag(
                self._spec, self._ind_params[j], self._ind_caches[j],
                xc[i:end], self._reduced_xk(xk_np[i:end]), with_noise=with_noise,
            )
            means.append(m)
            vars_.append(v)
        return torch.cat(means), torch.cat(vars_)

    def _kron_predict_tall(self, xc, xk, with_noise):
        """Kronecker prediction for tall (per-output block) point arrays.

        Prediction points arrive as identical location blocks tiled per
        requested output (built by ``_prepare_points_for_prediction``); each
        block is answered from the shared-location Kronecker posterior.
        """
        xk_col = _numpy(xk[:, 0])
        # Contiguous output blocks in order of appearance
        block_ids = []
        starts = [0]
        for i in range(1, len(xk_col)):
            if xk_col[i] != xk_col[i - 1]:
                starts.append(i)
        starts.append(len(xk_col))
        m = starts[1] - starts[0]
        xc_np = _numpy(xc)
        for s0, s1 in zip(starts[:-1], starts[1:]):
            assert s1 - s0 == m, "Kronecker prediction requires equal per-output blocks"
            assert np.array_equal(xc_np[s0:s1], xc_np[:m]), (
                "Kronecker prediction requires identical locations per output"
            )
            block_ids.append(int(xk_col[s0]))

        mean_all, var_all = kron_predict_diag(
            self._spec, self._params, self._kron_cache, xc[:m], with_noise=with_noise
        )  # (D, m)
        mean = torch.cat([mean_all[j] for j in block_ids])
        var = torch.cat([var_all[j] for j in block_ids])
        return mean, var

    def output_correlation(self, param_coords) -> np.ndarray:
        """Correlation between outputs from the learned output coregion."""
        W = self._params.get(f"W_{self.out_col}")
        κ = self._params.get(f"κ_{self.out_col}")
        if W is None:
            return np.eye(len(param_coords))
        cor = _numpy(output_correlation(W, κ))
        sorted_coords = self._cat_maps[self.out_col]
        idx = np.searchsorted(sorted_coords, np.asarray(param_coords, dtype=float))
        return cor[np.ix_(idx, idx)]

    def _parse_additive_level(self, additive_level):
        """Validate an ``additive_level`` request; return the term suffix or
        None for 'total'. Shared by predict/draw paths."""
        if additive_level == "total":
            return None
        if not self.additive:
            raise ValueError(
                "additive_level is only meaningful for additive models "
                "(fit with additive=True)."
            )
        if self.sparse or self._structure in ("Kronecker", "Independent"):
            raise NotImplementedError(
                "Sublevel prediction is implemented for the dense additive "
                "model (the structure additive models actually build)."
            )
        suffix = "total" if additive_level == "global" else additive_level
        valid = {"global"} | {t.suffix for t in self._spec.terms if t.suffix != "total"}
        if suffix not in {t.suffix for t in self._spec.terms}:
            raise ValueError(
                f"additive_level {additive_level!r} not among this model's "
                f"components {sorted(valid)}"
            )
        return suffix

    def cross_validate(self, *args, **kwargs):
        """:meth:`Regressor.cross_validate`, with its train and test models on
        this model's device and dtype.

        The method (a copy of the reference's) builds them as
        ``self.__class__(dataset, outputs=..., seed=...)``, which would put
        them on the CUDA card whatever this model's device; here it runs on a
        shallow copy of the model whose class passes ``device=`` and
        ``dtype=`` on.
        """
        cls = type(self)
        proxy = copy.copy(self)
        proxy.__class__ = type(cls.__name__, (cls,), {
            "__init__": functools.partialmethod(cls.__init__, dtype=self._dtype, device=self._device),
        })
        return super(GP, proxy).cross_validate(*args, **kwargs)

    ################################################################################
    # Full-Bayes sampling and posterior draws
    ################################################################################

    def sample(
        self,
        draws=500,
        tune=500,
        chains=None,
        seed=None,
        n_leapfrog=32,
        target_accept=None,
        sampler="chees",
        *,
        stream=None,
        **kwargs,
    ):
        """Sample the hyperparameter posterior on the model's device.

        ``sampler`` picks the kernel (``ops/hmc.py``):

        * ``'chees'`` (default) — ChEES-HMC: the trajectory length is learned
          during warmup, the step size by dual averaging, the diagonal mass
          by Welford; ``n_leapfrog`` is ignored and chains default to 16;
        * ``'hmc'`` — fixed-trajectory adaptive HMC (``n_leapfrog`` steps);
          chains default to 2.

        The chains advance in lockstep on the chain-batched exact objective
        (``mll.map_neg_logp_chains``), from the MAP when the model is fitted
        and from the prior moments when it is only built. Draws come from a
        ``torch.Generator`` seeded with ``seed``; ``stream=`` takes any
        object with :class:`~gumbi_tpu_torch.utils.torch_utils.TorchStream`'s
        interface instead (the samplers' hook).

        Returns (and stores as :attr:`trace`) a dict of natural-space arrays
        with leading (chains, draws) axes, plus ``_stats`` with acceptance
        (and for ChEES, adapted step-size/trajectory) diagnostics.
        """
        if sampler not in ("chees", "hmc"):
            raise ValueError(f"sampler must be 'chees' or 'hmc', got {sampler!r}")
        if chains is None:
            chains = 16 if sampler == "chees" else 2

        assert self._spec is not None, "Call build_model first"
        if self._structure == "Independent":
            raise NotImplementedError(
                "Full-Bayes sampling is not implemented for the Independent "
                "structure (the reference's ModelListGP backend is MAP-only, "
                "ref gumbi/regression/botorch/GP.py); use Hadamard for HMC "
                "over a joint multi-output model."
            )
        seed = self.seed if seed is None else seed
        ls_alpha = self._tensor(self._ls_alpha)
        ls_beta = self._tensor(self._ls_beta)

        def logp(uparams):
            # A heteroskedastic-input model's hyperparameter posterior is
            # conditional on the fitted noise shape (the noise GP stays at its MAP).
            return -map_neg_logp_chains(
                self._spec, uparams, self._xc, self._xk, self._yz, ls_alpha, ls_beta, mask=self._mask,
                noise_mult=self._noise_mult,
            )

        if self._params is not None:
            q0 = unconstrain(self._params)
        else:
            u0s = initial_params(
                self._spec, self._ls_alpha, self._ls_beta, 1, seed, dtype=self._dtype, device=self._device
            )
            q0 = {k: v[0] for k, v in u0s.items()}

        generator = torch.Generator(device=self._device).manual_seed(seed)
        common = dict(draws=draws, tune=tune, chains=chains, stream=stream, chain_batched=True)
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

    def _store_sample_var(self, var_name, increment_var, value):
        """Reference var-name bookkeeping (GP.py:846-858): store draws under
        ``var_name`` in :attr:`sample_vars`, appending '_' on collision when
        ``increment_var`` is True, raising otherwise."""
        if not hasattr(self, "sample_vars") or self.sample_vars is None:
            self.sample_vars = {}
        while var_name in self.sample_vars:
            if not increment_var:
                raise ValueError(
                    f'The variable name "{var_name}" already exists in model.'
                )
            var_name = var_name + "_"
        self.sample_vars[var_name] = value
        return var_name

    def draw_point_samples(
        self, points, n_samples=1, output=None, with_noise=False, seed=None, source=None,
        additive_level="total", var_name="posterior_samples", increment_var=True, *, stream=None,
    ):
        """Joint posterior draws at supplied points, returned as a parray.

        ``source=None`` uses the MAP hyperparameters; passing the dict
        returned by :meth:`sample` integrates over the hyperparameter
        posterior (one function draw per subsampled hyperparameter draw).

        Multiple outputs draw JOINTLY: the tall prediction stack carries the
        output coordinate, so the coregion (ICM) covariance correlates the
        outputs within each draw. For the ``Independent`` structure, outputs
        are uncorrelated by construction and are drawn from their per-output
        models. ``additive_level`` draws from one component's conditional of
        an additive model (``'total'``, ``'global'`` or a categorical dim
        name). ``var_name``/``increment_var`` mirror the reference's sample
        bookkeeping: draws are stored in ``self.sample_vars[var_name]``,
        appending ``'_'`` on collision when ``increment_var`` (raising
        otherwise).

        The standard-normal blocks come from a ``torch.Generator`` seeded
        with ``seed``, walked as the reference walks its key (one block for
        the MAP, ``fold_in(i)`` per output or per hyperparameter draw);
        ``stream=`` takes any object with ``TorchStream``'s interface
        instead. The trace is subsampled by ``np.random.default_rng(seed)``,
        as in the reference.
        A sparse model draws jointly from its FITC posterior
        (``fitc_draw_samples``), at the MAP or per trace draw alike.
        Returns a parray with one layer per output, shape (n_samples, n_points).
        """
        level = self._parse_additive_level(additive_level)
        output = self._parse_prediction_output(output)
        points_array, _, _ = self._prepare_points_for_prediction(points, output=output)
        xc, xk = self._split_X(np.asarray(points_array))
        seed = self.seed if seed is None else seed
        if stream is None:
            stream = TorchStream(torch.Generator(device=self._device).manual_seed(seed), self._dtype, self._device)
        d_out = len(output)
        n_pts = xc.shape[0] // d_out

        def eps(s, n_rows, n_s=n_samples):
            return s.normal((n_s, n_rows)).to(dtype=self._dtype, device=self._device)

        def fitc_draws(p, s, n_s):
            return fitc_draw_samples(
                self._spec, p, self._xc, self._xk, self._xu_c, self._xu_k, self._yz, xc, xk,
                n_samples=n_s, with_noise=with_noise, mask=self._mask, eps=eps(s, xc.shape[0], n_s),
            )

        with torch.no_grad():
            if source is None or source is self.MAP:
                if self.sparse:
                    out = _numpy(fitc_draws(self._params, stream, n_samples)).reshape(n_samples, d_out, n_pts)
                elif self._structure == "Independent":
                    xk_np = _numpy(xk)
                    blocks = []
                    for i, name in enumerate(output):
                        j = self._ind_output_index(name)
                        sl = slice(i * n_pts, (i + 1) * n_pts)
                        s = draw_samples(
                            self._spec, self._ind_params[j], self._ind_caches[j], xc[sl],
                            self._reduced_xk(xk_np[sl]), n_samples=n_samples, with_noise=with_noise,
                            eps=eps(stream.fold_in(i), n_pts),
                        )
                        blocks.append(_numpy(s))
                    out = np.stack(blocks, axis=1)  # (n_samples, d_out, n_pts)
                else:
                    samples = draw_samples(
                        self._spec, self._params, self._ensure_dense_cache(), xc, xk, n_samples=n_samples,
                        with_noise=with_noise, level=level, eps=eps(stream, xc.shape[0]),
                    )
                    out = _numpy(samples).reshape(n_samples, d_out, n_pts)
            else:
                # Hyperparameter-posterior-integrated draws: subsample the trace
                trace = {k: v for k, v in source.items() if not k.startswith("_")}
                chains, ndraws = next(iter(trace.values())).shape[:2]
                flat = {k: np.asarray(v).reshape(chains * ndraws, *np.shape(v)[2:]) for k, v in trace.items()}
                rng = np.random.default_rng(seed)
                idxs = rng.choice(chains * ndraws, n_samples, replace=n_samples > chains * ndraws)
                rows = []
                for i, idx in enumerate(idxs):
                    p = {k: self._tensor(np.array(v[idx])) for k, v in flat.items()}
                    if self.sparse:
                        rows.append(_numpy(fitc_draws(p, stream.fold_in(i), 1))[0])
                        continue
                    # conditioned on the fitted noise shape, as sample()'s trace was
                    cache_i = posterior_cache(self._spec, p, self._xc, self._xk, self._yz, mask=self._mask,
                                              noise_mult=self._noise_mult)
                    s = draw_samples(
                        self._spec, p, cache_i, xc, xk, n_samples=1, with_noise=with_noise, level=level,
                        eps=eps(stream.fold_in(i), xc.shape[0], 1),
                    )
                    rows.append(_numpy(s)[0])
                out = np.stack(rows).reshape(n_samples, d_out, n_pts)

        self.predictions = self.parray(
            **{name: out[:, i] for i, name in enumerate(output)}, stdzd=True
        )
        self.predictions_X = points
        self._store_sample_var(var_name, increment_var, self.predictions)
        return self.predictions

    def draw_grid_samples(self, n_samples=1, output=None, categorical_levels=None, **kwargs):
        """Joint posterior draws over the prepared grid, reshaped to the grid."""
        if self.grid_points is None:
            raise ValueError("Grid must first be specified with `prepare_grid`")
        points = self.grid_points
        if self.categorical_dims:
            points = self.append_categorical_points(points, categorical_levels=categorical_levels)
        samples = self.draw_point_samples(points, n_samples=n_samples, output=output, **kwargs)
        self.predictions = samples.reshape(-1, *self.grid_parray.shape)
        self.predictions_X = self.predictions_X.reshape(self.grid_parray.shape)
        return self.predictions

    ################################################################################
    # Bayesian optimization (the reference's engine acquisitions; reference
    # gumbi/regression/botorch/GP.py:652-780 used BoTorch qLogNEI/qLogNEHVI)
    ################################################################################

    def propose(
        self,
        target=None,
        acquisition="EI",
        *,
        q=None,
        bounds=None,
        maximize=True,
        num_restarts=10,
        raw_samples=512,
        mc_samples=256,
        seed=None,
        ref_point=None,
        sequential=False,
        max_baseline=64,
        **optim_kwargs,
    ):
        """Propose new experiments.

        Two modes, matching the two reference surfaces:

        * ``propose(target, acquisition='EI'|'PD')`` — grid-based proposal
          toward a target value over existing predictions (Regressor parity).
        * ``propose(q=...)`` — batch Bayesian optimization on the model's
          device: smoothed qLogNEI (single output), exact-sweep qLogNEHVI
          (two outputs), or decomposition-free QMC-box qLogNEHVI (three or
          more outputs) over Sobol QMC samples (:meth:`q_acquisition`),
          maximized by multi-restart L-BFGS from the best of ``raw_samples``
          Sobol q-batches. ``sequential=True`` proposes one point at a time,
          each joining the baseline. Returns (candidates parray,
          acquisition value).
        """
        if q is None:
            return super().propose(target, acquisition=acquisition)

        assert self._params is not None, "Model must be fit before proposing"
        seed = self.seed if seed is None else seed
        acq_kw = dict(bounds=bounds, maximize=maximize, mc_samples=mc_samples, seed=seed, ref_point=ref_point,
                      max_baseline=max_baseline)

        def propose_one(q_now, extra_base):
            a = self.q_acquisition(q_now, extra_base=extra_base, **acq_kw)
            if a["nei_args"] is not None:
                raw = sobol_uniform(raw_samples * q_now, a["lo"].shape[0], seed=seed)
                X_raw = self._tensor(raw.reshape(raw_samples, q_now, -1)) * (a["hi"] - a["lo"]) + a["lo"]
                return optimize_qlog_nei(
                    self._spec, self._params, self._ensure_dense_cache(), *a["nei_args"], X_raw, a["lo"], a["hi"],
                    num_restarts=num_restarts, maximize=maximize, **optim_kwargs,
                )
            return optimize_acqf(
                a["acq"], (a["lo"], a["hi"]), q=q_now, num_restarts=num_restarts, raw_samples=raw_samples,
                seed=seed, dtype=self._dtype, **optim_kwargs,
            )

        if sequential and q > 1:
            cands = []
            for _ in range(q):
                c, val = propose_one(1, self._tensor(np.vstack(cands)) if cands else None)
                cands.append(_numpy(c))
            candidates = np.vstack(cands)
        else:
            c, val = propose_one(q, None)
            candidates = _numpy(c)

        cand_parray = self.parray(
            **{dim: candidates[:, i] for i, dim in enumerate(self.continuous_dims)},
            stdzd=True,
        )
        return cand_parray, float(val)

    def q_acquisition(self, q, bounds=None, maximize=True, mc_samples=256, seed=None, ref_point=None,
                      max_baseline=64, extra_base=None):
        """The acquisition that ``propose(q=...)`` maximizes, at this model's
        MAP and dtype.

        Returns a dict: ``acq`` maps z-space candidate blocks (..., q, d) to
        values (...); ``lo``, ``hi`` bound the search box in z-space (the
        training locations' box unless ``bounds`` is given); ``nei_args``
        holds ``optimize_qlog_nei``'s model-side arguments for one output,
        else None. The baseline is up to ``max_baseline`` training locations
        subsampled by ``np.random.default_rng(seed)`` (repeated up to that
        size when fewer), then ``extra_base`` rows; the base samples are the
        Sobol normals of ``seed``; the reference point defaults to each
        output's training minimum − 1e-3.
        """
        # The Independent structure has no joint cache: its acquisitions
        # sample the block-diagonal model-list posterior. A Kronecker model
        # samples through its Kronecker cache (a named divergence: the
        # reference factors the dense tall cache, which at f32 loses digits
        # the whitened systems keep; the same numbers at f64).
        out_j = self.categorical_dims.index(self.out_col) if self.out_col in self.categorical_dims else None
        joint_params = joint_cache = None
        if self._structure == "Independent":
            sample_fn = make_indep_sample_fn(self._spec, self._ind_params, self._ind_caches, self._ind_out_idx)
        elif self._structure == "Kronecker":
            sample_fn = make_kron_sample_fn(self._spec, self._params, self._kron_cache, out_j)
        else:
            sample_fn = None
            joint_params, joint_cache = self._params, self._ensure_dense_cache()
        seed = self.seed if seed is None else seed
        d_out = len(self.outputs)

        # Bounds in z-space over the continuous dims. Bucketed fits pad
        # self._xc with zero rows — excluded here, or the search box would
        # stretch to the z-space origin regardless of the data's range.
        xc_train = _numpy(self._xc)
        n_real_rows = int(_numpy(self._mask).sum()) if self._mask is not None else xc_train.shape[0]
        if bounds is None:
            lo, hi = xc_train[:n_real_rows].min(0), xc_train[:n_real_rows].max(0)
        else:
            from ..arrays import ParameterArray

            if isinstance(bounds, ParameterArray):
                b = np.atleast_2d(bounds.z.values())
                lo, hi = b[:, 0], b[:, 1]
            else:
                b = np.asarray(bounds, dtype=float)
                if b.shape[0] == 2:  # (2, d)
                    lo, hi = b[0], b[1]
                else:  # (d, 2)
                    lo, hi = b[:, 0], b[:, 1]

        # Baseline: subsample training locations (pruning analog), from the
        # real rows only (bucket padding never enters the baseline), padded
        # to ``max_baseline`` rows by repetition as in the reference.
        if d_out == 1:
            base_locs = xc_train[:n_real_rows]
        elif self._structure == "Independent":
            # Independent data can be ragged across outputs: output 0's own block
            base_locs = _numpy(self._ind_data[0][0])
        else:
            # Tall layout is output-major: the first rows are output 0's locations
            base_locs = xc_train[: n_real_rows // d_out]
        if base_locs.shape[0] > max_baseline:
            idx = np.random.default_rng(seed).choice(base_locs.shape[0], max_baseline, replace=False)
            base_locs = base_locs[idx]
        elif base_locs.shape[0] < max_baseline:
            reps = -(-max_baseline // base_locs.shape[0])
            base_locs = np.tile(base_locs, (reps, 1))[:max_baseline]
        xc_b = self._tensor(base_locs)
        if extra_base is not None:
            xc_b = torch.cat([xc_b, extra_base])
        nb = xc_b.shape[0]

        n_cat = self._xk.shape[1]

        def cat_cols(n_rows, out_idx):
            cols = np.zeros((n_rows, n_cat), dtype=np.int64)
            if out_j is not None:
                cols[:, out_j] = out_idx
            return self._index(cols)

        box = dict(lo=self._tensor(lo), hi=self._tensor(hi))
        if d_out == 1:
            base_samples = self._tensor(sobol_normal(mc_samples, q + nb, seed=seed))
            nei_args = (cat_cols(q, 0), xc_b, cat_cols(nb, 0), base_samples)

            def acq(Xc):
                return qlog_nei(self._spec, joint_params, joint_cache, Xc, *nei_args, maximize=maximize)

            return dict(acq=acq, nei_args=nei_args, **box)

        # Each location contributes one row per output (output-major)
        base_samples = self._tensor(sobol_normal(mc_samples, d_out * (q + nb), seed=seed))
        xk_bD = torch.cat([cat_cols(nb, j) for j in range(d_out)])
        xc_bD = torch.cat([xc_b] * d_out)
        xk_cD = torch.cat([cat_cols(q, j) for j in range(d_out)])
        if ref_point is None:
            if self._structure == "Independent":
                halves = [_numpy(y_j) for (_, _, y_j) in self._ind_data]
            else:
                halves = np.split(_numpy(self._yz)[:n_real_rows], d_out)
            ref_point = [(h.min() - 1e-3) if maximize else -(h.max() + 1e-3) for h in halves]
        rp = self._tensor(list(ref_point))

        if d_out == 2:
            # Exact sweep-line hypervolume (differentiable a.e.)
            def acq(Xc):
                return qlog_nehvi_2d(
                    self._spec, joint_params, joint_cache, torch.cat([Xc] * d_out, dim=-2), xk_cD, xc_bD, xk_bD,
                    base_samples, rp, maximize=maximize, sample_fn=sample_fn,
                )
        else:
            # D ≥ 3: decomposition-free QMC box integration
            u_box = self._tensor(sobol_uniform(512, d_out, seed=seed + 1))

            def acq(Xc):
                return qlog_nehvi_mc(
                    self._spec, joint_params, joint_cache, torch.cat([Xc] * d_out, dim=-2), xk_cD, xc_bD, xk_bD,
                    base_samples, rp, u_box, d_out, maximize=maximize, sample_fn=sample_fn,
                )

        return dict(acq=acq, nei_args=None, **box)

    ################################################################################
    # Gradients of the posterior mean, by torch autograd
    ################################################################################

    def _mean_fn_single(self, xc_single, xk_single):
        """Posterior mean at one point (the reference's per-point function;
        :meth:`predict_grad` batches it)."""
        return self._mean_fn(self._params, self._ensure_dense_cache(), xc_single[None, :], xk_single[None, :])[0]

    def _mean_fn(self, params, cache, xc, xk):
        """Posterior means K(x*, X)·α at the rows of ``xc``, ``xk``."""
        return gram(self._spec, params, xc, xk, cache.xc, cache.xk) @ cache.alpha

    def _mean_grad(self, params, cache, xc, xk):
        """∂mean/∂x at every row: each row's mean depends on that row's input
        only, so one backward of the summed means gives every row's gradient
        (the reference's ``vmap(grad(...))``)."""
        with torch.enable_grad():
            x = xc.detach().clone().requires_grad_(True)
            (g,) = torch.autograd.grad(self._mean_fn(params, cache, x, xk).sum(), x)
        return _numpy(g)

    def predict_grad(self, points_array, additive_level="total"):
        """Raw z-space posterior-mean gradient at a tall dims-ordered array.

        The lowest of the three gradient entry points: takes the
        standardized tall points array directly (continuous columns first,
        categorical coords after, as produced by
        ``_prepare_points_for_prediction``) and returns the (M, d_cont)
        array of ∂mean_z/∂x_z with no unit rescaling.
        ``predict_points_grad`` / ``predict_grid_grad`` build on this and add
        natural-unit partials and norms.
        """
        if additive_level != "total":
            raise NotImplementedError("Prediction for additive sublevels is not yet supported.")
        assert self._params is not None, "Model must be fit before predicting"
        xc, xk = self._split_X(np.asarray(points_array))
        if self._structure == "Independent":
            # Per-output mean gradients against each sub-model's own cache
            # (tall points arrive in contiguous per-output blocks).
            xk_np = _numpy(xk)
            return np.concatenate([
                self._mean_grad(self._ind_params[j], self._ind_caches[j], xc[i:end], self._reduced_xk(xk_np[i:end]))
                for j, i, end in self._ind_blocks(xk_np)
            ])
        return self._mean_grad(self._params, self._ensure_dense_cache(), xc, xk)  # (M, d_cont) in z-space

    def predict_points_grad(self, points, output=None, norm=True):
        """∂(posterior mean)/∂(continuous inputs) at points, in natural units.

        Standardized-space gradients are rescaled per pair by σ_y/σ_x. With
        ``norm=True``, returns per-output gradient norms ``|∇|<output>``.
        """
        output = self._parse_prediction_output(output)
        points_array, tall_points, param_coords = self._prepare_points_for_prediction(
            points, output=output
        )
        dydX = self.predict_grad(np.asarray(points_array))  # (M_total, d_cont) z-space

        partials = {}
        for name in output:
            coord = self.categorical_coords[self.out_col][name] if param_coords else None
            σy = np.sqrt(self.stdzr.get(name, {"σ2": 1})["σ2"])
            if param_coords:
                idx = (tall_points[self.out_col].values() == coord).squeeze()
                rows = dydX[idx]
            else:
                rows = dydX
            for i, x_var in enumerate(self.continuous_dims):
                σx = np.sqrt(self.stdzr.get(x_var, {"σ2": 1})["σ2"])
                partials[f"δ[{name}]/δ[{x_var}]"] = rows[:, i] * σy / σx

        grad = self.parray(**partials)
        if norm:
            grad = self._get_pgrad_norm(grad)
        return grad

    def predict_grid_grad(self, output=None, categorical_levels=None, norm=True):
        """Gradient predictions over the prepared grid."""
        points = self.grid_points
        if self.categorical_dims:
            points = self.append_categorical_points(points, categorical_levels=categorical_levels)
        grad = self.predict_points_grad(points, output=output, norm=norm)
        return grad.reshape(self.grid_parray.shape)

    @staticmethod
    def _get_pgrad_norm(pgrad):
        from ..arrays import ParameterArray
        from ..utils import group_by

        def get_output_name(partial_name):
            return partial_name.split("/")[0].removeprefix("δ[").removesuffix("]")

        by_output = group_by(pgrad.names, get_output_name)
        norms = {}
        for out_name, partial_names in by_output.items():
            partials = np.stack([pgrad[p].values() for p in partial_names], axis=-1)
            norms[f"|∇|{out_name}"] = np.sqrt(np.sum(np.square(partials), axis=-1))
        return ParameterArray(**norms, stdzr=pgrad.stdzr)

    ################################################################################
    # Checkpointing: the reference's npz format (spec, MAP, data arrays, config)
    ################################################################################

    def _jsonable_model_specs(self):
        """model_specs with parray entries (period, ls_bounds) converted to
        z-space dicts so save() round-trips them instead of stringifying.

        ``json.dumps(..., default=str)`` would silently turn a period parray
        into a string, and a later ``cross_validate`` on the loaded model
        (which replays ``build_model(**model_specs)``) would crash on it.
        """
        ms = dict(self.model_specs)
        for key in ("period", "ls_bounds"):
            pa = ms.get(key)
            if pa is not None and hasattr(pa, "names"):
                ms[key] = {
                    "__parray_z__": {
                        name: np.asarray(pa[name].z.values(), dtype=float).tolist()
                        for name in pa.names
                    }
                }
        return ms

    @staticmethod
    def _restore_model_specs(ms, stdzr):
        """Inverse of :meth:`_jsonable_model_specs` (z dicts → parrays)."""
        from ..arrays import ParameterArray

        for key in ("period", "ls_bounds"):
            v = ms.get(key)
            if isinstance(v, dict) and "__parray_z__" in v:
                layers = {
                    name: np.asarray(vals, dtype=float)
                    for name, vals in v["__parray_z__"].items()
                }
                ms[key] = ParameterArray(stdzr=stdzr, stdzd=True, **layers)
        return ms

    def save(self, path):
        """Serialize the fitted model (spec, MAP, data arrays, config) to .npz,
        in the format ``gumbi_tpu``'s ``GP.save`` writes and its ``load`` reads."""
        assert self._spec is not None, "Nothing to save; build/fit a model first"
        meta = {
            "spec": asdict(self._spec),
            "outputs": self.outputs,
            "out_col": self.out_col,
            "seed": self.seed,
            "continuous_dims": self.continuous_dims,
            "linear_dims": self.linear_dims,
            "categorical_dims": self.categorical_dims,
            "continuous_levels": self.continuous_levels,
            "categorical_levels": self.categorical_levels,
            "continuous_coords": self.continuous_coords,
            "categorical_coords": self.categorical_coords,
            "filter_dims": self.filter_dims,
            "additive": self.additive,
            "model_specs": self._jsonable_model_specs(),
            "sparse": self.sparse,
            "structure": self._structure,
            "stdzr_moments": {k: v for k, v in self.stdzr.items()},
            "stdzr_log_vars": self.stdzr.log_vars,
            "stdzr_logit_vars": self.stdzr.logit_vars,
        }
        arrays = {
            "xc": _numpy(self._xc),
            "xk": _numpy(self._xk).astype(np.int32),
            "y": _numpy(self._yz),
            "ls_alpha": np.asarray(self._ls_alpha),
            "ls_beta": np.asarray(self._ls_beta),
        }
        if self._params is not None:
            arrays.update({f"param::{k}": _numpy(v) for k, v in self._params.items()})
        if self.sparse:
            arrays["xu_c"] = _numpy(self._xu_c)
            arrays["xu_k"] = _numpy(self._xu_k).astype(np.int32)
        if self._structure == "Kronecker":
            arrays["xc_locs"] = _numpy(self._xc_locs)
            arrays["Y"] = _numpy(self._Y)
        if self._structure == "Independent" and getattr(self, "_ind_params", None):
            # Per-output sub-model parameters (self._params is only output 0)
            for j, p in enumerate(self._ind_params):
                arrays.update({f"ind{j}::{k}": _numpy(v) for k, v in p.items()})
        if self._mask is not None:
            arrays["mask"] = _numpy(self._mask)
        if self._noise_params is not None:
            # Heteroskedastic-input state: the noise GP's MAP, its standardized
            # log-residual targets (the noise cache is rebuilt from them) and z's stats.
            arrays.update({f"noise::{k}": _numpy(v) for k, v in self._noise_params.items()})
            arrays["noise_zt"] = _numpy(self._noise_zt)
            arrays["noise_mult"] = _numpy(self._noise_mult)
            arrays["noise_stats"] = np.asarray(self._noise_stats, dtype=np.float64)
        np.savez(path, __meta__=json.dumps(meta, default=str), **arrays)

    @classmethod
    def load(cls, path, dataset, device=None):
        """Rebuild a fitted GP from :meth:`save` output (either package's)
        plus its data, on ``device`` (the CUDA card unless the caller asks
        for the CPU) in that device's model dtype. A classifier's save
        (``likelihood='bernoulli'``) loads as a latent model, with its mask
        and inducing points and no Gaussian cache, as the reference's does;
        ``GPC.load`` gives a :class:`~gumbi_tpu_torch.models.GPC`."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
        spec = spec_from_reference(meta["spec"])

        gp = cls(dataset, outputs=meta["outputs"], seed=meta["seed"], device=device)
        for attr in (
            "continuous_dims",
            "linear_dims",
            "categorical_dims",
            "continuous_levels",
            "categorical_levels",
            "continuous_coords",
            "categorical_coords",
            "filter_dims",
            "additive",
            "model_specs",
            "sparse",
        ):
            setattr(gp, attr, meta[attr])
        gp.model_specs = cls._restore_model_specs(gp.model_specs, gp.stdzr)
        gp._spec = spec
        gp.model = spec
        if spec.likelihood == "bernoulli":
            gp.latent = True
            gp._cache = None

        gp._xc = gp._tensor(arrays["xc"])
        gp._xk = gp._index(arrays["xk"])
        gp._yz = gp._tensor(arrays["y"])
        gp._ls_alpha = arrays["ls_alpha"]
        gp._ls_beta = arrays["ls_beta"]
        gp._build_cat_maps()
        if gp.sparse:
            gp._xu_c = gp._tensor(arrays["xu_c"])
            gp._xu_k = gp._index(arrays["xu_k"])

        def params_with(prefix):
            return {
                k[len(prefix):]: gp._index(v) if v.dtype.kind == "i" else gp._tensor(v)
                for k, v in arrays.items()
                if k.startswith(prefix)
            }

        params = params_with("param::")
        gp._structure = meta.get("structure", "Hadamard")
        if "mask" in arrays:
            gp._mask = gp._tensor(arrays["mask"])
        if gp._structure == "Kronecker":
            gp._xc_locs = gp._tensor(arrays["xc_locs"])
            gp._Y = gp._tensor(arrays["Y"])
        if gp._structure == "Independent":
            gp._split_ind_data()
            gp._ind_params = []
            gp._ind_caches = []
            j = 0
            while any(k.startswith(f"ind{j}::") for k in arrays):
                p_j = params_with(f"ind{j}::")
                xc_j, xk_j, y_j = gp._ind_data[j]
                gp._ind_params.append(p_j)
                with torch.no_grad():
                    gp._ind_caches.append(posterior_cache(gp._spec, p_j, xc_j, xk_j, y_j))
                j += 1
            if gp._ind_params:
                gp._params = gp._ind_params[0]
                gp.MAP = {out: _numpy(gp._ind_params[gp._ind_output_index(out)]) for out in gp.outputs}
            return gp
        gp.heteroskedastic_inputs = bool((gp.model_specs or {}).get("heteroskedastic_inputs", False))
        if "noise_zt" in arrays:
            gp._noise_params = params_with("noise::")
            gp._noise_zt = gp._tensor(arrays["noise_zt"])
            gp._noise_mult = gp._tensor(arrays["noise_mult"])
            gp._noise_stats = tuple(float(v) for v in arrays["noise_stats"])
            with torch.no_grad():
                gp._noise_cache = posterior_cache(gp._noise_spec(), gp._noise_params, gp._xc, gp._xk, gp._noise_zt)

        if params:
            gp._params = params
            gp.MAP = _numpy(params)
            with torch.no_grad():
                if spec.likelihood == "bernoulli":
                    pass  # the classifier predicts through the Laplace predictor
                elif gp._structure == "Kronecker":
                    gp._kron_cache = kron_cache(gp._spec, gp._params, gp._xc_locs, gp._Y)
                elif not gp.sparse:
                    # an iterative fit's save loads without its iterative
                    # state and predicts through the dense cache, as the
                    # reference's does
                    gp._cache = posterior_cache(
                        gp._spec, gp._params, gp._xc, gp._xk, gp._yz, mask=gp._mask, noise_mult=gp._noise_mult
                    )
        return gp
