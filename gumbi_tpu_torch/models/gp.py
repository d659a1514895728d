"""GP surface learning on the port's engine — the user-facing model.

Port of ``gumbi_tpu/models/gp.py``'s ``GP``, its fit-to-predict path:
:meth:`GP.fit` parses dimensions (:meth:`specify_model`), builds the
covariance structure (:meth:`build_model`) and learns MAP hyperparameters
(:meth:`find_MAP`) by multi-restart L-BFGS through the port's
``fit_gp_map`` / ``fit_kron_map``; ``prepare_grid``/``predict_grid`` then
answer from the posterior caches, and :meth:`save`/:meth:`load` use the
reference's npz format, so a file saved by either package loads in the
other. The model family, the structure choice (Hadamard, Kronecker
auto-selection, Independent), the priors and the starting points are the
reference's.

The model's tensors live on one device: the CUDA card unless the caller
passes ``device="cpu"``, where CUDA must exist or the constructor raises. The
dtype follows the device (f32 on CUDA, f64 on the CPU) unless ``dtype=`` is
given. On CUDA at f32 every ExpQuad Gram goes through the hand ``rbf_gram``
kernel (``ops/kernels.py``).

Paths of later steps raise ``NotImplementedError`` naming the step of the
roadmap's first queue that ports them: ``sparse=True`` (12),
``heteroskedastic_inputs=True`` (15), ``engine='iterative'`` (16),
``mesh=``/``shard_data=`` (19), ``sample`` (17), ``draw_*`` and
``predict_grad*`` (9b), ``propose(q=...)`` (11).
"""

from __future__ import annotations

import json
from dataclasses import asdict

import numpy as np
import torch

from ..convert import spec_from_reference
from ..ops import (
    CoregTerm,
    GPSpec,
    GPTerm,
    constrain,
    fit_gp_map,
    fit_kron_map,
    initial_params,
    kron_cache,
    kron_predict_diag,
    ls_prior_params,
    output_correlation,
    posterior_cache,
    predict_diag,
    predict_diag_chunked,
    predict_diag_level,
)
from ..ops.kernels import CONTINUOUS_KERNELS
from ..utils import assert_in
from ..utils.torch_utils import default_model_dtype, resolve_device
from .base import Regressor

__all__ = ["GP"]


def _later(what, step):
    return NotImplementedError(f"{what} is not ported yet: it comes with step {step} of ROADMAP.md's queue 1")


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
        from ..utils.profiling import phase

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
        """
        if sparse:
            raise _later("sparse=True (the FITC model)", 12)
        if heteroskedastic_inputs:
            raise _later("heteroskedastic_inputs=True", 15)
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
        ``fit_kron_map`` and keep a ``kron_cache``.
        """
        assert self._spec is not None, "Call build_model first"
        seed = self.seed if seed is None else seed

        if engine not in ("cholesky", "iterative"):
            raise ValueError("engine must be 'cholesky' or 'iterative'")
        if engine == "iterative":
            raise _later("engine='iterative'", 16)
        if mesh is not None or shard_data:
            raise _later("mesh= and shard_data=", 19)

        u0s = initial_params(
            self._spec, self._ls_alpha, self._ls_beta, n_restarts=n_restarts, seed=seed,
            dtype=self._dtype, device=self._device,
        )
        ls_alpha = self._tensor(self._ls_alpha)
        ls_beta = self._tensor(self._ls_beta)

        if self._structure == "Independent":
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
        self._params = params
        self._neg_logp = float(neg_logp)
        self._fit_aux = _numpy(aux)
        self.MAP = _numpy(params)
        if self._structure != "Kronecker":
            with torch.no_grad():
                self._cache = posterior_cache(
                    self._spec, self._params, self._xc, self._xk, self._yz, mask=self._mask
                )
        return self.MAP

    def _ensure_dense_cache(self):
        """Dense tall-basis factorization, built lazily when a path needs
        full covariances the Kronecker cache lacks."""
        if self._structure == "Independent":
            # There is no joint tall model: the sub-spec has no output
            # coregion and each output owns its own params/cache.
            raise RuntimeError(
                "Independent structure has no joint dense cache; "
                "use the per-output models (self._ind_params/_ind_caches)."
            )
        if self._cache is None:
            with torch.no_grad():
                self._cache = posterior_cache(
                    self._spec, self._params, self._xc, self._xk, self._yz, mask=self._mask
                )
        return self._cache

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
        """
        assert self._params is not None, "Model must be fit before predicting"
        if mesh is not None:
            raise _later("mesh=", 19)
        with torch.no_grad():
            if additive_level != "total":
                suffix = self._parse_additive_level(additive_level)
                xc, xk = self._split_X(np.asarray(points_array))
                mean, var = predict_diag_level(
                    self._spec, self._params, self._ensure_dense_cache(), xc, xk, level=suffix
                )
                return _numpy(mean), _numpy(var)

            xc, xk = self._split_X(np.asarray(points_array))
            if self._structure == "Kronecker":
                mean, var = self._kron_predict_tall(xc, xk, with_noise)
            elif self._structure == "Independent":
                mean, var = self._independent_predict_tall(xc, xk, with_noise)
            else:
                mean, var = predict_diag_chunked(
                    self._spec, self._params, self._ensure_dense_cache(), xc, xk,
                    with_noise=with_noise, chunk=8192,
                )
        return _numpy(mean), _numpy(var)

    def _independent_predict_tall(self, xc, xk, with_noise):
        """Per-output prediction for tall (per-output block) point arrays."""
        xk_np = _numpy(xk)
        out_colv = xk_np[:, self._ind_out_idx]
        means, vars_ = [], []
        i = 0
        while i < len(out_colv):
            j = int(out_colv[i])
            end = i
            while end < len(out_colv) and out_colv[end] == j:
                end += 1
            m, v = predict_diag(
                self._spec, self._ind_params[j], self._ind_caches[j],
                xc[i:end], self._reduced_xk(xk_np[i:end]), with_noise=with_noise,
            )
            means.append(m)
            vars_.append(v)
            i = end
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

    ################################################################################
    # Later steps
    ################################################################################

    def sample(self, *args, **kwargs):
        """Hyperparameter-posterior sampling (ChEES/HMC): step 17."""
        raise _later("GP.sample", 17)

    def draw_point_samples(self, *args, **kwargs):
        """Joint posterior draws at points: step 9b."""
        raise _later("GP.draw_point_samples", "9b")

    def draw_grid_samples(self, *args, **kwargs):
        """Joint posterior draws over the grid: step 9b."""
        raise _later("GP.draw_grid_samples", "9b")

    def propose(self, target=None, acquisition="EI", *, q=None, **kwargs):
        """Grid-based proposal toward ``target`` (``Regressor.propose``);
        batch Bayesian optimization (``q=...``) comes with step 11."""
        if q is None:
            return super().propose(target, acquisition=acquisition)
        raise _later("GP.propose(q=...)", 11)

    def predict_grad(self, *args, **kwargs):
        """Posterior-mean gradients: step 9b."""
        raise _later("GP.predict_grad", "9b")

    def predict_points_grad(self, *args, **kwargs):
        """Posterior-mean gradients at points: step 9b."""
        raise _later("GP.predict_points_grad", "9b")

    def predict_grid_grad(self, *args, **kwargs):
        """Posterior-mean gradients over the grid: step 9b."""
        raise _later("GP.predict_grid_grad", "9b")

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
        if self._structure == "Kronecker":
            arrays["xc_locs"] = _numpy(self._xc_locs)
            arrays["Y"] = _numpy(self._Y)
        if self._structure == "Independent" and getattr(self, "_ind_params", None):
            # Per-output sub-model parameters (self._params is only output 0)
            for j, p in enumerate(self._ind_params):
                arrays.update({f"ind{j}::{k}": _numpy(v) for k, v in p.items()})
        if self._mask is not None:
            arrays["mask"] = _numpy(self._mask)
        np.savez(path, __meta__=json.dumps(meta, default=str), **arrays)

    @classmethod
    def load(cls, path, dataset, device=None):
        """Rebuild a fitted GP from :meth:`save` output (either package's)
        plus its data, on ``device`` (the CUDA card unless the caller asks
        for the CPU) in that device's model dtype."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
        if meta.get("sparse") or "xu_c" in arrays or "xu_k" in arrays:
            raise _later("loading a sparse (FITC) model", 12)
        if any(k.startswith("noise") for k in arrays):
            raise _later("loading a heteroskedastic-input model", 15)
        spec = spec_from_reference(meta["spec"])
        if spec.likelihood != "gaussian":
            raise _later("loading a classifier (GPC)", 13)

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

        gp._xc = gp._tensor(arrays["xc"])
        gp._xk = gp._index(arrays["xk"])
        gp._yz = gp._tensor(arrays["y"])
        gp._ls_alpha = arrays["ls_alpha"]
        gp._ls_beta = arrays["ls_beta"]
        gp._build_cat_maps()

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

        if params:
            gp._params = params
            gp.MAP = _numpy(params)
            with torch.no_grad():
                if gp._structure == "Kronecker":
                    gp._kron_cache = kron_cache(gp._spec, gp._params, gp._xc_locs, gp._Y)
                else:
                    gp._cache = posterior_cache(
                        gp._spec, gp._params, gp._xc, gp._xk, gp._yz, mask=gp._mask
                    )
        return gp
