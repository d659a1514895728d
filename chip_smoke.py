#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gumbi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--dense-breakdown]

Phases (any failure raises and ends the run with a nonzero exit code):

0. Require CUDA; print the card (nvidia-smi name and power limit), the
   torch/CUDA versions, ``nvcc --version`` and whether ``triton`` imports.
1. Build the hand kernels from ``gumbi_tpu_torch/csrc`` with nvcc (sm_90a),
   one nvcc per source, all at once, and print the build time and ptxas'
   register/spill report of each source. Then hold the shared 3xTF32 tile
   product alone (``csrc/tf32x3.cuh``), through a test entry point of each
   library, against ``matmul_3xtf32_plain`` and an f64 product: the
   Cholesky's 128×128×128 ``mma.sync`` tile, and the symmetric matvec's
   ``wgmma`` warpgroup product both ways round on a ragged 200×150×65 one;
   |product − f64| ≤ 2e-6·(|a|·|b|) and at least 16× better than one TF32
   pass.
2. Hold the ``rbf_gram`` CUDA kernel against its plain torch version at
   the slice's shapes and ragged ones, d ∈ {1, 2, 3}, and at the other
   paths' shapes (the pivoted Cholesky's (1, 50,000) row and a strip of 4,
   ragged strips (1, 23) and (5, 10,001), the surrogate gradient's
   (2,500, 50,000) block, the dense polish's 16,384²), d ∈ {1, 2, 3, 17}
   and a shared lengthscale expanded to d entries: max |ΔK|/η² ≤ 1e-5,
   two calls bit-equal, and (up to 10⁶ entries) the ls/η gradients
   through autograd; the same at the shapes phases 9-11 give it, at BO's
   (phase 12) with the x1/x2 cotangents too, and at the samplers' training
   Grams (512², 2,048²) with x2 the same tensor as x1, at phase 15's grid
   shapes and at phase 16's (10,240² and 20,000² with x2 the same tensor
   as x1, 20,000×10,240, 5,120×132 and 5,120×2,112 with the x1/x2
   cotangents, 10,000×512, 10,000²) and at phase 19's (10,000×2,048 with the x1/x2
   cotangents, 10,000×512, 2,048×128, 128²). Count with torch.profiler that each call runs exactly
   one CUDA kernel. Time kernel and plain in turns at (1, 50,000),
   (2,500, 50,000), 1,024², 5,120², 5,120×10,000 and 16,384²: CUDA events
   over 100 launches, the median of 5 such runs, beside the profiler's
   device time per kernel. Phases 3, 6 and 8 count its launches by output
   shape on each path.
3. Drive the slice that ``bench.py`` times: a 2-output LMC on 5,120 shared
   locations (10,240 points), 8 restarts fitted coarse (640 points, 20
   iterations) → mid (1,024 points, 12) → polish (all points, 20, ftol
   1e-4) through ``fit_kron_map``, then ``kron_cache`` and
   ``kron_predict_diag`` on the 100×100 grid, at f32 on the card, twice
   (a first pass, then a warm pass that is checked and counted). Checks:
   finite outputs of shape (2, 10000), var ≥ 0, the kernel's launch count
   rising in both fit and predict, and the f32 (kernel) objective at the
   fitted point within 0.005 nats/point of the f64 (plain path) one.
4. Hold the fused Gram-matvec kernels (general and symmetric) against
   their plain version and an f64 evaluation: six kernel kinds, d ∈ {1,
   2, 3}, ragged shapes, r ∈ {1, 5, 8, 9, 16, 17, 32, 33, 64, 65, 72, 73,
   100, 288, 289, 513} (every column-group and chunk width the kernels are
   built for), the general kernel at one x2 segment and at several, on
   ragged n and m (37×23, 2500×300, 300×2500, 1000×4001, 45,100×1000) and
   at d = 40 (x1 read through L1), the symmetric band grid at nb = 4 and 7
   whole blocks, at nb = 5 and 6 with a short last block (odd, and even
   with the wrap band) and at nb = 12, where a band walker takes several
   bands, the general kernel on the same inputs and the two kernels within
   1e-5 of each other; |kernel − f64| ≤ 1e-5·(|K|·|V|) and no worse than
   twice the f32 plain version. The symmetric kernel against the plain
   version at N = 50,000 for r = 64 and 1 (LOVE, the cache's PCG), timed,
   with the general kernel checked and timed beside it; two runs
   bit-equal: sym at N = 50,000, r = 65, general at 10,000×50,000, r = 513
   and at 50,000², r = 65. Time both kernels at the large-N engine's
   shapes, the general one also at r = 1 (``iter_predict_mean``) and,
   kernel only, at 100,000², r = 65, past the symmetric kernel's gate.
5. Anchor the iterative engine at N = 16,384: its objective against the
   dense Cholesky one (≤ 5e-4 relative) and LOVE variances at rank 512
   against the exact posterior diagonal (median ≤ 5%).
6. The large-N iterative path of ``bench_iterative50k.py`` at N = 50,000
   (f32, block 2,500, rank 512, 64 probes): the rank-512 pivoted Cholesky
   timed with CUDA events at the bench point, then, with every launch count
   at 0, the main path: one value+grad at the bench point
   ls = (0.30, 0.35), one at ls = (0.10, 0.12) where the f32
   factorization is not exhausted and PCG + SLQ run, and one pass of the
   staged campaign (32 coarse Cholesky restarts on 2,048 rows → L-BFGS
   polish on the iterative objective → LOVE cache → 100×100 grid). Every
   polish evaluation's regime and CG iterations are logged. Then, counted
   apart, one value+grad at ls = (0.10, 0.12) with
   ``IterConfig(sym_matvec=False)``: every PCG sweep through the general
   kernel, beside the symmetric route's value, iterations and wall-clock.
   Checks: both values finite and trusted, PCG run at the second point,
   grid mean/var finite of shape (10000,), var ≥ 0,
   the f32 objective at the fit within 0.005 nats/point of an f64 one on
   the plain path, each kernel launched on that path, and the
   ``sym_matvec=False`` run finite, with no symmetric launch and at least
   one general launch per PCG iteration.
7. Hold the blocked Cholesky kernel against its plain version, the library
   factorization and an f64 factor: SPD inputs X·Xᵀ/64 + 2I from a numpy
   seed at D ∈ {1, 2, 3}, N ∈ {256, 512, 768, 5120} and (1, 1024),
   (1, 2048), (1, 16384), max |L_kernel − L_plain| ≤ 5e-5·max(|L|, 1) and
   the error against f64 at most twice the f32 library's; the Gram matrices
   of the Kronecker path (2, 5120, 5120) and of the dense path's coarse
   stage (1, 1024, 1024) and polish (1, 16384, 16384) against f64 by the
   same rule; a non-PD batch entry gives NaN there and right factors
   elsewhere; two runs at (2, 5120, 5120) bit-equal. Time plain, kernel,
   library, kernel at (1, 1024, 1024), (1, 2048, 2048), (2, 5120, 5120)
   and (1, 16384, 16384).
8. The exact dense path of ``bench_dense50k.py``'s single-accelerator
   configuration (N = 16,384, one ExpQuad ARD term over 2 dims, 8 restarts,
   coarse 1,024 rows × 32 iterations, polish 12 iterations at full N), then
   ``posterior_cache``, ``predict_diag_chunked`` on the 100×100 grid and
   ``draw_samples`` of 4 draws at 1,024 grid points, at f32: once with the
   library factorization at the ``linalg.safe_cholesky`` seam, once with
   ``hopper_chol.seam_cholesky`` there (the counted pass). Checks: both
   fitted objectives within 0.005 nats/point of each other and of an f64
   evaluation, ``rbf_gram`` and the Cholesky kernel launched, variances
   finite and ≥ 0. Times one value+grad at the fitted point with each
   factor, and the Kronecker objective's value and value+grad at D = 2,
   N = 5,120 with each factor. With ``--dense-breakdown`` it also times the
   steps of that value+grad one by one (Gram, factor, solves, A⁻¹, Gram
   backward); the default run leaves that out.
8b. One f64 value+grad of ``map_neg_logp`` and of ``map_neg_logp_blocked``
   at N = 16,384: values and gradients agree to rtol 1e-9; prints each
   one's time and peak memory.
9. The sparse regressor on ``bench_fitc50k.py``'s problem (N = 50,000,
   one ExpQuad ARD term over 2 dims, 512 k-means inducing points from
   8,192 rows, the lengthscale prior from a 512-row subsample, all drawn
   from ``default_rng(0)`` in the bench's order): 8 restarts of L-BFGS on
   ``fitc_neg_logp`` (maxiter 60), then ``fitc_predict`` on the bench's
   200-point line, at f32 after one untimed value+grad. Prints k-means,
   fit and predict seconds, iterations and evaluations per restart,
   ``rbf_gram`` launches by shape and peak memory; at the fit, one
   value+grad's and one value's seconds and, from torch.profiler, the
   device's busy time in the value+grad and its largest kernels. Checks: the f32
   objective at the fit within 0.005 nats/point of f64 (plain path),
   finite line mean/var, the kernel launched; prints the line's RMSE
   against the noise-free surface.
10. The sparse classifier on the same rows and inducing points, labels
   1[y > 0]: ``fit_fitc_laplace_map`` (8 restarts, maxiter 60), then
   ``fitc_laplace_predict`` and 4 draws of ``fitc_laplace_draw_latent``
   on the line. Prints and checks as phase 9, with the line's accuracy
   against the noise-free sign.
11. The dense classifier at N = 2,048 (the same generator, seed 1):
   ``fit_laplace_map`` (8 restarts, maxiter 60), ``laplace_predict`` and
   4 draws of ``laplace_draw_latent``; the analytic (autograd
   ``Function``) gradient at the first start against central differences
   of the f32 value (|Δ| ≤ 1e-3·max(|FD|, 1)) and against the f64
   gradient (≤ 1e-3 of its largest entry); one timed value+grad at
   N = 16,384 with its peak memory.
12. BO at ``GP.propose``'s defaults (q-batches of 512 Sobol raw starts
   swept in batched chunks, top 10, L-BFGS maxiter 100, 256 Sobol normal
   base samples, 64 training rows as the baseline): (a) ``optimize_qlog_nei``
   at q = 4 after ``fit_gp_map`` (8 restarts) on ``make_dense_problem`` at
   N = 512; (b) ``qlog_nehvi_2d`` through ``optimize_acqf`` at q = 2 on a
   2-output Hadamard LMC over the same locations; (c) ``qlog_nehvi_mc``
   (512 Sobol box points) through ``optimize_acqf`` at q = 1 over three
   Independent fits at N = 256 (``make_indep_sample_fn``). Prints the raw
   sweep's, the whole optimize's and the restarts' seconds, L-BFGS
   iterations per restart and ``rbf_gram`` launches by shape. Checks:
   candidates in the box, a finite value no lower than the best raw one,
   the f32 value at the candidate within the run's limit (``ACQ_F64_TOL``,
   log units) of the f64 plain path's, the kernel launched on each run.
13. ``GP.sample``'s ops path on 12(a)'s problem from its MAP fit:
   ``chees_sample`` (16 chains, target 0.75, at most 256 leapfrog steps)
   and ``hmc_sample`` (2 chains, 32 steps, target 0.8), ChEES at tune/draws
   100/100 and HMC at 50/50 (phase 16 runs ChEES at 250 + 250 through
   ``GP.sample``),
   both on the chain-batched objective
   ``map_neg_logp_chains``: one objective call for all chains a leapfrog
   step (counted). Prints seconds per iteration, the adapted step size and
   trajectory length, leapfrog steps per iteration and one batched
   16-chain value+grad with the library and the hand factor at the seam.
   Checks: finite draws, ChEES acceptance in [0.5, 0.95], HMC's at least
   0.5 (the chains move), each lengthscale's
   posterior median from ChEES and HMC within rtol 0.35, the f32 objective
   at the ChEES median within 0.005 nats/point of f64, the kernel launched.
14. ``GPC.sample(latent=True)``'s ops path on phase 11's problem from its
   Laplace fit: ``ess_gpc_sample`` (2 chains, tune 100, draws 100, 4 slice
   sweeps, target 0.3; phase 19 (b) runs it at 500 + 500 through ``GPC``), then ``latent_conditional_proba`` over 64
   subsampled draws on the line. Prints seconds, trials per slice step,
   host syncs per iteration and peak memory. Checks: finite draws and
   probabilities, MH acceptance in [0.1, 0.6], no slice step at the
   200-trial cap after tuning, line accuracy no more than 0.05 below phase
   11's, the kernel launched.
15. The model layer: ``GP.fit`` → ``prepare_grid`` → ``predict_grid`` →
   ``save``/``load`` at f32 through ``tools/array_table.py``'s ``GP`` (the
   card has no pandas, so a dict of numpy columns stands in for the
   ``DataSet``). (a) bench.py's table, ``make_problem``'s 5,120 locations
   and two outputs as float64 columns x1, x2, y1, y2 (10,240 tall rows),
   fit at ``find_MAP``'s defaults (8 restarts, maxiter 500, tol 1e-8),
   Kronecker auto-selected, and predicted on the 100×100 grid; (b) the same
   generator at 1,024 locations fit as ``multitask_kernel='Hadamard'``,
   ``'Independent'`` and auto (Kronecker), each predicted on the grid; (c)
   (a)'s model saved to a temporary npz, loaded and predicted again.
   Prints ``GP.fit``'s phase seconds, objective evaluations, L-BFGS
   iterations per restart, ``rbf_gram`` launches by shape and peak memory.
   Checks: (a) Kronecker, the f32 objective at the fit within 0.005
   nats/point of f64, the standardized grid within 1e-2 of the f64
   posterior at the f32 MAP, ``mvuparray.cor`` a correlation matrix, the
   grid mean within RMSE 0.05 of the noise-free f1, f2 inside the data's
   box (natural units, so the Standardizer's round trip is held too); (b)
   finite grids, the Hadamard grid mean within 1e-2 of the Kronecker one;
   (c) the loaded model's grid bit-equal to (a)'s; the kernel launched.
16. The rest of ``GP``'s dense surface through the same array table, with
   every launch count at 0 before its calls. (a) On phase 15 (a)'s fitted
   model (no second fit): ``draw_grid_samples`` of 4 joint draws of both
   outputs over the 100×100 grid (a 20,000-point joint covariance, the
   ``with_noise=False`` default), ``predict_grid_grad`` with and without
   norms, ``propose(q=2)`` at its defaults (qLogNEHVI-2d). (b) On phase
   12a's N = 512 problem as a one-output table: ``GP.fit`` at
   ``find_MAP``'s defaults, ``propose(q=4)`` (qLogNEI) at its defaults,
   ``GP.sample()`` (ChEES, 16 chains, 250 + 250), ``GP.sample(sampler=
   'hmc')`` at phase 13's 50 + 50, and 16 ``draw_point_samples`` from
   the ChEES trace on the 100×100 grid. Prints each call's seconds and
   peak GiB and ``rbf_gram`` launches by shape. Checks, against an f64
   twin of each model at the same MAP (the plain path): (a) finite draws
   within √floor·max|eps| + 1e-2 (standardized) of f64 draws on the same
   normal block and floor, each gradient layer within 1e-2/ℓ_min (the grid
   rule over the shortest lengthscale, in the layer's units) of f64, the
   f64 gradient within 1e-4 of central differences of ``predict`` at 5 grid
   points and the f32 one within 1e-2/ℓ_min, the candidates in the data's
   box and the f32 acquisition there within 1e-3 log units of f64; (b) the
   same proposal checks, ChEES acceptance in [0.5, 0.95], HMC's at least
   0.5, the ChEES lengthscale medians (in the data's units) within rtol
   0.35 of phase 13's, finite trace draws of shape (16, 10,000); the
   kernel launched.
17. bench_iterative50k.py's campaign through ``GP`` (f32, N = 50,000, the
   table x1, x2, y of ``make_iter_data``): ``fit`` with
   ``engine='iterative'`` at the bench's ``IterConfig`` (block 2,500, rank
   512, 64 probes, tol 1e-2, CG cap 256, LOVE rank 512), 32 coarse restarts
   on 2,048 rows (maxiter 40), the full-N polish (maxiter 40) on its
   recovery ladder and the LOVE cache, then ``predict_grid`` on the 100×100
   grid (``with_noise=False``). Prints ``GP.fit``'s phase seconds, the
   coarse iterations, the polish's iterations, evaluations and their
   regimes, the ladder rung, ``polish_fallback``, the launches of all three
   kernels (``rbf_gram`` by shape), peak GiB and the MAP beside phase 6's.
   Checks: no dense cache, no fallback, a finite grid, the symmetric kernel
   launched in the fit and the general one in the predict, the shape
   counts summing to the total; then, with the fit's buffers freed, the
   exact f64 dense Cholesky at full N (a 20 GB Gram and its factor): the
   iterative objective within 5e-4 relative of it, the GP's means at 512
   grid points within 1e-2 (standardized) of the exact posterior and its
   LOVE variances within a median 5%.
18. bench_fitc50k.py's problem through ``GP(sparse=True)`` (f32,
   N = 50,000): ``build_model(sparse=True, n_u=512)`` (k-means over all
   50,000 rows, 25 iterations, as the reference's ``select_inducing``),
   ``find_MAP(n_restarts=8, maxiter=60)``, then the 200-point line through
   ``predict_points`` and 4 ``draw_point_samples``. Prints the phase
   seconds (k-means inside ``build_model``), iterations and evaluations
   per restart, peak GiB and ``rbf_gram`` launches by shape. Checks: the
   f32 objective within 0.005 nats/point of f64 at the same MAP and
   inducing points, the shape counts summing to the total, a finite line
   mean and variance (RMSE against the noise-free surface printed), finite
   draws.
19. The classifier through the model layer, ``tools/array_table.py``'s
   ``GPC`` at f32 (the card has no pandas), every launch count at 0 before
   each run: (a) phase 11's generator (seed 1) at N = 2,048, labels
   1[y > 0], ``GPC.fit`` at ``find_MAP``'s defaults (8 restarts, maxiter
   300, tol 1e-6), ``predict_grid_proba`` on the 100×100 grid, the
   200-point line's ``predict_proba``, ``draw_grid_samples(4)`` and save →
   load → ``predict_grid_proba``; (b) ``sample(latent=True)`` on (a)'s
   model at the defaults (2 chains, 500 + 500, 4 sweeps) and
   ``predict_proba(source=trace)`` over 64 draws on the line; (c) a dense
   classifier at N = 512 (the same generator) fit at the defaults, then
   ``sample()`` (ChEES, 16 chains, cut to 100 + 100) on the chain-batched
   Laplace evidence and ``sample(sampler='hmc')`` (2 chains, 32 steps, cut
   to 10 + 10);
   (d) phase 10's 50,000 rows and labels, ``GPC.fit(sparse=True,
   n_u=512)`` (k-means inside ``build_model``) with ``n_restarts=8,
   maxiter=60``, the line's ``predict_proba``, 4 ``draw_point_samples`` and
   save → load; (e) a sparse build at 2,048 rows, n_u = 128, and ChEES
   (16 chains, chain by chain, cut to 12 + 12). Prints each run's seconds, peak
   GiB and ``rbf_gram`` launches by shape; (a)'s latent grid mean against
   the f64 twin summed in f32 and with the same f32 Ks summed in f64, and
   the draws' floor beside the latent spread; (c)'s s/iteration, leapfrog
   steps per iteration and one 16-chain value+grad with its device-busy
   share. Checks: (a) the f32 objective within 0.005 nats/point of f64, the
   grid's probabilities within 1e-2 of an f64 twin at the same MAP, line
   accuracy at most 0.05 below phase 11's, finite draws, the loaded grid
   bit-equal; (b) phase 14's checks, accuracy against (a)'s; (c) finite
   draws, ChEES acceptance in [0.5, 0.95], one objective call for all
   chains a leapfrog step (counted), the f32 objective at the ChEES median
   within 0.005 nats/point of f64; (d) as (a) against phase 10's accuracy,
   the loaded line bit-equal; (e) finite draws, acceptance in [0.5, 0.95];
   ``rbf_gram`` launched on every run.
20. Heteroskedastic inputs through ``ArrayTableGP`` at f32: tests/test_het.py's
   generator (sin(1.2x), noise sd 0.05 left of 0, 0.5 right of it) at
   N = 2,048, ``fit(heteroskedastic_inputs=True)`` at ``find_MAP``'s
   defaults (8 restarts, maxiter 500, tol 1e-8, ``het_iters=2``: five fits),
   and a homoskedastic fit of the same table. Prints each fit's seconds and
   ``rbf_gram`` launches by shape. Checks: noisy − latent variance at
   x = +1.5 over x = −1.5 above 5; held-out NLPD on 2,048 rows of seed 1
   at least 0.1 below the homoskedastic fit's; the f32 objective at the MAP
   (with its ``noise_mult``) within 0.005 nats/point of f64; ``predict``
   with and without noise on a 200-point line within 1e-2 (standardized) of
   an f64 twin holding the same MAP and noise GP; save → load bit-equal.
21. ``mesh=`` on ``torch.distributed``: ``parallel.make_mesh()`` (one NCCL
   rank on the card, a (1, 1) ('restart', 'data') mesh), every launch count
   at 0 before each run: (a) phase 15 (a)'s Kronecker model refit with
   ``find_MAP(mesh=)`` at the defaults; (b) bench_dense50k's problem
   (N = 16,384, one ExpQuad ARD term over 2 dims) as a one-output table,
   ``find_MAP(mesh=, shard_data=True)`` at 2 restarts × 8 iterations, then
   ``predict(mesh=)`` on the 100×100 grid; (c) phase 17's 50,000-row table,
   ``find_MAP(engine='iterative', mesh=)`` at 2 restarts × 8 iterations
   (unstaged, as the reference's mesh path), then ``predict_grid``; (d)
   phase 19 (a)'s classifier and (e) phase 18's ``GP(sparse=True)`` and
   phase 19 (e)'s sparse classifier, each refit with ``find_MAP(mesh=)``
   at its phase's settings. Checks: (a), (d), (e) the MAP and value of the
   single-device fit (rtol 1e-6); (b) ``sharded_gram_mll`` at the fit within
   0.005 nats/point of f64 and within 1e-5 relative of the dense ``mll``,
   gradients included, the grid of ``predict(mesh=)`` within 1e-5 relative
   of ``predict()``, no eager cache; (c) the objective at the fit within
   5e-4 relative of the single-device ``iter_map_neg_logp`` at the same
   parameters and probes, grid means within 1e-2 of the exact f64
   posterior (phase 17's anchor), the general fused matvec launched;
   ``rbf_gram`` launched on every run. The process group is destroyed.
22. Print the card, the kernels' JSON line, then ``{"ok": true, ...}`` last.
   Each kernel's ``bound_ms`` is the largest of its bytes over 3.35 TB/s,
   its product flops as three TF32 passes over 495 TFLOP/s, and its other
   operations over the 67 TFLOP/s FP32 peak; ``bound_fp32_ms`` is the
   earlier figure, all operations at the FP32 peak. No kernel's time may
   read under its bound.

Exits nonzero, printing no result, where CUDA is unavailable.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import gumbi_tpu_torch.ops.linalg as linalg  # noqa: E402
from gumbi_tpu_torch.ops import (  # noqa: E402
    BlockedChol,
    CoregTerm,
    FusedMatvec,
    FusedMatvecSym,
    GPSpec,
    GPTerm,
    IterConfig,
    RbfGram,
    cholesky_plain,
    coarse_restart_map,
    constrain,
    chees_sample,
    draw_probes,
    draw_samples,
    ess_gpc_sample,
    fit_fitc_laplace_map,
    fit_gp_map,
    fit_kron_map,
    fit_laplace_map,
    fitc_laplace_draw_latent,
    fitc_laplace_neg_logp,
    fitc_laplace_predict,
    fitc_neg_logp,
    fitc_predict,
    fused_matvec_plain,
    fused_stationary_matvec,
    fused_stationary_matvec_sym,
    gram,
    gram_diag,
    hmc_sample,
    initial_params,
    iter_map_neg_logp,
    iter_map_value_and_grad,
    iter_posterior_cache,
    iter_predict_diag,
    kron_cache,
    kron_neg_logp,
    kron_predict_diag,
    laplace_draw_latent,
    laplace_neg_logp,
    laplace_predict,
    latent_conditional_proba,
    lbfgs_backtracking_minimize,
    map_neg_logp,
    map_neg_logp_blocked,
    map_neg_logp_chains,
    multi_restart_minimize,
    noise_diag,
    optimize_acqf,
    optimize_qlog_nei,
    posterior_cache,
    predict_cov,
    predict_diag_chunked,
    qlog_nehvi_2d,
    qlog_nehvi_mc,
    qlog_nei,
    rbf_gram,
    rbf_gram_plain,
    sobol_normal,
    sobol_uniform,
    unconstrain,
)
from gumbi_tpu_torch.ops.acquisition import make_indep_sample_fn, raw_sweep  # noqa: E402
from gumbi_tpu_torch.ops import _build, hopper_chol, hopper_kernels  # noqa: E402
from gumbi_tpu_torch.models import gpc as gpc_module  # noqa: E402
from gumbi_tpu_torch.ops.hopper_chol import _chol_lib  # noqa: E402
from gumbi_tpu_torch.ops.hopper_kernels import (  # noqa: E402
    SYM_TILE,
    _fused_lib,
    _rbf_lib,
    general_split,
    sym_matvec_fits,
    sym_product_check,
)
from gumbi_tpu_torch.ops.iterative import (  # noqa: E402
    POSTERIOR_TOL,
    _make_matvec,
    _make_precond,
    _row_fn,
    pcg,
    pivoted_cholesky,
)
from gumbi_tpu_torch.ops.kronecker import _continuous_gram, _whitened_eig, _whitened_systems, kron_parts  # noqa: E402
from gumbi_tpu_torch.ops.laplace import _jittered_gram, laplace_mode, laplace_neg_logp_chains  # noqa: E402
from gumbi_tpu_torch.ops.mll import DEFAULT_JITTER, _noisy_gram  # noqa: E402
from gumbi_tpu_torch.ops.posterior import draw_floor  # noqa: E402
from gumbi_tpu_torch.ops.tf32x3 import matmul_3xtf32_plain, tf32_round  # noqa: E402
from gumbi_tpu_torch.tools.array_table import ArrayTable, ArrayTableGP, ArrayTableGPC  # noqa: E402
from gumbi_tpu_torch.tools.fitc_problem import (  # noqa: E402
    FITC_KMEANS_ITERS,
    FITC_KMEANS_ROWS,
    FITC_LINE,
    FITC_N,
    FITC_NU,
    fitc_spec,
    ls_prior_from_subsample,
    make_dense_problem,
    make_fitc_problem,
    problem_at,
)
from gumbi_tpu_torch.tools.iter_problem import exact_f64_posterior, make_iter_data  # noqa: E402
from gumbi_tpu_torch.utils.profiling import timings  # noqa: E402
from gumbi_tpu_torch.utils.torch_utils import TorchStream  # noqa: E402

# bench.py's workload (same seeds, spec and stage sizes)
N_LOCS = 5120
N_RESTARTS = 8
COARSE_N, COARSE_ITERS = 640, 20
MID_N, MID_ITERS, MID_FTOL = 1024, 12, 1e-6
POLISH_ITERS, POLISH_FTOL = 20, 1e-4
GRID = 100

KERNEL_TOL = 1e-5  # max |ΔK|/η²: a few f32 ulps of exp, see csrc/rbf_gram.cu
GRAD_RTOL = 1e-4  # ls/η gradients: f32 sums over up to 5.1e7 positive terms
BASIN_TOL = 0.005  # nats/point, tests/test_bench_quality.py's tolerance
# f32 grid mean/var against the f64 posterior at the same parameters (outputs
# are O(1)); f32 Cholesky solves at this conditioning land near 1e-4.
GRID_TOL = 1e-2


def log(msg):
    print(msg, flush=True)


def phase0_environment():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} | CUDA {torch.version.cuda} | python {sys.version.split()[0]} "
        f"| device {torch.cuda.get_device_name(0)} | count {torch.cuda.device_count()}")
    nvcc = _build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60, check=True)
    log(f"nvcc {nvcc}: " + " / ".join(ver.stdout.strip().splitlines()[-2:]))
    try:
        import triton

        log(f"triton {triton.__version__} imports")
    except ImportError as e:
        log(f"triton does not import: {e}")
    return card


SOURCES = ("rbf_gram", "fused_matvec", "blocked_chol")


def phase1_build():
    # ptxas' resource report of each source (registers, shared memory,
    # spills) compiles beside the libraries, all at once
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = [
        subprocess.Popen(
            [_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-cubin", "-Xptxas", "-v", "-o", str(_build.BUILD_DIR / f"{name}.cubin"),
             str(_build.CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for name in SOURCES
    ]
    _build.build_libraries(SOURCES)
    _rbf_lib()
    _fused_lib()
    _chol_lib()
    build_s = time.perf_counter() - t0
    log(f"[build] {', '.join(s + '.cu' for s in SOURCES)} built (one nvcc each, in parallel, beside the ptxas "
        f"reports) and loaded in {build_s:.2f} s")
    for name, proc in zip(SOURCES, procs):
        out, _ = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"ptxas report of {name}.cu failed:\n{out}")
        for line in out.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"[build] {name} ptxas: {line.strip()}")
    log(f"[build] ptxas reports done at {time.perf_counter() - t0:.2f} s")
    return build_s


PRODUCT_TOL = 2e-6  # |product − f64| in units of (|a|·|b|): three TF32 passes keep ~2^-21 per term


def _product_check(label, c, a, b):
    """Hold ``c``, a kernel's 3xTF32 product a·bᵀ, against f64 and against
    ``matmul_3xtf32_plain``; log the f32 matmul's and one TF32 pass's errors
    beside it. Returns the error against f64 in units of (|a|·|b|)."""
    ref = a.double() @ b.double().T
    scale = (a.double().abs() @ b.double().abs().T).clamp_min(1e-300)
    err = lambda x: float(((x.double() - ref).abs() / scale).max())  # noqa: E731
    plain = matmul_3xtf32_plain(a, b.T)
    e_k, e_p, e_32, e_1 = err(c), err(plain), err(a @ b.T), err(tf32_round(a) @ tf32_round(b).T)
    d_kp = float(((c - plain).double().abs() / scale).max())
    log(f"[product] {label}: max|kernel-f64|/(|a||b|) {e_k:.3e} | 3xTF32 plain {e_p:.3e} | f32 matmul {e_32:.3e} | "
        f"one TF32 pass {e_1:.3e} | kernel vs plain {d_kp:.3e}")
    if not (e_k <= PRODUCT_TOL and d_kp <= PRODUCT_TOL and e_k < e_1 / 16):
        # What the matmul precision state was, and whether the reference
        # products themselves repeat on the same tensors
        log(f"[product] {label} FAILED: torch.backends.cuda.matmul.allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32} | float32 matmul precision "
            f"{torch.get_float32_matmul_precision()}")
        for attempt in (1, 2):
            torch.cuda.synchronize()
            ref2 = a.double() @ b.double().T
            f32 = a @ b.T
            torch.cuda.synchronize()
            log(f"[product] {label} re-run {attempt}: max|f64 - first f64| {float((ref2 - ref).abs().max()):.3e} | "
                f"f32 matmul vs first f64 {err(f32):.3e} | f64 vs a CPU f64 product "
                f"{float((ref2.cpu() - a.double().cpu() @ b.double().cpu().T).abs().max()):.3e}")
    assert e_k <= PRODUCT_TOL and d_kp <= PRODUCT_TOL, f"3xTF32 product {label} is off: {e_k}, {d_kp}"
    assert e_k < e_1 / 16, f"3xTF32 product {label} is no better than one TF32 pass: {e_k} against {e_1}"
    return e_k


def phase1_products():
    """The shared 3xTF32 tile product alone, through each library's test
    entry point: a 128×128×128 tile (the Cholesky's), on standard normal
    operands and on operands spread over six decades, and a ragged
    matvec-shaped one (the symmetric matvec's warpgroup product)."""
    g = torch.Generator().manual_seed(0)
    for label, spread in (("normal", 0.0), ("six decades", 3.5)):
        a, b = (torch.randn(128, 128, generator=g) * torch.exp(spread * torch.randn(128, 128, generator=g))
                for _ in range(2))
        a, b = a.cuda(), b.cuda()
        c = hopper_chol.tile_product_check(a, b)
        torch.cuda.synchronize()
        _product_check(f"blocked_chol 128x128x128 {label}", c, a, b)
    # the symmetric matvec's warpgroup product, both ways round, ragged: 200 rows,
    # 150 inner indices, 65 columns (the 72-column build)
    t, v = torch.randn(200, 150, generator=g).cuda(), torch.randn(150, 65, generator=g).cuda()
    for label, trans in (("T V", False), ("T^T V", True)):
        out = sym_product_check(t.T.contiguous() if trans else t, v, trans=trans)
        torch.cuda.synchronize()
        _product_check(f"fused_matvec {label} 200x150x65", out, t, v.T.contiguous())


def _inputs(n, m, d, seed):
    g = torch.Generator().manual_seed(seed)
    x1 = (torch.rand(n, d, generator=g) * 4 - 2).cuda()
    x2 = (torch.rand(m, d, generator=g) * 4 - 2).cuda()
    ls = (torch.rand(d, generator=g) * 1.2 + 0.3).cuda()
    eta = torch.tensor(1.3).cuda()
    return x1, x2, ls, eta


def _time_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Shapes the three paths give rbf_gram beyond the slice's: the pivoted
# Cholesky's rows (1, 50,000) and a strip of 4, ragged strips, the surrogate
# gradient's (2,500, 50,000) blocks and the dense polish's 16,384².
RBF_PATH_SHAPES = [(1, 50_000), (4, 50_000), (1, 23), (5, 10_001), (2_500, 50_000), (16_384, 16_384)]
# Timed shapes: every path's (iterative row and block; Kronecker/dense coarse
# 1,024²; Kronecker 5,120² and predict 5,120×10,000; dense polish 16,384²).
RBF_TIMED_SHAPES = [(1, 50_000), (2_500, 50_000), (1024, 1024), (5120, 5120), (5120, 10_000), (16_384, 16_384),
                    (512, 50_000), (50_000, 512), (2048, 2048)]
# Shapes the sparse regressor and the classifiers give it (phases 9-11):
# FITC's Kux and Kuu, FITC-Laplace's Kfu, the 200-point line's cross-Grams
# with the inducing points both ways round and with the dense classifier's
# rows, its joint block, the dense classifier's 2,048².
RBF_SPARSE_SHAPES = [(512, 50_000), (50_000, 512), (512, 512), (512, 200), (200, 512), (200, 2048), (200, 200),
                     (2048, 2048)]
# Shapes BO gives it (phase 12), d = 2: each run's restart block (q +
# baseline rows) against the training rows, then the raw sweep's 16 stacked
# blocks. 12a: q = 4 + 64 rows, N = 512; 12b: 2 outputs × (2 + 64),
# N = 1,024; 12c: 1 + 64, N = 256. The restarts differentiate K with respect
# to the candidates, so the x1/x2 cotangents are checked too. (The joint
# prior block K(X, X) is formed in f64, off the kernel.)
RBF_BO_SHAPES = [(68, 512), (1088, 512), (132, 1024), (2112, 1024), (65, 256), (1040, 256)]
# The samplers' training Grams (phases 13-14), x2 the same tensor as x1, as
# every K(X, X) has it: autograd adds both cotangents into one.
RBF_SAME_SHAPES = [(512, 512), (2048, 2048)]
# Shapes the model layer's grid predictions give it (phase 15), d = 2, no
# gradient: the Hadamard grid's two chunks of 8,192 and 3,616 tall rows
# against the 2,048 training rows, and the Independent and Kronecker grids'
# 10,000 points against 1,024 locations both ways round. Its fits' 5,120²,
# 2,048² and 1,024² and (a)'s 5,120×10,000 are checked above.
RBF_MODEL_SHAPES = [(8192, 2048), (3616, 2048), (10_000, 1024), (1024, 10_000)]
# Shapes phase 16 gives it, d = 2: (a) the Kronecker model's dense cache
# (10,240 tall rows, x2 the same tensor as x1), the joint draws' cross and
# test blocks over both outputs' 20,000 grid rows, the gradients' cross block
# with the x1 cotangent, and propose(q=2)'s Kronecker joint posterior: the
# 5,120 locations against a restart block (2 × (2 + 64) rows) and a
# raw-sweep chunk of 16, with the x2 cotangent; (b) the trace draws' grid
# against N = 512 and their 10,000² test block (its fit, propose(q=4) and
# samplers give the 512², 68×512 and 1088×512 checked above). (shape,
# cotangents, x2 is x1)
RBF_SURFACE_SHAPES = [((10_240, 10_240), False, True), ((20_000, 10_240), True, False),
                      ((20_000, 20_000), False, True), ((5120, 132), True, False), ((5120, 2112), True, False),
                      ((10_000, 512), False, False), ((10_000, 10_000), False, True)]
# Shapes the classifier's model layer gives it (phase 19), d = 2: (a)'s grid
# cross-Gram against its 2,048 training rows (held with the x1/x2 cotangents
# too), a 10,000-point grid against 512 inducing points, and (e)'s sparse
# sampler's Kfu and Kuu at 128 inducing points (differentiated by its
# chains). Its training Grams (2,048², the sampler's 512², x2 the same
# tensor as x1), the joint 10,000² of (a)'s draws and the sparse
# (50,000, 512), (512, 512) and line shapes are held above.
# (shape, ls/η gradients, x1/x2 cotangents)
RBF_GPC_SHAPES = [((10_000, 2048), True, True), ((10_000, 512), False, False), ((2048, 128), True, False),
                  ((128, 128), True, False)]
RBF_REPS, RBF_RUNS = 100, 5  # CUDA events over 100 launches; median of 5 such runs
RBF_SHAPES = {}  # path -> Counter of rbf_gram launches by output shape (phases 3, 6, 8)


def _shape_key(n, m):
    return f"{n}x{m}"


@contextlib.contextmanager
def count_rbf_shapes(path):
    """Count the rbf_gram kernel's launches by output shape while the block
    runs, into RBF_SHAPES[path], by wrapping the launcher that RbfGram calls."""
    counts = RBF_SHAPES.setdefault(path, collections.Counter())
    orig = hopper_kernels._launch_rbf_gram

    def counted(x1, x2, ls, eta):
        before = RbfGram.launches
        out = orig(x1, x2, ls, eta)
        counts[_shape_key(x1.shape[0], x2.shape[0])] += RbfGram.launches - before
        return out

    hopper_kernels._launch_rbf_gram = counted
    try:
        yield counts
    finally:
        hopper_kernels._launch_rbf_gram = orig


def _rbf_check(n, m, d, ls_shared=False, grad=True, xgrad=False, same=False):
    """Hold one rbf_gram call against the plain version (max |ΔK|/η²), a
    second call bit-equal to the first, and with ``grad`` the ls/η gradients
    through the kernel's analytic backward against autograd through the
    plain formula. ``ls_shared``: one lengthscale expanded to d entries
    (stride 0), as ``kernels._term_cont`` passes a shared one. ``xgrad``:
    the x1/x2 cotangents too, against the plain gradient's largest entry
    (entries cross zero), as BO's L-BFGS differentiates the candidates.
    ``same``: x2 is x1 (n = m), as a joint block K(X, X) has it, so autograd
    adds both cotangents into one."""
    x1, x2, ls, eta = _inputs(n, m, d, seed=n + 7 * m + d)
    if same:
        x2 = x1
    if d > 3:  # keep K away from 0 over many coordinates
        ls = ls * (d / 2) ** 0.5
    if ls_shared:
        ls = ls[:1]
    ls_k, eta_k = ls.clone().requires_grad_(grad), eta.clone().requires_grad_(grad)
    ls_p, eta_p = ls.clone().requires_grad_(grad), eta.clone().requires_grad_(grad)
    x1_k, x1_p = x1.clone().requires_grad_(xgrad), x1.clone().requires_grad_(xgrad)
    x2_k = x1_k if same else x2.clone().requires_grad_(xgrad)
    x2_p = x1_p if same else x2.clone().requires_grad_(xgrad)
    K = rbf_gram(x1_k, x2_k, ls_k.expand(d) if ls_shared else ls_k, eta_k)
    K2 = rbf_gram(x1_k, x2_k, ls_k.expand(d) if ls_shared else ls_k, eta_k)
    torch.cuda.synchronize()
    Kp = rbf_gram_plain(x1_p, x2_p, ls_p, eta_p)
    torch.cuda.synchronize()
    rel = float((K - Kp).detach().abs().max()) / float(eta) ** 2
    same_calls = bool(torch.equal(K, K2))
    msg = f"[kernel] {n}x{m} d={d}{' shared ls' if ls_shared else ''}{' x2 is x1' if same else ''}: max|dK|/eta2 " \
          f"{rel:.3e} | two calls bit-equal {same_calls}"
    assert rel <= KERNEL_TOL, f"rbf_gram disagrees with plain at {n}x{m} d={d}: {rel}"
    assert same_calls, f"two rbf_gram calls differ at {n}x{m} d={d}"
    if grad:
        # a positive cotangent, drawn on the card
        gbar = torch.rand(n, m, generator=torch.Generator("cuda").manual_seed(d), device="cuda")
        wrt_k, wrt_p = [ls_k, eta_k], [ls_p, eta_p]
        if xgrad:
            wrt_k += [x1_k] if same else [x1_k, x2_k]
            wrt_p += [x1_p] if same else [x1_p, x2_p]
        gk = torch.autograd.grad((K * gbar).sum(), wrt_k)
        gp = torch.autograd.grad((Kp * gbar).sum(), wrt_p)
        torch.cuda.synchronize()
        grel = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max()) for a, b in zip(gk[:2], gp[:2]))
        msg += f" | grad(ls,eta) max rel {grel:.3e}"
        assert grel <= GRAD_RTOL, f"rbf_gram gradient disagrees at {n}x{m} d={d}: {grel}"
        if xgrad:
            xrel = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(gk[2:], gp[2:]))
            msg += f" | grad({'x' if same else 'x1,x2'}) max|diff|/max|plain| {xrel:.3e}"
            assert xrel <= GRAD_RTOL, f"rbf_gram x gradient disagrees at {n}x{m} d={d}: {xrel}"
    log(msg)
    return rel * float(eta) ** 2


def _profile_kernels(fn, calls):
    """Run ``fn`` ``calls`` times under torch.profiler; return every device
    operation it recorded as (name, device µs) pairs."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


PROFILE_TRIES = 3


def _rbf_kernels_per_call(fn, calls, label):
    """The device operations of ``calls`` rbf_gram calls: every one the
    kernel and ``calls`` of them. The profiler sometimes loses records (17
    of 20, and 0 of 20, in runs where every other count held), so a short
    record of the kernel alone is taken again, up to PROFILE_TRIES times;
    any other operation, or more than ``calls``, fails at once."""
    for attempt in range(1, PROFILE_TRIES + 1):
        kernels = _profile_kernels(fn, calls)
        assert len(kernels) <= calls and all("rbf_gram_kernel" in k for k, _ in kernels), \
            f"rbf_gram at {label} did not run exactly one kernel per call: {kernels}"
        if len(kernels) == calls:
            return kernels
        log(f"[kernel] profiler at {label}: {len(kernels)} of {calls} kernels recorded (try {attempt}), again")
    raise AssertionError(f"rbf_gram at {label}: the profiler recorded fewer than {calls} kernels {PROFILE_TRIES} times")


def phase2_kernel_vs_plain():
    shapes = [(640, 640), (1024, 1024), (5120, 5120), (5120, 10000), (37, 23)]
    max_abs = 0.0
    for n, m in shapes:
        for d in (1, 2, 3):
            max_abs = max(max_abs, _rbf_check(n, m, d))
    for n, m in RBF_PATH_SHAPES:
        small = n * m <= 1_000_000
        for d in (1, 2, 3, 17):
            max_abs = max(max_abs, _rbf_check(n, m, d, grad=small))
        max_abs = max(max_abs, _rbf_check(n, m, 2, ls_shared=True, grad=small))
    for n, m in RBF_SPARSE_SHAPES:
        max_abs = max(max_abs, _rbf_check(n, m, 2))
    for n, m in RBF_BO_SHAPES:
        max_abs = max(max_abs, _rbf_check(n, m, 2, xgrad=True))
    for n, m in RBF_SAME_SHAPES:
        max_abs = max(max_abs, _rbf_check(n, m, 2, xgrad=True, same=True))
    for n, m in RBF_MODEL_SHAPES:
        max_abs = max(max_abs, _rbf_check(n, m, 2, grad=False))
    for (n, m), xgrad, same in RBF_SURFACE_SHAPES:
        max_abs = max(max_abs, _rbf_check(n, m, 2, grad=xgrad, xgrad=xgrad, same=same))
    for (n, m), grad, xgrad in RBF_GPC_SHAPES:
        max_abs = max(max_abs, _rbf_check(n, m, 2, grad=grad, xgrad=xgrad))

    # exactly one CUDA kernel per call (torch.profiler on the card), the
    # autograd route and a shared (expanded) lengthscale included
    for n, m, shared in ((1, 50_000, True), (5120, 10_000, False), (37, 23, False)):
        x1, x2, ls, eta = _inputs(n, m, 2, seed=1)
        ls = ls[:1].expand(2) if shared else ls.requires_grad_(True)
        kernels = _rbf_kernels_per_call(lambda: rbf_gram(x1, x2, ls, eta), 10, f"{n}x{m}")
        names = sorted({k for k, _ in kernels})
        log(f"[kernel] profiler, 10 calls at {n}x{m}{' shared ls' if shared else ' ls requiring grad'}: "
            f"{len(kernels)} CUDA kernels {names}")

    times = {}
    with torch.no_grad():
        for n, m in RBF_TIMED_SHAPES:
            x1, x2, ls, eta = _inputs(n, m, 2, seed=0)
            kern = lambda: rbf_gram(x1, x2, ls, eta)  # noqa: E731
            plain = lambda: rbf_gram_plain(x1, x2, ls, eta)  # noqa: E731
            runs_k, runs_p = [], []
            for _ in range(RBF_RUNS):  # plain and kernel in turns
                runs_p.append(_time_ms(plain, RBF_REPS))
                runs_k.append(_time_ms(kern, RBF_REPS))
            k, p = float(np.median(runs_k)), float(np.median(runs_p))
            prof = _rbf_kernels_per_call(kern, 20, f"{n}x{m}")
            dev = float(np.median([us for _, us in prof])) / 1e3
            bound, by = _rbf_bound(n, m, 2)
            assert min(k, dev) >= bound, f"rbf_gram at {n}x{m}: {k} / {dev} ms is under its bound {bound} ms"
            log(f"[kernel] time {n}x{m} d=2: kernel {k:.4f} ms (median of {RBF_RUNS} runs of {RBF_REPS}: "
                f"{', '.join(f'{t:.4f}' for t in runs_k)}; {4 * n * m / (k * 1e-3) / 1e9:.0f} GB/s of output) | "
                f"device time per kernel (profiler, median of 20) {dev:.4f} ms | bound {bound:.4f} ms ({by}), "
                f"{bound / k:.1%} of it | plain {p:.4f} ms ({', '.join(f'{t:.4f}' for t in runs_p)})")
            times[(n, m)] = (k, p, dev)
    return max_abs, times


def bench_truth(X):
    """bench.py's noise-free outputs (f1, f2) at locations X (n, 2)."""
    f1 = np.sin(1.3 * X[:, 0]) * np.cos(0.9 * X[:, 1])
    return f1, 0.7 * f1 + 0.3 * np.cos(1.1 * X[:, 0])


def make_problem(n_locs, device, dtype):
    """bench.py's make_problem, rebuilt with numpy: same seeds, same spec."""
    rng = np.random.default_rng(0)
    Xb = rng.uniform(-2, 2, size=(n_locs, 2)).astype(np.float32)
    f1, f2 = bench_truth(Xb)
    Y = np.stack(
        [f1 + rng.normal(0, 0.1, n_locs), f2 + rng.normal(0, 0.15, n_locs)], axis=1
    ).astype(np.float32)

    out_cg = CoregTerm(name="Parameter", col=0, d_out=2)
    spec = GPSpec(
        terms=(GPTerm(suffix="total", kernel="ExpQuad", coregs=(out_cg,)),),
        d_cont=2,
        ard=True,
        noise_coreg=CoregTerm(name="Output_noise", col=0, d_out=2),
    )
    sub = Xb[rng.choice(n_locs, min(512, n_locs), replace=False)]
    ls_alpha, ls_beta = ls_prior_from_subsample(sub)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    return spec, t(Xb), t(Y), ls_alpha, ls_beta


def run_slice(device, dtype, n_locs=N_LOCS, coarse_n=COARSE_N, mid_n=MID_N, grid=GRID,
              n_restarts=N_RESTARTS):
    """Fit (coarse → mid → polish) and predict the grid; returns results and phase times."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    spec, xc, Y, la, lb = make_problem(n_locs, device, dtype)
    g = np.linspace(-2, 2, grid).astype(np.float32)
    G1, G2 = np.meshgrid(g, g, indexing="ij")
    xc_grid = torch.as_tensor(np.column_stack([G1.ravel(), G2.ravel()]), dtype=dtype, device=device)
    u0s = initial_params(spec, la, lb, n_restarts=n_restarts, seed=0, dtype=dtype, device=device)
    rng = np.random.default_rng(1)
    sub_c = torch.as_tensor(np.sort(rng.choice(n_locs, min(coarse_n, n_locs), replace=False)), device=device)
    sub_m = torch.as_tensor(np.sort(rng.choice(n_locs, min(mid_n, n_locs), replace=False)), device=device)
    one = lambda u: {k: v[None] for k, v in u.items()}  # noqa: E731

    launches = {}
    RbfGram.launches = 0
    t0 = time.perf_counter()
    u_c, _, aux_c = fit_kron_map(spec, xc[sub_c], Y[sub_c], la, lb, u0s, maxiter=COARSE_ITERS, tol=1e-6)
    sync()
    t1 = time.perf_counter()
    u_m, _, aux_m = fit_kron_map(spec, xc[sub_m], Y[sub_m], la, lb, one(u_c), maxiter=MID_ITERS, tol=MID_FTOL)
    sync()
    t2 = time.perf_counter()
    u_best, f_best, aux_p = fit_kron_map(spec, xc, Y, la, lb, one(u_m), maxiter=POLISH_ITERS, tol=POLISH_FTOL)
    sync()
    t3 = time.perf_counter()
    launches["fit"] = RbfGram.launches
    params = constrain(u_best)
    with torch.no_grad():
        kc = kron_cache(spec, params, xc, Y)
        mean, var = kron_predict_diag(spec, params, kc, xc_grid, with_noise=True)
    sync()
    t4 = time.perf_counter()
    launches["total"] = RbfGram.launches
    launches["predict"] = launches["total"] - launches["fit"]
    phases = {"coarse_s": t1 - t0, "mid_s": t2 - t1, "polish_s": t3 - t2, "predict_s": t4 - t3}
    iters = (aux_c["iters"].tolist(), aux_m["iters"].tolist(), aux_p["iters"].tolist())
    return dict(spec=spec, xc=xc, Y=Y, la=la, lb=lb, u_best=u_best, f_best=float(f_best),
                mean=mean, var=var, xc_grid=xc_grid, phases=phases, iters=iters, launches=launches)


def _log_phases(label, r):
    ph = r["phases"]
    log(f"[slice] {label}: coarse {ph['coarse_s']:.3f} s (iters {r['iters'][0]}) | mid {ph['mid_s']:.3f} s "
        f"(iters {r['iters'][1]}) | polish {ph['polish_s']:.3f} s (iters {r['iters'][2]}) | "
        f"predict {ph['predict_s']:.3f} s ({GRID * GRID}-pt grid x 2 outputs) | total "
        f"{sum(ph.values()):.3f} s")


def phase3_slice():
    # The first pass pays one-time costs (solver setup at each size); the
    # second, warm pass is the one checked and counted.
    _log_phases("phases, first pass", run_slice("cuda", torch.float32))
    with count_rbf_shapes("kronecker") as shapes:
        r = run_slice("cuda", torch.float32)
    _log_phases("phases, warm pass", r)
    mean, var = r["mean"], r["var"]
    n_grid = GRID * GRID
    assert mean.shape == (2, n_grid) and var.shape == (2, n_grid), (mean.shape, var.shape)
    assert bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())
    assert bool((var >= 0).all())
    assert np.isfinite(r["f_best"])
    launches = r["launches"]
    assert launches["fit"] > 0, f"the fit never launched the kernel: {launches}"
    assert launches["predict"] > 0, f"the predict never launched the kernel: {launches}"

    # f32 objective (kernel) against f64 (plain path on the card) at the fit
    spec = r["spec"]
    u64 = {k: v.double() for k, v in r["u_best"].items()}
    with torch.no_grad():
        f32 = float(kron_neg_logp(spec, r["u_best"], r["xc"], r["Y"], r["la"], r["lb"]))
        f64 = float(kron_neg_logp(spec, u64, r["xc"].double(), r["Y"].double(), r["la"], r["lb"]))
        kc64 = kron_cache(spec, constrain(u64), r["xc"].double(), r["Y"].double())
        mean64, var64 = kron_predict_diag(spec, constrain(u64), kc64, r["xc_grid"].double())
    n_points = 2 * N_LOCS
    per_pt = abs(f32 - f64) / n_points
    dmean = float((mean.double() - mean64).abs().max())
    dvar = float((var.double() - var64).abs().max())
    log(f"[slice] kernel launches: fit {launches['fit']} | predict {launches['predict']} | rbf_gram by shape "
        f"{dict(shapes)}")
    assert sum(shapes.values()) == launches["total"], f"shape counts {dict(shapes)} against {launches}"
    log(f"[slice] neg_logp at fit: f32 {f32:.4f} | f64 {f64:.4f} | |diff| {per_pt:.2e} nats/pt "
        f"(tol {BASIN_TOL}) | grid vs f64: max|dmean| {dmean:.3e} max|dvar| {dvar:.3e} | "
        f"mean range [{float(mean.min()):.3f}, {float(mean.max()):.3f}]")
    assert per_pt <= BASIN_TOL, f"f32 and f64 objectives differ by {per_pt} nats/pt"
    assert dmean <= GRID_TOL and dvar <= GRID_TOL, f"f32 grid differs from f64: {dmean}, {dvar}"
    return launches


# ------------------------------------------------------------------
# Phase 4: the fused Gram-matvec kernels against their plain version
# ------------------------------------------------------------------

FUSED_KINDS = ("ExpQuad", "RBF", "Matern12", "Matern32", "Matern52", "Exponential")
FUSED_TOL = 1e-5  # |kernel − f64| per entry, in units of (|K|·|V|)
# The kernel's error may be at most twice the f32 plain version's (both
# compute K in f32 by the same formula; only the product's summation order
# differs). Below one f32 ulp of (|K|·|V|) the comparison is noise, so the
# bound never drops under 2^-23.
ULP32 = 2.0 ** -23
FP32_PEAK = 67e12  # H100 SXM FP32 (non-tensor) FLOP/s, NVIDIA data sheet
TF32_PEAK = 495e12  # H100 SXM TF32 tensor-core FLOP/s, dense, NVIDIA data sheet
TF32_PASSES = 3  # an f32-class product on the tensor cores: lo·hi + hi·lo + hi·hi
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def _fused_inputs(n, m, d, r, seed):
    g = torch.Generator().manual_seed(seed)
    x1 = (torch.rand(n, d, generator=g) * 4 - 2).cuda()
    x2 = (torch.rand(m, d, generator=g) * 4 - 2).cuda()
    v = torch.randn(m, r, generator=g).cuda()
    ls = (torch.rand(d, generator=g) * 1.0 + 0.5).cuda()
    return x1, x2, v, ls


def _fused_check(label, out, x1, x2, v, ls, kind):
    """Normalized max errors of ``out`` and of the f32 plain version against
    an f64 evaluation; raises past the bounds. Returns the max |Δ|."""
    p32 = fused_matvec_plain(x1, x2, v, ls, kind)
    x1d, x2d, vd, lsd = x1.double(), x2.double(), v.double(), ls.double()
    p64 = fused_matvec_plain(x1d, x2d, vd, lsd, kind)
    scale = fused_matvec_plain(x1d, x2d, vd.abs(), lsd, kind).clamp_min(1e-300)  # |K|·|V|
    e_k = float(((out.double() - p64).abs() / scale).max())
    e_p = float(((p32.double() - p64).abs() / scale).max())
    torch.cuda.synchronize()
    ok = e_k <= FUSED_TOL and e_k <= 2.0 * max(e_p, ULP32)
    log(f"[fused] {label}: max|kernel-f64|/(|K||V|) {e_k:.3e} | plain f32 {e_p:.3e}")
    assert ok, f"fused kernel {label} disagrees with f64: {e_k} (plain {e_p}, tol {FUSED_TOL})"
    return float((out.double() - p64).abs().max())


def _matvec_bound(n, m, d, r, sym=False):
    """(bound_ms, bound_by, bound_fp32_ms) of K(x1,x2)·V: the largest of the
    2·n·m·r product flops as three TF32 passes at the tensor-core peak, the
    2·d distance flops per distinct Gram entry (n·m of them, or n(n+1)/2 for
    the symmetric K(x, x)) at the FP32 peak, and each input read once and
    the output written once. The last figure is the earlier bound: all
    operations at the FP32 FMA peak."""
    entries = n * (n + 1) / 2 if sym else n * m
    product, distance = 2.0 * n * m * r, 2.0 * d * entries
    ops_s = max(TF32_PASSES * product / TF32_PEAK, distance / FP32_PEAK)
    inputs = n * d + n * r if sym else n * d + m * d + m * r
    bytes_s = 4.0 * (inputs + n * r) / HBM_BYTES_PER_S
    return (1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes",
            1e3 * max((product + distance) / FP32_PEAK, bytes_s))


def phase4_fused_vs_plain():
    errs = {"general": 0.0, "sym": 0.0}
    with torch.no_grad():
        for kind in FUSED_KINDS:
            for d in (1, 2, 3):
                x1, x2, v, ls = _fused_inputs(37, 23, d, 5, seed=d)
                out = fused_stationary_matvec(x1, x2, v, ls, kind)
                errs["general"] = max(errs["general"], _fused_check(f"general {kind} 37x23 d={d} r=5",
                                                                    out, x1, x2, v, ls, kind))
                x, _, vs, ls = _fused_inputs(300, 300, d, 5, seed=10 + d)
                out = fused_stationary_matvec_sym(x, vs, ls, kind)
                errs["sym"] = max(errs["sym"], _fused_check(f"sym {kind} n=300 d={d} r=5",
                                                            out, x, x, vs, ls, kind))
        # every column width the kernels are built for. General: column
        # groups of up to two chunks of 8·NTL columns, NTL = 9 for every
        # chunk but the last, which is as narrow as the remainder: 1 (r ≤ 8,
        # 73's and 289's), 2 (9, 16, 513's), 4 (17, 32, 100's), 8 (33, 64),
        # 9 (65, 72, 288); one group for r ≤ 144 (1, 2 chunks), two for 288
        # and 289, four for 513. At 2500×300 (5 x2 tiles) every one runs
        # s = 5 segments. Symmetric: 8·NTL columns per chunk, NTL = 1 (r ≤
        # 8, 73's remainder), 2 (9, 16, 513's remainder), 4 (17, 32, 100's
        # remainder), 8 (33, 64), 9 (65, 72 and every full chunk of a wider r)
        for r in (1, 5, 8, 9, 16, 17, 32, 33, 64, 65, 72, 73, 100, 288, 289, 513):
            x1, x2, v, ls = _fused_inputs(2500, 300, 2, r, seed=r)
            out = fused_stationary_matvec(x1, x2, v, ls, "ExpQuad")
            errs["general"] = max(errs["general"], _fused_check(
                f"general ExpQuad 2500x300 r={r} s={general_split(2500, 300, r)[0]}", out, x1, x2, v, ls, "ExpQuad"))
            x, _, vs, ls = _fused_inputs(2500, 2500, 2, r, seed=100 + r)
            out = fused_stationary_matvec_sym(x, vs, ls, "Matern52")
            errs["sym"] = max(errs["sym"], _fused_check(f"sym Matern52 n=2500 r={r}",
                                                        out, x, x, vs, ls, "Matern52"))
        # ragged n and m, one x2 segment and several: 300×2500 (s = 40), an m
        # that is no multiple of 64 at s > 1 (1000×4001, s = 15) and at s = 1
        # (45,100 rows: 353 row blocks), 37×23 above (one x2 tile, s = 1);
        # and d = 40, past the 32 coordinates staged in shared memory
        for n, m, d, r, kind in ((300, 2500, 3, 65, "Matern32"), (1000, 4001, 3, 289, "Matern12"),
                                 (45_100, 1000, 3, 65, "Exponential"), (45_100, 1000, 3, 1, "ExpQuad"),
                                 (700, 1500, 40, 9, "Matern12")):
            x1, x2, v, ls = _fused_inputs(n, m, d, r, seed=n + m + r)
            out = fused_stationary_matvec(x1, x2, v, ls, kind)
            errs["general"] = max(errs["general"], _fused_check(
                f"general {kind} {n}x{m} d={d} r={r} s={general_split(n, m, r)[0]}", out, x1, x2, v, ls, kind))
        # band grids: even (with the wrap band) and odd, whole blocks and a
        # short last block (2,085 rows: nb = 5; 2,860: nb = 6), and nb = 12,
        # where a band walker takes more than one band; the general kernel on
        # the same square inputs, against f64 and against the symmetric one
        for n in (4 * SYM_TILE, 7 * SYM_TILE, 4 * SYM_TILE + 37, 5 * SYM_TILE + 300, 12 * SYM_TILE - 5):
            nb = -(-n // SYM_TILE)
            for kind in ("ExpQuad", "Matern32"):
                x, _, vs, ls = _fused_inputs(n, n, 2, 65, seed=nb)
                sym = fused_stationary_matvec_sym(x, vs, ls, kind)
                gen = fused_stationary_matvec(x, x, vs, ls, kind)
                errs["sym"] = max(errs["sym"], _fused_check(f"sym {kind} n={n} (nb={nb}) r=65",
                                                            sym, x, x, vs, ls, kind))
                errs["general"] = max(errs["general"], _fused_check(
                    f"general {kind} {n}x{n} r=65 s={general_split(n, n, 65)[0]}", gen, x, x, vs, ls, kind))
                dsg = float((sym - gen).abs().max() / gen.abs().max())
                log(f"[fused] sym vs general n={n} {kind}: max|d|/max|general| {dsg:.3e}")
                assert dsg <= 1e-5, f"sym and general kernels disagree at n={n}: {dsg}"
        # The sym kernel at the main path's other widths, N = 50,000: the LOVE
        # sweeps (r = 64) and the posterior cache's PCG (r = 1); checked
        # against the plain version and timed (the r = 65 row is below), the
        # general kernel timed beside it on the same inputs
        sym_times, times = {}, {}
        for r in (64, 1):
            x, _, vs, ls = _fused_inputs(50_000, 50_000, 2, r, seed=200 + r)
            ref = fused_matvec_plain(x, x, vs, ls, "ExpQuad")
            kern = lambda: fused_stationary_matvec_sym(x, vs, ls, "ExpQuad")  # noqa: E731
            gen = lambda: fused_stationary_matvec(x, x, vs, ls, "ExpQuad")  # noqa: E731
            dmax = float((kern() - ref).abs().max() / ref.abs().max())
            gmax = float((gen() - ref).abs().max() / ref.abs().max())
            del ref
            ms, gms = _time_ms(kern, 10), _time_ms(gen, 10)
            bound, by, bound32 = _matvec_bound(50_000, 50_000, 2, r, sym=True)
            gbound, gby, gbound32 = _matvec_bound(50_000, 50_000, 2, r)
            log(f"[fused] sym ExpQuad n=50000 r={r}: max|kernel-plain|/max|plain| {dmax:.2e} | kernel {ms:.3f} ms | "
                f"bound {bound:.3f} ms ({by}; {bound32:.3f} ms at the FP32 FMA peak) | general kernel {gms:.3f} ms "
                f"(bound {gbound:.3f} ms, max|general-plain|/max|plain| {gmax:.2e})")
            assert dmax <= 1e-5, f"sym kernel disagrees with plain at n=50000 r={r}: {dmax}"
            assert gmax <= 1e-5, f"general kernel disagrees with plain at n=50000 r={r}: {gmax}"
            assert ms >= bound, f"sym kernel at r={r}: {ms} ms is under its bound {bound} ms"
            assert gms >= gbound, f"general kernel at 50000x50000 r={r}: {gms} ms is under its bound {gbound} ms"
            sym_times[r] = ms
            times[("general", 50_000, 50_000, r)] = (gms, None, gbound, gby, gbound32)

        # deterministic: every slot has one writer, and the sums a fixed order
        x, _, vs, ls = _fused_inputs(50_000, 50_000, 2, 65, seed=7)
        same = torch.equal(fused_stationary_matvec_sym(x, vs, ls, "ExpQuad"),
                           fused_stationary_matvec_sym(x, vs, ls, "ExpQuad"))
        log(f"[fused] sym ExpQuad n=50000 r=65, two runs bit-equal: {same}")
        assert same, "the symmetric matvec kernel is not deterministic"
        for n, m, r in ((10_000, 50_000, 513), (50_000, 50_000, 65)):
            x1, x2, v, ls = _fused_inputs(n, m, 2, r, seed=8)
            same = torch.equal(fused_stationary_matvec(x1, x2, v, ls, "ExpQuad"),
                               fused_stationary_matvec(x1, x2, v, ls, "ExpQuad"))
            log(f"[fused] general ExpQuad {n}x{m} r={r} (s={general_split(n, m, r)[0]}), two runs bit-equal: {same}")
            assert same, f"the general matvec kernel is not deterministic at {n}x{m} r={r}"

        # Times at the large-N engine's shapes: plain, kernel, kernel, plain
        cases = [("sym", 50_000, 50_000, 65), ("general", 50_000, 50_000, 65), ("general", 10_000, 50_000, 513),
                 ("general", 10_000, 50_000, 1)]
        for which, n, m, r in cases:
            x1, x2, v, ls = _fused_inputs(n, m, 2, r, seed=7)
            if which == "sym":
                x2 = x1
                kern = lambda: fused_stationary_matvec_sym(x1, v, ls, "ExpQuad")  # noqa: E731
            else:
                kern = lambda: fused_stationary_matvec(x1, x2, v, ls, "ExpQuad")  # noqa: E731
            plain = lambda: fused_matvec_plain(x1, x2, v, ls, "ExpQuad")  # noqa: E731
            ref = plain()
            dmax = float((kern() - ref).abs().max() / ref.abs().max())
            del ref
            p1, k1 = _time_ms(plain), _time_ms(kern)
            k2, p2 = _time_ms(kern), _time_ms(plain)
            k, p = (k1 + k2) / 2, (p1 + p2) / 2
            flops = 2.0 * n * m * (2 + r)
            bound, by, bound32 = _matvec_bound(n, m, 2, r, sym=which == "sym")
            log(f"[fused] time {which} {n}x{m} d=2 r={r}: kernel {k:.3f} ms ({k1:.3f}, {k2:.3f}; "
                f"{flops / (k * 1e-3) / 1e9:.0f} GFLOP/s counted as 2nm(d+r)) | plain {p:.3f} ms "
                f"({p1:.3f}, {p2:.3f}; {flops / (p * 1e-3) / 1e9:.0f} GFLOP/s) | bound {bound:.3f} ms "
                f"({by}; {bound32:.3f} ms at the FP32 FMA peak) | max|kernel-plain|/max|plain| {dmax:.2e}")
            assert dmax <= 1e-5, f"{which} kernel disagrees with plain at {n}x{m} r={r}: {dmax}"
            assert k >= bound, f"{which} kernel at {n}x{m} r={r}: {k} ms is under its bound {bound} ms"
            times[(which, n, m, r)] = (k, p, bound, by, bound32)

        # past the symmetric kernel's scratch gate: the general kernel alone,
        # checked once against the plain version, then timed
        n = 100_000
        x1, _, v, ls = _fused_inputs(n, n, 2, 65, seed=9)
        kern = lambda: fused_stationary_matvec(x1, x1, v, ls, "ExpQuad")  # noqa: E731
        ref = fused_matvec_plain(x1, x1, v, ls, "ExpQuad")
        dmax = float((kern() - ref).abs().max() / ref.abs().max())
        del ref
        k = _time_ms(kern, 5)
        bound, by, bound32 = _matvec_bound(n, n, 2, 65)
        log(f"[fused] time general {n}x{n} d=2 r=65 (past the sym gate: fits {sym_matvec_fits(n, 65)}): kernel "
            f"{k:.3f} ms | bound {bound:.3f} ms ({by}; {bound32:.3f} ms at the FP32 FMA peak) | "
            f"max|kernel-plain|/max|plain| {dmax:.2e}")
        assert dmax <= 1e-5, f"general kernel disagrees with plain at {n}x{n} r=65: {dmax}"
        assert k >= bound, f"general kernel at {n}x{n} r=65: {k} ms is under its bound {bound} ms"
        times[("general", n, n, 65)] = (k, None, bound, by, bound32)
    return errs, times, sym_times


# ------------------------------------------------------------------
# Phases 5-6: the large-N iterative engine (bench_iterative50k.py's path)
# ------------------------------------------------------------------

ITER_N, ITER_BLOCK, ITER_RANK, ITER_PROBES = 50_000, 2_500, 512, 64
ITER_TOL, ITER_MAXITER, ITER_QUAD, LOVE_RANK = 1e-2, 256, 32, 512
ITER_RESTARTS, ITER_COARSE_N, ITER_COARSE_ITERS, ITER_POLISH_ITERS = 32, 2048, 40, 40
FIT_TOL = 1e-8  # GP.find_MAP's default tol, the coarse and polish ftol
BENCH_LS = (0.30, 0.35)  # bench_iterative50k.py's evaluation point
# At BENCH_LS the f32 pivoted Cholesky of rank 512 reads exhausted on the
# card but its Woodbury solve misses tol, so a few PCG sweeps run; the
# objective phase adds a shorter lengthscale where the factorization is not
# exhausted and PCG + SLQ run to convergence at full N through the sym kernel.
CG_LS = (0.10, 0.12)
CHOL_N = 16_384
ANCHOR_TOL = 5e-4  # |iterative − Cholesky| / |Cholesky| at CHOL_N
LOVE_MEDIAN_TOL = 0.05  # median |LOVE − exact| / exact variance at CHOL_N


def _iter_spec():
    return GPSpec(terms=(GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _counts():
    return {"rbf_gram": RbfGram.launches, "fused_stationary_matvec": FusedMatvec.launches,
            "fused_stationary_matvec_sym": FusedMatvecSym.launches}


def _delta(a, b):
    return {k: b[k] - a[k] for k in a}


def bench_point_value_and_grad(device="cuda", dtype=torch.float32, n=ITER_N, ls=BENCH_LS, sym_matvec=None):
    """One value+grad of the iterative MAP objective at bench_iterative50k's
    point, ls = (0.30, 0.35), η = 1, σ = 0.1 (or at another ``ls``), with
    its priors and config (``sym_matvec=False``: every sweep through the
    general kernel)."""
    spec = _iter_spec()
    X, y = make_iter_data(n)
    xc = torch.as_tensor(X, dtype=dtype, device=device)
    yt = torch.as_tensor(y, dtype=dtype, device=device)
    xk = torch.zeros((n, 0), dtype=torch.long, device=device)
    la, lb = np.array([2.0, 2.0]), np.array([1.0, 1.0])
    cfg = IterConfig(maxiter=ITER_MAXITER, tol=ITER_TOL, n_probes=ITER_PROBES, precond_rank=ITER_RANK,
                     quad_steps=ITER_QUAD, block=ITER_BLOCK, love_rank=LOVE_RANK, sym_matvec=sym_matvec)
    pn, pk = draw_probes(0, n, cfg, dtype=dtype, device=device)
    u = {"ls_total": torch.log(torch.tensor(ls, dtype=dtype, device=device)),
         "η_total": torch.zeros((), dtype=dtype, device=device),
         "σ": torch.log(torch.tensor(0.10, dtype=dtype, device=device))}
    info = {}
    _sync(device)
    t0 = time.perf_counter()
    value, grad = iter_map_value_and_grad(spec, cfg, u, xc, xk, yt, la, lb, pn, pk, info=info)
    _sync(device)
    wall = time.perf_counter() - t0
    return dict(ls=tuple(ls), value=float(value), grad={k: v.tolist() for k, v in grad.items()}, wall_s=wall,
                iters=info["iters"], rel_res=float(info["rel_res"]), exhausted=info["exhausted"])


def time_pivoted_cholesky(n=ITER_N, rank=ITER_RANK, ls=BENCH_LS, reps=3):
    """Time of the rank-``rank`` pivoted Cholesky (the preconditioner every
    evaluation builds) at bench_iterative50k's point: CUDA events over
    ``reps`` calls after one warm call. The host issues its launches with
    no sync, so this is the span the stream takes, host gaps included."""
    spec = _iter_spec()
    X, _ = make_iter_data(n)
    xc = torch.as_tensor(X, device="cuda")
    xk = torch.zeros((n, 0), dtype=torch.long, device="cuda")
    params = constrain({"ls_total": torch.log(torch.tensor(ls, device="cuda")),
                        "η_total": torch.zeros((), device="cuda"),
                        "σ": torch.log(torch.tensor(0.10, device="cuda"))})
    with torch.no_grad():
        kdiag = gram_diag(spec, params, xc, xk)
        row_fn = _row_fn(spec, params, xc, xk, None)
        before = RbfGram.launches
        ms = _time_ms(lambda: pivoted_cholesky(row_fn, kdiag, rank), reps=reps)
    per_call = (RbfGram.launches - before) // (reps + 1)
    log(f"[iter] pivoted Cholesky N={n} rank={rank} ls={tuple(ls)}: {ms:.3f} ms per call "
        f"(CUDA events, mean of {reps}) | rbf_gram launches per call {per_call}")
    return ms


def _grid_points(xc, grid):
    lo, hi = xc.min(0).values, xc.max(0).values
    g0 = torch.linspace(float(lo[0]), float(hi[0]), grid, dtype=xc.dtype, device=xc.device)
    g1 = torch.linspace(float(lo[1]), float(hi[1]), grid, dtype=xc.dtype, device=xc.device)
    G0, G1 = torch.meshgrid(g0, g1, indexing="ij")
    return torch.stack([G0.reshape(-1), G1.reshape(-1)], dim=1)


def campaign_problem(n, device, dtype):
    """The campaign's data in the model's coordinates: bench_iterative50k's
    make_data, continuous dims and output z-scored, the lengthscale prior
    from pairwise distances of a 512-point subsample (as make_problem)."""
    X, y = make_iter_data(n)
    Xz = (X - X.mean(0)) / X.std(0)
    yz = (y - y.mean()) / y.std()
    rng = np.random.default_rng(0)
    sub = Xz[rng.choice(n, min(512, n), replace=False)]
    la, lb = ls_prior_from_subsample(sub)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    return t(Xz), t(yz), la, lb


def run_iter_campaign(device, dtype, n=ITER_N, block=ITER_BLOCK, rank=ITER_RANK, probes=ITER_PROBES,
                      love_rank=LOVE_RANK, coarse_n=ITER_COARSE_N, n_restarts=ITER_RESTARTS,
                      coarse_iters=ITER_COARSE_ITERS, polish_iters=ITER_POLISH_ITERS, grid=GRID,
                      omega=None):
    """The staged large-N fit of ``GP._find_MAP_iterative`` and its grid
    predict, through the port's ops: coarse restarts of the dense Cholesky
    MAP on a ``coarse_n``-row subsample → L-BFGS polish of the iterative
    objective at full N from the coarse winner → LOVE posterior cache →
    ``iter_predict_diag`` on a ``grid``² grid (``with_noise=False``).
    Returns results, phase times, per-phase launch counts and the regime
    and CG iterations of every polish evaluation."""
    spec = _iter_spec()
    xc, y, la, lb = campaign_problem(n, device, dtype)
    xk = torch.zeros((n, 0), dtype=torch.long, device=device)
    cfg = IterConfig(maxiter=ITER_MAXITER, tol=ITER_TOL, n_probes=probes, precond_rank=rank,
                     quad_steps=ITER_QUAD, block=block, love_rank=love_rank)
    pn, pk = draw_probes(0, n, cfg, dtype=dtype, device=device)
    u0s = initial_params(spec, la, lb, n_restarts=n_restarts, seed=0, dtype=dtype, device=device)
    # the coarse subsample, drawn as GP._find_MAP_iterative draws it (seed 0)
    idx = np.random.default_rng(0).choice(np.arange(n), size=min(coarse_n, n), replace=False)
    idx_t = torch.as_tensor(idx, device=device)
    xc_c, xk_c, y_c = xc[idx_t], xk[idx_t], y[idx_t]
    la_t, lb_t = (torch.as_tensor(a, dtype=dtype, device=device) for a in (la, lb))
    evals = []

    def objective(u):
        info = {}
        f = iter_map_neg_logp(spec, u, xc, xk, y, la_t, lb_t, pn, pk, cfg, info=info)
        evals.append((info["exhausted"], info["iters"], info["woodbury_rel"]))
        return f

    counts = [_counts()]
    _sync(device)
    t0 = time.perf_counter()
    u_start, f_coarse, aux_c = multi_restart_minimize(
        None, u0s,
        runner=lambda u0: coarse_restart_map(spec, xc_c, xk_c, y_c, la_t, lb_t, u0, maxiter=coarse_iters,
                                             tol=FIT_TOL),
    )
    _sync(device)
    t1 = time.perf_counter()
    u_best, f_best, polish_iters = lbfgs_backtracking_minimize(objective, u_start, maxiter=polish_iters,
                                                               ftol=FIT_TOL)
    _sync(device)
    t2 = time.perf_counter()
    counts.append(_counts())
    params = constrain(u_best)
    cache_info = {}
    cache = iter_posterior_cache(spec, cfg, params, xc, xk, y, omega=omega, info=cache_info)
    _sync(device)
    t3 = time.perf_counter()
    counts.append(_counts())
    xg = _grid_points(xc, grid)
    xkg = torch.zeros((xg.shape[0], 0), dtype=torch.long, device=device)
    mean, var = iter_predict_diag(spec, cfg, params, cache, xc, xk, xg, xkg, with_noise=False)
    _sync(device)
    t4 = time.perf_counter()
    counts.append(_counts())
    launches = {"fit": _delta(counts[0], counts[1]), "cache": _delta(counts[1], counts[2]),
                "predict": _delta(counts[2], counts[3])}
    return dict(spec=spec, cfg=cfg, xc=xc, xk=xk, y=y, la=la, lb=lb, idx=idx, u0s=u0s, pn=pn, pk=pk,
                u_best=u_best, f_best=float(f_best), f_coarse=float(f_coarse), aux_c=aux_c,
                polish_iters=polish_iters, evals=evals, cache=cache, cache_info=cache_info,
                xg=xg, mean=mean, var=var, launches=launches,
                phases={"coarse_s": t1 - t0, "polish_s": t2 - t1, "cache_s": t3 - t2, "predict_s": t4 - t3})


# E: exhausted, the Woodbury solve kept; W: the factorization read exhausted
# but the Woodbury solve missed tol, so PCG + SLQ ran; C: the CG regime
REGIME_KEY = "E = exhausted/Woodbury, W = exhausted gate, Woodbury missed tol → CG, C = CG"


def _regimes(exhausted, woodbury_rel):
    return "".join("E" if e else ("C" if np.isnan(w) else "W") for e, w in zip(exhausted, woodbury_rel))


def _log_campaign(label, r):
    ph = r["phases"]
    regimes = _regimes([e for e, _, _ in r["evals"]], [w for _, _, w in r["evals"]])
    cg = [it for _, it, _ in r["evals"]]
    log(f"[iter] campaign {label}: coarse {ph['coarse_s']:.3f} s ({len(r['aux_c']['iters'])} restarts @"
        f"{len(r['idx'])}, iters {r['aux_c']['iters'].tolist()}) | polish {ph['polish_s']:.3f} s "
        f"({r['polish_iters']} iterations, {len(r['evals'])} evaluations) | cache {ph['cache_s']:.3f} s "
        f"(regime {'exhausted' if r['cache_info']['exhausted'] else 'CG'}, CG iters {r['cache_info']['iters']}, "
        f"Woodbury residual {r['cache_info']['woodbury_rel']:.3e}) | predict {ph['predict_s']:.3f} s "
        f"({r['xg'].shape[0]}-pt grid) | "
        f"total {sum(ph.values()):.3f} s")
    log(f"[iter] polish evaluations ({REGIME_KEY}): {regimes} | CG iters {cg}")
    log(f"[iter] launches {label}: {r['launches']}")
    log(f"[iter] MAP ls {constrain(r['u_best'])['ls_total'].tolist()} | f_best {r['f_best']:.4f} "
        f"(coarse winner {r['f_coarse']:.4f} on the subsample)")


def phase5_anchor():
    """Iterative objective and LOVE variances at N = 16,384 against the
    dense Cholesky engine (bench_iterative50k.py's bench_chol_anchor)."""
    spec = _iter_spec()
    X, y = make_iter_data(ITER_N)
    xc = torch.as_tensor(X[:CHOL_N], device="cuda")
    yt = torch.as_tensor(y[:CHOL_N], device="cuda")
    xk = torch.zeros((CHOL_N, 0), dtype=torch.long, device="cuda")
    la, lb = np.array([2.0, 2.0]), np.array([1.0, 1.0])
    cfg = IterConfig(maxiter=ITER_MAXITER, tol=1e-4, n_probes=ITER_PROBES, precond_rank=ITER_RANK,
                     quad_steps=ITER_QUAD, block=2048, love_rank=LOVE_RANK)
    pn, pk = draw_probes(0, CHOL_N, cfg, dtype=torch.float32, device="cuda")
    u = {"ls_total": torch.log(torch.tensor([0.30, 0.35], device="cuda")),
         "η_total": torch.zeros((), device="cuda"), "σ": torch.log(torch.tensor(0.10, device="cuda"))}
    info = {}
    with torch.no_grad():
        vi = float(iter_map_neg_logp(spec, u, xc, xk, yt, la, lb, pn, pk, cfg, info=info))
        vc = float(map_neg_logp(spec, u, xc, xk, yt, la, lb))
        rel = abs(vi - vc) / abs(vc)
        params = constrain(u)
        rng = np.random.default_rng(7)
        xs = torch.as_tensor(rng.uniform(-2, 2, (512, 2)).astype(np.float32), device="cuda")
        xks = torch.zeros((512, 0), dtype=torch.long, device="cuda")
        cache = iter_posterior_cache(spec, cfg, params, xc, xk, yt)
        _, var_love = iter_predict_diag(spec, cfg, params, cache, xc, xk, xs, xks, with_noise=False)
        # exact posterior diagonal, f64 Cholesky on the card
        p64 = {k: v.double() for k, v in params.items()}
        x64, xs64 = xc.double(), xs.double()
        A = gram(spec, p64, x64, xk, x64, xk)
        A.diagonal().add_(noise_diag(spec, p64, xk, dtype=torch.float64) + DEFAULT_JITTER)
        C = torch.linalg.cholesky(A)
        del A
        Wx = torch.linalg.solve_triangular(C, gram(spec, p64, x64, xk, xs64, xks), upper=False)
        var_exact = gram_diag(spec, p64, xs64, xks) - (Wx * Wx).sum(0)
        del C, Wx
    vl, ve = var_love.double().cpu().numpy(), var_exact.cpu().numpy()
    med = float(np.median(np.abs(vl - ve) / np.maximum(ve, 1e-12)))
    conservative = float(np.mean(vl >= ve - 1e-6))
    log(f"[anchor] N={CHOL_N}: iterative {vi:.4f} (CG iters {info['iters']}, rel_res {float(info['rel_res']):.2e}, "
        f"{'exhausted' if info['exhausted'] else 'CG'}) | Cholesky {vc:.4f} | rel err {rel:.3e} (tol {ANCHOR_TOL}) | "
        f"LOVE rank {LOVE_RANK} var median rel err {med:.4f} (tol {LOVE_MEDIAN_TOL}), "
        f"{100 * conservative:.1f}% conservative")
    assert np.isfinite(vi) and rel <= ANCHOR_TOL, f"iterative objective off the Cholesky one: {rel}"
    assert med <= LOVE_MEDIAN_TOL, f"LOVE variances off the exact ones: median {med}"
    return rel, med, conservative


def phase6_iterative():
    """The counted main path (two value+grads, then the staged campaign,
    run once: each pass takes ~100-110 s, and a second one only repeated
    the first's evaluations), then its checks."""
    time_pivoted_cholesky()
    for k in (RbfGram, FusedMatvec, FusedMatvecSym):
        k.launches = 0
    with count_rbf_shapes("iterative") as shapes:
        bench = bench_point_value_and_grad()
        cgpt = bench_point_value_and_grad(ls=CG_LS)
        after_objective = _counts()
        r = run_iter_campaign("cuda", torch.float32)
    launches = _counts()
    # the CG point again with every sweep through the general kernel
    # (IterConfig(sym_matvec=False), the route past the symmetric gate)
    before = _counts()
    cg_gen = bench_point_value_and_grad(ls=CG_LS, sym_matvec=False)
    gen_launches = _delta(before, _counts())
    for label, b in (("bench point", bench), ("CG point", cgpt)):
        log(f"[iter] {label} ls={b['ls']}: value {b['value']:.4f} | grad {b['grad']} | "
            f"CG iters {b['iters']} | rel_res {b['rel_res']:.3e} | "
            f"{'exhausted' if b['exhausted'] else 'CG'} regime | value+grad {b['wall_s']:.3f} s")
    log(f"[iter] launches of the two value+grads: {after_objective}")
    log(f"[iter] CG point ls={cg_gen['ls']} with sym_matvec=False: value {cg_gen['value']:.4f} (symmetric route "
        f"{cgpt['value']:.4f}, diff {cg_gen['value'] - cgpt['value']:.3e}) | CG iters {cg_gen['iters']} (symmetric "
        f"{cgpt['iters']}) | rel_res {cg_gen['rel_res']:.3e} | value+grad {cg_gen['wall_s']:.3f} s (symmetric "
        f"{cgpt['wall_s']:.3f} s) | launches {gen_launches}")
    _log_campaign("single pass", r)
    log(f"[iter] main path launches (two value+grads + the campaign, run once): {launches} | rbf_gram by shape "
        f"{dict(shapes)}")
    assert sum(shapes.values()) == launches["rbf_gram"], f"shape counts {dict(shapes)} against {launches}"
    for b in (bench, cgpt):
        assert np.isfinite(b["value"]), f"iterative objective at ls={b['ls']} is not finite"
        assert b["exhausted"] or b["rel_res"] <= 10 * ITER_TOL, f"solve at ls={b['ls']} not trusted: {b}"
    assert not cgpt["exhausted"] and cgpt["iters"] > 0, f"no PCG ran at ls={CG_LS}: {cgpt}"
    assert after_objective["fused_stationary_matvec_sym"] > 0, "the objective's PCG never ran the sym kernel"
    assert np.isfinite(cg_gen["value"]) and not cg_gen["exhausted"], f"sym_matvec=False at ls={CG_LS}: {cg_gen}"
    assert gen_launches["fused_stationary_matvec_sym"] == 0, f"sym_matvec=False ran the sym kernel: {gen_launches}"
    assert gen_launches["fused_stationary_matvec"] >= cg_gen["iters"] > 0, \
        f"sym_matvec=False: fewer general launches than PCG sweeps: {gen_launches}, {cg_gen['iters']}"

    mean, var = r["mean"], r["var"]
    assert mean.shape == (GRID * GRID,) and var.shape == (GRID * GRID,), (mean.shape, var.shape)
    assert bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all()) and bool((var >= 0).all())
    assert np.isfinite(r["f_best"]), "the polish never evaluated finite"
    lc = r["launches"]
    assert lc["fit"]["rbf_gram"] > 0, f"the fit never launched rbf_gram: {lc}"
    sym_fit_cache = lc["fit"]["fused_stationary_matvec_sym"] + lc["cache"]["fused_stationary_matvec_sym"]
    assert sym_fit_cache > 0, f"fit and cache never launched the symmetric kernel: {lc}"
    assert lc["predict"]["fused_stationary_matvec"] > 0, f"predict never launched the general kernel: {lc}"
    for name, c in launches.items():
        assert c > 0, f"{name} was launched no time on the main path"

    # f32 objective at the fit against f64 on the plain path, same probes
    spec, cfg = r["spec"], r["cfg"]
    with torch.no_grad():
        f32 = float(iter_map_neg_logp(spec, r["u_best"], r["xc"], r["xk"], r["y"], r["la"], r["lb"],
                                      r["pn"], r["pk"], cfg))
        info64 = {}
        u64 = {k: v.double() for k, v in r["u_best"].items()}
        f64 = float(iter_map_neg_logp(spec, u64, r["xc"].double(), r["xk"], r["y"].double(), r["la"], r["lb"],
                                      r["pn"].double(), r["pk"].double(), cfg, info=info64))
    per_pt = abs(f32 - f64) / ITER_N
    log(f"[iter] neg_logp at fit: f32 {f32:.4f} | f64 {f64:.4f} (plain path, CG iters {info64['iters']}, "
        f"{'exhausted' if info64['exhausted'] else 'CG'}) | |diff| {per_pt:.2e} nats/pt (tol {BASIN_TOL}) | "
        f"grid mean [{float(mean.min()):.3f}, {float(mean.max()):.3f}] var [{float(var.min()):.2e}, "
        f"{float(var.max()):.2e}]")
    assert per_pt <= BASIN_TOL, f"f32 and f64 iterative objectives differ by {per_pt} nats/pt"
    return launches, bench, r


# ------------------------------------------------------------------
# Phase 7: the blocked Cholesky kernel against plain, library and f64
# ------------------------------------------------------------------

CHOL_TOL = 5e-5  # max |L_kernel − L_plain| / max(|L|, 1), tests/test_pallas_chol.py's tolerance
CHOL_F64_FACTOR = 2.0  # the kernel's error against f64 may be at most this many times the f32 library's
DENSE_N, DENSE_RESTARTS = 16_384, 8
DENSE_COARSE_N, DENSE_COARSE_ITERS, DENSE_POLISH_ITERS = 1024, 32, 12
DENSE_DRAW_GRID, DENSE_DRAWS = 32, 4  # draw_samples: 4 draws at 32 × 32 = 1,024 grid points


def _spd_input(D, n, seed=0):
    """probe_pallas_chol.py's input, X·Xᵀ/64 + 2I with X (D, n, 64) standard
    normal from a numpy seed; the product is taken on the card."""
    X = torch.as_tensor(np.random.default_rng(seed).normal(size=(D, n, 64)).astype(np.float32)).cuda()
    return X @ X.transpose(1, 2) / 64 + 2.0 * torch.eye(n, device="cuda")


def _chol_errors(label, A, spd):
    """Factor ``A`` by kernel, plain version and library (f32) and by the
    library at f64; log and check. Returns max |L_kernel − L_plain|."""
    before = BlockedChol.launches
    L = hopper_chol.cholesky(A)
    torch.cuda.synchronize()
    assert BlockedChol.launches == before + 1, f"{label}: the dispatcher did not launch the kernel"
    Lp = cholesky_plain(A)
    Ll = torch.linalg.cholesky(A)
    L64 = torch.linalg.cholesky(A.double())
    scale = max(float(L64.abs().max()), 1.0)
    d_kp = float((L - Lp).abs().max())
    e_k, e_p, e_l = (float((x - L64).abs().max()) for x in (L, Lp, Ll))
    upper = float(L.triu(1).abs().max())
    log(f"[chol] {label}: max|kernel-plain| {d_kp:.3e} (scale {scale:.2f}) | max error vs f64: kernel {e_k:.3e}, "
        f"plain {e_p:.3e}, library {e_l:.3e} | upper triangle max {upper:.1e}")
    assert upper == 0.0, f"{label}: the kernel's factor has entries above the diagonal"
    assert np.isfinite(e_k) and e_k <= CHOL_F64_FACTOR * e_l, \
        f"{label}: kernel error vs f64 {e_k} exceeds {CHOL_F64_FACTOR} x the library's {e_l}"
    if spd:
        assert d_kp <= CHOL_TOL * scale, f"{label}: kernel and plain disagree by {d_kp}"
    return d_kp


def _chol_bound(D, n):
    """(bound_ms, bound_by, bound_fp32_ms): the D·n³/3 product flops as three
    TF32 passes at the tensor-core peak, against A read and L written once;
    and the earlier figure, the same flops at the FP32 FMA peak."""
    flops = D * n**3 / 3.0
    ops_s = TF32_PASSES * flops / TF32_PEAK
    bytes_s = 8.0 * D * n * n / HBM_BYTES_PER_S
    return (1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes",
            1e3 * max(flops / FP32_PEAK, bytes_s))


def _dense_gram_input(coarse=False):
    """K + σ²I + jitter·I of the dense path (ls = (0.30, 0.35), η = 1,
    σ = 0.1) with a leading batch axis of 1: at N = 16,384, or on the coarse
    stage's 1,024-row subsample."""
    spec, X, y, _, _, rng = make_dense_problem(DENSE_N, np.float32)
    if coarse:
        X = X[np.sort(rng.choice(DENSE_N, DENSE_COARSE_N, replace=False))]
    xc = torch.as_tensor(X, device="cuda")
    xk = torch.zeros((X.shape[0], 0), dtype=torch.long, device="cuda")
    params = {"ls_total": torch.tensor([0.30, 0.35], device="cuda"), "η_total": torch.ones((), device="cuda"),
              "σ": torch.tensor(0.10, device="cuda")}
    return _noisy_gram(spec, params, xc, xk)[None]


def _kron_gram_input():
    """The (2, 5120, 5120) whitened systems ωᵢ·Kx + I of the Kronecker
    objective at bench.py's first start."""
    spec, xc, Y, la, lb = make_problem(N_LOCS, "cuda", torch.float32)
    u0s = initial_params(spec, la, lb, n_restarts=1, seed=0, dtype=torch.float32, device="cuda")
    params = constrain({k: v[0] for k, v in u0s.items()})
    B, s2 = kron_parts(spec, params)
    _, ω, _ = _whitened_eig(B, s2)
    return _whitened_systems(_continuous_gram(spec, params, xc, xc), ω).contiguous()


def phase7_chol_vs_plain():
    max_abs = 0.0
    with torch.no_grad():
        # (1, 1024) is the coarse stage's and draw_samples' shape, (1, 16384) the polish's
        shapes = [(D, n) for n in (256, 512, 768, 5120) for D in (1, 2, 3)]
        for D, n in shapes + [(1, DENSE_COARSE_N), (1, 2048), (1, DENSE_N)]:
            max_abs = max(max_abs, _chol_errors(f"spd D={D} N={n}", _spd_input(D, n), spd=True))
        _chol_errors(f"Kronecker Gram D=2 N={N_LOCS}", _kron_gram_input(), spd=False)
        _chol_errors(f"dense coarse Gram D=1 N={DENSE_COARSE_N}", _dense_gram_input(coarse=True), spd=False)
        _chol_errors(f"dense Gram D=1 N={DENSE_N}", _dense_gram_input(), spd=False)

        # a non-PD batch entry: NaN there, right factors elsewhere
        A = _spd_input(3, 512)
        A[1, 300, 300] = -5.0
        L = hopper_chol.cholesky(A)
        torch.cuda.synchronize()
        nan = [bool(torch.isnan(L[i]).any()) for i in range(3)]
        ref = torch.linalg.cholesky(A[[0, 2]])
        ok = float((L[[0, 2]] - ref).abs().max())
        log(f"[chol] non-PD entry 1 of 3: NaN per entry {nan} | others vs library {ok:.3e}")
        assert nan == [False, True, False], f"NaN in the wrong batch entries: {nan}"
        assert ok <= CHOL_TOL * max(float(ref.abs().max()), 1.0), f"entries beside the non-PD one are off by {ok}"

        # deterministic: one writer per tile and a fixed order of sums
        A = _kron_gram_input()
        same = torch.equal(hopper_chol.cholesky(A), hopper_chol.cholesky(A))
        log(f"[chol] two runs at (2, {N_LOCS}, {N_LOCS}) bit-equal: {same}")
        assert same, "the blocked Cholesky kernel is not deterministic"
        del A

        times = {}
        # (1, 2048, 2048) is 16 panels with little trailing work: the cost
        # of the per-panel chain (diagonal CTA, strip, three launches)
        # (1, 1024, 1024) is the shape of the dense path's coarse evaluations
        for D, n, reps in [(1, DENSE_COARSE_N, 20), (1, 2048, 20), (2, N_LOCS, 20), (1, DENSE_N, 5)]:
            A = _spd_input(D, n)
            plain = lambda: cholesky_plain(A)  # noqa: E731
            kern = lambda: hopper_chol.cholesky(A)  # noqa: E731
            lib = lambda: torch.linalg.cholesky(A)  # noqa: E731
            p, k1, l, k2 = _time_ms(plain, reps), _time_ms(kern, reps), _time_ms(lib, reps), _time_ms(kern, reps)
            k = (k1 + k2) / 2
            bound, by, bound32 = _chol_bound(D, n)
            flops = D * n**3 / 3.0
            log(f"[chol] time ({D}, {n}, {n}): kernel {k:.3f} ms ({k1:.3f}, {k2:.3f}; "
                f"{flops / (k * 1e-3) / 1e12:.2f} TFLOP/s) | plain {p:.3f} ms | library "
                f"(torch.linalg.cholesky) {l:.3f} ms | bound {bound:.3f} ms ({by}; {bound32:.3f} ms at the FP32 "
                f"FMA peak) | kernel/library {k / l:.2f}")
            assert k >= bound, f"({D}, {n}, {n}): kernel time {k} ms is under its bound {bound} ms"
            times[(D, n)] = (k, p, l, bound, by, bound32)
            del A
    return max_abs, times


# ------------------------------------------------------------------
# Phases 8 and 8b: the exact dense path (bench_dense50k.py, one accelerator)
# ------------------------------------------------------------------


@contextlib.contextmanager
def cholesky_seam(fn):
    """Put ``fn`` at the dense path's one factorization seam,
    ``linalg.safe_cholesky``, and restore the library one on the way out."""
    orig = linalg.safe_cholesky
    linalg.safe_cholesky = fn
    try:
        yield
    finally:
        linalg.safe_cholesky = orig


def run_dense_campaign(device, dtype, n=DENSE_N, coarse_n=DENSE_COARSE_N, n_restarts=DENSE_RESTARTS,
                       coarse_iters=DENSE_COARSE_ITERS, polish_iters=DENSE_POLISH_ITERS, grid=GRID,
                       draw_grid=DENSE_DRAW_GRID, n_draws=DENSE_DRAWS, chol=None):
    """The exact dense fit and posterior of bench_dense50k.py's single-device
    run through the port's ops: ``n_restarts`` coarse L-BFGS restarts of
    ``map_neg_logp`` on a ``coarse_n``-row subsample (one after another,
    where the reference maps them) → polish at full N from the coarse winner
    → ``posterior_cache`` → ``predict_diag_chunked`` on a ``grid``² grid →
    ``draw_samples`` at a ``draw_grid``² grid. Grid variances and draws are
    predictive (``with_noise=True``): the noise-free covariance of a dense
    grid plus the default 1e-6 jitter is not positive definite at f32, in
    either package. ``chol`` replaces the factorization at the
    ``linalg.safe_cholesky`` seam for the whole run."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    spec, X, y_np, la, lb, rng = make_dense_problem(n, np_dtype)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    xc, y, la_t, lb_t = t(X), t(y_np), t(la), t(lb)
    xk = torch.zeros((n, 0), dtype=torch.long, device=device)
    u0s = initial_params(spec, la, lb, n_restarts=n_restarts, seed=0, dtype=dtype, device=device)
    subi = np.sort(rng.choice(n, min(coarse_n, n), replace=False))
    sub_t = torch.as_tensor(subi, device=device)
    xc_c, xk_c, y_c = xc[sub_t], xk[sub_t], y[sub_t]
    evals = {"coarse": 0, "polish": 0}

    def counted(stage, x, k, yy):
        def objective(u):
            evals[stage] += 1
            return map_neg_logp(spec, u, x, k, yy, la_t, lb_t)
        return objective

    def grid_points(m):
        g = np.linspace(-2, 2, m).astype(np_dtype)
        G1, G2 = np.meshgrid(g, g, indexing="ij")
        pts = t(np.column_stack([G1.ravel(), G2.ravel()]))
        return pts, torch.zeros((pts.shape[0], 0), dtype=torch.long, device=device)

    with cholesky_seam(chol) if chol is not None else contextlib.nullcontext():
        _sync(device)
        t0 = time.perf_counter()
        u_c, f_c, aux_c = multi_restart_minimize(counted("coarse", xc_c, xk_c, y_c), u0s, maxiter=coarse_iters,
                                                 tol=1e-6)
        _sync(device)
        t1 = time.perf_counter()
        u_best, f_best, polish_n = lbfgs_backtracking_minimize(counted("polish", xc, xk, y), u_c,
                                                               maxiter=polish_iters)
        _sync(device)
        t2 = time.perf_counter()
        params = constrain(u_best)
        with torch.no_grad():
            cache = posterior_cache(spec, params, xc, xk, y)
            _sync(device)
            t3 = time.perf_counter()
            xg, xkg = grid_points(grid)
            mean, var = predict_diag_chunked(spec, params, cache, xg, xkg)
            _sync(device)
            t4 = time.perf_counter()
            xd, xkd = grid_points(draw_grid)
            gen = torch.Generator(device=device).manual_seed(0)
            draws = draw_samples(spec, params, cache, xd, xkd, gen, n_samples=n_draws, with_noise=True)
            _sync(device)
            t5 = time.perf_counter()
    return dict(spec=spec, xc=xc, xk=xk, y=y, la=la, lb=lb, u0s=u0s, subi=subi, u_coarse=u_c,
                f_coarse=float(f_c), aux_c=aux_c, u_best=u_best, f_best=float(f_best), polish_iters=polish_n,
                evals=evals, cache=cache, xg=xg, mean=mean, var=var, xd=xd, draws=draws,
                phases={"coarse_s": t1 - t0, "polish_s": t2 - t1, "cache_s": t3 - t2, "predict_s": t4 - t3,
                        "draw_s": t5 - t4})


def _log_dense(label, r):
    ph = r["phases"]
    log(f"[dense] campaign {label}: coarse {ph['coarse_s']:.3f} s ({len(r['aux_c']['iters'])} restarts @"
        f"{len(r['subi'])}, iters {r['aux_c']['iters'].tolist()}, {r['evals']['coarse']} evaluations, winner "
        f"{r['aux_c']['best_restart']}) | polish {ph['polish_s']:.3f} s ({r['polish_iters']} iterations, "
        f"{r['evals']['polish']} evaluations) | cache {ph['cache_s']:.3f} s | predict {ph['predict_s']:.3f} s "
        f"({r['xg'].shape[0]}-pt grid) | draws {ph['draw_s']:.3f} s ({tuple(r['draws'].shape)}) | total "
        f"{sum(ph.values()):.3f} s")
    log(f"[dense] MAP {label}: ls {constrain(r['u_best'])['ls_total'].tolist()} | f_best {r['f_best']:.4f}")


def _value_and_grad(objective, u):
    leaves = {k: v.detach().requires_grad_(True) for k, v in u.items()}
    value = objective(leaves)
    grads = torch.autograd.grad(value, list(leaves.values()))
    return value.detach(), dict(zip(leaves, grads))


def _time_host(fn, reps):
    """Mean host-clock seconds of ``fn`` over ``reps`` calls after a warm one,
    each ending in a synchronise; and the peak device memory of one call."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps, torch.cuda.max_memory_allocated()


def phase8_dense(breakdown=False):
    """The dense campaign with the library factor, then (counted) with the
    hand factor at the seam; then its checks and timings. ``breakdown`` adds
    the step-by-step times of one value+grad."""
    stock = run_dense_campaign("cuda", torch.float32)
    _log_dense("library factor", stock)
    RbfGram.launches = 0
    BlockedChol.launches = 0
    with count_rbf_shapes("dense") as shapes:
        hand = run_dense_campaign("cuda", torch.float32, chol=hopper_chol.seam_cholesky)
    launches = {"rbf_gram": RbfGram.launches, "blocked_cholesky": BlockedChol.launches}
    _log_dense("hand factor", hand)
    log(f"[dense] main path launches (hand-factor campaign): {launches} | rbf_gram by shape {dict(shapes)}")
    assert sum(shapes.values()) == launches["rbf_gram"], f"shape counts {dict(shapes)} against {launches}"
    assert linalg.safe_cholesky.__module__ == linalg.__name__, "the seam was not restored"
    for name, c in launches.items():
        assert c > 0, f"{name} was launched no time on the dense path"

    n = DENSE_N
    f64 = {}
    for label, r in (("library", stock), ("hand", hand)):
        mean, var, draws = r["mean"], r["var"], r["draws"]
        assert mean.shape == (GRID * GRID,) and var.shape == (GRID * GRID,), (mean.shape, var.shape)
        assert draws.shape == (DENSE_DRAWS, DENSE_DRAW_GRID**2), draws.shape
        assert bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all()) and bool((var >= 0).all())
        assert bool(torch.isfinite(draws).all()), f"{label}: non-finite posterior draws"
        assert np.isfinite(r["f_best"]), f"{label}: the polish never evaluated finite"
        with torch.no_grad():
            u64 = {k: v.double() for k, v in r["u_best"].items()}
            f64[label] = float(map_neg_logp(r["spec"], u64, r["xc"].double(), r["xk"], r["y"].double(),
                                            r["la"], r["lb"]))
        per_pt = abs(r["f_best"] - f64[label]) / n
        log(f"[dense] neg_logp at the {label}-factor fit: f32 {r['f_best']:.4f} | f64 {f64[label]:.4f} | |diff| "
            f"{per_pt:.2e} nats/pt (tol {BASIN_TOL}) | grid mean [{float(mean.min()):.3f}, {float(mean.max()):.3f}] "
            f"var [{float(var.min()):.2e}, {float(var.max()):.2e}]")
        assert per_pt <= BASIN_TOL, f"{label}: f32 and f64 objectives differ by {per_pt} nats/pt"
    between = abs(stock["f_best"] - hand["f_best"]) / n
    dmean = float((stock["mean"] - hand["mean"]).abs().max())
    log(f"[dense] library vs hand fit: |diff| {between:.2e} nats/pt (tol {BASIN_TOL}) | max|dmean| on the grid "
        f"{dmean:.3e}")
    assert between <= BASIN_TOL, f"the two fits differ by {between} nats/pt"

    # what the draws' floor (ops.posterior.draw_floor) moved: the library
    # campaign's draws against the same normal block at the bare jitter
    r = stock
    with torch.no_grad():
        xkd = torch.zeros((r["xd"].shape[0], 0), dtype=torch.long, device="cuda")
        p = constrain(r["u_best"])
        mean_d, cov = predict_cov(r["spec"], p, r["cache"], r["xd"], xkd, with_noise=True)
        floor = float(draw_floor(cov, gram_diag(r["spec"], p, r["xd"], xkd), DEFAULT_JITTER))
        eps = torch.randn(r["draws"].shape, generator=torch.Generator(device="cuda").manual_seed(0),
                          dtype=cov.dtype, device="cuda")
        cov.diagonal().add_(DEFAULT_JITTER)
        bare = mean_d[None, :] + eps @ torch.linalg.cholesky(cov).T
    log(f"[dense] draws' floor {floor:.3e} (jitter {DEFAULT_JITTER}, {r['xd'].shape[0]} points, with noise): max "
        f"|draws - draws at the bare jitter| on the same normal block {float((r['draws'] - bare).abs().max()):.3e} "
        f"(draws' max |value| {float(r['draws'].abs().max()):.3e})")

    # one value+grad of the full-N objective at the fitted point, each factor
    r = stock
    la_t, lb_t = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (r["la"], r["lb"]))
    objective = lambda u: map_neg_logp(r["spec"], u, r["xc"], r["xk"], r["y"], la_t, lb_t)  # noqa: E731
    vg = lambda: _value_and_grad(objective, r["u_best"])  # noqa: E731
    s1, mem_s = _time_host(vg, 3)
    with cholesky_seam(hopper_chol.seam_cholesky):
        h1, mem_h = _time_host(vg, 3)
        h2, _ = _time_host(vg, 3)
    s2, _ = _time_host(vg, 3)
    log(f"[dense] value+grad at the fit, N={n} f32: library factor {(s1 + s2) / 2:.4f} s ({s1:.4f}, {s2:.4f}; "
        f"peak {mem_s / 2**30:.2f} GiB) | hand factor {(h1 + h2) / 2:.4f} s ({h1:.4f}, {h2:.4f}; peak "
        f"{mem_h / 2**30:.2f} GiB)")
    if breakdown:
        _dense_breakdown(r)

    # the probe's other shape: the Kronecker objective at D = 2, N = 5,120
    spec, xc, Y, la, lb = make_problem(N_LOCS, "cuda", torch.float32)
    u0s = initial_params(spec, la, lb, n_restarts=1, seed=0, dtype=torch.float32, device="cuda")
    u0 = {k: v[0] for k, v in u0s.items()}
    kobj = lambda u: kron_neg_logp(spec, u, xc, Y, la, lb)  # noqa: E731

    def kval():
        with torch.no_grad():
            return kobj(u0)

    for label, seam in (("library", None), ("hand", hopper_chol.seam_cholesky)):
        with cholesky_seam(seam) if seam is not None else contextlib.nullcontext():
            tv, _ = _time_host(kval, 10)
            tg, _ = _time_host(lambda: _value_and_grad(kobj, u0), 10)
            f = float(kval())
        log(f"[dense] Kronecker objective D=2 N={N_LOCS}, {label} factor: value {tv * 1e3:.2f} ms | value+grad "
            f"{tg * 1e3:.2f} ms | f={f:.3f}")
    return launches, (s1 + s2) / 2, (h1 + h2) / 2


def _dense_breakdown(r):
    """CUDA-event times of the steps of one f32 value+grad at the fit:
    Gram, factor, the two solves for α, L⁻¹, L⁻ᵀL⁻¹, and the Gram's backward."""
    spec, xc, xk, y = r["spec"], r["xc"], r["xk"], r["y"]
    with torch.no_grad():
        params = constrain(r["u_best"])
        t_gram = _time_ms(lambda: _noisy_gram(spec, params, xc, xk), 3)
        A = _noisy_gram(spec, params, xc, xk)
        t_fac = _time_ms(lambda: linalg.safe_cholesky(A), 3)
        t_hand = _time_ms(lambda: hopper_chol.seam_cholesky(A), 3)
        L = linalg.safe_cholesky(A)
        del A
        t_alpha = _time_ms(lambda: linalg.cho_solve(L, y[:, None]), 3)
        eye = torch.eye(L.shape[0], device="cuda")
        t_linv = _time_ms(lambda: torch.linalg.solve_triangular(L, eye, upper=False), 3)
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        del eye, L
        t_ainv = _time_ms(lambda: Linv.T @ Linv, 3)
        del Linv
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    K = gram(spec, p, xc, xk, xc, xk)
    gbar = torch.ones_like(K)
    t_bwd = _time_ms(lambda: torch.autograd.grad(K, list(p.values()), gbar, retain_graph=True, allow_unused=True), 3)
    log(f"[dense] steps of one value+grad, N={DENSE_N} f32 (CUDA events, mean of 3): Gram+noise {t_gram:.2f} ms | "
        f"factor: library {t_fac:.2f} ms, hand {t_hand:.2f} ms | alpha (two solves) {t_alpha:.2f} ms | "
        f"L^-1 (triangular solve of I) {t_linv:.2f} ms | L^-T L^-1 {t_ainv:.2f} ms | Gram backward {t_bwd:.2f} ms")


def phase8b_blocked_backward():
    """One f64 value+grad of the dense and of the blocked-backward objective
    at N = 16,384 (bench_dense50k.py's BENCH_DTYPE=float64 BENCH_FACT_ONLY=1)."""
    spec, X, y_np, la, lb, _ = make_dense_problem(DENSE_N, np.float64)
    xc, y = torch.as_tensor(X, device="cuda"), torch.as_tensor(y_np, device="cuda")
    xk = torch.zeros((DENSE_N, 0), dtype=torch.long, device="cuda")
    u0s = initial_params(spec, la, lb, n_restarts=DENSE_RESTARTS, seed=0, dtype=torch.float64, device="cuda")
    u0 = {k: v[0] for k, v in u0s.items()}
    out = {}
    for label, fn in (("dense", map_neg_logp), ("blocked", map_neg_logp_blocked)):
        objective = lambda u: fn(spec, u, xc, xk, y, la, lb)  # noqa: E731,B023
        secs, peak = _time_host(lambda: out.__setitem__(label, _value_and_grad(objective, u0)), 1)  # noqa: B023
        log(f"[dense] f64 value+grad N={DENSE_N}, {label} backward: {secs:.4f} s | peak memory "
            f"{peak / 2**30:.2f} GiB | value {float(out[label][0]):.6f}")
        out[label + "_s"], out[label + "_peak"] = secs, peak
    (vd, gd), (vb, gb) = out["dense"], out["blocked"]
    rel_v = abs(float(vd) - float(vb)) / abs(float(vd))
    rel_g = max(float(((gd[k] - gb[k]).abs() / gd[k].abs().clamp_min(1e-300)).max()) for k in gd)
    log(f"[dense] dense vs blocked f64: value rel diff {rel_v:.3e} | gradient max rel diff {rel_g:.3e} (rtol 1e-9) | "
        f"grad {[(k, v.tolist()) for k, v in gd.items()]}")
    assert np.isfinite(float(vd)) and rel_v <= 1e-9 and rel_g <= 1e-9, "dense and blocked f64 value+grad disagree"
    return out


# ------------------------------------------------------------------
# Phases 9-11: the sparse regressor and both Laplace classifiers
# ------------------------------------------------------------------

FITC_RESTARTS, FITC_MAXITER = 8, 60  # bench_fitc50k.py's restarts and maxiter
LAPLACE_N, LAPLACE_BIG_N, N_LATENT_DRAWS = 2048, 16_384, 4


def _peak_reset(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak_gib(device):
    return torch.cuda.max_memory_allocated() / 2**30 if torch.device(device).type == "cuda" else None


def _line_truth(p):
    """The noise-free surface on the 200-point line: sin(1.3·x₀)·cos(0)."""
    return np.sin(1.3 * p["g"].astype(np.float64))


def run_fitc_campaign(p, device, dtype, n_restarts=FITC_RESTARTS, maxiter=FITC_MAXITER):
    """bench_fitc50k.py's fit and predict through the port's ops: ``initial_params``
    (seed 0), ``multi_restart_minimize`` on ``fitc_neg_logp`` (restarts one after
    another, tol 1e-6), then ``fitc_predict`` (with noise) on the 200-point line.
    Returns results, stage times, evaluations per restart and launches."""
    spec = fitc_spec()
    la_t, lb_t = (torch.as_tensor(a, dtype=dtype, device=device) for a in (p["la"], p["lb"]))
    u0s = initial_params(spec, p["la"], p["lb"], n_restarts=n_restarts, seed=0, dtype=dtype, device=device)
    evals = []

    def objective(u):
        evals[-1] += 1
        return fitc_neg_logp(spec, u, p["xc"], p["xk"], p["xu_c"], p["xu_k"], p["y"], la_t, lb_t)

    def runner(u0):
        evals.append(0)
        return lbfgs_backtracking_minimize(objective, u0, maxiter=maxiter, ftol=1e-6)

    before = RbfGram.launches
    _peak_reset(device)
    _sync(device)
    t0 = time.perf_counter()
    u_best, f_best, aux = multi_restart_minimize(None, u0s, runner=runner)
    _sync(device)
    t1 = time.perf_counter()
    fit_launches = RbfGram.launches - before
    params = constrain(u_best)
    with torch.no_grad():
        mean, var = fitc_predict(spec, params, p["xc"], p["xk"], p["xu_c"], p["xu_k"], p["y"], p["line"], p["line_k"])
    _sync(device)
    t2 = time.perf_counter()
    rmse = float(np.sqrt(np.mean((mean.double().cpu().numpy() - _line_truth(p)) ** 2)))
    return dict(spec=spec, la=la_t, lb=lb_t, u0s=u0s, u_best=u_best, f_best=float(f_best), aux=aux, evals=evals,
                mean=mean, var=var, rmse=rmse, peak_gib=_peak_gib(device),
                launches={"fit": fit_launches, "predict": RbfGram.launches - before - fit_launches},
                phases={"fit_s": t1 - t0, "predict_s": t2 - t1})


def _accuracy(p, prob):
    """Share of the line where the predicted class (prob > 0.5) is the
    noise-free surface's sign."""
    return float(np.mean((prob.double().cpu().numpy() > 0.5) == (_line_truth(p) > 0)))


def run_classifier_campaign(p, device, dtype, sparse, n_restarts=FITC_RESTARTS, maxiter=FITC_MAXITER,
                            n_draws=N_LATENT_DRAWS):
    """A classifier on ``p``'s rows with labels 1[y > 0]: ``fit_fitc_laplace_map``
    on its inducing points (``sparse``) or ``fit_laplace_map`` (``initial_params``
    seed 0), then the matching predict and ``n_draws`` latent draws
    (generator seed 0) on the line."""
    spec = fitc_spec("bernoulli")
    u0s = initial_params(spec, p["la"], p["lb"], n_restarts=n_restarts, seed=0, dtype=dtype, device=device)
    data = (p["xc"], p["xk"], p["xu_c"], p["xu_k"]) if sparse else (p["xc"], p["xk"])
    fit = fit_fitc_laplace_map if sparse else fit_laplace_map
    predict, draw = ((fitc_laplace_predict, fitc_laplace_draw_latent) if sparse
                     else (laplace_predict, laplace_draw_latent))
    before = RbfGram.launches
    _peak_reset(device)
    _sync(device)
    t0 = time.perf_counter()
    u_best, f_best, aux = fit(spec, *data, p["yb"], p["la"], p["lb"], u0s, maxiter=maxiter, device=device)
    _sync(device)
    t1 = time.perf_counter()
    fit_launches = RbfGram.launches - before
    with torch.no_grad():
        args = (spec, constrain(u_best), *data, p["yb"], p["line"], p["line_k"])
        mean, var, prob = predict(*args)
        _sync(device)
        t2 = time.perf_counter()
        draws = draw(*args, torch.Generator(device=device).manual_seed(0), n_samples=n_draws)
        _sync(device)
        t3 = time.perf_counter()
    return dict(spec=spec, u0s=u0s, u_best=u_best, f_best=float(f_best), aux=aux, mean=mean, var=var, prob=prob,
                draws=draws, accuracy=_accuracy(p, prob), peak_gib=_peak_gib(device),
                launches={"fit": fit_launches, "predict": RbfGram.launches - before - fit_launches},
                phases={"fit_s": t1 - t0, "predict_s": t2 - t1, "draw_s": t3 - t2})


def _f64_gap(fn, r, n):
    """(f32 value at the fit, f64 value there on the plain path, nats/point
    apart): ``fn(u, dtype)`` evaluates the objective at the model dtype given."""
    with torch.no_grad():
        f32 = float(fn(r["u_best"], torch.float32))
        f64 = float(fn({k: v.double() for k, v in r["u_best"].items()}, torch.float64))
    return f32, f64, abs(f32 - f64) / n


def _log_fit(tag, r, n_evals):
    aux = r["aux"]
    ph = " | ".join(f"{k[:-2]} {v:.3f} s" for k, v in r["phases"].items())
    log(f"[{tag}] {ph} | {len(aux['iters'])} restarts, iterations {aux['iters'].tolist()}, evaluations "
        f"{n_evals} | values {[round(float(v), 4) for v in aux['all_values']]} (winner {aux['best_restart']}) | "
        f"ls {constrain(r['u_best'])['ls_total'].tolist()} eta {float(constrain(r['u_best'])['η_total']):.4f} | "
        f"peak {r['peak_gib']:.2f} GiB")


def _eval_breakdown(tag, objective, u):
    """Host seconds of one value+grad and of one value at ``u`` (mean of 3
    after a warm call), peak memory of the value+grad, and from one
    torch.profiler pass of it the device time (sum over its CUDA kernels and
    copies) with the four largest names: how much of the call the card is
    busy, and with what."""
    def value():
        with torch.no_grad():
            return objective(u)

    vg_s, peak = _time_host(lambda: _value_and_grad(objective, u), 3)
    v_s, _ = _time_host(value, 3)
    ops = _profile_kernels(lambda: _value_and_grad(objective, u), 1)
    by_name = collections.Counter()
    for name, us in ops:
        by_name[name[:48]] += us / 1e3
    busy = sum(by_name.values())
    top = ", ".join(f"{k} {v:.2f} ms" for k, v in by_name.most_common(4))
    log(f"[{tag}] at the fit: value+grad {vg_s * 1e3:.2f} ms (peak {peak / 2**30:.2f} GiB) | value "
        f"{v_s * 1e3:.2f} ms | device busy {busy:.2f} ms of the value+grad in {len(ops)} ops ({busy / (vg_s * 1e3):.0%}) | top: {top}")
    return vg_s, v_s


def phase9_fitc():
    """bench_fitc50k.py's problem: k-means, fit (8 restarts, maxiter 60) and the
    200-point predict at f32, after one untimed value+grad at the first start;
    the f32 objective at the fit against f64 on the plain path."""
    p = make_fitc_problem(FITC_N, "cuda", torch.float32)
    log(f"[fitc] N={FITC_N} M={FITC_NU}: k-means {p['kmeans_s']:.3f} s on the host ({FITC_KMEANS_ROWS} rows, "
        f"{FITC_KMEANS_ITERS} iterations) | ls prior alpha {p['la'].tolist()} beta {p['lb'].tolist()}")
    spec = fitc_spec()
    warm = initial_params(spec, p["la"], p["lb"], n_restarts=1, seed=0, dtype=torch.float32, device="cuda")
    la_t, lb_t = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (p["la"], p["lb"]))
    _value_and_grad(lambda u: fitc_neg_logp(spec, u, p["xc"], p["xk"], p["xu_c"], p["xu_k"], p["y"], la_t, lb_t),
                    {k: v[0] for k, v in warm.items()})
    RbfGram.launches = 0
    with count_rbf_shapes("fitc") as shapes:
        r = run_fitc_campaign(p, "cuda", torch.float32)
    launches = RbfGram.launches
    _log_fit("fitc", r, r["evals"])
    log(f"[fitc] rbf_gram launches {launches} (fit {r['launches']['fit']}, predict {r['launches']['predict']}) | "
        f"by shape {dict(shapes)}")

    def objective(u, dtype):
        q = problem_at(p, dtype)
        return fitc_neg_logp(spec, u, q["xc"], q["xk"], q["xu_c"], q["xu_k"], q["y"], r["la"].to(dtype),
                             r["lb"].to(dtype))

    f32, f64, per_pt = _f64_gap(objective, r, FITC_N)
    _eval_breakdown("fitc", lambda u: objective(u, torch.float32), r["u_best"])
    mean, var = r["mean"], r["var"]
    log(f"[fitc] neg_logp at fit: f32 {f32:.4f} (fit {r['f_best']:.4f}) | f64 {f64:.4f} | |diff| {per_pt:.2e} "
        f"nats/pt (tol {BASIN_TOL}) | line RMSE vs truth {r['rmse']:.4f} | mean [{float(mean.min()):.3f}, "
        f"{float(mean.max()):.3f}] var [{float(var.min()):.2e}, {float(var.max()):.2e}]")
    assert sum(shapes.values()) == launches > 0, f"rbf_gram launches on the FITC path: {launches}, {dict(shapes)}"
    assert r["launches"]["predict"] > 0, "the FITC predict never launched rbf_gram"
    assert mean.shape == (FITC_LINE,) and var.shape == (FITC_LINE,), (mean.shape, var.shape)
    assert bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all()) and bool((var >= 0).all())
    assert per_pt <= BASIN_TOL, f"FITC: f32 and f64 objectives differ by {per_pt} nats/pt"
    return p, launches


def _check_classifier(label, r, launches, shapes, per_pt):
    """Every launch counted by shape, the kernel launched in fit and predict,
    finite line outputs and draws of the right shape, and the f32 objective
    at the fit within the basin tolerance of f64."""
    assert sum(shapes.values()) == launches > 0, f"rbf_gram launches on the {label} path: {launches}"
    assert r["launches"]["predict"] > 0, f"the {label} predict never launched rbf_gram"
    for name in ("mean", "var", "prob"):
        assert r[name].shape == (FITC_LINE,) and bool(torch.isfinite(r[name]).all()), f"{label} {name}"
    assert r["draws"].shape == (N_LATENT_DRAWS, FITC_LINE) and bool(torch.isfinite(r["draws"]).all()), \
        f"{label}: latent draws not finite"
    assert per_pt <= BASIN_TOL, f"{label}: f32 and f64 objectives differ by {per_pt} nats/pt"


def phase10_fitc_laplace(p):
    """The sparse classifier at N = 50,000 on phase 9's rows and inducing
    points: fit (8 restarts, maxiter 60), predict, 4 latent draws at f32,
    after one untimed value+grad at the first start; f32 against f64 at the
    fit and the line's accuracy."""
    spec = fitc_spec("bernoulli")
    warm = initial_params(spec, p["la"], p["lb"], n_restarts=1, seed=0, dtype=torch.float32, device="cuda")
    la_t, lb_t = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (p["la"], p["lb"]))
    _value_and_grad(lambda u: fitc_laplace_neg_logp(spec, u, p["xc"], p["xk"], p["xu_c"], p["xu_k"], p["yb"], la_t,
                                                    lb_t), {k: v[0] for k, v in warm.items()})
    RbfGram.launches = 0
    with count_rbf_shapes("fitc_laplace") as shapes:
        r = run_classifier_campaign(p, "cuda", torch.float32, sparse=True)
    launches = RbfGram.launches
    evals = r["launches"]["fit"] // 2  # an evaluation makes two Grams: Kuu and the (N, M) Kfu
    _log_fit("fitc_laplace", r, f"{evals} (two Grams each)")
    log(f"[fitc_laplace] rbf_gram launches {launches} (fit {r['launches']['fit']}, predict + draws "
        f"{r['launches']['predict']}) | by shape {dict(shapes)}")

    def objective(u, dtype):
        q = problem_at(p, dtype)
        return fitc_laplace_neg_logp(spec, u, q["xc"], q["xk"], q["xu_c"], q["xu_k"], q["yb"],
                                     torch.as_tensor(p["la"], dtype=dtype, device="cuda"),
                                     torch.as_tensor(p["lb"], dtype=dtype, device="cuda"))

    f32, f64, per_pt = _f64_gap(objective, r, FITC_N)
    _eval_breakdown("fitc_laplace", lambda u: objective(u, torch.float32), r["u_best"])
    log(f"[fitc_laplace] neg_logp at fit: f32 {f32:.4f} (fit {r['f_best']:.4f}) | f64 {f64:.4f} | |diff| "
        f"{per_pt:.2e} nats/pt (tol {BASIN_TOL}) | line accuracy vs the noise-free sign {r['accuracy']:.3f} | "
        f"prob [{float(r['prob'].min()):.3f}, {float(r['prob'].max()):.3f}] | draws {tuple(r['draws'].shape)}")
    _check_classifier("FITC-Laplace", r, launches, shapes, per_pt)
    return launches, r["accuracy"]


LAPLACE_FD_H = 1e-2  # central-difference step in the unconstrained parameters
# |grad − FD of the f32 value| ≤ tol·max(|FD|, 1). The FD's error: f32
# rounding of a ~400-nat value (~2.4e-5 each) over 2h, ~2e-3 absolute at
# worst, plus O(h²) truncation; against gradients of ~100 that is ~2e-5
# relative. Measured 6.15e-5 on one H100 (PERF.md §6).
LAPLACE_FD_TOL = 1e-3
LAPLACE_F64_GRAD_RTOL = 1e-3  # f32 gradient against the f64 one, relative to the largest entry


def phase11_laplace():
    """The dense classifier: a campaign at N = 2,048 (seed 1; fit, predict,
    4 draws, f32, after one untimed value+grad), its Function gradient
    against central differences of the f32 value and against the f64
    gradient at the first start, and one timed value+grad at N = 16,384."""
    p = make_fitc_problem(LAPLACE_N, "cuda", torch.float32, seed=1, kmeans=False)
    spec = fitc_spec("bernoulli")
    u0s = initial_params(spec, p["la"], p["lb"], n_restarts=1, seed=0, dtype=torch.float32, device="cuda")
    u0 = {k: v[0] for k, v in u0s.items()}

    def objective_at(q, dtype):
        la_t, lb_t = (torch.as_tensor(a, dtype=dtype, device="cuda") for a in (q["la"], q["lb"]))
        return lambda u: laplace_neg_logp(spec, u, q["xc"], q["xk"], q["yb"], la_t, lb_t)

    obj32 = objective_at(p, torch.float32)
    _value_and_grad(obj32, u0)
    RbfGram.launches = 0
    with count_rbf_shapes("laplace") as shapes:
        r = run_classifier_campaign(p, "cuda", torch.float32, sparse=False)
    launches = RbfGram.launches
    _log_fit("laplace", r, f"{r['launches']['fit']} (one Gram each)")
    log(f"[laplace] rbf_gram launches {launches} (fit {r['launches']['fit']}, predict + draws "
        f"{r['launches']['predict']}) | by shape {dict(shapes)}")
    f32, f64, per_pt = _f64_gap(lambda u, dt: objective_at(problem_at(p, dt), dt)(u), r, LAPLACE_N)
    _eval_breakdown("laplace", obj32, r["u_best"])
    log(f"[laplace] neg_logp at fit: f32 {f32:.4f} (fit {r['f_best']:.4f}) | f64 {f64:.4f} | |diff| {per_pt:.2e} "
        f"nats/pt (tol {BASIN_TOL}) | line accuracy {r['accuracy']:.3f} | draws {tuple(r['draws'].shape)}")
    _check_classifier("Laplace", r, launches, shapes, per_pt)

    # the Function's gradient at the first start: central differences of the
    # f32 value along each coordinate, and the f64 gradient
    v32, g32 = _value_and_grad(obj32, u0)
    _, g64 = _value_and_grad(objective_at(problem_at(p, torch.float64), torch.float64),
                             {k: v.double() for k, v in u0.items()})
    worst_fd, worst_64 = 0.0, 0.0
    for k, v in u0.items():
        flat = v.reshape(-1)
        for i in range(flat.numel()):
            vals = []
            for s in (1.0, -1.0):
                u = {kk: vv.clone() for kk, vv in u0.items()}
                u[k].reshape(-1)[i] += s * LAPLACE_FD_H
                with torch.no_grad():
                    vals.append(float(obj32(u)))
            fd = (vals[0] - vals[1]) / (2 * LAPLACE_FD_H)
            g = float(g32[k].reshape(-1)[i])
            worst_fd = max(worst_fd, abs(g - fd) / max(abs(fd), 1.0))
            log(f"[laplace] d/d{k}[{i}] at start 0: Function f32 {g:.5f} | central difference (h {LAPLACE_FD_H}) "
                f"{fd:.5f} | Function f64 {float(g64[k].reshape(-1)[i]):.5f}")
    scale = max(float(x.abs().max()) for x in g64.values())
    worst_64 = max(float((g32[k].double() - g64[k]).abs().max()) for k in g64) / scale
    log(f"[laplace] gradient checks: max |f32 - FD|/max(|FD|, 1) {worst_fd:.2e} (tol {LAPLACE_FD_TOL}) | "
        f"max |f32 - f64|/max|f64| {worst_64:.2e} (tol {LAPLACE_F64_GRAD_RTOL})")
    assert worst_fd <= LAPLACE_FD_TOL, f"Laplace Function gradient off the f32 central difference: {worst_fd}"
    assert worst_64 <= LAPLACE_F64_GRAD_RTOL, f"Laplace f32 gradient off the f64 one: {worst_64}"

    # one value+grad at the dense regression path's size, at the fitted point
    big = make_fitc_problem(LAPLACE_BIG_N, "cuda", torch.float32, seed=1, kmeans=False)
    obj_big = objective_at(big, torch.float32)
    out = {}
    secs, peak = _time_host(lambda: out.__setitem__("vg", _value_and_grad(obj_big, r["u_best"])), 1)
    value, grad = out["vg"]
    log(f"[laplace] value+grad N={LAPLACE_BIG_N} f32 at the N={LAPLACE_N} fit: {secs:.4f} s | peak {peak / 2**30:.2f} "
        f"GiB | value {float(value):.4f} | grad {[(k, v.tolist()) for k, v in grad.items()]}")
    assert np.isfinite(float(value)) and all(bool(torch.isfinite(v).all()) for v in grad.values()), \
        "the N = 16,384 Laplace value+grad is not finite"
    return launches, secs, peak, p, r


# ------------------------------------------------------------------
# Phases 12-14: BO's acquisitions and the full-Bayes samplers
# ------------------------------------------------------------------

BO_N, BO_INDEP_N, BO_FIT_RESTARTS = 512, 256, 8
# GP.propose's defaults (gumbi_tpu/models/gp.py:1785-1800): q, restarts, raw
# q-batches, MC base samples, L-BFGS iterations, baseline rows
BO_Q, BO_NUM_RESTARTS, BO_RAW, BO_MC, BO_MAXITER, BO_BASELINE = 4, 10, 512, 256, 100, 64
# |f32 − f64 (plain path)| of the acquisition at the candidate, in log units,
# per run: about twice each run's reading on one H100 (8.14e-4, 1.76e-4,
# 3.38e-4; PERF.md §6), and no more than 1e-3. What 12a keeps is the f32
# cross-Gram's rounding, which the mean's sum Ks·α amplifies: with Ks in f64
# as well the gap is 1.1e-6 (tools/probe_sampler_precision.py).
ACQ_F64_TOL = {"qLogNEI q=4": 1e-3, "qLogNEHVI-2d q=2": 4e-4, "qLogNEHVI-MC q=1 (3 outputs)": 7e-4}
# The best raw value comes from the batched sweep and the optimum from
# single-block evaluations of the same function, which at f32 may differ in
# their last bits (values are O(1) in log units).
ACQ_RAW_TOL = 1e-4
# GP.sample's defaults (gp.py:1502-1540)
CHEES_CHAINS, CHEES_TUNE, CHEES_DRAWS, CHEES_TARGET, CHEES_MAX_LEAP = 16, 500, 500, 0.75, 256
# phase 13's ops-level ChEES, cut from the defaults for time: phase 16 runs
# GP.sample() at the defaults through the model layer on the same problem
CHEES_OPS_TUNE, CHEES_OPS_DRAWS = 100, 100
# sampler='hmc' at its defaults but tune/draws, cut from 500/500 to 50/50 for time (PERF.md §4): at 100/100
# phases 13 and 16 took 106 s and 191 s on a slow host, most of it HMC and ChEES
HMC_CHAINS, HMC_TUNE, HMC_DRAWS, HMC_LEAP, HMC_TARGET = 2, 50, 50, 32, 0.8
LS_MEDIAN_RTOL = 0.35  # tests/test_extras.py's ChEES-against-HMC median rule
CHEES_ACCEPT = (0.5, 0.95)
HMC_MIN_ACCEPT = 0.5  # the chains move: a stalled chain's medians equal its start and would pass the median rule
# GPC.sample(latent=True)'s defaults (gpc.py:206-275) and predict_proba's max_draws (gpc.py:398)
# phase 14's ops-level ESS, cut from GPC.sample's 500 + 500 for time: phase 19
# (b) runs GPC.sample(latent=True) at the defaults on the same problem
ESS_CHAINS, ESS_TUNE, ESS_DRAWS, ESS_SWEEPS, ESS_TARGET, ESS_PROBA_DRAWS = 2, 100, 100, 4, 0.3, 64
ESS_ACCEPT = (0.1, 0.6)
ESS_ACC_SLACK = 0.05  # line accuracy at most this far below phase 11's Laplace accuracy


def _bo_surface(X, j):
    """Output j ≥ 1 of the BO problems beside make_dense_problem's y:
    sin(1.3·x₀ + 0.8·j)·cos(0.9·x₁ − 0.5·j) + N(0, 0.1) from default_rng(j)."""
    noise = np.random.default_rng(j).normal(0, 0.1, X.shape[0])
    return (np.sin(1.3 * X[:, 0] + 0.8 * j) * np.cos(0.9 * X[:, 1] - 0.5 * j) + noise).astype(X.dtype)


def _fit_and_cache(spec, X, xk, y, la, lb):
    """fit_gp_map (8 restarts from initial_params seed 0, f32 on the card);
    returns the fitted parameters, ``state(dtype)`` (those parameters and
    their posterior cache at f32, the hand kernel, or f64, the plain path)
    and the fit's aux."""
    u0s = initial_params(spec, la, lb, n_restarts=BO_FIT_RESTARTS, seed=0, dtype=torch.float32, device="cuda")
    params, _, aux = fit_gp_map(spec, X, xk, y, la, lb, u0s, device="cuda")

    def state(dtype):
        t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")  # noqa: E731
        p = {k: v.to(dtype) for k, v in params.items()}
        with torch.no_grad():
            return p, posterior_cache(spec, p, t(X), torch.as_tensor(xk, device="cuda").long(), t(y))

    return params, state, aux


def _bo_rows(n, d_out):
    """Output-major level column: n rows of each output."""
    return torch.as_tensor(np.repeat(np.arange(d_out), n).reshape(-1, 1), device="cuda")


def _bo_run(label, acq32, acq64, optimize, X_raw, lo, hi):
    """One acquisition campaign: the raw sweep timed alone (a warm call on the
    same starts), then, with the launch counts at 0, the whole optimize (raw
    sweep, top-k, L-BFGS restarts); checks the candidate, its value and the
    f32 value against the f64 plain path at the candidate (the run's
    ACQ_F64_TOL)."""
    with torch.no_grad():
        raw_sweep(acq32, X_raw[:16])
    _sync("cuda")
    t0 = time.perf_counter()
    raw_vals = raw_sweep(acq32, X_raw)
    _sync("cuda")
    raw_s = time.perf_counter() - t0
    RbfGram.launches = 0
    before = collections.Counter(RBF_SHAPES.get("bo", {}))
    with count_rbf_shapes("bo") as shapes:
        t1 = time.perf_counter()
        x, value, aux = optimize()
        _sync("cuda")
        total_s = time.perf_counter() - t1
    launches = RbfGram.launches
    by_shape = dict(collections.Counter(shapes) - before)
    value = float(value)
    best_raw = float(aux["raw_values"].max())
    with torch.no_grad():
        v32, v64 = float(acq32(x)), float(acq64(x.double()))
    tol = ACQ_F64_TOL[label]
    log(f"[bo] {label}: raw sweep {raw_s:.3f} s ({X_raw.shape[0]} q-batches, alone) | optimize {total_s:.3f} s "
        f"(sweep + restarts; restarts ~{total_s - raw_s:.3f} s) | L-BFGS iterations per restart "
        f"{aux['iters'].tolist()} | value {value:.6f} (best raw {best_raw:.6f}) | at the candidate f32 {v32:.6f} "
        f"f64 {v64:.6f} |diff| {abs(v32 - v64):.2e} (tol {tol}) | candidates {x.tolist()} | rbf_gram launches "
        f"{launches} by shape {by_shape}")
    assert bool(torch.isfinite(raw_vals).all()) and bool(torch.isfinite(aux["raw_values"]).all()), \
        f"{label}: non-finite raw acquisition values"
    assert bool(((x >= lo) & (x <= hi)).all()), f"{label}: candidates outside the box"
    assert np.isfinite(value) and value >= best_raw - ACQ_RAW_TOL, f"{label}: value {value} below best raw {best_raw}"
    assert abs(v32 - v64) <= tol, f"{label}: f32 and f64 acquisition differ by {abs(v32 - v64)}"
    assert launches > 0 and sum(by_shape.values()) == launches, f"{label}: rbf_gram launches {launches}"
    return dict(label=label, raw_s=raw_s, total_s=total_s, iters=aux["iters"].tolist(), value=value,
                launches=launches, by_shape=by_shape, x=x)


def phase12_bo():
    """GP.propose's ops path at its defaults, three runs: qLogNEI (q = 4) on
    make_dense_problem at N = 512; qLogNEHVI (q = 2) on a 2-output Hadamard
    LMC over the same locations; QMC-box qLogNEHVI (q = 1) over three
    Independent fits at N = 256."""
    f32 = dict(dtype=torch.float32, device="cuda")
    zeros = lambda k: torch.zeros((k, 0), dtype=torch.long, device="cuda")  # noqa: E731
    spec, X, y, la, lb, _ = make_dense_problem(BO_N, np.float32)
    lo, hi = torch.as_tensor(X.min(0), **f32), torch.as_tensor(X.max(0), **f32)
    base = X[np.random.default_rng(0).choice(BO_N, BO_BASELINE, replace=False)]
    runs = []

    # (a) qLogNEI, one output
    t0 = time.perf_counter()
    params, state, fit_aux = _fit_and_cache(spec, X, np.zeros((BO_N, 0)), y, la, lb)
    log(f"[bo] qLogNEI fit N={BO_N}: {time.perf_counter() - t0:.3f} s, iterations {fit_aux['iters'].tolist()}, "
        f"ls {params['ls_total'].tolist()} eta {float(params['η_total']):.4f} sigma {float(params['σ']):.4f}")

    def nei(dtype):
        p, c = state(dtype)
        xb = torch.as_tensor(base, dtype=dtype, device="cuda")
        bs = torch.as_tensor(sobol_normal(BO_MC, BO_Q + BO_BASELINE, seed=0), dtype=dtype, device="cuda")
        args = (p, c, zeros(BO_Q), xb, zeros(BO_BASELINE), bs)
        return (lambda Xc: qlog_nei(spec, *args[:2], Xc, *args[2:])), args

    acq32, args32 = nei(torch.float32)
    acq64, _ = nei(torch.float64)
    X_raw = torch.as_tensor(sobol_uniform(BO_RAW * BO_Q, 2, seed=0).reshape(BO_RAW, BO_Q, 2), **f32) * (hi - lo) + lo
    runs.append(_bo_run("qLogNEI q=4", acq32, acq64, lambda: optimize_qlog_nei(
        spec, *args32, X_raw, lo, hi, num_restarts=BO_NUM_RESTARTS, maxiter=BO_MAXITER, return_aux=True),
        X_raw, lo, hi))
    dense = dict(spec=spec, X=X, y=y, la=la, lb=lb, params=params)

    # (b) qLogNEHVI, 2 outputs: a Hadamard LMC (rank-1 coregion over the output column)
    cg = CoregTerm(name="Parameter", col=0, d_out=2, rank=1)
    spec2 = GPSpec(terms=(GPTerm(suffix="total", kernel="ExpQuad", coregs=(cg,)),), d_cont=2, ard=True)
    ys = [y, _bo_surface(X, 1)]
    t0 = time.perf_counter()
    params2, state2, fit_aux = _fit_and_cache(spec2, np.concatenate([X, X]), np.repeat([0, 1], BO_N)[:, None],
                                              np.concatenate(ys), la, lb)
    log(f"[bo] qLogNEHVI-2d fit N={2 * BO_N} (2 outputs): {time.perf_counter() - t0:.3f} s, iterations "
        f"{fit_aux['iters'].tolist()}")
    q2 = 2
    ref2 = [float(h.min()) - 1e-3 for h in ys]

    def nehvi2(dtype):
        p, c = state2(dtype)
        xb = torch.as_tensor(np.concatenate([base, base]), dtype=dtype, device="cuda")
        bs = torch.as_tensor(sobol_normal(BO_MC, 2 * (q2 + BO_BASELINE), seed=0), dtype=dtype, device="cuda")
        return lambda Xc: qlog_nehvi_2d(spec2, p, c, torch.cat([Xc, Xc], -2), _bo_rows(q2, 2), xb,
                                        _bo_rows(BO_BASELINE, 2), bs, ref2)

    acq32 = nehvi2(torch.float32)
    X_raw = torch.as_tensor(sobol_uniform(BO_RAW * q2, 2, seed=0).reshape(BO_RAW, q2, 2), **f32) * (hi - lo) + lo
    runs.append(_bo_run("qLogNEHVI-2d q=2", acq32, nehvi2(torch.float64), lambda: optimize_acqf(
        acq32, (lo, hi), q=q2, num_restarts=BO_NUM_RESTARTS, raw_samples=BO_RAW, seed=0, maxiter=BO_MAXITER,
        return_aux=True), X_raw, lo, hi))

    # (c) qLogNEHVI by QMC-box integration, 3 outputs from three Independent fits
    spec3, X3, _, la3, lb3, _ = make_dense_problem(BO_INDEP_N, np.float32)
    ys3 = [make_dense_problem(BO_INDEP_N, np.float32)[2]] + [_bo_surface(X3, j) for j in (1, 2)]
    t0 = time.perf_counter()
    fits = [_fit_and_cache(spec3, X3, np.zeros((BO_INDEP_N, 0)), yj, la3, lb3) for yj in ys3]
    log(f"[bo] qLogNEHVI-MC fits: 3 x N={BO_INDEP_N}, {time.perf_counter() - t0:.3f} s")
    lo3, hi3 = torch.as_tensor(X3.min(0), **f32), torch.as_tensor(X3.max(0), **f32)
    base3 = X3[np.random.default_rng(0).choice(BO_INDEP_N, BO_BASELINE, replace=False)]
    ref3 = [float(h.min()) - 1e-3 for h in ys3]

    def nehvi_mc(dtype):
        states = [f[1](dtype) for f in fits]
        fn = make_indep_sample_fn(spec3, [s_[0] for s_ in states], [s_[1] for s_ in states], out_col_idx=0)
        xb = torch.as_tensor(np.concatenate([base3] * 3), dtype=dtype, device="cuda")
        bs = torch.as_tensor(sobol_normal(BO_MC, 3 * (1 + BO_BASELINE), seed=0), dtype=dtype, device="cuda")
        u_box = torch.as_tensor(sobol_uniform(512, 3, seed=1), dtype=dtype, device="cuda")
        return lambda Xc: qlog_nehvi_mc(spec3, None, None, torch.cat([Xc] * 3, -2), _bo_rows(1, 3), xb,
                                        _bo_rows(BO_BASELINE, 3), bs, ref3, u_box, 3, sample_fn=fn)

    acq32 = nehvi_mc(torch.float32)
    X_raw = torch.as_tensor(sobol_uniform(BO_RAW, 2, seed=0).reshape(BO_RAW, 1, 2), **f32) * (hi3 - lo3) + lo3
    runs.append(_bo_run("qLogNEHVI-MC q=1 (3 outputs)", acq32, nehvi_mc(torch.float64), lambda: optimize_acqf(
        acq32, (lo3, hi3), q=1, num_restarts=BO_NUM_RESTARTS, raw_samples=BO_RAW, seed=0, maxiter=BO_MAXITER,
        return_aux=True), X_raw, lo3, hi3))
    return runs, dense


def _draws_finite(samples):
    return all(bool(torch.isfinite(v).all()) for v in samples.values())


def _natural_median(samples):
    """Each parameter's median over chains and draws, in natural space (numpy)."""
    return {k: np.median(v.double().cpu().numpy().reshape(-1, *v.shape[2:]), axis=0)
            for k, v in constrain(samples).items()}


def phase13_samplers(dense):
    """GP.sample's ops path on phase 12a's problem and MAP fit: ChEES (16
    chains batched, tune 100, draws 100), then fixed-length HMC (2 chains,
    32 leapfrog steps, tune/draws 50/50), both on the chain-batched exact
    objective; checks, and one batched 16-chain value+grad timed with each
    factor at the seam."""
    spec, la, lb = dense["spec"], dense["la"], dense["lb"]
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")  # noqa: E731
    xc, y, la_t, lb_t = t(dense["X"]), t(dense["y"]), t(la), t(lb)
    xk = torch.zeros((BO_N, 0), dtype=torch.long, device="cuda")
    calls = [0]

    def logp(u):
        calls[0] += 1
        return -map_neg_logp_chains(spec, u, xc, xk, y, la_t, lb_t)

    q0 = unconstrain(dense["params"])
    out = {}
    for name, sampler, kw in (
        ("chees", chees_sample, dict(draws=CHEES_OPS_DRAWS, tune=CHEES_OPS_TUNE, chains=CHEES_CHAINS,
                                     target_accept=CHEES_TARGET, max_leapfrog=CHEES_MAX_LEAP)),
        ("hmc", hmc_sample, dict(draws=HMC_DRAWS, tune=HMC_TUNE, chains=HMC_CHAINS, n_leapfrog=HMC_LEAP,
                                 target_accept=HMC_TARGET)),
    ):
        calls[0] = 0
        RbfGram.launches = 0
        with count_rbf_shapes(name) as shapes:
            _sync("cuda")
            t0 = time.perf_counter()
            samples, stats = sampler(logp, q0, torch.Generator(device="cuda").manual_seed(0), chain_batched=True, **kw)
            _sync("cuda")
            secs = time.perf_counter() - t0
        iters = kw["tune"] + kw["draws"]
        leaps = stats["n_leapfrog"] if name == "chees" else np.full(iters, HMC_LEAP)
        out[name] = dict(samples=samples, stats=stats, secs=secs, launches=RbfGram.launches, calls=calls[0],
                         shapes=dict(shapes), median=_natural_median(samples))
        extra = (f" | adapted step {float(stats['step_size']):.4f}, T {float(stats['trajectory_length']):.4f}"
                 if name == "chees" else "")
        log(f"[{name}] {kw['chains']} chains, tune {kw['tune']} draws {kw['draws']}: {secs:.3f} s, "
            f"{secs / iters * 1e3:.2f} ms/iteration | leapfrog steps per iteration mean {leaps.mean():.2f} max "
            f"{leaps.max()} | {calls[0]} batched objective calls ({secs / calls[0] * 1e3:.3f} ms each) | mean "
            f"acceptance {float(stats['mean_accept']):.4f}{extra} | posterior medians "
            f"{ {k: np.round(v, 4).tolist() for k, v in out[name]['median'].items()} } | rbf_gram launches "
            f"{RbfGram.launches} by shape {dict(shapes)}")
        assert calls[0] == 1 + int(leaps.sum()), f"{name}: {calls[0]} objective calls for {int(leaps.sum())} steps"
        assert _draws_finite(samples), f"{name}: non-finite draws"
        assert RbfGram.launches > 0 and sum(shapes.values()) == RbfGram.launches, f"{name}: rbf_gram launches"

    c, h = out["chees"], out["hmc"]
    acc = float(c["stats"]["mean_accept"])
    assert CHEES_ACCEPT[0] <= acc <= CHEES_ACCEPT[1], f"ChEES mean acceptance {acc}"
    assert float(h["stats"]["mean_accept"]) >= HMC_MIN_ACCEPT, f"HMC mean acceptance {float(h['stats']['mean_accept'])}"
    med_c, med_h = c["median"]["ls_total"], h["median"]["ls_total"]
    assert np.allclose(med_c, med_h, rtol=LS_MEDIAN_RTOL, atol=0.0), f"lengthscale medians {med_c} vs {med_h}"
    u_med = unconstrain({k: torch.as_tensor(v, dtype=torch.float64, device="cuda") for k, v in c["median"].items()})
    with torch.no_grad():
        f32 = float(map_neg_logp(spec, {k: v.float() for k, v in u_med.items()}, xc, xk, y, la_t, lb_t))
        f64 = float(map_neg_logp(spec, u_med, xc.double(), xk, y.double(), la_t.double(), lb_t.double()))
    per_pt = abs(f32 - f64) / BO_N
    log(f"[chees] neg_logp at the posterior median: f32 {f32:.4f} | f64 {f64:.4f} | |diff| {per_pt:.2e} nats/pt "
        f"(tol {BASIN_TOL}) | ls medians ChEES {med_c.tolist()} HMC {med_h.tolist()} (rtol {LS_MEDIAN_RTOL})")
    assert per_pt <= BASIN_TOL, f"ChEES median: f32 and f64 objectives differ by {per_pt} nats/pt"

    # one batched value+grad of all 16 chains, library factor and hand factor at the seam
    u_last = {k: v[:, -1].detach() for k, v in c["samples"].items()}

    def objective(u):
        return map_neg_logp_chains(spec, u, xc, xk, y, la_t, lb_t).sum()

    vg = {"library": _eval_breakdown(f"chees {CHEES_CHAINS}-chain objective, library factor", objective, u_last)[0]}
    with cholesky_seam(hopper_chol.seam_cholesky):
        vg["hand"], _ = _time_host(lambda: _value_and_grad(objective, u_last), 20)
    log(f"[chees] one batched value+grad, {CHEES_CHAINS} chains at N={BO_N} at the last draws: library factor "
        f"{vg['library'] * 1e3:.3f} ms | hand factor (hopper_chol.seam_cholesky) {vg['hand'] * 1e3:.3f} ms")
    return {k: (v["launches"], v["secs"]) for k, v in out.items()}, vg, med_c


def phase14_ess(p, laplace):
    """GPC.sample(latent=True)'s ops path on phase 11's problem from its
    Laplace fit (2 chains batched, tune 100, draws 100, 4 ESS sweeps), then
    latent_conditional_proba with 64 subsampled draws on the line."""
    spec = fitc_spec("bernoulli")
    RbfGram.launches = 0
    _peak_reset("cuda")
    with count_rbf_shapes("ess") as shapes:
        _sync("cuda")
        t0 = time.perf_counter()
        us, fs, stats = ess_gpc_sample(spec, laplace["u_best"], p["xc"], p["xk"], p["yb"], p["la"], p["lb"],
                                       torch.Generator(device="cuda").manual_seed(0), draws=ESS_DRAWS, tune=ESS_TUNE,
                                       chains=ESS_CHAINS, ess_sweeps=ESS_SWEEPS, target_accept=ESS_TARGET)
        _sync("cuda")
        t1 = time.perf_counter()
        s_all = ESS_CHAINS * ESS_DRAWS
        idx = torch.as_tensor(np.random.default_rng(0).choice(s_all, ESS_PROBA_DRAWS, replace=False), device="cuda")
        params = {k: v.reshape(s_all, *v.shape[2:])[idx] for k, v in constrain(us).items()}
        with torch.no_grad():
            prob = latent_conditional_proba(spec, params, fs.reshape(s_all, -1)[idx], p["xc"], p["xk"], p["line"],
                                            p["line_k"])
        _sync("cuda")
        t2 = time.perf_counter()
    launches, peak = RbfGram.launches, _peak_gib("cuda")
    trials = stats["ess_trials"]
    drawn = trials[:, ESS_TUNE:]
    acc = _accuracy(p, prob)
    mh = float(stats["accept_rate"].mean())
    iters = ESS_TUNE + ESS_DRAWS
    log(f"[ess] N={LAPLACE_N}, {ESS_CHAINS} chains, tune {ESS_TUNE} draws {ESS_DRAWS}, {ESS_SWEEPS} sweeps: sampler "
        f"{t1 - t0:.3f} s ({(t1 - t0) / iters * 1e3:.2f} ms/iteration) | proba ({ESS_PROBA_DRAWS} draws) "
        f"{t2 - t1:.3f} s | trials per ESS step mean {float(trials.float().mean()):.2f} max {int(trials.max())} "
        f"(after tuning mean {float(drawn.float().mean()):.2f} max {int(drawn.max())}) | host syncs "
        f"{stats['host_syncs']} ({stats['host_syncs'] / iters:.1f} per iteration) | MH acceptance {mh:.4f} per chain "
        f"{stats['accept_rate'].tolist()} step {stats['step_size'].tolist()} | line accuracy {acc:.3f} (Laplace "
        f"{laplace['accuracy']:.3f}) | peak {peak:.2f} GiB | rbf_gram launches {launches} by shape {dict(shapes)}")
    assert _draws_finite(us) and bool(torch.isfinite(fs).all()) and bool(torch.isfinite(prob).all()), \
        "ESS: non-finite draws or probabilities"
    assert ESS_ACCEPT[0] <= mh <= ESS_ACCEPT[1], f"ESS: MH acceptance {mh}"
    assert int(drawn.max()) < 200, "ESS: a slice step hit the 200-trial cap after tuning"
    assert acc >= laplace["accuracy"] - ESS_ACC_SLACK, f"ESS line accuracy {acc} vs Laplace {laplace['accuracy']}"
    assert launches > 0 and sum(shapes.values()) == launches, f"ESS: rbf_gram launches {launches}"
    return launches, t2 - t0


# ------------------------------------------------------------------
# Phase 15: the model layer, GP.fit -> predict_grid -> save/load
# ------------------------------------------------------------------

MODEL_OUTPUTS = ["y1", "y2"]
MODEL_DIMS = ["x1", "x2"]
MODEL_DENSE_N = 1024  # (b): the Hadamard and Independent fits' locations (2,048 tall rows)
MODEL_MAP_KWARGS = {}  # find_MAP's defaults: 8 restarts, maxiter 500, tol 1e-8
MODEL_RMSE_TOL = 0.05  # grid mean against the noise-free surface in the data's box (noise sd 0.1 and 0.15)
MODEL_HK_TOL = GRID_TOL  # max |Hadamard − Kronecker| grid mean, natural units, two f32 fits of one table


def bench_table(n_locs):
    """make_problem's locations and outputs as a wide table of float64
    columns x1, x2, y1, y2: one row per location."""
    _, xc, Y, _, _ = make_problem(n_locs, "cpu", torch.float64)
    X, Y = xc.numpy(), Y.numpy()
    return ArrayTable({"x1": X[:, 0], "x2": X[:, 1], "y1": Y[:, 0], "y2": Y[:, 1]}, outputs=MODEL_OUTPUTS)


def run_model_fit(table, device, dtype, multitask_kernel=None, map_kwargs=None, grid=GRID):
    """``ArrayTableGP(table).fit(...)`` over both outputs and both dims, then
    ``prepare_grid(resolution=grid)`` and ``predict_grid()``. Returns the
    model, the prediction, the stage seconds (``GP.fit``'s phases and the
    predict), objective evaluations and rbf_gram launches of each part."""
    timings.clear()
    launches0 = RbfGram.launches
    gp = ArrayTableGP(table, outputs=MODEL_OUTPUTS, dtype=dtype, device=device)
    gp.fit(outputs=MODEL_OUTPUTS, continuous_dims=MODEL_DIMS, multitask_kernel=multitask_kernel,
           MAP_kwargs=map_kwargs)
    _sync(device)
    fit_launches = RbfGram.launches - launches0
    t0 = time.perf_counter()
    gp.prepare_grid(resolution=grid)
    y = gp.predict_grid()
    _sync(device)
    stages = {**timings.last(), "predict": time.perf_counter() - t0}
    aux = gp._fit_aux
    auxes = ([aux[f"output_{j}"] for j in range(len(MODEL_OUTPUTS))] if gp._structure == "Independent"
             else [aux])
    iters = [a["iters"].tolist() for a in auxes]
    iters = iters if gp._structure == "Independent" else iters[0]
    evals = sum(int(a["evals"].sum()) for a in auxes)
    assert evals > 0, f"{gp._structure} fit reports no objective evaluations"
    return dict(gp=gp, y=y, stages=stages, evals=evals, iters=iters,
                launches={"fit": fit_launches, "predict": RbfGram.launches - launches0 - fit_launches})


def _log_model(tag, r):
    st = r["stages"]
    log(f"[gp_model] {tag}: structure {r['gp']._structure} | specify {st['specify_model']:.3f} s | build "
        f"{st['build_model']:.3f} s | find_MAP {st['find_MAP']:.3f} s ({r['evals']} objective evaluations, "
        f"L-BFGS iterations per restart {r['iters']}) | prepare_grid + predict_grid {st['predict']:.3f} s | "
        f"rbf_gram launches fit {r['launches']['fit']} predict {r['launches']['predict']}")


def _grid_means(y):
    return {o: np.asarray(y.get(o).μ, dtype=np.float64) for o in MODEL_OUTPUTS}


def _check_cor(tag, cor):
    cor = np.asarray(cor, dtype=np.float64)
    ok = (cor.shape == (2, 2) and np.allclose(cor, cor.T) and np.allclose(np.diag(cor), 1.0)
          and float(np.abs(cor).max()) <= 1.0 + 1e-6 and float(np.linalg.eigvalsh(cor).min()) >= -1e-6)
    assert ok, f"{tag}: mvuparray.cor is not a correlation matrix: {cor.tolist()}"


def model_grid_errors(gp, y, table):
    """Grid mean RMSE (natural units) against bench.py's noise-free f1, f2
    at the grid points inside the data's box, per output."""
    x1, x2 = gp.grid_parray["x1"].values(), gp.grid_parray["x2"].values()
    c = table.columns
    inside = ((x1 >= c["x1"].min()) & (x1 <= c["x1"].max()) & (x2 >= c["x2"].min()) & (x2 <= c["x2"].max()))
    truth = bench_truth(np.column_stack([x1[inside], x2[inside]]))
    means = _grid_means(y)
    return {o: float(np.sqrt(np.mean((means[o][inside] - f) ** 2))) for o, f in zip(MODEL_OUTPUTS, truth)}


def kron_f64_gaps(gp):
    """The fitted Kronecker model's f32 objective against f64 at the same
    (f32) MAP, in nats per point, and its standardized grid mean and
    variance against the f64 posterior there."""
    spec, dev = gp._spec, gp._xc_locs.device
    u32 = unconstrain(gp._params)
    u64 = {k: v.double() for k, v in u32.items()}
    la32, lb32 = (torch.as_tensor(a, dtype=gp._dtype, device=dev) for a in (gp._ls_alpha, gp._ls_beta))
    la64, lb64 = (torch.as_tensor(a, dtype=torch.float64, device=dev) for a in (gp._ls_alpha, gp._ls_beta))
    xl64, Y64 = gp._xc_locs.double(), gp._Y.double()
    points, _, _ = gp._prepare_points_for_prediction(gp.grid_points, output=MODEL_OUTPUTS)
    m32, v32 = gp.predict(points)
    with torch.no_grad():
        f32 = float(kron_neg_logp(spec, u32, gp._xc_locs, gp._Y, la32, lb32))
        f64 = float(kron_neg_logp(spec, u64, xl64, Y64, la64, lb64))
        p64 = constrain(u64)
        n_grid = points.shape[0] // len(MODEL_OUTPUTS)
        xg = torch.as_tensor(points[:n_grid, : len(MODEL_DIMS)], dtype=torch.float64, device=dev)
        m64, v64 = kron_predict_diag(spec, p64, kron_cache(spec, p64, xl64, Y64), xg)
    dmean = float(np.abs(m32.reshape(len(MODEL_OUTPUTS), -1) - m64.cpu().numpy()).max())
    dvar = float(np.abs(v32.reshape(len(MODEL_OUTPUTS), -1) - v64.cpu().numpy()).max())
    return f32, f64, abs(f32 - f64) / gp._yz.shape[0], dmean, dvar


@torch.no_grad()
def kron_mean_sum_gaps(gp):
    """The Kronecker grid mean B·(α·Kxs) against f64 at the same MAP, with
    the model's own f32 Kxs, α and B summed in f32 (``kron_predict_diag``'s
    sum), the same f32 pieces summed in f64, and the f32 Kxs with the f64
    α and B: the largest standardized gap of each, and the f64 mean's
    largest magnitude."""
    spec, dev, cache = gp._spec, gp._xc_locs.device, gp._kron_cache
    points = _grid_tall(gp, gp.grid_points)
    xg = torch.as_tensor(points[: points.shape[0] // len(MODEL_OUTPUTS), : len(MODEL_DIMS)], dtype=gp._dtype,
                         device=dev)
    Kxs = _continuous_gram(spec, gp._params, gp._xc_locs, xg)
    p64 = {k: v.double() for k, v in gp._params.items()}
    xl64 = gp._xc_locs.double()
    c64 = kron_cache(spec, p64, xl64, gp._Y.double())
    m64 = kron_predict_diag(spec, p64, c64, xg.double())[0]
    return dict(f32_sum=float(((cache.B @ (cache.alpha @ Kxs)).double() - m64).abs().max()),
                f64_sum=float((cache.B.double() @ (cache.alpha.double() @ Kxs.double()) - m64).abs().max()),
                f64_alpha=float((c64.B @ (c64.alpha @ Kxs.double()) - m64).abs().max()), scale=float(m64.abs().max()))


def phase15_model_layer():
    """The model layer on the card through tools/array_table.py's GP: (a)
    bench.py's table (5,120 locations, two outputs) fit at find_MAP's
    defaults and predicted on the 100×100 grid; (b) the dense Hadamard and
    Independent fits (and a Kronecker fit for comparison) at 1,024
    locations; (c) (a)'s model saved, loaded and predicted again."""
    t_start = time.perf_counter()
    table, dense_table = bench_table(N_LOCS), bench_table(MODEL_DENSE_N)
    RbfGram.launches = 0
    _peak_reset("cuda")
    with count_rbf_shapes("gp_model") as shapes:
        ra = run_model_fit(table, "cuda", torch.float32, map_kwargs=MODEL_MAP_KWARGS)
        peak = _peak_gib("cuda")
        dense = {mk: run_model_fit(dense_table, "cuda", torch.float32, multitask_kernel=mk,
                                   map_kwargs=MODEL_MAP_KWARGS) for mk in ("Hadamard", "Independent", None)}
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as d:
            path = os.path.join(d, "gp.npz")
            ra["gp"].save(path)
            loaded = ArrayTableGP.load(path, table, device="cuda")
        loaded.prepare_grid()
        y_loaded = loaded.predict_grid()
        _sync("cuda")
    launches = RbfGram.launches
    seconds = time.perf_counter() - t_start
    assert launches > 0 and sum(shapes.values()) == launches, f"gp_model: rbf_gram launches {launches}, {dict(shapes)}"

    # (a)
    gp, y = ra["gp"], ra["y"]
    _log_model(f"(a) N={N_LOCS} x {len(MODEL_OUTPUTS)} outputs", ra)
    assert gp._structure == "Kronecker", gp._structure
    assert y.shape == (GRID, GRID), y.shape
    f32, f64, per_pt, dmean, dvar = kron_f64_gaps(gp)
    rmse = model_grid_errors(gp, y, table)
    log(f"[gp_model] (a) neg_logp at fit: f32 {f32:.4f} | f64 {f64:.4f} | |diff| {per_pt:.2e} nats/pt (tol "
        f"{BASIN_TOL}) | standardized grid vs f64 at the f32 MAP: max|dmean| {dmean:.3e} max|dvar| {dvar:.3e} (tol "
        f"{GRID_TOL}) | cor {np.asarray(y.cor).round(6).tolist()} | grid mean RMSE vs truth in the data's box "
        f"{rmse} (tol {MODEL_RMSE_TOL}) | peak {peak:.2f} GiB | rbf_gram by shape {dict(shapes)}")
    su = kron_mean_sum_gaps(gp)
    log(f"[gp_model] (a) grid mean vs f64 (standardized, largest |mean| {su['scale']:.3f}): B·(α·Kxs) summed in f32 "
        f"{su['f32_sum']:.3e} | the same f32 Kxs, α and B summed in f64 {su['f64_sum']:.3e} | f32 Kxs with the f64 "
        f"α and B {su['f64_alpha']:.3e}")
    for o in MODEL_OUTPUTS:
        assert np.isfinite(y.get(o).μ).all() and np.isfinite(y.get(o).σ2).all() and (y.get(o).σ2 >= 0).all(), o
    assert per_pt <= BASIN_TOL, f"gp_model (a): f32 and f64 objectives differ by {per_pt} nats/pt"
    assert dmean <= GRID_TOL and dvar <= GRID_TOL, f"gp_model (a): f32 grid differs from f64: {dmean}, {dvar}"
    _check_cor("gp_model (a)", y.cor)
    assert max(rmse.values()) <= MODEL_RMSE_TOL, f"gp_model (a): grid mean RMSE vs truth {rmse}"
    assert ra["launches"]["fit"] > 0 and ra["launches"]["predict"] > 0, f"gp_model (a): {ra['launches']}"

    # (b)
    for mk, r in dense.items():
        _log_model(f"(b) N={MODEL_DENSE_N} x {len(MODEL_OUTPUTS)} outputs, multitask_kernel={mk}", r)
        for o in MODEL_OUTPUTS:
            u = r["y"].get(o)
            assert np.isfinite(u.μ).all() and np.isfinite(u.σ2).all() and (u.σ2 >= 0).all(), (mk, o)
        _check_cor(f"gp_model (b) {mk}", r["y"].cor)
    assert [dense[mk]["gp"]._structure for mk in dense] == ["Hadamard", "Independent", "Kronecker"]
    hk = {o: float(np.abs(_grid_means(dense["Hadamard"]["y"])[o] - _grid_means(dense[None]["y"])[o]).max())
          for o in MODEL_OUTPUTS}
    log(f"[gp_model] (b) Hadamard vs Kronecker grid mean: max|diff| {hk} (tol {MODEL_HK_TOL}) | Independent cor "
        f"{np.asarray(dense['Independent']['y'].cor).tolist()}")
    assert max(hk.values()) <= MODEL_HK_TOL, f"gp_model (b): Hadamard and Kronecker grids differ by {hk}"

    # (c)
    same = all(np.array_equal(y_loaded.get(o).μ, y.get(o).μ) and np.array_equal(y_loaded.get(o).σ2, y.get(o).σ2)
               for o in MODEL_OUTPUTS) and np.array_equal(y_loaded.cor, y.cor)
    log(f"[gp_model] (c) save -> load -> predict_grid bit-equal to (a): {same} | phase 15 took {seconds:.1f} s, "
        f"rbf_gram launches {launches}")
    assert same, "gp_model (c): the loaded model's grid differs from the saved model's"
    return launches, seconds, gp


# ------------------------------------------------------------------
# Phase 16: the model layer, the rest: draws, gradients, propose, sample
# ------------------------------------------------------------------

SURFACE_DRAWS = 4  # (a)'s joint grid draws: both outputs, 20,000 points
SURFACE_FD_POINTS = 5  # grid points of the central differences
SURFACE_FD_H = 1e-3  # their step in z-units
SURFACE_FD_RTOL = 1e-4  # f64 gradient against f64 central differences, of the largest entry
SURFACE_ACQ_TOL = 1e-3  # |f32 − f64| of the acquisition at the candidate, log units (phase 12's rule)
SURFACE_TRACE_DRAWS = 16  # draw_point_samples(source=trace)'s n_samples
SURFACE_BO_N = BO_N  # (b): phase 12a's problem as a table
SURFACE_CHEES = dict(tune=250, draws=250)  # (b)'s GP.sample(): 16 chains, cut from 500 + 500 for time


def f64_twin(gp):
    """A shallow copy of a fitted model with its data, MAP and caches in f64
    (the plain path: no kernel runs at f64), for the f32 − f64 checks."""
    tw = copy.copy(gp)
    tw._dtype, tw.sample_vars = torch.float64, None
    tw._xc, tw._yz = gp._xc.double(), gp._yz.double()
    tw._params = {k: v.double() for k, v in gp._params.items()}
    tw._cache = None
    if gp._structure == "Kronecker":
        tw._xc_locs, tw._Y = gp._xc_locs.double(), gp._Y.double()
        with torch.no_grad():
            tw._kron_cache = kron_cache(tw._spec, tw._params, tw._xc_locs, tw._Y)
    return tw


def _timed(device, fn):
    """(fn(), seconds, peak GiB) with the device synchronized around it."""
    _peak_reset(device)
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0, _peak_gib(device)


def _grid_tall(gp, points):
    """The tall z-space points array of ``points`` for every output."""
    return gp._prepare_points_for_prediction(points, output=gp.outputs)[0]


def run_surface_a(gp, n_draws=SURFACE_DRAWS, seed=0, propose_kw=None):
    """Phase 16 (a)'s user calls on a fitted model with a prepared grid:
    ``draw_grid_samples`` (both outputs jointly, ``with_noise=False``, the
    normal block from a generator seeded with ``seed``),
    ``predict_grid_grad`` with and without norms, ``propose(q=2)`` at its
    defaults (``propose_kw`` may set its raw q-batches and restarts, which
    leave the acquisition as it is). Returns each result with its seconds
    and peak GiB."""
    dev = gp._device
    stream = TorchStream(torch.Generator(device=dev).manual_seed(seed), gp._dtype, dev)
    calls = {
        "draw_grid_samples": lambda: gp.draw_grid_samples(n_samples=n_draws, stream=stream),
        "predict_grid_grad(norm=False)": lambda: gp.predict_grid_grad(norm=False),
        "predict_grid_grad(norm=True)": lambda: gp.predict_grid_grad(norm=True),
        "propose(q=2)": lambda: gp.propose(q=2, **(propose_kw or {})),
    }
    return {name: _timed(dev, fn) for name, fn in calls.items()}


def check_surface_a(gp, res, n_draws=SURFACE_DRAWS, seed=0):
    """(a)'s numbers against the f64 twin at the same MAP. Returns a dict of
    the measured gaps and their limits; asserts nothing."""
    dev, outs = gp._device, gp.outputs
    tw = f64_twin(gp)
    out = {}

    # Draws: the model's against f64 draws on the same normal block with the
    # same floor. The f32 covariance's rounding (entries off by up to ~the
    # floor) moves the factor's near-null columns by ~√floor, so the draws
    # by up to √floor·max|eps|; the posterior mean's f32 error adds GRID_TOL.
    y = res["draw_grid_samples"][0]
    d32 = np.stack([np.asarray(y[o].z.values()).reshape(n_draws, -1) for o in outs], 1).reshape(n_draws, -1)
    points = gp.grid_points
    if gp.categorical_dims:
        points = gp.append_categorical_points(points, categorical_levels=None)
    A_grid = np.asarray(_grid_tall(gp, points))
    xc, xk = gp._split_X(A_grid)
    m = xc.shape[0]
    eps = torch.randn((n_draws, m), generator=torch.Generator(device=dev).manual_seed(seed), dtype=gp._dtype,
                      device=dev)
    with torch.no_grad():
        prior = gram_diag(gp._spec, gp._params, xc, xk)
        floor = max(DEFAULT_JITTER, m * torch.finfo(gp._dtype).eps * float(prior.mean()))
        d64 = draw_samples(tw._spec, tw._params, tw._ensure_dense_cache(), xc.double(), xk, eps=eps.double(),
                           jitter=floor).cpu().numpy()
    out["draws"] = dict(finite=bool(np.isfinite(d32).all()), gap=float(np.abs(d32 - d64).max()),
                        tol=float(np.sqrt(floor) * float(eps.abs().max()) + GRID_TOL), floor=floor, m=m,
                        post_sd=float(np.std(d64 - d64.mean(0), axis=0).mean()) if n_draws > 1 else None)

    # Gradients: a mean error bounded by GRID_TOL, smooth at the shortest
    # lengthscale ℓ, moves the gradient by up to GRID_TOL/ℓ per z-unit.
    ls_min = float(gp._params["ls_total"].min())
    gaps = {}
    for norm in (False, True):
        g32, g64 = res[f"predict_grid_grad(norm={norm})"][0], tw.predict_grid_grad(norm=norm)
        for name in g64.names:
            gap = float(np.abs(np.asarray(g32[name].values()) - np.asarray(g64[name].values())).max())
            if norm:
                o = name.removeprefix("|∇|")
                scale = np.sqrt(sum(gp.stdzr[o]["σ2"] / gp.stdzr[x]["σ2"] for x in gp.continuous_dims))
            else:
                o, x = name.split("/")[0][2:-1], name.split("/")[1][2:-1]
                scale = np.sqrt(gp.stdzr[o]["σ2"] / gp.stdzr[x]["σ2"])
            gaps[name] = (gap, float(GRID_TOL / ls_min * scale))
    out["grad"] = gaps

    # A Kronecker model's dense cache: the port's α (the Kronecker solve's)
    # beside the reference's (solved through the dense f32 factor), in the
    # z-space gradients and means on the grid
    if gp._structure == "Kronecker":
        g64z = tw.predict_grad(A_grid)
        with torch.no_grad():
            caches = {"kron": gp._ensure_dense_cache(),
                      "dense": posterior_cache(gp._spec, gp._params, gp._xc, gp._xk, gp._yz)}
            m64 = tw._mean_fn(tw._params, tw._ensure_dense_cache(), xc.double(), xk)
            means = {k: gp._mean_fn(gp._params, c, xc, xk).double() for k, c in caches.items()}
        out["routes"] = dict(scale=float(np.abs(g64z).max()), **{
            f"grad_{k}": float(np.abs(gp._mean_grad(gp._params, c, xc, xk) - g64z).max()) for k, c in caches.items()},
            **{f"mean_{k}": float((m - m64).abs().max()) for k, m in means.items()})

    # Central differences of the f64 twin's predict at a few grid points,
    # against its own gradient and the model's
    idx = np.linspace(0, len(gp.grid_points) - 1, SURFACE_FD_POINTS).astype(int)
    A = np.asarray(_grid_tall(gp, gp.grid_points[idx]), dtype=float)
    g64z, g32z = tw.predict_grad(A), gp.predict_grad(A)
    cd = np.empty_like(g64z)
    for i in range(len(gp.continuous_dims)):
        up, dn = A.copy(), A.copy()
        up[:, i] += SURFACE_FD_H
        dn[:, i] -= SURFACE_FD_H
        cd[:, i] = (tw.predict(up)[0] - tw.predict(dn)[0]) / (2 * SURFACE_FD_H)
    scale = float(np.abs(g64z).max())
    out["fd"] = dict(f64=float(np.abs(g64z - cd).max()) / scale, f32=float(np.abs(g32z - cd).max()),
                     tol_f32=GRID_TOL / ls_min)

    # propose(q=2): the candidates in the data's box, and the acquisition at
    # them at f32 (the model's) and f64 (the twin's)
    cands, value = res["propose(q=2)"][0]
    z = torch.as_tensor(np.stack([np.asarray(cands[n].z.values()) for n in gp.continuous_dims], -1), device=dev)
    xc_np = gp._xc.cpu().numpy()
    lo, hi = xc_np.min(0) - 1e-6, xc_np.max(0) + 1e-6
    with torch.no_grad():
        a32 = float(gp.q_acquisition(2)["acq"](z.to(gp._dtype)))
        a64 = float(tw.q_acquisition(2)["acq"](z.double()))
    zn = z.cpu().numpy()
    out["propose"] = dict(value=value, at32=a32, at64=a64, in_box=bool(((zn >= lo) & (zn <= hi)).all()),
                          candidates=zn.tolist())
    return out


def surface_table(n):
    """Phase 12a's problem (``make_dense_problem``) as a table: x1, x2, y."""
    _, X, y, _, _, _ = make_dense_problem(n, np.float64)
    return ArrayTable({"x1": X[:, 0], "x2": X[:, 1], "y": y}, outputs=["y"])


def run_surface_b(table, device, dtype, map_kwargs=None, chees_kw=None, hmc_kw=None, grid=GRID,
                  n_trace=SURFACE_TRACE_DRAWS, propose_kw=None):
    """Phase 16 (b)'s user calls: ``GP.fit`` (``find_MAP``'s defaults unless
    ``map_kwargs``), ``propose(q=4)``, ``sample()`` (ChEES at its defaults
    unless ``chees_kw``), ``sample(sampler='hmc', **hmc_kw)``, then
    ``draw_point_samples`` from the ChEES trace on the grid (``propose_kw``
    as in :func:`run_surface_a`). Returns the
    model and each call's result, seconds and peak GiB."""
    gp = ArrayTableGP(table, outputs=["y"], dtype=dtype, device=device)
    res = {"fit": _timed(device, lambda: gp.fit(outputs=["y"], continuous_dims=["x1", "x2"], MAP_kwargs=map_kwargs))}
    res["propose(q=4)"] = _timed(device, lambda: gp.propose(q=4, **(propose_kw or {})))
    res["sample()"] = _timed(device, lambda: gp.sample(**(chees_kw or {})))
    res["sample(sampler='hmc')"] = _timed(device, lambda: gp.sample(sampler="hmc", **(hmc_kw or {})))
    gp.prepare_grid(resolution=grid)
    trace = res["sample()"][0]
    res["draw_point_samples(source=trace)"] = _timed(
        device, lambda: gp.draw_point_samples(gp.grid_points, n_samples=n_trace, source=trace))
    return gp, res


def check_surface_b(gp, res):
    """(b)'s numbers: the proposal against the f64 twin, the samplers'
    acceptance, the ChEES lengthscale medians in the data's units, the
    trace draws' finiteness. Asserts nothing."""
    cands, value = res["propose(q=4)"][0]
    dev = gp._device
    z = torch.as_tensor(np.stack([np.asarray(cands[n].z.values()) for n in gp.continuous_dims], -1), device=dev)
    xc_np = gp._xc.cpu().numpy()
    lo, hi = xc_np.min(0) - 1e-6, xc_np.max(0) + 1e-6
    with torch.no_grad():
        a32 = float(gp.q_acquisition(4)["acq"](z.to(gp._dtype)))
        a64 = float(f64_twin(gp).q_acquisition(4)["acq"](z.double()))
    zn = z.cpu().numpy()
    chees, hmc = res["sample()"][0], res["sample(sampler='hmc')"][0]
    sd_x = np.sqrt([gp.stdzr[x]["σ2"] for x in gp.continuous_dims])
    draws = res["draw_point_samples(source=trace)"][0]
    return dict(
        propose=dict(value=value, at32=a32, at64=a64, in_box=bool(((zn >= lo) & (zn <= hi)).all()),
                     candidates=zn.tolist()),
        chees_accept=float(chees["_stats"]["mean_accept"]), hmc_accept=float(hmc["_stats"]["mean_accept"]),
        ls_median=np.median(chees["ls_total"].reshape(-1, chees["ls_total"].shape[-1]), axis=0) * sd_x,
        finite=bool(np.isfinite(chees["ls_total"]).all() and np.isfinite(hmc["ls_total"]).all()
                    and np.isfinite(np.asarray(draws["y"].values())).all()),
        draws_shape=tuple(draws.shape),
    )


def _log_calls(tag, res):
    for name, (_, secs, peak) in res.items():
        log(f"[gp_surface] {tag} {name}: {secs:.3f} s | peak {peak if peak is None else f'{peak:.2f}'} GiB")


def phase16_model_surface(gp_a, ls_median_ops):
    """The rest of GP's dense surface on the card through
    tools/array_table.py's GP: (a) on phase 15 (a)'s fitted Kronecker model
    (5,120 locations × 2 outputs, the 100×100 grid): joint grid draws,
    mean gradients and propose(q=2); (b) on phase 12a's N = 512 problem as
    a table: GP.fit, propose(q=4), GP.sample() (ChEES, 16 chains, cut to
    250 + 250), GP.sample(sampler='hmc') at phase 13's cut, draws from the
    ChEES trace."""
    t_start = time.perf_counter()
    table_b = surface_table(SURFACE_BO_N)
    RbfGram.launches = 0
    with count_rbf_shapes("gp_surface") as shapes:
        res_a = run_surface_a(gp_a)
        gp_b, res_b = run_surface_b(table_b, "cuda", torch.float32, chees_kw=SURFACE_CHEES,
                                    hmc_kw=dict(tune=HMC_TUNE, draws=HMC_DRAWS, n_leapfrog=HMC_LEAP))
    launches = RbfGram.launches
    seconds = time.perf_counter() - t_start
    shapes = dict(shapes)
    assert launches > 0 and sum(shapes.values()) == launches, f"gp_surface: rbf_gram launches {launches}, {shapes}"
    _log_calls("(a)", res_a)
    _log_calls("(b)", res_b)

    # (a)
    ca = check_surface_a(gp_a, res_a)
    dr = ca["draws"]
    log(f"[gp_surface] (a) draws: {SURFACE_DRAWS} joint draws at {dr['m']} points, finite {dr['finite']} | floor "
        f"{dr['floor']:.3e} (sqrt {np.sqrt(dr['floor']):.3e}) | max|f32 - f64| on the same normal block and floor "
        f"{dr['gap']:.3e} (tol {dr['tol']:.3e}) | f64 draws' mean sd about their mean {dr['post_sd']}")
    assert dr["finite"], "gp_surface (a): non-finite draws"
    assert dr["gap"] <= dr["tol"], f"gp_surface (a): f32 draws {dr['gap']} from f64 (tol {dr['tol']})"
    for name, (gap, tol) in ca["grad"].items():
        log(f"[gp_surface] (a) grad {name}: max|f32 - f64| {gap:.3e} (tol {tol:.3e})")
        assert gap <= tol, f"gp_surface (a): {name} f32 and f64 differ by {gap} (tol {tol})"
    if "routes" in ca:
        rt = ca["routes"]
        log(f"[gp_surface] (a) Kronecker model's dense cache, f32 - f64 in z-units on the grid: gradients with the "
            f"Kronecker solve's alpha (the port's) {rt['grad_kron']:.3e}, with alpha solved through the dense factor "
            f"(the reference's) {rt['grad_dense']:.3e}, largest f64 entry {rt['scale']:.3e} | means "
            f"{rt['mean_kron']:.3e} and {rt['mean_dense']:.3e}")
    fd = ca["fd"]
    log(f"[gp_surface] (a) central differences of predict (h {SURFACE_FD_H}, {SURFACE_FD_POINTS} grid points): f64 "
        f"gradient {fd['f64']:.3e} of its largest entry (tol {SURFACE_FD_RTOL}) | f32 gradient max|diff| "
        f"{fd['f32']:.3e} (tol {fd['tol_f32']:.3e})")
    assert fd["f64"] <= SURFACE_FD_RTOL and fd["f32"] <= fd["tol_f32"], f"gp_surface (a): central differences {fd}"
    pa = ca["propose"]
    log(f"[gp_surface] (a) propose(q=2): value {pa['value']:.6f} | at the candidate f32 {pa['at32']:.6f} f64 "
        f"{pa['at64']:.6f} |diff| {abs(pa['at32'] - pa['at64']):.2e} (tol {SURFACE_ACQ_TOL}) | candidates (z) "
        f"{pa['candidates']}")
    assert pa["in_box"] and np.isfinite(pa["value"]), f"gp_surface (a): propose {pa}"
    assert abs(pa["at32"] - pa["at64"]) <= SURFACE_ACQ_TOL, f"gp_surface (a): acquisition f32 vs f64 {pa}"
    assert abs(pa["value"] - pa["at32"]) <= ACQ_RAW_TOL, f"gp_surface (a): returned value {pa}"

    # (b)
    cb = check_surface_b(gp_b, res_b)
    pb = cb["propose"]
    aux = gp_b._fit_aux
    log(f"[gp_surface] (b) fit N={SURFACE_BO_N}: {int(aux['evals'].sum())} evaluations, iterations per restart "
        f"{aux['iters'].tolist()} | propose(q=4): value {pb['value']:.6f} | at the candidate f32 {pb['at32']:.6f} "
        f"f64 {pb['at64']:.6f} |diff| {abs(pb['at32'] - pb['at64']):.2e} (tol {SURFACE_ACQ_TOL}) | ChEES acceptance "
        f"{cb['chees_accept']:.4f} (band {CHEES_ACCEPT}) | HMC acceptance {cb['hmc_accept']:.4f} (min "
        f"{HMC_MIN_ACCEPT}) | ChEES ls medians in the data's units {cb['ls_median'].tolist()} vs phase 13's "
        f"{np.asarray(ls_median_ops).tolist()} (rtol {LS_MEDIAN_RTOL}) | trace draws {cb['draws_shape']}")
    assert pb["in_box"] and np.isfinite(pb["value"]), f"gp_surface (b): propose {pb}"
    assert abs(pb["at32"] - pb["at64"]) <= SURFACE_ACQ_TOL, f"gp_surface (b): acquisition f32 vs f64 {pb}"
    assert CHEES_ACCEPT[0] <= cb["chees_accept"] <= CHEES_ACCEPT[1], f"gp_surface (b): ChEES {cb['chees_accept']}"
    assert cb["hmc_accept"] >= HMC_MIN_ACCEPT, f"gp_surface (b): HMC acceptance {cb['hmc_accept']}"
    assert np.allclose(cb["ls_median"], ls_median_ops, rtol=LS_MEDIAN_RTOL, atol=0.0), \
        f"gp_surface (b): ls medians {cb['ls_median']} vs {ls_median_ops}"
    assert cb["finite"] and cb["draws_shape"] == (SURFACE_TRACE_DRAWS, GRID * GRID), f"gp_surface (b): {cb}"
    log(f"[gp_surface] phase 16 took {seconds:.1f} s (checks {time.perf_counter() - t_start - seconds:.1f} s more) | "
        f"rbf_gram launches {launches} by shape {shapes}")
    return launches, seconds


# ------------------------------------------------------------------
# Phases 17-18: GP's two large-N regressors (engine='iterative', sparse=True)
# ------------------------------------------------------------------

# bench_iterative50k.py:232-242's fit through GP (the staged campaign of phase 6)
GP_ITER_MAP = dict(engine="iterative", n_restarts=ITER_RESTARTS, maxiter=ITER_COARSE_ITERS, seed=0,
                   coarse_n=ITER_COARSE_N, polish_maxiter=ITER_POLISH_ITERS)
ANCHOR_POINTS = 512  # grid points of the exact f64 posterior
GP_SPARSE_MAP = dict(n_restarts=FITC_RESTARTS, maxiter=FITC_MAXITER)  # phase 9's restarts, find_MAP's tol
GP_SPARSE_DRAWS = 4


def gp_iter_config(block=ITER_BLOCK, rank=ITER_RANK, probes=ITER_PROBES, love_rank=LOVE_RANK):
    """bench_iterative50k.py's IterConfig (chip_smoke's ITER_* constants)."""
    return IterConfig(maxiter=ITER_MAXITER, tol=ITER_TOL, n_probes=probes, precond_rank=rank, quad_steps=ITER_QUAD,
                      block=block, love_rank=love_rank)


def xy_table(X, y):
    """Columns x1, x2 (inputs) and y (output) as float64: the table a user
    would hand ``GP``."""
    X = np.asarray(X, dtype=np.float64)
    return ArrayTable({"x1": X[:, 0], "x2": X[:, 1], "y": np.asarray(y, dtype=np.float64)}, outputs=["y"])


def _gp_fit(table, device, dtype, build_kw, map_kw):
    """``ArrayTableGP(table).fit(...)`` of y on (x1, x2): the model, its
    ``GP.fit`` phase seconds and the launches of the three kernels."""
    timings.clear()
    c0 = _counts()
    gp = ArrayTableGP(table, outputs=["y"], dtype=dtype, device=device)
    gp.fit(outputs=["y"], continuous_dims=["x1", "x2"], MAP_kwargs=map_kw, **build_kw)
    _sync(device)
    return gp, timings.last(), _delta(c0, _counts())


def run_gp_iterative(table, device, dtype, cfg, map_kw=GP_ITER_MAP, grid=GRID):
    """bench_iterative50k.py's campaign through ``GP``: ``fit`` with
    ``engine='iterative'`` (staged: coarse Cholesky restarts → full-N polish
    on its recovery ladder → LOVE cache), then ``prepare_grid`` and
    ``predict_grid(with_noise=False)``. Returns the model, the grid, the
    stage seconds, peak GiB and each part's launches."""
    _peak_reset(device)
    gp, stages, fit_launches = _gp_fit(table, device, dtype, {}, dict(map_kw, iter_config=cfg))
    c0 = _counts()
    t0 = time.perf_counter()
    gp.prepare_grid(resolution=grid)
    y = gp.predict_grid(with_noise=False)
    _sync(device)
    stages["predict"] = time.perf_counter() - t0
    return dict(gp=gp, y=y, stages=stages, peak_gib=_peak_gib(device),
                launches={"fit": fit_launches, "predict": _delta(c0, _counts())})


def anchor_gp_iterative(gp, n_points=ANCHOR_POINTS, seed=7):
    """Check 2 of phase 17: the iterative fit's objective and posterior
    against the exact f64 dense ones at the fitted parameters, on the GP's
    own standardized rows. Returns the relative objective gap, the largest
    standardized mean gap at ``n_points`` grid points (drawn with
    ``default_rng(seed)``), the median relative LOVE variance error, the
    share of grid points whose LOVE variance is not below the exact one,
    and the mean gaps of the α the reference would take (``ref_alpha``)."""
    arr, _, _ = gp._prepare_points_for_prediction(gp.grid_points, output=gp.outputs)
    idx = np.sort(np.random.default_rng(seed).choice(arr.shape[0], min(n_points, arr.shape[0]), replace=False))
    m32, v32 = gp.predict(np.asarray(arr)[idx], with_noise=False)
    xs, xks = gp._split_X(np.asarray(arr)[idx])
    f64, mean, var, _ = exact_f64_posterior(gp._spec, gp._params, gp._xc, gp._xk, gp._yz, gp._ls_alpha, gp._ls_beta,
                                         xs, xks)
    me, ve = mean.cpu().numpy(), var.cpu().numpy()
    return dict(f_iter=gp._neg_logp, f64=f64, rel=abs(gp._neg_logp - f64) / abs(f64),
                dmean=float(np.abs(np.asarray(m32, dtype=np.float64) - me).max()),
                love_med=float(np.median(np.abs(np.asarray(v32, dtype=np.float64) - ve) / np.maximum(ve, 1e-12))),
                conservative=float(np.mean(np.asarray(v32, dtype=np.float64) >= ve - 1e-6)), m=len(idx),
                ref_alpha=reference_alpha_gaps(gp, xs, xks, mean))


@torch.no_grad()
def reference_alpha_gaps(gp, xs, xks, mean_exact):
    """The posterior mean's largest gap from the exact one at ``xs`` with α
    solved as the reference solves it at this fit, from the fit's own
    preconditioner: the Woodbury solve P⁻¹y (its exhausted regime, whenever
    the factorization reads exhausted) and PCG to the config's tol (its CG
    regime); the cross-Gram in f64, so only α differs."""
    st, cache = gp._iter_state, gp._iter_cache
    cfg, n = st["cfg"], int(gp._xc.shape[0])
    psolve = _make_precond(cache["L"], cache["d"])[0]
    matvec = _make_matvec(gp._spec, cfg, gp._params, st["xc"], st["xk"], cache["d"], st["mask"])
    b = (st["yz"] if st["mask"] is None else st["yz"] * st["mask"])[:, None]
    X, *_, iters, rel = pcg(matvec, psolve, b, cfg.maxiter, cfg.tol)
    p64 = {k: v.double() for k, v in gp._params.items()}
    ks = gram(gp._spec, p64, xs.double(), xks, gp._xc.double(), gp._xk)

    def gap(alpha):
        return float((ks @ alpha[:n].double() - mean_exact).abs().max())

    return dict(woodbury=gap(psolve(b)[:, 0]), pcg=gap(X[:, 0]), pcg_iters=iters, pcg_rel=float(rel), tol=cfg.tol)


def _log_gp_stages(tag, stages):
    log(f"[{tag}] GP.fit phases: " + " | ".join(f"{k} {v:.3f} s" for k, v in stages.items()))


def phase17_gp_iterative(ops_map_ls):
    """bench_iterative50k.py's campaign through GP at N = 50,000 (f32):
    fit (engine='iterative', staged, its recovery ladder) → predict_grid on
    the 100×100 grid; then the exact f64 anchor at full N."""
    t_start = time.perf_counter()
    X, yv = make_iter_data(ITER_N)
    table = xy_table(X, yv)
    for k in (RbfGram, FusedMatvec, FusedMatvecSym):
        k.launches = 0
    with count_rbf_shapes("gp_iterative") as shapes:
        r = run_gp_iterative(table, "cuda", torch.float32, gp_iter_config())
    launches = _counts()
    seconds = time.perf_counter() - t_start
    shapes = dict(shapes)
    gp, aux = r["gp"], r["gp"]._fit_aux
    regimes = _regimes(aux["polish_exhausted"], aux["polish_woodbury_rel"])
    _log_gp_stages("gp_iter", r["stages"])
    log(f"[gp_iter] coarse restarts {len(aux['iters'])} @{ITER_COARSE_N}, iterations {aux['iters'].tolist()} | polish "
        f"{int(aux['polish_iters'])} iterations, {len(regimes)} evaluations on ladder rung {int(aux['polish_rung'])} "
        f"(start restart {int(aux['polish_start_restart'])}, CG cap {gp._iter_state['cfg'].maxiter}) | polish_fallback "
        f"{bool(aux['polish_fallback'])} | posterior solve: gate {'exhausted' if aux['cache_exhausted'] else 'CG'}, "
        f"{int(aux['cache_cg_iters'])} CG iterations, rel_res {float(aux['cache_rel_res']):.2e}, Woodbury residual "
        f"{float(aux['cache_woodbury_rel']):.3e} | peak "
        f"{r['peak_gib']:.2f} GiB")
    log(f"[gp_iter] polish evaluations ({REGIME_KEY}): {regimes} | CG iters "
        f"{aux['polish_cg_iters'].tolist()}")
    log(f"[gp_iter] launches fit (incl. cache) {r['launches']['fit']} | predict {r['launches']['predict']} | total "
        f"{launches} | rbf_gram by shape {shapes}")
    log(f"[gp_iter] MAP ls (z) {gp.MAP['ls_total'].tolist()} eta {float(gp.MAP['η_total']):.4f} sigma "
        f"{float(gp.MAP['σ']):.4f} | neg_logp {gp._neg_logp:.4f} | phase 6's ops-level MAP ls {ops_map_ls} (its own "
        f"z-scoring and prior subsample: logged, not compared)")

    # Check 1
    y = r["y"]
    assert gp._cache is None and gp._iter_cache is not None, "gp_iter: the iterative fit built a dense cache"
    assert not bool(aux["polish_fallback"]), f"gp_iter: the polish fell back to the subsample MAP: {aux}"
    assert y.shape == (GRID, GRID) and np.isfinite(y.μ).all() and np.isfinite(y.σ2).all() and (y.σ2 >= 0).all()
    assert sum(shapes.values()) == launches["rbf_gram"] > 0, f"gp_iter: rbf_gram launches {launches}, {shapes}"
    assert r["launches"]["fit"]["fused_stationary_matvec_sym"] > 0, \
        f"gp_iter: no sym launch in the fit: {r['launches']}"
    assert r["launches"]["predict"]["fused_stationary_matvec"] > 0, \
        f"gp_iter: no general launch in the predict: {r['launches']}"

    # Check 2: the exact f64 anchor at full N, with the fit's buffers freed first
    torch.cuda.empty_cache()
    _peak_reset("cuda")
    t0 = time.perf_counter()
    a = anchor_gp_iterative(gp)
    anchor_s = time.perf_counter() - t0
    log(f"[gp_iter] anchor N={ITER_N} (f64 dense Cholesky, {anchor_s:.1f} s, peak {_peak_gib('cuda'):.2f} GiB): "
        f"iterative {a['f_iter']:.4f} | Cholesky {a['f64']:.4f} | rel err {a['rel']:.3e} (tol {ANCHOR_TOL}) | "
        f"{a['m']} grid points: max|mean - exact| {a['dmean']:.3e} (standardized, tol {GRID_TOL}) | LOVE rank "
        f"{LOVE_RANK} var median rel err {a['love_med']:.4f} (tol {LOVE_MEDIAN_TOL}), {100 * a['conservative']:.1f}% "
        f"conservative | phase 17 took {seconds:.1f} s before the anchor")
    ra = a["ref_alpha"]
    log(f"[gp_iter] posterior mean gap with the reference's α at this fit: Woodbury P⁻¹y (its exhausted regime) "
        f"{ra['woodbury']:.3e} | PCG to tol {ra['tol']:g} (its CG regime; {ra['pcg_iters']} iterations, rel_res "
        f"{ra['pcg_rel']:.2e}) {ra['pcg']:.3e} | the port's (Woodbury gate, PCG to {POSTERIOR_TOL:g}) {a['dmean']:.3e}")
    assert a["rel"] <= ANCHOR_TOL, f"gp_iter: iterative objective off the f64 Cholesky one: {a['rel']}"
    assert a["dmean"] <= GRID_TOL, f"gp_iter: grid means off the exact posterior: {a['dmean']}"
    assert a["love_med"] <= LOVE_MEDIAN_TOL, f"gp_iter: LOVE variances off the exact ones: median {a['love_med']}"
    del gp, r
    torch.cuda.empty_cache()
    return launches, seconds


def fitc_table(n=FITC_N):
    """bench_fitc50k.py's rows (``make_fitc_problem``'s draws at f32) as a table."""
    p = make_fitc_problem(n, "cpu", torch.float32, kmeans=False)
    return xy_table(p["xc"].numpy(), p["y"].numpy()), p["g"]


def run_gp_sparse(table, g, device, dtype, n_u=FITC_NU, map_kw=GP_SPARSE_MAP, n_draws=GP_SPARSE_DRAWS):
    """bench_fitc50k.py's problem through ``GP(sparse=True)``: ``fit`` with
    ``n_u`` k-means inducing points (``build_model``, over every real row),
    then the 200-point line (x1 = g, x2 = 0) through ``predict`` and
    ``draw_point_samples``."""
    _peak_reset(device)
    gp, stages, fit_launches = _gp_fit(table, device, dtype, dict(sparse=True, n_u=n_u), map_kw)
    c0 = _counts()
    line = gp.parray(x1=np.asarray(g, dtype=np.float64), x2=np.zeros(len(g)))
    t0 = time.perf_counter()
    pred = gp.predict_points(line)
    _sync(device)
    t1 = time.perf_counter()
    draws = gp.draw_point_samples(line, n_samples=n_draws, seed=0)
    _sync(device)
    stages.update(predict=t1 - t0, draws=time.perf_counter() - t1)
    return dict(gp=gp, pred=pred, draws=draws, stages=stages, peak_gib=_peak_gib(device),
                launches={"fit": fit_launches, "predict": _delta(c0, _counts())})


def sparse_f64_gap(gp):
    """The fitted sparse model's f32 FITC objective against f64 at the same
    MAP and inducing points, in nats per point."""
    u32 = unconstrain(gp._params)
    dev = gp._xc.device

    def f(u, dt):
        la, lb = (torch.as_tensor(a, dtype=dt, device=dev) for a in (gp._ls_alpha, gp._ls_beta))
        return float(fitc_neg_logp(gp._spec, u, gp._xc.to(dt), gp._xk, gp._xu_c.to(dt), gp._xu_k, gp._yz.to(dt),
                                   la, lb))

    with torch.no_grad():
        f32, f64 = f(u32, gp._dtype), f({k: v.double() for k, v in u32.items()}, torch.float64)
    return f32, f64, abs(f32 - f64) / gp._yz.shape[0]


def phase18_gp_sparse():
    """bench_fitc50k.py's problem through GP(sparse=True) at N = 50,000,
    M = 512 (f32): build (k-means over all rows) → fit → the line through
    predict and 4 draws."""
    t_start = time.perf_counter()
    table, g = fitc_table()
    RbfGram.launches = 0
    with count_rbf_shapes("gp_sparse") as shapes:
        r = run_gp_sparse(table, g, "cuda", torch.float32)
    launches = RbfGram.launches
    seconds = time.perf_counter() - t_start
    shapes = dict(shapes)
    gp, aux = r["gp"], r["gp"]._fit_aux
    _log_gp_stages("gp_sparse", r["stages"])
    log(f"[gp_sparse] build_model holds the k-means: {FITC_N} real rows, 25 iterations, {FITC_NU} centers | "
        f"{len(aux['iters'])} restarts, iterations {aux['iters'].tolist()}, evaluations {aux['evals'].tolist()} | "
        f"values {[round(float(v), 4) for v in aux['all_values']]} (winner {aux['best_restart']}) | peak "
        f"{r['peak_gib']:.2f} GiB | rbf_gram launches {launches} (fit {r['launches']['fit']['rbf_gram']}, predict and "
        f"draws {r['launches']['predict']['rbf_gram']}) by shape {shapes}")
    f32, f64, per_pt = sparse_f64_gap(gp)
    mean, var = np.asarray(r["pred"].μ, dtype=np.float64), np.asarray(r["pred"].σ2, dtype=np.float64)
    rmse = float(np.sqrt(np.mean((mean - np.sin(1.3 * np.asarray(g, dtype=np.float64))) ** 2)))
    dv = r["draws"]["y"].values()
    log(f"[gp_sparse] neg_logp at fit: f32 {f32:.4f} (fit {gp._neg_logp:.4f}) | f64 {f64:.4f} | |diff| {per_pt:.2e} "
        f"nats/pt (tol {BASIN_TOL}; GP carries the port's whitened FITC evidence, the named divergence from "
        f"the reference's NaN f32 value) | MAP ls (z) {gp.MAP['ls_total'].tolist()} | line RMSE vs truth {rmse:.4f} | mean "
        f"[{mean.min():.3f}, {mean.max():.3f}] var [{var.min():.2e}, {var.max():.2e}] | draws {dv.shape}, finite "
        f"{bool(np.isfinite(dv).all())} | phase 18 took {seconds:.1f} s")
    assert gp.sparse and gp._cache is None and gp._xu_c.shape == (FITC_NU, 2), "gp_sparse: not a sparse model"
    assert sum(shapes.values()) == launches > 0, f"gp_sparse: rbf_gram launches {launches}, {shapes}"
    assert r["launches"]["predict"]["rbf_gram"] > 0, "gp_sparse: the line's predict never launched rbf_gram"
    assert mean.shape == (FITC_LINE,) and np.isfinite(mean).all() and np.isfinite(var).all() and (var >= 0).all()
    assert dv.shape == (GP_SPARSE_DRAWS, FITC_LINE) and np.isfinite(dv).all(), "gp_sparse: draws"
    assert per_pt <= BASIN_TOL, f"gp_sparse: f32 and f64 objectives differ by {per_pt} nats/pt"
    del r
    return launches, seconds, gp


# ------------------------------------------------------------------
# Phase 19: the classifier through the model layer (GPC)
# ------------------------------------------------------------------

GPC_DRAWS = N_LATENT_DRAWS  # (a)'s grid draws and (d)'s line draws
GPC_SAMPLER_N = BO_N  # (c): phase 11's generator at 512 rows
GPC_SPARSE_SAMPLER_N, GPC_SPARSE_SAMPLER_NU = LAPLACE_N, 128  # (e)
# What each run passes to find_MAP and sample on the card. (a)-(c) fit at
# find_MAP's defaults (8 restarts, maxiter 300, tol 1e-6) and (b) samples at
# the defaults (ESS, 2 chains, 500 + 500). Cut for time (PERF.md §4; phase
# 19 took 311.8 s with (c)'s ChEES at 200 + 200, HMC at 25 + 25 and (e)'s
# ChEES at 25 + 25 on one H100): (c)'s ChEES (16 chains) from 500 + 500 to
# 100 + 100, its HMC (2 chains, 32 leapfrog steps) from 500 + 500 to
# 10 + 10; (d) and (e) fit at phase 10's settings (8 restarts, maxiter 60,
# cut from 300) and (e)'s ChEES (16 chains) is cut to 12 + 12.
GPC_CARD = dict(dense_map={}, latent={}, chees=dict(draws=100, tune=100), hmc=dict(sampler="hmc", draws=10, tune=10),
                sparse_map=dict(n_restarts=FITC_RESTARTS, maxiter=FITC_MAXITER), sparse_chees=dict(draws=12, tune=12))
# The same calls at a few iterations each: the CPU rehearsal of phase 19
# (tests/test_torch_gpc.py)
GPC_SMALL = dict(dense_map=dict(n_restarts=2, maxiter=30), latent=dict(draws=10, tune=10),
                 chees=dict(draws=6, tune=6), hmc=dict(sampler="hmc", draws=3, tune=3, n_leapfrog=4),
                 sparse_map=dict(n_restarts=2, maxiter=10), sparse_chees=dict(draws=3, tune=3, chains=4))


def gpc_table(n, seed):
    """``make_fitc_problem``'s rows (seed 0: phases 9-10's, seed 1: phase
    11's) and labels 1[y > 0] as float64 columns x1, x2, label; and the
    200-point line's x1."""
    p = make_fitc_problem(n, "cpu", torch.float32, seed=seed, kmeans=False)
    X = p["xc"].numpy().astype(np.float64)
    cols = {"x1": X[:, 0], "x2": X[:, 1], "label": p["yb"].numpy().astype(np.float64)}
    return ArrayTable(cols, outputs=["label"]), p["g"]


def _gpc_fit(table, device, dtype, build_kw, map_kw):
    """``ArrayTableGPC(table).fit(...)`` of the label on (x1, x2): the model
    and ``GP.fit``'s phase seconds."""
    timings.clear()
    gp = ArrayTableGPC(table, outputs=["label"], dtype=dtype, device=device)
    gp.fit(outputs=["label"], continuous_dims=["x1", "x2"], heteroskedastic_outputs=False, MAP_kwargs=map_kw,
           **build_kw)
    _sync(device)
    return gp, timings.last()


def gpc_line(gp, g):
    """The 200-point line x1 = g, x2 = 0 in natural units."""
    return gp.parray(x1=np.asarray(g, dtype=np.float64), x2=np.zeros(len(g)))


def gpc_accuracy(prob, g):
    """Share of the line where the predicted class is the noise-free sign."""
    return float(np.mean((np.asarray(prob, dtype=np.float64) > 0.5) == (np.sin(1.3 * np.asarray(g, np.float64)) > 0)))


def gpc_twin(gp):
    """The fitted classifier's f64 twin at the same MAP (the plain path)."""
    tw = f64_twin(gp)
    if gp._mask is not None:
        tw._mask = gp._mask.double()
    if gp.sparse:
        tw._xu_c = gp._xu_c.double()
    return tw


def gpc_f64_gap(gp):
    """The f32 objective at the fitted MAP (Laplace, or FITC-Laplace when
    sparse) against the f64 twin's, in nats per row."""
    def value(m):
        u = unconstrain(m._params)
        la, lb = (torch.as_tensor(a, dtype=m._dtype, device=m._device) for a in (m._ls_alpha, m._ls_beta))
        if m.sparse:
            return float(fitc_laplace_neg_logp(m._spec, u, m._xc, m._xk, m._xu_c, m._xu_k, m._yz, la, lb, mask=m._mask))
        return float(laplace_neg_logp(m._spec, u, m._xc, m._xk, m._yz, la, lb, mask=m._mask))

    with torch.no_grad():
        f32, f64 = value(gp), value(gpc_twin(gp))
    return f32, f64, abs(f32 - f64) / gp._yz.shape[0]


@torch.no_grad()
def gpc_mean_sum_gaps(gp, tw, xs, xks, mean):
    """The latent mean Ks·w, w = m·(y − π(f̂)), at ``xs`` against the f64
    twin's: in the reference's form (the f32 Newton mode, f32 Ks and
    weights summed in f32), the same f32 Ks and weights summed in f64, the
    f32 Ks with the twin's f64 weights (its f64 Newton mode), and the
    model's own ``mean`` (the port's predictor: the mode in f64 from the
    f32 Grams): the largest gap of each, the f64 mean's largest magnitude
    and the two modes' gap."""
    def weights(model):
        m = torch.ones_like(model._yz) if model._mask is None else model._mask
        K = _jittered_gram(model._spec, model._params, model._xc, model._xk, DEFAULT_JITTER)
        f = laplace_mode(K, model._yz, mask=m)[0]
        return m * (model._yz - torch.sigmoid(f)), f

    (w, f), (w64, f64) = weights(gp), weights(tw)
    Ks = gram(gp._spec, gp._params, xs, xks, gp._xc, gp._xk)
    m64 = gram(tw._spec, tw._params, xs.double(), xks, tw._xc, tw._xk) @ w64
    return dict(f32_sum=float(((Ks @ w).double() - m64).abs().max()),
                f64_sum=float((Ks.double() @ w.double() - m64).abs().max()),
                f64_weights=float((Ks.double() @ w64 - m64).abs().max()), scale=float(m64.abs().max()),
                mode_gap=float((f.double() - f64).abs().max()),
                port=float((torch.as_tensor(np.asarray(mean, dtype=np.float64), device=m64.device) - m64).abs().max()))


def run_gpc_dense(table, g, device, dtype, map_kw, grid, n_draws, tmp_dir):
    """(a): ``GPC.fit``, ``predict_grid_proba`` on the grid, the line's
    ``predict_proba``, ``draw_grid_samples(n_draws)`` and save → load →
    ``predict_grid_proba``."""
    _peak_reset(device)
    l0 = RbfGram.launches
    gp, stages = _gpc_fit(table, device, dtype, {}, map_kw)
    fit_launches = RbfGram.launches - l0
    t0 = time.perf_counter()
    gp.prepare_grid(resolution=grid)
    prob_grid = gp.predict_grid_proba()
    _sync(device)
    t1 = time.perf_counter()
    prob_line = gp.predict_proba(gpc_line(gp, g))
    _sync(device)
    t2 = time.perf_counter()
    draws = gp.draw_grid_samples(n_samples=n_draws, seed=0)
    _sync(device)
    t3 = time.perf_counter()
    path = os.path.join(tmp_dir, "gpc.npz")
    gp.save(path)
    loaded = ArrayTableGPC.load(path, table, device=device)
    loaded.prepare_grid(resolution=grid)
    prob_loaded = loaded.predict_grid_proba()
    _sync(device)
    stages.update(predict_grid_proba=t1 - t0, line_proba=t2 - t1, draw_grid_samples=t3 - t2,
                  save_load_predict=time.perf_counter() - t3)
    return dict(gp=gp, prob_grid=prob_grid, prob_line=prob_line, draws=np.asarray(draws["label"].values()),
                loaded_equal=bool(np.array_equal(prob_loaded, prob_grid)), accuracy=gpc_accuracy(prob_line, g),
                stages=stages, peak_gib=_peak_gib(device),
                launches={"fit": fit_launches, "rest": RbfGram.launches - l0 - fit_launches})


def gpc_dense_readings(r):
    """(a)'s numbers against the f64 twin at the same MAP: the objective,
    the grid's probabilities, the latent grid mean's sum in f32 and f64, and
    the draws' floor beside the latent draws' own spread."""
    gp = r["gp"]
    tw = gpc_twin(gp)
    f32, f64, per_pt = gpc_f64_gap(gp)
    prob64 = tw.predict_grid_proba()
    points = np.asarray(_grid_tall(gp, gp.grid_points))
    xs, xks = gp._split_X(points)
    mean, var = gp.predict(points)
    sums = gpc_mean_sum_gaps(gp, tw, xs, xks, mean)
    with torch.no_grad():
        prior = gram_diag(gp._spec, gp._params, xs, xks)
    # the floor joint_draws puts under the factor (ops/posterior.draw_floor)
    floor = max(DEFAULT_JITTER, xs.shape[0] * torch.finfo(gp._dtype).eps * float(prior.mean()))
    p = r["draws"].reshape(r["draws"].shape[0], -1).astype(np.float64)
    with np.errstate(divide="ignore"):
        logit = np.log(p) - np.log1p(-p)  # ±inf where the f32 logistic saturated
    dev = logit - np.asarray(mean, dtype=np.float64)[None]
    ok = np.isfinite(dev)
    return dict(f32=f32, f64=f64, per_pt=per_pt, dprob=float(np.abs(r["prob_grid"] - prob64).max()), sums=sums,
                floor=floor, spread_pred=float(np.sqrt(np.mean(np.asarray(var, dtype=np.float64)))),
                spread_draws=float(np.sqrt(np.mean(dev[ok] ** 2))), draws_finite_logit=float(ok.mean()))


def run_gpc_latent(gp, g, sample_kw):
    """(b): ``sample(latent=True)`` on (a)'s model, then ``predict_proba``
    on the line over ESS_PROBA_DRAWS of its (θ, f) draws."""
    dev = gp._device
    trace, secs, peak = _timed(dev, lambda: gp.sample(latent=True, **sample_kw))
    prob, p_secs, _ = _timed(dev, lambda: gp.predict_proba(gpc_line(gp, g), source=trace, max_draws=ESS_PROBA_DRAWS))
    tune = sample_kw.get("tune", 500)
    return dict(trace=trace, prob=prob, secs=secs, proba_s=p_secs, peak_gib=peak, accuracy=gpc_accuracy(prob, g),
                iterations=tune + trace["_latent_f"].shape[1], drawn_trials=trace["_stats"]["ess_trials"][:, tune:])


def run_gpc_sampler(table, device, dtype, map_kw, chees_kw, hmc_kw):
    """(c): ``GPC.fit`` then ``sample()`` (ChEES) and ``sample(sampler='hmc')``,
    counting the calls of the chain-batched objective."""
    gp, stages = _gpc_fit(table, device, dtype, {}, map_kw)
    calls = [0]
    orig = gpc_module.laplace_neg_logp_chains

    def counted(*args, **kwargs):
        calls[0] += 1
        return orig(*args, **kwargs)

    gpc_module.laplace_neg_logp_chains = counted
    try:
        chees, c_secs, c_peak = _timed(device, lambda: gp.sample(**chees_kw))
        chees_calls = calls[0]
        hmc, h_secs, _ = _timed(device, lambda: gp.sample(**hmc_kw))
    finally:
        gpc_module.laplace_neg_logp_chains = orig
    leaps = np.asarray(chees["_stats"]["n_leapfrog"])
    return dict(gp=gp, stages=stages, chees=chees, hmc=hmc, chees_s=c_secs, hmc_s=h_secs, peak_gib=c_peak,
                calls=chees_calls, hmc_calls=calls[0] - chees_calls, leapfrog_steps=int(leaps.sum()),
                iterations=len(leaps))


def gpc_median_gap(gp, trace):
    """The f32 Laplace objective at the trace's natural-space median against
    f64 there, nats per row."""
    med = {k: np.median(v.reshape(-1, *v.shape[2:]), axis=0) for k, v in trace.items() if not k.startswith("_")}
    tw = gpc_twin(gp)
    vals = []
    with torch.no_grad():
        for m in (gp, tw):
            u = unconstrain({k: torch.as_tensor(v, dtype=m._dtype, device=m._device) for k, v in med.items()})
            la, lb = (torch.as_tensor(a, dtype=m._dtype, device=m._device) for a in (m._ls_alpha, m._ls_beta))
            vals.append(float(laplace_neg_logp(m._spec, u, m._xc, m._xk, m._yz, la, lb, mask=m._mask)))
    return vals[0], vals[1], abs(vals[0] - vals[1]) / gp._yz.shape[0]


def run_gpc_sparse(table, g, device, dtype, n_u, map_kw, n_draws, tmp_dir):
    """(d): ``GPC.fit(sparse=True, n_u)`` (k-means inside ``build_model``),
    the line's ``predict_proba``, ``draw_point_samples(n_draws)`` there and
    save → load → the line again."""
    _peak_reset(device)
    l0 = RbfGram.launches
    gp, stages = _gpc_fit(table, device, dtype, dict(sparse=True, n_u=n_u), map_kw)
    fit_launches = RbfGram.launches - l0
    line = gpc_line(gp, g)
    t0 = time.perf_counter()
    prob = gp.predict_proba(line)
    _sync(device)
    t1 = time.perf_counter()
    draws = gp.draw_point_samples(line, n_samples=n_draws, seed=0)
    _sync(device)
    t2 = time.perf_counter()
    path = os.path.join(tmp_dir, "gpc_sparse.npz")
    gp.save(path)
    loaded = ArrayTableGPC.load(path, table, device=device)
    prob_loaded = loaded.predict_proba(gpc_line(loaded, g))
    _sync(device)
    stages.update(line_proba=t1 - t0, draw_point_samples=t2 - t1, save_load_predict=time.perf_counter() - t2)
    return dict(gp=gp, prob=prob, draws=np.asarray(draws["label"].values()), accuracy=gpc_accuracy(prob, g),
                loaded_equal=bool(np.array_equal(prob_loaded, prob)), stages=stages, peak_gib=_peak_gib(device),
                launches={"fit": fit_launches, "rest": RbfGram.launches - l0 - fit_launches})


def run_gpc_sparse_sampler(table, device, dtype, n_u, map_kw, chees_kw):
    """(e): a sparse build and fit, then ``sample()`` (ChEES, the chains
    evaluated one after another on the FITC-Laplace evidence)."""
    gp, stages = _gpc_fit(table, device, dtype, dict(sparse=True, n_u=n_u), map_kw)
    trace, secs, peak = _timed(device, lambda: gp.sample(**chees_kw))
    return dict(gp=gp, stages=stages, trace=trace, secs=secs, peak_gib=peak)


def _trace_finite(trace):
    return all(np.isfinite(np.asarray(v)).all() for k, v in trace.items() if not k.startswith("_"))


def phase19_run(device="cuda", dtype=torch.float32, n_dense=LAPLACE_N, n_sampler=GPC_SAMPLER_N, n_sparse=FITC_N,
                n_sparse_sampler=GPC_SPARSE_SAMPLER_N, n_u=FITC_NU, n_u_sampler=GPC_SPARSE_SAMPLER_NU, grid=GRID,
                small=False, tmp_dir=None):
    """Phase 19's five runs, each with rbf_gram's launch count at 0 just
    before it and read just after (by shape): (a) the dense classifier on
    phase 11's generator (seed 1) at ``n_dense`` rows, (b) its latent
    sampler, (c) a dense classifier at ``n_sampler`` rows and its
    hyperparameter samplers, (d) the sparse classifier on phase 10's rows
    and labels at ``n_sparse`` (``n_u`` inducing points), (e) a sparse
    sampler at ``n_sparse_sampler`` rows (``n_u_sampler``). ``small`` takes
    GPC_SMALL's iterations in place of GPC_CARD's. Returns every result
    with its readings; asserts nothing."""
    cfg = GPC_SMALL if small else GPC_CARD
    out = {}

    def counted(name, fn):
        RbfGram.launches = 0
        with count_rbf_shapes(f"gpc_{name}") as shapes:
            t0 = time.perf_counter()
            r = fn()
            _sync(device)
            r["seconds"] = time.perf_counter() - t0
        r["rbf_launches"], r["shapes"] = RbfGram.launches, dict(shapes)
        out[name] = r
        return r

    with tempfile.TemporaryDirectory(dir=tmp_dir or _build.BUILD_DIR) as d:
        table, g = gpc_table(n_dense, seed=1)
        a = counted("dense", lambda: run_gpc_dense(table, g, device, dtype, cfg["dense_map"], grid, GPC_DRAWS, d))
        a.update(gpc_dense_readings(a))
        counted("latent", lambda: run_gpc_latent(a["gp"], g, cfg["latent"]))
        sampler_table, _ = gpc_table(n_sampler, seed=1)
        c = counted("chees", lambda: run_gpc_sampler(sampler_table, device, dtype, cfg["dense_map"], cfg["chees"],
                                                     cfg["hmc"]))
        c["median_gap"] = gpc_median_gap(c["gp"], c["chees"])
        out["hmc"] = dict(trace=c["hmc"], secs=c["hmc_s"], calls=c["hmc_calls"])
        sparse_table, g_s = gpc_table(n_sparse, seed=0)
        sp = counted("sparse", lambda: run_gpc_sparse(sparse_table, g_s, device, dtype, n_u, cfg["sparse_map"],
                                                      GPC_DRAWS, d))
        sp["f32"], sp["f64"], sp["per_pt"] = gpc_f64_gap(sp["gp"])
        sp["dprob"] = float(np.abs(sp["prob"] - gpc_twin(sp["gp"]).predict_proba(gpc_line(sp["gp"], g_s))).max())
        del sparse_table, sp["gp"]
        sampler_sparse_table, _ = gpc_table(n_sparse_sampler, seed=1)
        counted("sparse_chees", lambda: run_gpc_sparse_sampler(sampler_sparse_table, device, dtype, n_u_sampler,
                                                              cfg["sparse_map"], cfg["sparse_chees"]))
    return out


GPC_SLACK = ESS_ACC_SLACK  # line accuracy at most this far below the ops-level run's (phases 10, 11) or (a)'s


def _log_runs_launches(out):
    for name, r in out.items():
        if "rbf_launches" in r:
            log(f"[gpc] ({name}) {r['seconds']:.3f} s | peak {r.get('peak_gib') or 0:.2f} GiB | rbf_gram launches "
                f"{r['rbf_launches']} by shape {r['shapes']}")


def phase19_gpc(laplace_accuracy, fitc_laplace_accuracy):
    """The classifier through the model layer (``ArrayTableGPC``, f32):
    phase19_run's five runs at full size, logged and checked."""
    t_start = time.perf_counter()
    out = phase19_run()
    seconds = time.perf_counter() - t_start
    _log_runs_launches(out)
    a, b, c, h, d, e = (out[k] for k in ("dense", "latent", "chees", "hmc", "sparse", "sparse_chees"))

    gp = a["gp"]
    _log_gp_stages("gpc (a)", a["stages"])
    aux = gp._fit_aux
    su = a["sums"]
    log(f"[gpc] (a) N={LAPLACE_N}: {len(aux['iters'])} restarts, iterations {aux['iters'].tolist()}, evaluations "
        f"{aux['evals'].tolist()} | MAP ls (z) {gp.MAP['ls_total'].tolist()} eta {float(gp.MAP['η_total']):.4f} | "
        f"neg_logp at fit: f32 {a['f32']:.4f} (fit {gp._neg_logp:.4f}) | f64 {a['f64']:.4f} | |diff| "
        f"{a['per_pt']:.2e} nats/pt (tol {BASIN_TOL}) | grid probabilities vs the f64 twin max|diff| {a['dprob']:.3e} "
        f"(tol {GRID_TOL}) | line accuracy {a['accuracy']:.3f} (phase 11 {laplace_accuracy:.3f}) | loaded grid "
        f"bit-equal {a['loaded_equal']}")
    log(f"[gpc] (a) latent grid mean vs f64 (largest |mean| {su['scale']:.3f}): the reference's form (f32 mode, "
        f"Ks·(y − π) summed in f32) {su['f32_sum']:.3e} | the same f32 Ks and weights summed in f64 "
        f"{su['f64_sum']:.3e} | "
        f"f32 Ks with the f64 mode's weights {su['f64_weights']:.3e} (modes max|df| {su['mode_gap']:.3e}) | the port's "
        f"predictor (mode in f64) {su['port']:.3e} | draws: floor "
        f"{a['floor']:.3e} (sqrt {np.sqrt(a['floor']):.3e}) beside the latent spread sqrt(mean var) "
        f"{a['spread_pred']:.3e} and the draws' own RMS about the mean {a['spread_draws']:.3e} "
        f"({100 * a['draws_finite_logit']:.1f}% of the draws unsaturated)")
    assert a["per_pt"] <= BASIN_TOL, f"gpc (a): f32 and f64 objectives differ by {a['per_pt']} nats/pt"
    assert a["dprob"] <= GRID_TOL, f"gpc (a): grid probabilities off the f64 twin by {a['dprob']}"
    assert a["accuracy"] >= laplace_accuracy - GPC_SLACK, f"gpc (a): line accuracy {a['accuracy']}"
    assert a["draws"].shape == (GPC_DRAWS, GRID, GRID) and np.isfinite(a["draws"]).all(), "gpc (a): grid draws"
    assert a["loaded_equal"], "gpc (a): the loaded model's grid probabilities differ"

    mh = float(np.mean(b["trace"]["_stats"]["accept_rate"]))
    log(f"[gpc] (b) sample(latent=True): {b['secs']:.3f} s ({b['secs'] / b['iterations'] * 1e3:.2f} ms/iteration) | "
        f"predict_proba(source=trace) {b['proba_s']:.3f} s | MH acceptance {mh:.4f} | trials per slice step after "
        f"tuning mean {float(np.mean(b['drawn_trials'])):.2f} max {int(np.max(b['drawn_trials']))} | line accuracy "
        f"{b['accuracy']:.3f} ((a) {a['accuracy']:.3f})")
    assert _trace_finite(b["trace"]) and np.isfinite(b["trace"]["_latent_f"]).all() and np.isfinite(b["prob"]).all()
    assert ESS_ACCEPT[0] <= mh <= ESS_ACCEPT[1], f"gpc (b): MH acceptance {mh}"
    assert int(np.max(b["drawn_trials"])) < 200, "gpc (b): a slice step hit the 200-trial cap after tuning"
    assert b["accuracy"] >= a["accuracy"] - GPC_SLACK, f"gpc (b): line accuracy {b['accuracy']}"

    acc_c = float(c["chees"]["_stats"]["mean_accept"])
    f32, f64, per_pt = c["median_gap"]
    st = c["chees"]["_stats"]
    log(f"[gpc] (c) N={GPC_SAMPLER_N} sample() ChEES 16 chains, {c['iterations']} iterations: {c['chees_s']:.3f} s, "
        f"{c['chees_s'] / c['iterations']:.4f} s/iteration | leapfrog steps per iteration "
        f"{c['leapfrog_steps'] / c['iterations']:.2f} | {c['calls']} chain-batched objective calls "
        f"({c['chees_s'] / c['calls'] * 1e3:.3f} ms each) | acceptance {acc_c:.4f} | step "
        f"{float(st['step_size']):.4f} T {float(st['trajectory_length']):.4f} | neg_logp at the median: f32 "
        f"{f32:.4f} f64 {f64:.4f} |diff| {per_pt:.2e} nats/pt | HMC 2 chains: {h['secs']:.3f} s, {h['calls']} calls, "
        f"acceptance {float(h['trace']['_stats']['mean_accept']):.4f}")
    gpc_c = c["gp"]
    u_last = unconstrain({k: torch.as_tensor(v[:, -1], dtype=gpc_c._dtype, device=gpc_c._device)
                          for k, v in c["chees"].items() if not k.startswith("_")})
    la, lb = (torch.as_tensor(x, dtype=gpc_c._dtype, device=gpc_c._device) for x in (gpc_c._ls_alpha, gpc_c._ls_beta))
    _eval_breakdown("gpc (c) 16-chain Laplace value+grad", lambda u: laplace_neg_logp_chains(
        gpc_c._spec, u, gpc_c._xc, gpc_c._xk, gpc_c._yz, la, lb).sum(), u_last)
    assert _trace_finite(c["chees"]) and _trace_finite(h["trace"]), "gpc (c): non-finite draws"
    assert CHEES_ACCEPT[0] <= acc_c <= CHEES_ACCEPT[1], f"gpc (c): ChEES acceptance {acc_c}"
    assert c["calls"] == 1 + c["leapfrog_steps"], f"gpc (c): {c['calls']} calls for {c['leapfrog_steps']} steps"
    assert per_pt <= BASIN_TOL, f"gpc (c): f32 and f64 objectives differ by {per_pt} nats/pt at the median"

    _log_gp_stages("gpc (d)", d["stages"])
    log(f"[gpc] (d) N={FITC_N} sparse, M={FITC_NU}: neg_logp at fit f32 {d['f32']:.4f} | f64 {d['f64']:.4f} | "
        f"|diff| {d['per_pt']:.2e} nats/pt (tol {BASIN_TOL}) | line probabilities vs the f64 twin max|diff| "
        f"{d['dprob']:.3e} | line accuracy {d['accuracy']:.3f} (phase 10 "
        f"{fitc_laplace_accuracy:.3f}) | draws {d['draws'].shape} | loaded line bit-equal {d['loaded_equal']}")
    assert d["per_pt"] <= BASIN_TOL, f"gpc (d): f32 and f64 objectives differ by {d['per_pt']} nats/pt"
    assert d["accuracy"] >= fitc_laplace_accuracy - GPC_SLACK, f"gpc (d): line accuracy {d['accuracy']}"
    assert d["draws"].shape == (GPC_DRAWS, FITC_LINE) and np.isfinite(d["draws"]).all(), "gpc (d): draws"
    assert d["loaded_equal"], "gpc (d): the loaded model's line differs"

    acc_e = float(e["trace"]["_stats"]["mean_accept"])
    leaps_e = np.asarray(e["trace"]["_stats"]["n_leapfrog"])
    log(f"[gpc] (e) N={GPC_SPARSE_SAMPLER_N} sparse, M={GPC_SPARSE_SAMPLER_NU}: sample() ChEES 16 chains chain by "
        f"chain, {len(leaps_e)} iterations: {e['secs']:.3f} s | leapfrog steps per iteration {leaps_e.mean():.2f} "
        f"({e['secs'] / max(int(leaps_e.sum()), 1) / 16 * 1e3:.2f} ms a chain's value+grad) | acceptance {acc_e:.4f} | "
        f"phase 19 took {seconds:.1f} s")
    assert _trace_finite(e["trace"]), "gpc (e): non-finite draws"
    assert CHEES_ACCEPT[0] <= acc_e <= CHEES_ACCEPT[1], f"gpc (e): ChEES acceptance {acc_e}"
    for name, r in out.items():
        if "rbf_launches" in r:
            assert r["rbf_launches"] > 0 and sum(r["shapes"].values()) == r["rbf_launches"], \
                f"gpc ({name}): rbf_gram launches {r['rbf_launches']}, {r['shapes']}"
    launches = sum(r.get("rbf_launches", 0) for r in out.values())
    gpc_dense, gpc_sparse = out["dense"]["gp"], out["sparse_chees"]["gp"]
    del out, a, b, c, h, d, e, gp, gpc_c
    torch.cuda.empty_cache()
    return launches, seconds, gpc_dense, gpc_sparse


# ------------------------------------------------------------------
# Phase 20: heteroskedastic inputs through GP
# ------------------------------------------------------------------

HET_N = 2048  # rows of tests/test_het.py's generator (seed 0) and of its held-out set (seed 1)
HET_MAP = {}  # find_MAP's defaults: 8 restarts, maxiter 500, tol 1e-8, het_iters=2
HET_RATIO_MIN = 5.0  # tests/test_het.py: noisy − latent variance at x = +1.5 over x = −1.5 (the truth's is 100)
HET_NLPD_MARGIN = 0.1  # tests/test_het.py: held-out NLPD at least this far below the homoskedastic fit's
HET_LINE = 200
HET_SMALL = dict(n=256, map_kw=dict(n_restarts=2, maxiter=40, het_iters=1))


def het_table(n, seed):
    """tests/test_het.py's ``_het_df``: sin(1.2x), noise sd 0.05 for x < 0
    and 0.5 for x > 0, as columns x, y."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-2, 2, n))
    y = np.sin(1.2 * x) + rng.normal(0, np.where(x > 0, 0.5, 0.05))
    return ArrayTable({"x": x, "y": y}, outputs=["y"])


def het_twin(gp):
    """``f64_twin`` of a heteroskedastic-input model, its noise GP included."""
    tw = f64_twin(gp)
    tw._noise_params = {k: v.double() for k, v in gp._noise_params.items()}
    tw._noise_zt, tw._noise_mult = gp._noise_zt.double(), gp._noise_mult.double()
    with torch.no_grad():
        tw._noise_cache = posterior_cache(tw._noise_spec(), tw._noise_params, tw._xc, tw._xk, tw._noise_zt)
    return tw


def _het_noise_var(gp, xs):
    pts = gp.parray(x=np.asarray(xs, dtype=np.float64))
    return np.asarray(gp.predict_points(pts, with_noise=True).σ2) - np.asarray(gp.predict_points(pts, with_noise=False).σ2)


def _het_nlpd(gp, test):
    x, y = test.columns["x"], test.columns["y"]
    up = gp.predict_points(gp.parray(x=x), with_noise=True)
    mu, var = np.asarray(up.μ, dtype=np.float64), np.asarray(up.σ2, dtype=np.float64)
    return float(np.mean(0.5 * ((y - mu) ** 2 / var + np.log(2 * np.pi * var))))


def _het_objective(m, noise_mult):
    u = unconstrain(m._params)
    la, lb = (torch.as_tensor(a, dtype=m._dtype, device=m._device) for a in (m._ls_alpha, m._ls_beta))
    with torch.no_grad():
        return float(map_neg_logp(m._spec, u, m._xc, m._xk, m._yz, la, lb, noise_mult=noise_mult))


def phase20_run(device="cuda", dtype=torch.float32, n=HET_N, map_kw=HET_MAP, line=HET_LINE, tmp_dir=None):
    """Phase 20's run: ``fit(heteroskedastic_inputs=True)`` on ``n`` rows of
    tests/test_het.py's generator, a homoskedastic fit of the same table,
    and their readings: the noise ratio, held-out NLPD on ``n`` rows of seed
    1, the f32 objective at the MAP (with its ``noise_mult``) against f64,
    ``predict`` with and without noise on a ``line``-point line against an
    f64 twin that holds the same MAP and noise GP, and save → load. Returns
    the readings with each fit's seconds and rbf_gram's launches by shape;
    asserts nothing."""
    table, test = het_table(n, 0), het_table(n, 1)
    RbfGram.launches = 0
    with count_rbf_shapes("het") as shapes:
        timings.clear()
        t0 = time.perf_counter()
        gp = ArrayTableGP(table, outputs=["y"], dtype=dtype, device=device)
        gp.fit(outputs=["y"], continuous_dims=["x"], heteroskedastic_inputs=True, MAP_kwargs=map_kw)
        _sync(device)
        het_s, stages = time.perf_counter() - t0, timings.last()
        t0 = time.perf_counter()
        gp0 = ArrayTableGP(table, outputs=["y"], dtype=dtype, device=device)
        gp0.fit(outputs=["y"], continuous_dims=["x"],
                MAP_kwargs={k: v for k, v in map_kw.items() if k != "het_iters"})
        _sync(device)
        homo_s = time.perf_counter() - t0
        ratio = _het_noise_var(gp, [-1.5, 1.5])
        ratio0 = _het_noise_var(gp0, [-1.5, 1.5])
        nlpd, nlpd0 = _het_nlpd(gp, test), _het_nlpd(gp0, test)
        tw = het_twin(gp)
        f32, f64 = _het_objective(gp, gp._noise_mult), _het_objective(tw, tw._noise_mult)
        arr, _, _ = gp._prepare_points_for_prediction(gp.parray(x=np.linspace(-2, 2, line)), output=gp.outputs)
        gaps = {}
        for noise in (True, False):
            m32, v32 = gp.predict(arr, with_noise=noise)
            m64, v64 = tw.predict(arr, with_noise=noise)
            gaps[noise] = (float(np.abs(m32 - m64).max()), float(np.abs(v32 - v64).max()))
        with tempfile.TemporaryDirectory(dir=tmp_dir or _build.BUILD_DIR) as d:
            path = os.path.join(d, "het.npz")
            gp.save(path)
            loaded = ArrayTableGP.load(path, table, device=device)
        loaded_equal = all(np.array_equal(a, b) for noise in (True, False)
                           for a, b in zip(gp.predict(arr, with_noise=noise), loaded.predict(arr, with_noise=noise)))
        _sync(device)
    return dict(gp=gp, het_s=het_s, homo_s=homo_s, stages=stages, ratio=float(ratio[1] / ratio[0]),
                ratio0=float(ratio0[1] / ratio0[0]), nlpd=nlpd, nlpd0=nlpd0, f32=f32, f64=f64,
                per_pt=abs(f32 - f64) / n, gaps=gaps, loaded_equal=loaded_equal,
                loaded_het=bool(loaded.heteroskedastic_inputs), rbf_launches=RbfGram.launches, shapes=dict(shapes))


def phase20_het():
    """Heteroskedastic inputs through GP (ArrayTableGP, f32, N = 2,048 at
    find_MAP's defaults), logged and checked."""
    t_start = time.perf_counter()
    r = phase20_run()
    seconds = time.perf_counter() - t_start
    gp = r["gp"]
    fits = {k: v for k, v in r["stages"].items() if k.startswith("het_")}
    log(f"[het] N={HET_N}: fit(heteroskedastic_inputs=True) {r['het_s']:.3f} s, its {len(fits)} fits "
        + " | ".join(f"{k} {v:.3f} s" for k, v in fits.items()) + f" | homoskedastic fit {r['homo_s']:.3f} s")
    log(f"[het] noisy − latent variance at x = +1.5 over x = −1.5: {r['ratio']:.2f} (min {HET_RATIO_MIN}; "
        f"homoskedastic {r['ratio0']:.4f}) | held-out NLPD on {HET_N} rows of seed 1: {r['nlpd']:.4f} against "
        f"{r['nlpd0']:.4f} homoskedastic (margin {HET_NLPD_MARGIN}) | noise stats (z_m, z_s, l̄) "
        f"{tuple(round(v, 4) for v in gp._noise_stats)} | MAP ls (z) {gp.MAP['ls_total'].tolist()} sigma "
        f"{float(gp.MAP['σ']):.4f}")
    g = r["gaps"]
    log(f"[het] neg_logp at fit with its noise_mult: f32 {r['f32']:.4f} (fit {gp._neg_logp:.4f}) | f64 {r['f64']:.4f} | "
        f"|diff| {r['per_pt']:.2e} nats/pt (tol {BASIN_TOL}) | {HET_LINE}-point line vs the f64 twin (standardized): "
        f"with noise max|dmean| {g[True][0]:.3e} max|dvar| {g[True][1]:.3e}, without {g[False][0]:.3e} "
        f"{g[False][1]:.3e} (tol {GRID_TOL}) | save -> load bit-equal {r['loaded_equal']} | rbf_gram launches "
        f"{r['rbf_launches']} by shape {r['shapes']} | phase 20 took {seconds:.1f} s")
    assert gp.heteroskedastic_inputs and gp._noise_params is not None and r["loaded_het"], "het: no noise GP"
    assert r["ratio"] > HET_RATIO_MIN, f"het: noise ratio {r['ratio']}"
    assert r["nlpd"] <= r["nlpd0"] - HET_NLPD_MARGIN, f"het: NLPD {r['nlpd']} against {r['nlpd0']}"
    assert r["per_pt"] <= BASIN_TOL, f"het: f32 and f64 objectives differ by {r['per_pt']} nats/pt"
    assert max(max(v) for v in g.values()) <= GRID_TOL, f"het: line off the f64 twin: {g}"
    assert r["loaded_equal"], "het: the loaded model predicts otherwise"
    assert r["rbf_launches"] > 0 and sum(r["shapes"].values()) == r["rbf_launches"], \
        f"het: rbf_gram launches {r['rbf_launches']}, {r['shapes']}"
    launches = r["rbf_launches"]
    del r, gp
    torch.cuda.empty_cache()
    return launches, seconds


# ------------------------------------------------------------------
# Phase 21: mesh= on torch.distributed (one NCCL rank on the card)
# ------------------------------------------------------------------

MESH_FIT_RTOL = 1e-6  # one rank runs every start in the single-device order
MESH_DENSE_MAP = dict(n_restarts=2, maxiter=8)  # (b): cut from find_MAP's 8 restarts × 500 (PERF.md §4)
# (c): cut from find_MAP's 8 restarts × 500 to 2 × 1. Unstaged from its
# starts an iteration at N = 50,000 took ~8-11 evaluations of ~1.7-2 s
# (PCG to the 256 cap): 2 × 8 took 249 s, 2 × 2 78 s on one H100
MESH_ITER_MAP = dict(n_restarts=2, maxiter=1)
MESH_REL_TOL = 1e-5  # (b): sharded against single-device values, gradients and grid, relative
# (b), (f): two f32 gradients of one objective differ by their rounding
# (each ~2e-5 to 5e-5 of the largest entry from f64 at N = 16,384 at the
# prior's start, and much more at the fit, where the data term's gradient
# balances the prior's and its terms cancel), so each is held against f64:
# the sharded one no further off than twice the dense one
MESH_GRAD_F64_RATIO = 2.0
MESH_SMALL = dict(dense_n=128, iter_n=256, iter_cfg=IterConfig(maxiter=128, tol=1e-2, n_probes=8, precond_rank=16,
                                                               block=32, love_rank=32), grid=12)


def _refit_on_mesh(gp, mesh, map_kw):
    """``find_MAP(mesh=)`` on an already fitted model: (seconds, its
    single-device MAP and value, the mesh fit's)."""
    before, f_before = {k: np.array(v) for k, v in gp.MAP.items()}, gp._neg_logp
    t0 = time.perf_counter()
    gp.find_MAP(mesh=mesh, **map_kw)
    _sync(gp._device)
    return time.perf_counter() - t0, (before, f_before), ({k: np.array(v) for k, v in gp.MAP.items()}, gp._neg_logp)


def _map_gap(a, b):
    """Largest relative gap between two MAPs and between their values."""
    (ma, fa), (mb, fb) = a, b
    gm = max(float(np.max(np.abs(ma[k] - mb[k]) / np.maximum(np.abs(mb[k]), 1e-12))) for k in mb)
    return gm, abs(fa - fb) / max(abs(fb), 1e-12)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _sharded_vs_dense(gp, mesh, params):
    """(b)'s readings at ``params``: ``sharded_gram_mll``'s value and
    gradient at f32 and f64, and the dense ``mll`` (``map_neg_logp``'s data
    term) at f32 and f64."""
    from gumbi_tpu_torch.ops import mll as dense_mll
    from gumbi_tpu_torch.parallel import sharded_gram_mll

    def vg(fn, dt):
        p = {k: v.to(dt).detach().requires_grad_(True) for k, v in params.items()}
        val = fn(p, gp._xc.to(dt), gp._yz.to(dt))
        grads = torch.autograd.grad(val, list(p.values()))
        return float(val.detach()), [g.detach().double().cpu().numpy() for g in grads]

    shard = lambda p, x, y: sharded_gram_mll(mesh, gp._spec, p, x, gp._xk, y)  # noqa: E731
    dense = lambda p, x, y: dense_mll(gp._spec, p, x, gp._xk, y)  # noqa: E731
    _sync(gp._device)
    t0 = time.perf_counter()
    s32 = vg(shard, torch.float32)
    _sync(gp._device)
    s32_s = time.perf_counter() - t0
    d32, s64, d64 = vg(dense, torch.float32), vg(shard, torch.float64), vg(dense, torch.float64)

    def gap(a, b):
        return max(float(np.abs(x - y).max()) for x, y in zip(a[1], b[1]))

    scale = max(float(np.abs(g).max()) for g in d64[1])
    return dict(s32=s32[0], s64=s64[0], d32=d32[0], d64=d64[0], s32_s=s32_s, grad_scale=scale,
                grad_rel=gap(s32, d32) / scale, grad_gap64=gap(s32, d64), dense_gap64=gap(d32, d64),
                shard64_rel=gap(s64, d64) / scale)


MESH_TWO_RANK_N = 4096  # (f): bench_dense50k's problem cut to this many rows
MESH_TWO_RANK_TIMEOUT = 300


def _grad_errors(grads, g64):
    """Largest entry of each gradient's gap from the f64 one."""
    return max(float(np.abs(np.asarray(grads[k], dtype=np.float64) - g64[k]).max()) for k in g64)


def _dense_mll_grads(spec, params, X, y, dtype, device):
    """The dense ``mll``'s value and gradient at ``params`` (numpy), at ``dtype``."""
    from gumbi_tpu_torch.ops import mll as dense_mll

    p = {k: torch.as_tensor(v, dtype=dtype, device=device).requires_grad_(True) for k, v in params.items()}
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    val = dense_mll(spec, p, t(X), torch.zeros((len(y), 0), dtype=torch.long, device=device), t(y))
    grads = torch.autograd.grad(val, list(p.values()))
    return float(val.detach()), {k: g.detach().double().cpu().numpy() for k, g in zip(p, grads)}


def phase21_two_ranks(device="cuda", dtype=torch.float32, small=False):
    """(f): a world of two gloo ranks on one device (``tools/mesh_jobs``):
    phase 15 (a)'s table fit with ``find_MAP(mesh=, n_restarts=2)`` on a
    (1, 2) mesh, one restart a rank; ``sharded_gram_mll``'s value and
    gradient at N = 4,096 rows of bench_dense50k's problem (the prior's
    start); and ``blocked_cholesky``/``dist_quad_and_logdet`` at f64 on a
    96×96 SPD matrix. Each beside the one-rank result in this process: the
    single-device fit with the same two restarts, the dense ``mll`` at f32
    and f64, and numpy."""
    from gumbi_tpu_torch.tools.mesh_jobs import launch

    table = bench_table(64 if small else N_LOCS)
    n = 256 if small else MESH_TWO_RANK_N
    spec, X, y, la, lb, _ = make_dense_problem(n, np.float64)
    u0 = initial_params(spec, la, lb, n_restarts=1, seed=0, dtype=torch.float64, device="cpu")
    params = {k: v.numpy() for k, v in constrain({k: v[0] for k, v in u0.items()}).items()}
    rng = np.random.default_rng(11)
    A = rng.standard_normal((96, 96))
    K, yk = A @ A.T / 96 + np.eye(96), rng.standard_normal(96)
    find_kw = dict(n_restarts=2, maxiter=20) if small else dict(n_restarts=2)
    jobs = [("kronecker", "model", dict(mesh="1x2", cls="gp", columns=table.columns, outputs=MODEL_OUTPUTS,
                                        fit_kw=dict(continuous_dims=MODEL_DIMS), find_kw=find_kw, points=None)),
            ("mll", "gram_mll", dict(mesh="1x2", spec=spec, params=params, xc=X, xk=np.zeros((n, 0), np.int64),
                                     y=y, dtype=str(dtype).removeprefix("torch."))),
            ("quad_logdet", "quad_logdet", dict(mesh="1x2", K=K, y=yk, g_quad=0.7, g_logdet=1.3))]
    t0 = time.perf_counter()
    res = launch(jobs, world=2, meshes={"1x2": 1}, device_type=torch.device(device).type, backend="gloo",
                 timeout=MESH_TWO_RANK_TIMEOUT)
    launch_s = time.perf_counter() - t0
    out = dict(launch_s=launch_s, n=n, errors={k: [r[1] for r in v if r[0] != "ok"] for k, v in res.items()})
    if any(out["errors"].values()):
        return out
    gp1 = ArrayTableGP(table, outputs=MODEL_OUTPUTS, dtype=dtype, device=device)
    gp1.fit(outputs=MODEL_OUTPUTS, continuous_dims=MODEL_DIMS, MAP_kwargs=find_kw)
    v32, g32 = _dense_mll_grads(spec, params, X, y, dtype, device)
    _, g64 = _dense_mll_grads(spec, params, X, y, torch.float64, device)
    ranks = [r[1] for r in res["kronecker"]]
    m, q = res["mll"][0][1], res["quad_logdet"][0][1]
    Kinv = np.linalg.inv(K)
    alpha = Kinv @ yk
    exact = dict(L=np.linalg.cholesky(K), quad=yk @ alpha, logdet=np.linalg.slogdet(K)[1],
                 gK=1.3 * Kinv - 0.7 * np.outer(alpha, alpha), gy=1.4 * alpha)
    out.update(
        same=all(_same_tree(r[1], res[k][0][1]) for k in res for r in res[k][1:]),
        kron_gap=_map_gap((ranks[0]["MAP"], ranks[0]["neg_logp"]),
                          ({k: np.array(v) for k, v in gp1.MAP.items()}, gp1._neg_logp)),
        mll_rel=abs(m["value"] - v32) / abs(v32), grad_scale=max(float(np.abs(g).max()) for g in g64.values()),
        grad_gap64=_grad_errors(m["grads"], g64), dense_gap64=_grad_errors(g32, g64),
        qld_rel=max(_rel(q[k], exact[k]) for k in exact))
    return out


def _same_tree(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k]) for k in a)
    return np.array_equal(np.asarray(a), np.asarray(b))


def phase21_run(mesh, models, device="cuda", dtype=torch.float32, small=False):
    """Phase 21's runs on ``mesh``, each with the kernels' launch counts at 0
    just before it and read just after (the comparisons run after the
    counts are read): (a) the restart-sharded refit of phase 15 (a)'s
    Kronecker model, (b) the data-sharded dense fit of bench_dense50k's
    problem as a one-output table and ``predict(mesh=)`` on the grid, (c)
    the distributed iterative fit of phase 17's table and ``predict_grid``,
    (d) phase 19 (a)'s classifier refit on the mesh, (e) phase 18's sparse
    GP and phase 19 (e)'s sparse classifier refit on the mesh; then (f) two
    gloo ranks on the device (:func:`phase21_two_ranks`). ``models``: the
    fitted models of (a), (d) and (e) with the find_MAP keywords they were
    fitted with. ``small`` takes MESH_SMALL's sizes for (b), (c) and (f).
    Returns every reading; asserts nothing."""
    out = {}

    def counted(name, fn):
        for k in (RbfGram, FusedMatvec, FusedMatvecSym):
            k.launches = 0
        with count_rbf_shapes(f"mesh_{name}") as shapes:
            _peak_reset(device)
            t0 = time.perf_counter()
            r = fn()
            _sync(device)
            r["seconds"] = time.perf_counter() - t0
            r["peak_gib"] = _peak_gib(device)
        r["launches"], r["shapes"] = _counts(), dict(shapes)
        out[name] = r
        return r

    def refit(name):
        gp, map_kw = models[name]
        s, single, sharded = _refit_on_mesh(gp, mesh, map_kw)
        return dict(fit_s=s, single=single, sharded=sharded, gap=_map_gap(sharded, single), gp=gp)

    counted("kronecker", lambda: refit("kronecker"))

    def dense():
        n = MESH_SMALL["dense_n"] if small else DENSE_N
        _, X, y, _, _, _ = make_dense_problem(n, np.float64)
        gp, stages, _ = _gp_fit(xy_table(X, y), device, dtype, {}, dict(MESH_DENSE_MAP, mesh=mesh, shard_data=True))
        no_cache = gp._cache is None
        gp.prepare_grid(resolution=MESH_SMALL["grid"] if small else GRID)
        arr = np.asarray(_grid_tall(gp, gp.grid_points))
        t0 = time.perf_counter()
        m_mesh, v_mesh = gp.predict(arr, mesh=mesh)
        _sync(device)
        return dict(gp=gp, stages=stages, no_cache=no_cache, predict_s=time.perf_counter() - t0, arr=arr,
                    mesh_grid=(m_mesh, v_mesh), n=n)

    b = counted("data_sharded", dense)
    gp = b["gp"]
    m, v = gp.predict(b.pop("arr"))
    m_mesh, v_mesh = b.pop("mesh_grid")
    b.update(grid_rel=(_rel(m_mesh, m), _rel(v_mesh, v)),
             finite=bool(np.isfinite(m_mesh).all() and np.isfinite(v_mesh).all()))
    u0 = initial_params(gp._spec, gp._ls_alpha, gp._ls_beta, n_restarts=1, seed=gp.seed, dtype=dtype, device=device)
    b["readings"] = {"fit": _sharded_vs_dense(gp, mesh, gp._params),
                     "start": _sharded_vs_dense(gp, mesh, constrain({k: v[0] for k, v in u0.items()}))}

    def iterative():
        n = MESH_SMALL["iter_n"] if small else ITER_N
        cfg = MESH_SMALL["iter_cfg"] if small else gp_iter_config()
        X, yv = make_iter_data(n)
        gp, stages, _ = _gp_fit(xy_table(X, yv), device, dtype, {},
                                dict(MESH_ITER_MAP, engine="iterative", iter_config=cfg, seed=0, mesh=mesh))
        gp.prepare_grid(resolution=MESH_SMALL["grid"] if small else GRID)
        t0 = time.perf_counter()
        y = gp.predict_grid(with_noise=False)
        _sync(device)
        return dict(gp=gp, stages=stages, y=y, predict_s=time.perf_counter() - t0, n=n, cfg=cfg)

    c = counted("iterative", iterative)
    c["evaluations"] = int(c["gp"]._fit_aux["evals"].sum())
    gp, cfg = c["gp"], c["cfg"]
    st = gp._iter_state
    pn, pk = draw_probes(0, int(st["xc"].shape[0]), cfg, dtype=dtype, device=device)
    la, lb = (torch.as_tensor(a, dtype=dtype, device=device) for a in (gp._ls_alpha, gp._ls_beta))
    for key, cfg_s in (("single", dataclasses.replace(cfg, sym_matvec=False)), ("single_sym", cfg)):
        # the same engine on one device: with the general kernel (the mesh
        # path's) and with the symmetric one (the single-device default)
        with torch.no_grad():
            c[key] = float(iter_map_neg_logp(gp._spec, unconstrain(gp._params), st["xc"], st["xk"], st["yz"], la, lb,
                                             pn, pk, cfg_s, mask=st["mask"]))
    c["obj_rel"] = abs(gp._neg_logp - c["single"]) / abs(c["single"])
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    c["anchor"] = anchor_gp_iterative(gp, n_points=64 if small else ANCHOR_POINTS)
    gp._iter_cache = None  # the 50k LOVE factor
    counted("gpc", lambda: refit("gpc"))
    counted("sparse", lambda: refit("sparse"))
    counted("gpc_sparse", lambda: refit("gpc_sparse"))
    out["two_ranks"] = phase21_two_ranks(device, dtype, small)
    return out


def phase21_models(gp_kron, gp_sparse, gpc_dense, gpc_sparse):
    """Phase 21's ``models``: phases 15 (a), 18, 19 (a) and 19 (e)'s fitted
    models with the find_MAP keywords they were fitted with."""
    return {"kronecker": (gp_kron, MODEL_MAP_KWARGS), "sparse": (gp_sparse, GP_SPARSE_MAP),
            "gpc": (gpc_dense, GPC_CARD["dense_map"]), "gpc_sparse": (gpc_sparse, GPC_CARD["sparse_map"])}


def phase21_small_models(device="cpu", dtype=torch.float64):
    """Small fitted stand-ins of (a), (d) and (e)'s models, for the CPU
    rehearsal of phase 21 (``tests/test_torch_parallel.py`` holds the
    branches against the reference)."""
    kw = dict(n_restarts=2, maxiter=20)
    ra = run_model_fit(bench_table(64), device, dtype, map_kwargs=kw, grid=8)
    table, _ = fitc_table(512)
    sp, _, _ = _gp_fit(table, device, dtype, dict(sparse=True, n_u=16), kw)
    gt, _ = gpc_table(256, seed=1)
    gpc, _ = _gpc_fit(gt, device, dtype, {}, kw)
    gpc_s, _ = _gpc_fit(gt, device, dtype, dict(sparse=True, n_u=16), kw)
    return {"kronecker": (ra["gp"], kw), "sparse": (sp, kw), "gpc": (gpc, kw), "gpc_sparse": (gpc_s, kw)}


def phase21_mesh(models):
    """``mesh=`` through GP and GPC on a one-rank NCCL mesh
    (``parallel.make_mesh()``, f32), logged and checked; the process group
    is destroyed at the end. ``models`` as in :func:`phase21_run`
    (:func:`phase21_models`)."""
    import torch.distributed as dist

    from gumbi_tpu_torch.parallel import make_mesh

    t_start = time.perf_counter()
    mesh = make_mesh()
    log(f"[mesh] make_mesh(): {dist.get_backend()} group of {dist.get_world_size()}, mesh "
        f"{tuple(mesh.mesh_dim_names)} {tuple(mesh.shape)}")
    try:
        out = phase21_run(mesh, models)
    finally:
        dist.destroy_process_group()
    seconds = time.perf_counter() - t_start
    f = out.pop("two_ranks")
    for name, r in out.items():
        log(f"[mesh] ({name}) {r['seconds']:.3f} s | peak {r['peak_gib'] or 0:.2f} GiB | launches {r['launches']} | "
            f"rbf_gram by shape {r['shapes']}")
    for name in ("kronecker", "gpc", "sparse", "gpc_sparse"):
        r = out[name]
        log(f"[mesh] ({name}) find_MAP(mesh=) {r['fit_s']:.3f} s | neg_logp {r['sharded'][1]:.6f} against the "
            f"single-device fit's {r['single'][1]:.6f} | MAP rel gap {r['gap'][0]:.2e}, value {r['gap'][1]:.2e} "
            f"(rtol {MESH_FIT_RTOL})")
    b = out["data_sharded"]
    log(f"[mesh] (data_sharded) N={b['n']}: GP.fit phases " + " | ".join(f"{k} {v:.3f} s" for k, v in b["stages"].items())
        + f" | iterations {b['gp']._fit_aux['iters'].tolist()}, evaluations {b['gp']._fit_aux['evals'].tolist()} | "
        f"predict(mesh=) {b['predict_s']:.3f} s, grid mean rel "
        f"{b['grid_rel'][0]:.2e} var rel {b['grid_rel'][1]:.2e} against predict()")
    for at, rd in b["readings"].items():
        log(f"[mesh] (data_sharded) sharded_gram_mll at the {at}: f32 {rd['s32']:.4f} ({rd['s32_s']:.3f} s "
            f"value+grad) | f64 {rd['s64']:.4f} | |diff| {abs(rd['s32'] - rd['s64']) / b['n']:.2e} nats/pt (tol "
            f"{BASIN_TOL}) | dense mll f32 {rd['d32']:.4f}: rel {abs(rd['s32'] - rd['d32']) / abs(rd['d32']):.2e} | "
            f"gradients (largest f64 entry {rd['grad_scale']:.3e}): sharded − dense f32 {rd['grad_rel']:.2e} of it, "
            f"against f64 sharded {rd['grad_gap64']:.3e} dense {rd['dense_gap64']:.3e}, f64 "
            f"sharded − dense {rd['shard64_rel']:.2e} (f32 against f64: sharded at most {MESH_GRAD_F64_RATIO}× dense)")
    c = out["iterative"]
    aux, a = c["gp"]._fit_aux, c["anchor"]
    log(f"[mesh] (iterative) N={c['n']}: GP.fit phases " + " | ".join(f"{k} {v:.3f} s" for k, v in c["stages"].items())
        + f" | iterations {aux['iters'].tolist()}, evaluations {aux['evals'].tolist()} | objective at the fit "
        f"{c['gp']._neg_logp:.4f} against the single-device iter_map_neg_logp at its parameters and probes "
        f"{c['single']:.4f} (general kernel, the mesh path's): rel {c['obj_rel']:.2e} (tol {ANCHOR_TOL}); with the "
        f"symmetric kernel {c['single_sym']:.4f} | posterior solve {'exhausted' if aux['cache_exhausted'] else 'CG'}, "
        f"{int(aux['cache_cg_iters'])} CG iterations | predict_grid {c['predict_s']:.3f} s | anchor (f64 Cholesky): "
        f"objective rel {a['rel']:.2e}, grid max|mean - exact| {a['dmean']:.3e} (tol {GRID_TOL}), LOVE median "
        f"{a['love_med']:.4f}")
    if any(f["errors"].values()):
        log(f"[mesh] (two_ranks) two gloo ranks on one card failed ({f['launch_s']:.1f} s): {f['errors']}")
    else:
        log(f"[mesh] (two_ranks) two gloo ranks on one card, {f['launch_s']:.1f} s with the processes' start: "
            f"ranks' results equal {f['same']} | phase 15 (a)'s table, 2 restarts on a (1, 2) mesh: MAP rel gap to "
            f"the one-process fit {f['kron_gap'][0]:.2e}, value {f['kron_gap'][1]:.2e} | sharded_gram_mll at "
            f"N={f['n']}: value rel to the dense mll {f['mll_rel']:.2e}; gradient (largest f64 entry "
            f"{f['grad_scale']:.3e}) against f64 {f['grad_gap64']:.3e}, the dense f32 one's {f['dense_gap64']:.3e} "
            f"| blocked_cholesky and dist_quad_and_logdet at f64 against numpy: rel {f['qld_rel']:.2e}")
    log(f"[mesh] phase 21 took {seconds:.1f} s")
    for name in ("kronecker", "gpc", "sparse", "gpc_sparse"):
        gm, gf = out[name]["gap"]
        assert gm <= MESH_FIT_RTOL and gf <= MESH_FIT_RTOL, f"mesh ({name}): MAP off the single-device fit: {gm}, {gf}"
    assert b["no_cache"] and b["finite"], "mesh (data_sharded): an eager cache or a non-finite grid"
    for at, rd in b["readings"].items():
        assert abs(rd["s32"] - rd["s64"]) / b["n"] <= BASIN_TOL, f"mesh (data_sharded): f32 off f64 at the {at}"
        assert abs(rd["s32"] - rd["d32"]) / abs(rd["d32"]) <= MESH_REL_TOL, \
            f"mesh (data_sharded): sharded off the dense mll at the {at}: {rd['s32']} {rd['d32']}"
        assert rd["shard64_rel"] <= 1e-9, f"mesh (data_sharded): f64 gradients differ at the {at}: {rd}"
        assert rd["grad_gap64"] <= MESH_GRAD_F64_RATIO * rd["dense_gap64"] + MESH_REL_TOL * rd["grad_scale"], \
            f"mesh (data_sharded): f32 gradient further from f64 than the dense one's at the {at}: {rd}"
    assert max(b["grid_rel"]) <= MESH_REL_TOL, f"mesh (data_sharded): predict(mesh=) off predict(): {b['grid_rel']}"
    assert c["obj_rel"] <= ANCHOR_TOL, f"mesh (iterative): objective off the single-device one: {c['obj_rel']}"
    assert a["dmean"] <= GRID_TOL, f"mesh (iterative): grid means off the exact posterior: {a['dmean']}"
    y = c["y"]
    assert y.shape == (GRID, GRID) and np.isfinite(y.μ).all() and np.isfinite(y.σ2).all()
    assert c["launches"]["fused_stationary_matvec"] > 0, f"mesh (iterative): no general matvec launch: {c['launches']}"
    for name, r in out.items():
        assert r["launches"]["rbf_gram"] > 0 and sum(r["shapes"].values()) == r["launches"]["rbf_gram"], \
            f"mesh ({name}): rbf_gram launches {r['launches']}, {r['shapes']}"
    assert not any(f["errors"].values()), f"mesh (two_ranks): {f['errors']}"
    assert f["same"], "mesh (two_ranks): the ranks' results differ"
    assert max(f["kron_gap"]) <= MESH_REL_TOL and f["mll_rel"] <= MESH_REL_TOL and f["qld_rel"] <= 1e-10, \
        f"mesh (two_ranks): off the one-rank results: {f}"
    assert f["grad_gap64"] <= MESH_GRAD_F64_RATIO * f["dense_gap64"] + MESH_REL_TOL * f["grad_scale"], \
        f"mesh (two_ranks): f32 gradient further from f64 than the dense one's: {f}"
    launches = {k: sum(r["launches"][k] for r in out.values()) for k in _counts()}
    del out, b, c
    torch.cuda.empty_cache()
    return launches, seconds


def _rbf_bound(n, m, d):
    bytes_s = 4.0 * (n * d + m * d + n * m) / HBM_BYTES_PER_S
    ops_s = n * m * (3.0 * d + 2.0) / FP32_PEAK
    return (1e3 * max(ops_s, bytes_s), "bytes" if bytes_s >= ops_s else "operations")


def _fp32_peak_of_card():
    """FP32 FMA peak from the card's SM count and max SM clock (128 FP32
    lanes per Hopper SM, 2 flops per FMA), to set beside the data sheet's."""
    q = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60, check=True)
    mhz = float(q.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms, mhz, sms * 128 * 2 * mhz * 1e6


def main():
    unknown = [a for a in sys.argv[1:] if a != "--dense-breakdown"]
    if unknown:
        sys.exit(f"chip_smoke: unknown arguments {unknown}; usage: python3 chip_smoke.py [--dense-breakdown]")
    t_start = time.perf_counter()
    card = phase0_environment()
    phase1_build()
    phase1_products()
    rbf_max_abs, rbf_times = phase2_kernel_vs_plain()
    kron_launches = phase3_slice()
    fused_errs, fused_times, sym_times = phase4_fused_vs_plain()
    phase5_anchor()
    iter_launches, _, iter_r = phase6_iterative()
    ops_map_ls = constrain(iter_r["u_best"])["ls_total"].tolist()
    del iter_r
    chol_max_abs, chol_times = phase7_chol_vs_plain()
    dense_launches, _, _ = phase8_dense(breakdown="--dense-breakdown" in sys.argv[1:])
    phase8b_blocked_backward()
    p, fitc_launches = phase9_fitc()
    fitc_laplace_launches, fitc_laplace_accuracy = phase10_fitc_laplace(p)
    del p
    laplace_launches, _, _, lap_p, lap_r = phase11_laplace()
    bo_runs, dense = phase12_bo()
    sampler_runs, _, chees_ls = phase13_samplers(dense)
    ess_launches, _ = phase14_ess(lap_p, lap_r)
    laplace_accuracy = lap_r["accuracy"]
    del lap_p, lap_r
    gp_launches, _, gp_a = phase15_model_layer()
    surface_launches, _ = phase16_model_surface(gp_a, chees_ls)
    gp_iter_launches, _ = phase17_gp_iterative(ops_map_ls)
    gp_sparse_launches, _, gp_sparse = phase18_gp_sparse()
    gpc_launches, _, gpc_dense, gpc_sparse = phase19_gpc(laplace_accuracy, fitc_laplace_accuracy)
    het_launches, _ = phase20_het()
    mesh_launches, _ = phase21_mesh(phase21_models(gp_a, gp_sparse, gpc_dense, gpc_sparse))
    del gp_a, gp_sparse, gpc_dense, gpc_sparse
    sms, mhz, peak = _fp32_peak_of_card()
    log(f"[card] {sms} SMs at max {mhz:.0f} MHz: FP32 FMA peak {peak / 1e12:.1f} TFLOP/s "
        f"(bounds use the data sheet's {FP32_PEAK / 1e12:.0f})")
    log(f"[smoke] all phases took {time.perf_counter() - t_start:.1f} s")

    k_ms, p_ms, _ = rbf_times[(5120, 10000)]
    rb, rby = _rbf_bound(5120, 10000, 2)
    sk, sp, sb, sby, sb32 = fused_times[("sym", 50_000, 50_000, 65)]
    gk, gp, gb, gby, gb32 = fused_times[("general", 10_000, 50_000, 513)]
    ck, cp, cl, cb, cby, cb32 = chol_times[(1, DENSE_N)]
    kernels = [
        {"name": "rbf_gram", "route": "cuda", "source": "gumbi_tpu_torch/csrc/rbf_gram.cu",
         "replaces": "gumbi_tpu/ops/pallas_kernels.py:111",
         "launches": kron_launches["total"] + iter_launches["rbf_gram"] + dense_launches["rbf_gram"]
         + fitc_launches + fitc_laplace_launches + laplace_launches + sum(r["launches"] for r in bo_runs)
         + sampler_runs["chees"][0] + sampler_runs["hmc"][0] + ess_launches + gp_launches + surface_launches
         + gp_iter_launches["rbf_gram"] + gp_sparse_launches + gpc_launches + het_launches
         + mesh_launches["rbf_gram"],
         "launches_by_path": {"kronecker": kron_launches["total"], "iterative": iter_launches["rbf_gram"],
                              "dense": dense_launches["rbf_gram"], "fitc": fitc_launches,
                              "fitc_laplace": fitc_laplace_launches, "laplace": laplace_launches,
                              "bo": sum(r["launches"] for r in bo_runs), "chees": sampler_runs["chees"][0],
                              "hmc": sampler_runs["hmc"][0], "ess": ess_launches, "gp_model": gp_launches,
                              "gp_surface": surface_launches, "gp_iterative": gp_iter_launches["rbf_gram"],
                              "gp_sparse": gp_sparse_launches, "gpc": gpc_launches, "het": het_launches,
                              "mesh": mesh_launches["rbf_gram"]},
         "launches_by_path_and_shape": {path: dict(c) for path, c in RBF_SHAPES.items()},
         "max_abs_err": rbf_max_abs, "ms": k_ms, "plain_ms": p_ms, "bound_ms": rb, "bound_fp32_ms": rb,
         "bound_by": rby,
         "library_ms": None, "shape": "5120x10000 d=2",
         "ms_by_shape": {_shape_key(n, m): t[0] for (n, m), t in rbf_times.items()},
         "device_ms_by_shape": {_shape_key(n, m): t[2] for (n, m), t in rbf_times.items()},
         "plain_ms_by_shape": {_shape_key(n, m): t[1] for (n, m), t in rbf_times.items()},
         "bound_ms_by_shape": {_shape_key(n, m): _rbf_bound(n, m, 2)[0] for (n, m) in rbf_times}},
        {"name": "fused_stationary_matvec", "route": "cuda", "source": "gumbi_tpu_torch/csrc/fused_matvec.cu",
         "replaces": "gumbi_tpu/ops/pallas_kernels.py:309",
         "launches": iter_launches["fused_stationary_matvec"] + gp_iter_launches["fused_stationary_matvec"]
         + mesh_launches["fused_stationary_matvec"],
         "launches_by_path": {"iterative": iter_launches["fused_stationary_matvec"],
                              "gp_iterative": gp_iter_launches["fused_stationary_matvec"],
                              "mesh": mesh_launches["fused_stationary_matvec"]},
         "max_abs_err": fused_errs["general"],
         "ms": gk, "plain_ms": gp, "bound_ms": gb, "bound_fp32_ms": gb32, "bound_by": gby, "library_ms": None,
         "shape": "10000x50000 d=2 r=513", "ms_r65": fused_times[("general", 50_000, 50_000, 65)][0],
         "ms_r1": fused_times[("general", 10_000, 50_000, 1)][0],
         "ms_100000x100000_r65": fused_times[("general", 100_000, 100_000, 65)][0],
         "ms_50000x50000_r64": fused_times[("general", 50_000, 50_000, 64)][0],
         "ms_50000x50000_r1": fused_times[("general", 50_000, 50_000, 1)][0]},
        {"name": "fused_stationary_matvec_sym", "route": "cuda", "source": "gumbi_tpu_torch/csrc/fused_matvec.cu",
         "replaces": "gumbi_tpu/ops/pallas_kernels.py:471",
         "launches": iter_launches["fused_stationary_matvec_sym"] + gp_iter_launches["fused_stationary_matvec_sym"]
         + mesh_launches["fused_stationary_matvec_sym"],
         "launches_by_path": {"iterative": iter_launches["fused_stationary_matvec_sym"],
                              "gp_iterative": gp_iter_launches["fused_stationary_matvec_sym"],
                              "mesh": mesh_launches["fused_stationary_matvec_sym"]},
         "max_abs_err": fused_errs["sym"],
         "ms": sk, "plain_ms": sp, "bound_ms": sb, "bound_fp32_ms": sb32, "bound_by": sby, "library_ms": None,
         "shape": "50000x50000 d=2 r=65", "ms_r64": sym_times[64], "ms_r1": sym_times[1]},
        {"name": "blocked_cholesky", "route": "cuda", "source": "gumbi_tpu_torch/csrc/blocked_chol.cu",
         "replaces": "gumbi_tpu/ops/pallas_chol.py:184",
         "launches": dense_launches["blocked_cholesky"],
         "launches_by_path": {"dense": dense_launches["blocked_cholesky"]},
         "max_abs_err": chol_max_abs, "ms": ck, "plain_ms": cp, "bound_ms": cb, "bound_fp32_ms": cb32,
         "bound_by": cby,
         "library_ms": cl, "shape": f"1x{DENSE_N}x{DENSE_N}"},
    ]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
