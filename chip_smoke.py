#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gumbi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a nonzero exit code):

0. Require CUDA; print the card (nvidia-smi name and power limit), the
   torch/CUDA versions, ``nvcc --version`` and whether ``triton`` imports.
1. Build the hand kernels from ``gumbi_tpu_torch/csrc`` with nvcc (sm_90a),
   one nvcc per source, all at once, and print the build time and ptxas'
   register/spill report of each source.
2. Hold the ``rbf_gram`` CUDA kernel against its plain torch version at
   the slice's shapes and ragged ones, d ∈ {1, 2, 3}: max |ΔK|/η² ≤ 1e-5,
   and the ls/η gradients through autograd. Time both at 5120² and
   5120×10000.
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
   2, 3}, ragged shapes, r ∈ {1, 5, 17, 32, 33, 64, 65, 100, 513} (every
   column width the kernels are built for), the symmetric band grid at
   nb = 4 and 7; |kernel − f64| ≤ 1e-5·(|K|·|V|) and no worse than twice
   the f32 plain version. The symmetric kernel against the plain version
   at N = 50,000 for r = 64 and 1 (LOVE, the cache's PCG). Time both at
   the large-N engine's shapes.
5. Anchor the iterative engine at N = 16,384: its objective against the
   dense Cholesky one (≤ 5e-4 relative) and LOVE variances at rank 512
   against the exact posterior diagonal (median ≤ 5%).
6. The large-N iterative path of ``bench_iterative50k.py`` at N = 50,000
   (f32, block 2,500, rank 512, 64 probes): a first pass of the staged
   campaign (32 coarse Cholesky restarts on 2,048 rows → L-BFGS polish on
   the iterative objective → LOVE cache → 100×100 grid), the rank-512
   pivoted Cholesky timed with CUDA events at the bench point, then, with
   every launch count at 0, the main path: one value+grad at the bench point
   ls = (0.30, 0.35), one at ls = (0.10, 0.12) where the f32
   factorization is not exhausted and PCG + SLQ run, and a warm campaign
   pass. Every polish evaluation's regime and CG iterations are logged.
   Checks: both values finite and trusted, PCG run at the second point,
   grid mean/var finite of shape (10000,), var ≥ 0,
   the f32 objective at the fit within 0.005 nats/point of an f64 one on
   the plain path, and each kernel launched on that path.
7. Print the card, the kernels' JSON line, then ``{"ok": true, ...}`` last.

Exits nonzero, printing no result, where CUDA is unavailable.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gumbi_tpu_torch.ops import (  # noqa: E402
    CoregTerm,
    FusedMatvec,
    FusedMatvecSym,
    GPSpec,
    GPTerm,
    IterConfig,
    RbfGram,
    coarse_restart_map,
    constrain,
    draw_probes,
    fit_kron_map,
    fused_matvec_plain,
    fused_stationary_matvec,
    fused_stationary_matvec_sym,
    gram,
    gram_diag,
    initial_params,
    iter_map_neg_logp,
    iter_map_value_and_grad,
    iter_posterior_cache,
    iter_predict_diag,
    kron_cache,
    kron_neg_logp,
    kron_predict_diag,
    lbfgs_backtracking_minimize,
    ls_prior_params,
    map_neg_logp,
    multi_restart_minimize,
    noise_diag,
    rbf_gram,
    rbf_gram_plain,
)
from gumbi_tpu_torch.ops import _build  # noqa: E402
from gumbi_tpu_torch.ops.hopper_kernels import SYM_TILE, _fused_lib, _rbf_lib  # noqa: E402
from gumbi_tpu_torch.ops.iterative import _row_fn, pivoted_cholesky  # noqa: E402
from gumbi_tpu_torch.ops.mll import DEFAULT_JITTER  # noqa: E402

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


SOURCES = ("rbf_gram", "fused_matvec")


def phase1_build():
    t0 = time.perf_counter()
    _build.build_libraries(SOURCES)
    _rbf_lib()
    _fused_lib()
    build_s = time.perf_counter() - t0
    log(f"[build] {', '.join(s + '.cu' for s in SOURCES)} built (one nvcc each, in parallel) "
        f"and loaded in {build_s:.2f} s")
    # Resource report of the same sources (registers, shared memory, spills)
    procs = [
        subprocess.Popen(
            [_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-cubin", "-Xptxas", "-v", "-o", str(_build.BUILD_DIR / f"{name}.cubin"),
             str(_build.CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for name in SOURCES
    ]
    for name, proc in zip(SOURCES, procs):
        out, _ = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"ptxas report of {name}.cu failed:\n{out}")
        for line in out.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"[build] {name} ptxas: {line.strip()}")
    return build_s


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


def phase2_kernel_vs_plain():
    shapes = [(640, 640), (1024, 1024), (5120, 5120), (5120, 10000), (37, 23)]
    max_abs = 0.0
    for n, m in shapes:
        for d in (1, 2, 3):
            x1, x2, ls, eta = _inputs(n, m, d, seed=n + 7 * m + d)
            ls_k, eta_k = ls.clone().requires_grad_(True), eta.clone().requires_grad_(True)
            ls_p, eta_p = ls.clone().requires_grad_(True), eta.clone().requires_grad_(True)
            K = rbf_gram(x1, x2, ls_k, eta_k)
            torch.cuda.synchronize()
            Kp = rbf_gram_plain(x1, x2, ls_p, eta_p)
            torch.cuda.synchronize()
            err = float((K - Kp).detach().abs().max())
            rel = err / float(eta) ** 2
            max_abs = max(max_abs, err)
            # gradients: the kernel route's analytic backward vs autograd
            # through the plain formula, with a positive cotangent
            gbar = torch.rand(n, m, generator=torch.Generator().manual_seed(d)).cuda()
            gk = torch.autograd.grad((K * gbar).sum(), (ls_k, eta_k))
            gp = torch.autograd.grad((Kp * gbar).sum(), (ls_p, eta_p))
            torch.cuda.synchronize()
            grel = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max()) for a, b in zip(gk, gp))
            log(f"[kernel] {n}x{m} d={d}: max|dK|/eta2 {rel:.3e}  grad(ls,eta) max rel {grel:.3e}")
            assert rel <= KERNEL_TOL, f"rbf_gram disagrees with plain at {n}x{m} d={d}: {rel}"
            assert grel <= GRAD_RTOL, f"rbf_gram gradient disagrees at {n}x{m} d={d}: {grel}"

    times = {}
    with torch.no_grad():
        for n, m in [(5120, 5120), (5120, 10000)]:
            x1, x2, ls, eta = _inputs(n, m, 2, seed=0)
            # plain, kernel, kernel, plain: each reported time is the mean of its two turns
            p1 = _time_ms(lambda: rbf_gram_plain(x1, x2, ls, eta))
            k1 = _time_ms(lambda: rbf_gram(x1, x2, ls, eta))
            k2 = _time_ms(lambda: rbf_gram(x1, x2, ls, eta))
            p2 = _time_ms(lambda: rbf_gram_plain(x1, x2, ls, eta))
            k, p = (k1 + k2) / 2, (p1 + p2) / 2
            gbs = 4 * n * m / (k * 1e-3) / 1e9
            log(f"[kernel] time {n}x{m} d=2: kernel {k:.4f} ms ({k1:.4f}, {k2:.4f}; {gbs:.0f} GB/s "
                f"of output) | plain {p:.4f} ms ({p1:.4f}, {p2:.4f})")
            times[(n, m)] = (k, p)
    return max_abs, times


def make_problem(n_locs, device, dtype):
    """bench.py's make_problem, rebuilt with numpy: same seeds, same spec."""
    rng = np.random.default_rng(0)
    Xb = rng.uniform(-2, 2, size=(n_locs, 2)).astype(np.float32)
    f1 = np.sin(1.3 * Xb[:, 0]) * np.cos(0.9 * Xb[:, 1])
    f2 = 0.7 * f1 + 0.3 * np.cos(1.1 * Xb[:, 0])
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
    lowers, uppers = [], []
    for j in range(2):
        dd = np.abs(sub[:, j : j + 1] - sub[:, j : j + 1].T)[np.triu_indices(len(sub), 1)]
        dd = dd[dd > 0]
        lowers.append(max(float(dd.min()), 0.01))
        uppers.append(float(dd.max()))
    ls_alpha, ls_beta = ls_prior_params(lowers, uppers)
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
    log(f"[slice] kernel launches: fit {launches['fit']} | predict {launches['predict']}")
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
    """(bound_ms, bound_by) of K(x1,x2)·V at the FP32 peak against each input
    read once and the output written once. Operations: 2·n·m·r product
    flops plus 2·d distance flops per distinct Gram entry, n·m of them, or
    n(n+1)/2 for the symmetric K(x, x)."""
    entries = n * (n + 1) / 2 if sym else n * m
    ops_s = (2.0 * n * m * r + 2.0 * d * entries) / FP32_PEAK
    inputs = n * d + n * r if sym else n * d + m * d + m * r
    bytes_s = 4.0 * (inputs + n * r) / HBM_BYTES_PER_S
    return (1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes")


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
        # every column width the kernels are built for: 16·TN columns per
        # chunk, TN = 1 (r 1, 5, 513's remainder), 2 (17, 32), 4 (33, 64),
        # 5 (65), 8 (100, 513's full chunks)
        for r in (1, 5, 17, 32, 33, 64, 65, 100, 513):
            x1, x2, v, ls = _fused_inputs(2500, 300, 2, r, seed=r)
            out = fused_stationary_matvec(x1, x2, v, ls, "ExpQuad")
            errs["general"] = max(errs["general"], _fused_check(f"general ExpQuad 2500x300 r={r}",
                                                                out, x1, x2, v, ls, "ExpQuad"))
            x, _, vs, ls = _fused_inputs(2500, 2500, 2, r, seed=100 + r)
            out = fused_stationary_matvec_sym(x, vs, ls, "Matern52")
            errs["sym"] = max(errs["sym"], _fused_check(f"sym Matern52 n=2500 r={r}",
                                                        out, x, x, vs, ls, "Matern52"))
        for nb in (4, 7):  # even and odd band grids
            n = nb * SYM_TILE
            for kind in ("ExpQuad", "Matern32"):
                x, _, vs, ls = _fused_inputs(n, n, 2, 65, seed=nb)
                sym = fused_stationary_matvec_sym(x, vs, ls, kind)
                gen = fused_stationary_matvec(x, x, vs, ls, kind)
                errs["sym"] = max(errs["sym"], _fused_check(f"sym {kind} n={n} (nb={nb}) r=65",
                                                            sym, x, x, vs, ls, kind))
                dsg = float((sym - gen).abs().max() / gen.abs().max())
                log(f"[fused] sym vs general n={n} {kind}: max|d|/max|general| {dsg:.3e}")
                assert dsg <= 1e-5, f"sym and general kernels disagree at n={n}: {dsg}"

        # The sym kernel at the main path's other widths: the LOVE sweeps
        # (r = 64) and the posterior cache's PCG (r = 1), N = 50,000
        for r in (64, 1):
            x, _, vs, ls = _fused_inputs(50_000, 50_000, 2, r, seed=200 + r)
            ref = fused_matvec_plain(x, x, vs, ls, "ExpQuad")
            dmax = float((fused_stationary_matvec_sym(x, vs, ls, "ExpQuad") - ref).abs().max() / ref.abs().max())
            log(f"[fused] sym ExpQuad n=50000 r={r}: max|kernel-plain|/max|plain| {dmax:.2e}")
            assert dmax <= 1e-5, f"sym kernel disagrees with plain at n=50000 r={r}: {dmax}"
            del ref

        # Times at the large-N engine's shapes: plain, kernel, kernel, plain
        times = {}
        cases = [("sym", 50_000, 50_000, 65), ("general", 50_000, 50_000, 65), ("general", 10_000, 50_000, 513)]
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
            bound, by = _matvec_bound(n, m, 2, r, sym=which == "sym")
            log(f"[fused] time {which} {n}x{m} d=2 r={r}: kernel {k:.3f} ms ({k1:.3f}, {k2:.3f}; "
                f"{flops / (k * 1e-3) / 1e9:.0f} GFLOP/s counted as 2nm(d+r)) | plain {p:.3f} ms "
                f"({p1:.3f}, {p2:.3f}; {flops / (p * 1e-3) / 1e9:.0f} GFLOP/s) | bound {bound:.3f} ms "
                f"({by}) | max|kernel-plain|/max|plain| {dmax:.2e}")
            assert dmax <= 1e-5, f"{which} kernel disagrees with plain at {n}x{m} r={r}: {dmax}"
            times[(which, n, m, r)] = (k, p, bound, by)
    return errs, times


# ------------------------------------------------------------------
# Phases 5-6: the large-N iterative engine (bench_iterative50k.py's path)
# ------------------------------------------------------------------

ITER_N, ITER_BLOCK, ITER_RANK, ITER_PROBES = 50_000, 2_500, 512, 64
ITER_TOL, ITER_MAXITER, ITER_QUAD, LOVE_RANK = 1e-2, 256, 32, 512
ITER_RESTARTS, ITER_COARSE_N, ITER_COARSE_ITERS, ITER_POLISH_ITERS = 32, 2048, 40, 40
FIT_TOL = 1e-8  # GP.find_MAP's default tol, the coarse and polish ftol
BENCH_LS = (0.30, 0.35)  # bench_iterative50k.py's evaluation point
# At BENCH_LS the f32 pivoted Cholesky of rank 512 is exhausted on the card
# (Woodbury, no CG), so the objective phase adds a shorter lengthscale
# where it is not, and PCG + SLQ run at full N through the sym kernel.
CG_LS = (0.10, 0.12)
CHOL_N = 16_384
ANCHOR_TOL = 5e-4  # |iterative − Cholesky| / |Cholesky| at CHOL_N
LOVE_MEDIAN_TOL = 0.05  # median |LOVE − exact| / exact variance at CHOL_N


def make_iter_data(n, seed=0):
    """bench_iterative50k.py's make_data: same seed, same draws."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(n, 2)).astype(np.float32)
    y = (np.sin(1.3 * X[:, 0]) * np.cos(0.9 * X[:, 1]) + rng.normal(0, 0.1, n)).astype(np.float32)
    return X, y


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


def bench_point_value_and_grad(device="cuda", dtype=torch.float32, n=ITER_N, ls=BENCH_LS):
    """One value+grad of the iterative MAP objective at bench_iterative50k's
    point, ls = (0.30, 0.35), η = 1, σ = 0.1 (or at another ``ls``), with
    its priors and config."""
    spec = _iter_spec()
    X, y = make_iter_data(n)
    xc = torch.as_tensor(X, dtype=dtype, device=device)
    yt = torch.as_tensor(y, dtype=dtype, device=device)
    xk = torch.zeros((n, 0), dtype=torch.long, device=device)
    la, lb = np.array([2.0, 2.0]), np.array([1.0, 1.0])
    cfg = IterConfig(maxiter=ITER_MAXITER, tol=ITER_TOL, n_probes=ITER_PROBES, precond_rank=ITER_RANK,
                     quad_steps=ITER_QUAD, block=ITER_BLOCK, love_rank=LOVE_RANK)
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
    lowers, uppers = [], []
    for j in range(2):
        dd = np.abs(sub[:, j : j + 1] - sub[:, j : j + 1].T)[np.triu_indices(len(sub), 1)]
        dd = dd[dd > 0]
        lowers.append(max(float(dd.min()), 0.01))
        uppers.append(float(dd.max()))
    la, lb = ls_prior_params(lowers, uppers)
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
        evals.append((info["exhausted"], info["iters"], float(info["rel_res"])))
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


def _log_campaign(label, r):
    ph = r["phases"]
    regimes = "".join("E" if e else "C" for e, _, _ in r["evals"])
    cg = [it for _, it, _ in r["evals"]]
    log(f"[iter] campaign {label}: coarse {ph['coarse_s']:.3f} s ({len(r['aux_c']['iters'])} restarts @"
        f"{len(r['idx'])}, iters {r['aux_c']['iters'].tolist()}) | polish {ph['polish_s']:.3f} s "
        f"({r['polish_iters']} iterations, {len(r['evals'])} evaluations) | cache {ph['cache_s']:.3f} s "
        f"(regime {'exhausted' if r['cache_info']['exhausted'] else 'CG'}, "
        f"CG iters {r['cache_info']['iters']}) | predict {ph['predict_s']:.3f} s ({r['xg'].shape[0]}-pt grid) | "
        f"total {sum(ph.values()):.3f} s")
    log(f"[iter] polish evaluations (E = exhausted/Woodbury, C = CG): {regimes} | CG iters {cg}")
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
    """First campaign pass, then the counted main path (bench point +
    warm campaign), then its checks."""
    _log_campaign("first pass", run_iter_campaign("cuda", torch.float32))
    time_pivoted_cholesky()
    for k in (RbfGram, FusedMatvec, FusedMatvecSym):
        k.launches = 0
    bench = bench_point_value_and_grad()
    cgpt = bench_point_value_and_grad(ls=CG_LS)
    after_objective = _counts()
    r = run_iter_campaign("cuda", torch.float32)
    launches = _counts()
    for label, b in (("bench point", bench), ("CG point", cgpt)):
        log(f"[iter] {label} ls={b['ls']}: value {b['value']:.4f} | grad {b['grad']} | "
            f"CG iters {b['iters']} | rel_res {b['rel_res']:.3e} | "
            f"{'exhausted' if b['exhausted'] else 'CG'} regime | value+grad {b['wall_s']:.3f} s")
    log(f"[iter] launches of the two value+grads: {after_objective}")
    _log_campaign("warm pass", r)
    log(f"[iter] main path launches (two value+grads + warm campaign): {launches}")
    for b in (bench, cgpt):
        assert np.isfinite(b["value"]), f"iterative objective at ls={b['ls']} is not finite"
        assert b["exhausted"] or b["rel_res"] <= 10 * ITER_TOL, f"solve at ls={b['ls']} not trusted: {b}"
    assert not cgpt["exhausted"] and cgpt["iters"] > 0, f"no PCG ran at ls={CG_LS}: {cgpt}"
    assert after_objective["fused_stationary_matvec_sym"] > 0, "the objective's PCG never ran the sym kernel"

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
    card = phase0_environment()
    phase1_build()
    rbf_max_abs, rbf_times = phase2_kernel_vs_plain()
    kron_launches = phase3_slice()
    fused_errs, fused_times = phase4_fused_vs_plain()
    phase5_anchor()
    iter_launches, _, _ = phase6_iterative()
    sms, mhz, peak = _fp32_peak_of_card()
    log(f"[card] {sms} SMs at max {mhz:.0f} MHz: FP32 FMA peak {peak / 1e12:.1f} TFLOP/s "
        f"(bounds use the data sheet's {FP32_PEAK / 1e12:.0f})")

    k_ms, p_ms = rbf_times[(5120, 10000)]
    rb, rby = _rbf_bound(5120, 10000, 2)
    sk, sp, sb, sby = fused_times[("sym", 50_000, 50_000, 65)]
    gk, gp, gb, gby = fused_times[("general", 10_000, 50_000, 513)]
    kernels = [
        {"name": "rbf_gram", "route": "cuda", "source": "gumbi_tpu_torch/csrc/rbf_gram.cu",
         "replaces": "gumbi_tpu/ops/pallas_kernels.py:111",
         "launches": kron_launches["total"] + iter_launches["rbf_gram"],
         "launches_by_path": {"kronecker": kron_launches["total"], "iterative": iter_launches["rbf_gram"]},
         "max_abs_err": rbf_max_abs, "ms": k_ms, "plain_ms": p_ms, "bound_ms": rb, "bound_by": rby,
         "library_ms": None, "shape": "5120x10000 d=2"},
        {"name": "fused_stationary_matvec", "route": "cuda", "source": "gumbi_tpu_torch/csrc/fused_matvec.cu",
         "replaces": "gumbi_tpu/ops/pallas_kernels.py:309",
         "launches": iter_launches["fused_stationary_matvec"], "max_abs_err": fused_errs["general"],
         "ms": gk, "plain_ms": gp, "bound_ms": gb, "bound_by": gby, "library_ms": None,
         "shape": "10000x50000 d=2 r=513"},
        {"name": "fused_stationary_matvec_sym", "route": "cuda", "source": "gumbi_tpu_torch/csrc/fused_matvec.cu",
         "replaces": "gumbi_tpu/ops/pallas_kernels.py:471",
         "launches": iter_launches["fused_stationary_matvec_sym"], "max_abs_err": fused_errs["sym"],
         "ms": sk, "plain_ms": sp, "bound_ms": sb, "bound_by": sby, "library_ms": None,
         "shape": "50000x50000 d=2 r=65"},
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
