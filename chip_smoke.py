#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gumbi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a nonzero exit code):

0. Require CUDA; print the card (nvidia-smi name and power limit), the
   torch/CUDA versions, ``nvcc --version`` and whether ``triton`` imports.
1. Build the hand kernel from ``gumbi_tpu_torch/csrc`` with nvcc (sm_90a)
   and print the build time and ptxas' register/spill report.
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
4. Print the kernels' JSON line, then ``{"ok": true, "device": ...}`` last.

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
    GPSpec,
    GPTerm,
    RbfGram,
    constrain,
    fit_kron_map,
    initial_params,
    kron_cache,
    kron_neg_logp,
    kron_predict_diag,
    ls_prior_params,
    rbf_gram,
    rbf_gram_plain,
)
from gumbi_tpu_torch.ops import _build  # noqa: E402
from gumbi_tpu_torch.ops.hopper_kernels import _rbf_lib  # noqa: E402

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


def phase1_build():
    t0 = time.perf_counter()
    _rbf_lib()
    build_s = time.perf_counter() - t0
    log(f"[build] rbf_gram.cu built and loaded in {build_s:.2f} s")
    # Resource report of the same source (registers, shared memory, spills)
    out = _build.BUILD_DIR / "rbf_gram.cubin"
    rep = subprocess.run(
        [_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-cubin", "-Xptxas", "-v", "-o", str(out), str(_build.CSRC / "rbf_gram.cu")],
        capture_output=True, text=True, timeout=300, check=True,
    )
    for line in (rep.stdout + rep.stderr).splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")
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


def main():
    card = phase0_environment()
    phase1_build()
    max_abs, times = phase2_kernel_vs_plain()
    launches = phase3_slice()
    k_ms, p_ms = times[(5120, 10000)]
    log(card)
    print(json.dumps({"kernels": [{
        "name": "rbf_gram",
        "route": "cuda",
        "source": "gumbi_tpu_torch/csrc/rbf_gram.cu",
        "replaces": "gumbi_tpu/ops/pallas_kernels.py:111",
        "launches": launches["total"],
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
