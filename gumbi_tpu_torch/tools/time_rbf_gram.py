"""Time ``rbf_gram`` of this tree against another checkout's on one card, in
turns in one process, and check that the two give bit-equal K:

    python3 gumbi_tpu_torch/tools/time_rbf_gram.py --other PATH

PATH is the root of another checkout of the repository (e.g. the parent
commit unpacked with ``git archive`` under ``gumbi_tpu_torch/_build/``).
Its ``gumbi_tpu_torch`` is imported under another name (the package imports
itself only relatively), so it builds its kernels in its own tree at first
use and both wrappers run side by side on the same tensors.

At the paths' shapes ((1, 50,000) pivoted-Cholesky rows, (2,500, 50,000)
gradient blocks, 1,024², 5,120², 5,120×10,000 and 16,384², d = 2, ARD
lengthscales) it times each tree's whole call (wrapper and every device op
it issues) with CUDA events over 100 calls, five runs in turns (other,
this), and reports the medians; then it counts the CUDA kernels of 20 calls
under torch.profiler and their device time per call. K must be bit-equal
between the trees at those shapes and at ragged ones, d ∈ {1, 2, 3, 17},
with ARD and shared lengthscales. Last, it times each tree's rank-512
pivoted Cholesky at N = 50,000 (``bench_iterative50k.py``'s data and point,
512 (1, N) ``rbf_gram`` rows a call) with CUDA events, three calls a run,
five runs in turns. Prints the card (name, power limit), one line per shape
and, last, a JSON object of the medians.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

THIS = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(THIS))

import gumbi_tpu_torch.ops as this_ops  # noqa: E402

TIMED = ((1, 50_000), (2_500, 50_000), (1024, 1024), (5120, 5120), (5120, 10_000), (16_384, 16_384))
CHECKED = ((37, 23), (1, 23), (5, 10_001), (4, 50_000), (640, 640))
REPS, RUNS = 100, 5


def load_other(root):
    """The other checkout's ``ops`` package, its ``gumbi_tpu_torch`` imported
    under another name."""
    pkg = Path(root).resolve() / "gumbi_tpu_torch"
    name = "other_gumbi_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops")


def inputs(n, m, d, seed, shared=False):
    g = torch.Generator().manual_seed(seed)
    x1 = (torch.rand(n, d, generator=g) * 4 - 2).cuda()
    x2 = (torch.rand(m, d, generator=g) * 4 - 2).cuda()
    ls = (torch.rand(d, generator=g) * 1.2 + 0.3) * max(1.0, (d / 2) ** 0.5)
    ls = ls[:1].expand(d) if shared else ls
    return x1, x2, ls.cuda(), torch.tensor(1.3).cuda()


def time_ms(fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def pivoted_cholesky_call(ops, n=50_000, rank=512):
    """One tree's rank-``rank`` pivoted Cholesky at bench_iterative50k's data
    (seed 0, uniform on [-2, 2]²) and point (ls = (0.30, 0.35), η = 1,
    σ = 0.1), as a function of no arguments."""
    it = importlib.import_module(ops.__name__ + ".iterative")
    x = np.random.default_rng(0).uniform(-2, 2, size=(n, 2)).astype(np.float32)
    spec = ops.GPSpec(terms=(ops.GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2)
    xc = torch.as_tensor(x, device="cuda")
    xk = torch.zeros((n, 0), dtype=torch.long, device="cuda")
    params = ops.constrain({"ls_total": torch.log(torch.tensor((0.30, 0.35), device="cuda")),
                            "η_total": torch.zeros((), device="cuda"),
                            "σ": torch.log(torch.tensor(0.10, device="cuda"))})
    kdiag = ops.gram_diag(spec, params, xc, xk)
    row_fn = it._row_fn(spec, params, xc, xk, None)
    return lambda: it.pivoted_cholesky(row_fn, kdiag, rank)


def device_per_call(fn, calls=20):
    """(CUDA kernels per call, their device ms per call) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ks = [e.time_range.elapsed_us() for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(ks) / calls, sum(ks) / calls / 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the checkout to compare with")
    args = ap.parse_args()
    assert torch.cuda.is_available(), "this tool needs a CUDA GPU"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    other = load_other(args.other)
    pkgs = {"other": other, "this": this_ops}
    trees = {label: ops.rbf_gram for label, ops in pkgs.items()}
    print(f"other: {os.path.abspath(args.other)} | this: {THIS}", flush=True)

    unequal = []
    with torch.no_grad():
        for n, m in CHECKED + TIMED:
            for d in (1, 2, 3, 17):
                for shared in (False, True):
                    x1, x2, ls, eta = inputs(n, m, d, n + 7 * m + d, shared)
                    if not torch.equal(trees["other"](x1, x2, ls, eta), trees["this"](x1, x2, ls, eta)):
                        unequal.append(f"{n}x{m} d={d}{' shared' if shared else ''}")
                    torch.cuda.synchronize()
        print(f"K bit-equal between the trees in {len(CHECKED + TIMED) * 8 - len(unequal)} of "
              f"{len(CHECKED + TIMED) * 8} cases" + (f"; differ at {unequal}" if unequal else ""), flush=True)

        result = {}
        for n, m in TIMED:
            x1, x2, ls, eta = inputs(n, m, 2, seed=0)
            runs = {k: [] for k in trees}
            for _ in range(RUNS):
                for label, fn in trees.items():
                    runs[label].append(time_ms(lambda: fn(x1, x2, ls, eta)))  # noqa: B023
            row = {}
            for label, fn in trees.items():
                kernels, dev = device_per_call(lambda: fn(x1, x2, ls, eta))  # noqa: B023
                row[label] = {"ms": float(np.median(runs[label])), "runs": runs[label],
                              "kernels_per_call": kernels, "device_ms_per_call": dev}
            result[f"{n}x{m}"] = row
            print(f"{n}x{m} d=2: " + " | ".join(
                f"{label} {r['ms']:.4f} ms (runs {', '.join(f'{t:.4f}' for t in r['runs'])}; "
                f"{r['kernels_per_call']:g} kernels, {r['device_ms_per_call']:.4f} ms device per call)"
                for label, r in row.items()) + f" | this/other {row['this']['ms'] / row['other']['ms']:.3f}",
                flush=True)

        chol = {label: pivoted_cholesky_call(ops) for label, ops in pkgs.items()}
        runs = {k: [] for k in chol}
        for _ in range(RUNS):
            for label, fn in chol.items():
                runs[label].append(time_ms(fn, reps=3))
        result["pivoted_cholesky_50000_r512"] = {label: {"ms": float(np.median(r)), "runs": r}
                                                 for label, r in runs.items()}
        print("pivoted Cholesky N=50000 rank=512: " + " | ".join(
            f"{label} {np.median(r):.3f} ms (runs {', '.join(f'{t:.3f}' for t in r)})" for label, r in runs.items())
            + f" | this/other {np.median(runs['this']) / np.median(runs['other']):.3f}", flush=True)
    print(json.dumps({"unequal": unequal, "times": result}))
    if unequal:
        sys.exit(1)


if __name__ == "__main__":
    main()
