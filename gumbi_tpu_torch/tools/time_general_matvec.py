"""Time the general fused matvec of this tree against another checkout's, on
one card, in turns (other, this, this, other):

    python3 gumbi_tpu_torch/tools/time_general_matvec.py --other PATH

PATH is the root of another checkout of the repository (e.g. the parent
commit unpacked with ``git archive``). Each turn is a subprocess that
imports ``gumbi_tpu_torch`` from one tree (building its kernels there at
first use) and times ``fused_stationary_matvec`` with CUDA events at the
main path's shapes: the grid predict's 10,000 × 50,000 against r = 513
columns, a PCG sweep's 50,000² at r = 65, ``iter_predict_mean``'s
10,000 × 50,000 at r = 1 and 100,000² at r = 65 (past the symmetric
kernel's scratch gate). Inputs are the same seeded draws in every turn.
Prints the card (name, power limit), each turn's times, and each tree's
mean of its two turns; the last line is a JSON object of those means.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHAPES = ((10_000, 50_000, 513), (50_000, 50_000, 65), (10_000, 50_000, 1), (100_000, 100_000, 65))


def worker(tree):
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from gumbi_tpu_torch.ops.hopper_kernels import fused_stationary_matvec

    assert torch.cuda.is_available(), "this tool needs a CUDA GPU"
    times = {}
    with torch.no_grad():
        for n, m, r in SHAPES:
            g = torch.Generator().manual_seed(n + m + r)
            x1 = (torch.rand(n, 2, generator=g) * 4 - 2).cuda()
            x2 = x1 if n == m else (torch.rand(m, 2, generator=g) * 4 - 2).cuda()
            v = torch.randn(m, r, generator=g).cuda()
            ls = (torch.rand(2, generator=g) + 0.5).cuda()
            fn = lambda: fused_stationary_matvec(x1, x2, v, ls, "ExpQuad")  # noqa: E731
            fn()
            torch.cuda.synchronize()
            reps = 5 if n * m * r > 1e11 else 10
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            times[f"{n}x{m} r={r}"] = start.elapsed_time(end) / reps
    print(json.dumps(times), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the checkout to compare with")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return
    if not args.other:
        ap.error("--other PATH is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    this = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    runs = {"other": [], "this": []}
    for label, tree in (("other", args.other), ("this", this), ("this", this), ("other", args.other)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree],
                             capture_output=True, text=True, timeout=1200)
        if out.returncode != 0:
            raise RuntimeError(f"the {label} tree's turn failed:\n{out.stdout}\n{out.stderr}")
        t = json.loads(out.stdout.strip().splitlines()[-1])
        runs[label].append(t)
        print(f"{label} ({tree}): " + " | ".join(f"{k} {ms:.3f} ms" for k, ms in t.items()), flush=True)
    means = {label: {k: sum(t[k] for t in ts) / len(ts) for k in ts[0]} for label, ts in runs.items()}
    print(json.dumps(means))


if __name__ == "__main__":
    main()
