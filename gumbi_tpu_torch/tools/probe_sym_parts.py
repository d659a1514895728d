#!/usr/bin/env python3
"""Where the symmetric fused matvec's time goes, on the card: builds
``csrc/fused_matvec.cu`` four times with ``-DSYM_PROBE_SKIP=0..3`` (bit 0
leaves out the tile build, bit 1 the products; the results of those builds
are wrong on purpose) and times each at n = 50,000, d = 2, r = 65 and 1.

    python3 gumbi_tpu_torch/tools/probe_sym_parts.py

Needs nvcc, PyTorch with CUDA and one NVIDIA GPU of compute capability 9.0.
What is left with both skipped is the loop itself: fetching V's operands,
the barriers, the stores of the sums. Prints the card (name, power limit)
and one line per build and width.
"""

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from gumbi_tpu_torch.ops import _build  # noqa: E402
from gumbi_tpu_torch.ops import hopper_kernels as hk  # noqa: E402

LABELS = {0: "everything", 1: "no tile build", 2: "no products", 3: "neither"}


def time_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    n, d = 50_000, 2
    g = torch.Generator().manual_seed(7)
    x = (torch.rand(n, d, generator=g) * 4 - 2).cuda()
    ls = (torch.rand(d, generator=g) + 0.5).cuda()
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        for skip, label in LABELS.items():
            lib = Path(tmp) / f"fused_matvec_skip{skip}.so"
            subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, f"-DSYM_PROBE_SKIP={skip}", "-o", str(lib),
                            str(_build.CSRC / "fused_matvec.cu")], check=True)
            hk._fused_lib.cache_clear()
            hk.load_library = lambda name, lib=lib: ctypes.CDLL(str(lib))  # this build instead of the package's
            for r in (65, 1):
                v = torch.randn(n, r, generator=g).cuda()
                ms = time_ms(lambda: hk.fused_stationary_matvec_sym(x, v, ls, "ExpQuad"))
                print(f"sym n={n} d={d} r={r:2d}, {label}: {ms:.3f} ms", flush=True)


if __name__ == "__main__":
    main()
