#!/usr/bin/env python3
"""Where the fused matvecs' time goes, on the card: builds
``csrc/fused_matvec.cu`` with ``-DSYM_PROBE_SKIP=0..3`` (bit 0 leaves out
the tile build, bit 1 the products; the results of those builds are wrong on
purpose), all builds at once, and times each

* symmetric kernel at n = 50,000, d = 2, r = 65 and 1;
* general kernel at 10,000 × 50,000 (r = 513 and 1) and 50,000² (r = 65),
  d = 2, with its own x2 segments and with one segment.

    python3 gumbi_tpu_torch/tools/probe_matvec_parts.py

Needs nvcc, PyTorch with CUDA and one NVIDIA GPU of compute capability 9.0.
What is left with both skipped is the loop itself: fetching V's operands,
the barriers, the stores of the sums. Prints the card (name, power limit)
and one line per build, kernel and shape.
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

BUILDS = {"everything": "-DSYM_PROBE_SKIP=0", "no tile build": "-DSYM_PROBE_SKIP=1",
          "no products": "-DSYM_PROBE_SKIP=2", "neither": "-DSYM_PROBE_SKIP=3"}
GENERAL = ((10_000, 50_000, 513), (50_000, 50_000, 65), (10_000, 50_000, 1))


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
    g = torch.Generator().manual_seed(7)
    x = (torch.rand(50_000, 2, generator=g) * 4 - 2).cuda()
    x1 = x[:10_000].contiguous()
    ls = (torch.rand(2, generator=g) + 0.5).cuda()
    vs = {r: torch.randn(50_000, r, generator=g).cuda() for r in (1, 65, 513)}
    split = hk.general_split
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        libs = {label: Path(tmp) / f"fused_matvec_{i}.so" for i, label in enumerate(BUILDS)}
        procs = [subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", BUILDS[label],
                                   "-o", str(lib), str(_build.CSRC / "fused_matvec.cu")],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for label, lib in libs.items()]
        for label, proc in zip(libs, procs):
            report, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"the probe build {label!r} failed:\n{report}")
            # the general kernel's registers and spills, per instantiation
            entry = None
            for line in report.splitlines():
                if "Compiling entry" in line:
                    entry = "fused_matvec_gen_kernel" in line
                elif entry and ("spill" in line or "registers" in line):
                    print(f"[{label}] general kernel ptxas: {line.strip()}", flush=True)
        for label, lib in libs.items():
            hk._fused_lib.cache_clear()
            hk.load_library = lambda name, lib=lib: ctypes.CDLL(str(lib))  # this build instead of the package's
            for r in (65, 1):
                ms = time_ms(lambda: hk.fused_stationary_matvec_sym(x, vs[r], ls, "ExpQuad"))
                print(f"sym n=50000 d=2 r={r:3d}, {label}: {ms:.3f} ms", flush=True)
            for n, m, r in GENERAL:
                a = x1 if n < m else x
                for one in (False, True):
                    s = split(n, m, r)[0]
                    if one and s == 1:
                        continue
                    hk.general_split = (lambda n_, m_, r_: (1, *split(n_, m_, r_)[1:])) if one else split
                    ms = time_ms(lambda: hk.fused_stationary_matvec(a, x, vs[r], ls, "ExpQuad"))
                    print(f"general {n}x{m} d=2 r={r:3d} s={1 if one else s}, {label}: {ms:.3f} ms", flush=True)
            hk.general_split = split


if __name__ == "__main__":
    main()
