#!/usr/bin/env python3
"""Build and run ``probe_rbf_store.cu`` on the card: the ``rbf_gram`` kernel
(``csrc/rbf_gram.cu``) against the same tile computation with other stores
(default-policy 16-byte stores, a TMA tensor store per tile) and other grid
sizes, at the paths' large shapes, each K compared bit for bit with the
shipped kernel's.

    python3 gumbi_tpu_torch/tools/probe_rbf_store.py

Needs nvcc and one NVIDIA GPU of compute capability 9.0. Prints the card
(name, power limit) and one line per shape and variant; exits nonzero if
the build or the run fails.
"""

import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent))

from gumbi_tpu_torch.ops._build import CSRC, find_nvcc  # noqa: E402


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        exe = Path(tmp) / "probe_rbf_store"
        subprocess.run([find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-I", str(CSRC), "-o", str(exe), str(HERE / "probe_rbf_store.cu")], check=True)
        subprocess.run([str(exe)], check=True)


if __name__ == "__main__":
    main()
