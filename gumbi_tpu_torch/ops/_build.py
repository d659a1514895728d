"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into ``_build/<name>-<hash>.so`` inside the
package directory, where ``<hash>`` covers the source, every header under
``csrc/`` that it includes (directly or through another header) and the
compiler flags, so an edited source or header rebuilds and an unchanged one
loads at once. The
library has a plain C interface (no PyTorch headers), which keeps a build to
seconds. There is no fallback: a missing nvcc or a failed build raises.

Nothing here runs at import time; the first launch of a kernel builds it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_libraries", "find_nvcc", "load_library", "source_files"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels of gumbi_tpu_torch need the CUDA toolkit to build"
    )


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_files(src: Path) -> list[Path]:
    """``src`` and the files next to it that it includes with quotes,
    transitively, in the order first met."""
    files, todo = [], [src]
    while todo:
        f = todo.pop()
        if f in files:
            continue
        files.append(f)
        for name in _INCLUDE.findall(f.read_text()):
            inc = (f.parent / name).resolve()
            if inc.is_file():
                todo.append(inc)
    return files


def _source_hash(src: Path) -> str:
    h = hashlib.sha256()
    for f in source_files(src):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash(CSRC / f'{name}.cu')}.so"


def build_libraries(names) -> None:
    """Build every missing ``csrc/<name>.cu`` library, one nvcc per source,
    all started together; raise if any build fails."""
    todo = [n for n in dict.fromkeys(names) if not _lib_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    jobs = []
    for name in todo:
        # Build into a temporary file and rename: concurrent first uses
        # never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        src = CSRC / f"{name}.cu"
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        jobs.append((name, src, tmp, proc))
    failures = []
    for name, src, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, _lib_path(name))
        else:
            failures.append(f"nvcc failed to build {src.name} (exit {proc.returncode}):\n{out}\n{err}")
        if os.path.exists(tmp):
            os.unlink(tmp)
    if failures:
        raise RuntimeError("\n".join(failures))


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it."""
    build_libraries([name])
    return ctypes.CDLL(str(_lib_path(name)))
