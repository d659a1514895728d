"""Published peaks of one H100 and the bounds of the port's kernels.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at
its 700 W limit. ``rbf_bound_s``, ``chol_bound_s`` and ``matvec_bound_s``
are frozen copies of ``chip_smoke.py`` ``_rbf_bound``, ``_chol_bound`` and
``_matvec_bound`` (commit 47d6025), returning seconds. ``count_rbf_shapes``
is ``chip_smoke.count_rbf_shapes``'s wrapper pattern: it counts the
``rbf_gram`` kernel's launches by shape while a block runs.
"""

from __future__ import annotations

import collections
import contextlib

HBM_BYTES_PER_S = 3.35e12
TF32_PEAK = 495e12  # FLOP/s on the tensor cores; the peak every mfu share is taken against
FP32_PEAK = 67e12  # FLOP/s outside the tensor cores
TF32_PASSES = 3  # an f32-accurate product on the tensor cores: lo·hi + hi·lo + hi·hi


def rbf_bound_s(n, m, d):
    """Least time of one (n, m) Gram over d dims: the larger of the inputs
    read once and the output written once at the HBM rate, and the
    n·m·(3d + 2) distance and exp operations at the FP32 peak."""
    bytes_s = 4.0 * (n * d + m * d + n * m) / HBM_BYTES_PER_S
    ops_s = n * m * (3.0 * d + 2.0) / FP32_PEAK
    return max(bytes_s, ops_s)


def chol_bound_s(batch, n):
    """Least time of ``batch`` f32-accurate Cholesky factors of order n: the
    n³/3 product flops as three TF32 passes, against A read and L written."""
    ops_s = TF32_PASSES * batch * n**3 / 3.0 / TF32_PEAK
    bytes_s = 8.0 * batch * n * n / HBM_BYTES_PER_S
    return max(ops_s, bytes_s)


def matvec_bound_s(n, m, d, r, sym=False):
    """Least time of K(x1, x2)·V with V of r columns (see chip_smoke)."""
    entries = n * (n + 1) / 2 if sym else n * m
    product, distance = 2.0 * n * m * r, 2.0 * d * entries
    ops_s = max(TF32_PASSES * product / TF32_PEAK, distance / FP32_PEAK)
    inputs = n * d + n * r if sym else n * d + m * d + m * r
    return max(ops_s, 4.0 * (inputs + n * r) / HBM_BYTES_PER_S)


@contextlib.contextmanager
def count_rbf_shapes():
    """Count the port's ``rbf_gram`` kernel launches by (n, m, d) while the
    block runs, by wrapping the launcher its autograd function calls."""
    from gumbi_tpu_torch.ops import hopper_kernels

    counts = collections.Counter()
    orig = hopper_kernels._launch_rbf_gram

    def counted(x1, x2, ls, eta):
        out = orig(x1, x2, ls, eta)
        counts[(x1.shape[0], x2.shape[0], x1.shape[1])] += 1
        return out

    hopper_kernels._launch_rbf_gram = counted
    try:
        yield counts
    finally:
        hopper_kernels._launch_rbf_gram = orig
