"""The profiler's record of the traced units, reduced to what the metric
readers and the result's ``breakdown`` need.

The traced units (one extra job, or a few extra queries) run after the
measured window has closed, under ``torch.profiler`` with CPU and CUDA
activity, each inside ``record_function(unit)`` and its stages inside
``record_function(stage)`` (``core.Spans``). The traced window runs from the
first unit's start to the last unit's end; the device is busy where any
device operation runs (the union of their intervals).
"""

from __future__ import annotations

import collections
import contextlib
import re

from .roofline import count_rbf_shapes, rbf_bound_s

# The linear-algebra layer's kernels: cuSOLVER's potrf family (its kernels
# carry potrf, getrf, trtri, syrk names), cuBLAS trsm/trsv, the dense
# products that trsm blocks into and that form L⁻ᵀL⁻¹ (gemm, gemv, CUTLASS
# sgemm), and blocked_chol.cu's. The Gram and its backward run in rbf_gram
# and elementwise kernels, which match none of these.
LINALG = re.compile(r"potrf|getrf|potri|trtri|trsm|trsv|syrk|herk|gemm|gemv|chol", re.IGNORECASE)
RBF = "rbf_gram_kernel"


@contextlib.contextmanager
def traced():
    """Profile the block; yield a dict that holds, on exit, the profiler and
    the ``rbf_gram`` launches by shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    torch.cuda.synchronize()
    with count_rbf_shapes() as shapes:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            yield out
            torch.cuda.synchronize()
    out["prof"], out["rbf_shapes"] = prof, dict(shapes)


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(prof, rbf_shapes, unit, stages, n_units):
    """Busy and window seconds, device seconds by operation, idle seconds by
    the stage the host was in, and the linear-algebra and ``rbf_gram``
    sums, over the traced ``unit`` spans."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    kernels, units, stage_spans = [], [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.name != unit and e.name not in stages:
            if e.device_type == cuda:
                kernels.append((e.name, s, t))
        elif e.device_type == cuda:
            continue  # the profiler repeats record_function ranges on the device's timeline
        elif e.name == unit:
            units.append((s, t))
        else:
            stage_spans.append((e.name, s, t))
    if not units or not kernels:
        return None
    w0, w1 = min(s for s, _ in units), max(t for _, t in units)
    busy = _merge([(max(s, w0), min(t, w1)) for _, s, t in kernels if t > w0 and s < w1])
    busy_us = sum(t - s for s, t in busy)

    by_op = collections.Counter()
    for name, s, t in kernels:
        by_op[name] += (t - s) * 1e-6
    idle = collections.Counter()
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, t in zip(edges[::2], edges[1::2]):
        if t <= s:
            continue
        mid = 0.5 * (s + t)
        where = [n for n, a, b in stage_spans if a <= mid <= b]
        idle[where[0] if where else "between stages"] += (t - s) * 1e-6

    rbf_bound = sum(c * rbf_bound_s(n, m, d) for (n, m, d), c in rbf_shapes.items())
    return dict(
        busy_s=busy_us * 1e-6,
        window_s=(w1 - w0) * 1e-6,
        units=n_units,
        device_ops=[[n, s] for n, s in by_op.most_common(10)],
        idle_gaps=[[n, s] for n, s in idle.most_common(10)],
        linalg_s=sum((t - s) * 1e-6 for n, s, t in kernels if LINALG.search(n)),
        rbf_device_s=sum((t - s) * 1e-6 for n, s, t in kernels if RBF in n),
        rbf_bound_s=rbf_bound,
        rbf_launches=sum(rbf_shapes.values()),
    )
