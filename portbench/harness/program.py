"""The program's own spans and counters, reduced to per-job numbers.

``gumbi_tpu_torch.utils.profiling`` records, while its tracing is on, a
span for each L-BFGS run (``lbfgs.run``), each evaluation (``lbfgs.vg``,
``lbfgs.v``), each blocking device-to-host read (``lbfgs.read``) and the
objective's forward and backward enqueue (``objective``,
``objective.grad``, with ``objective.gram``, ``.linalg`` and ``.prior``
inside the forward), and counts iterations and evaluations. While a
``torch.profiler`` records, each span is also a ``record_function`` range
on the profiler's clock.

* :func:`job_numbers` reduces one job's ``collect()`` to host milliseconds
  in the objective, in the optimizer's own work and in reads, with the
  counts.
* :func:`window_numbers` averages those over a window's jobs.
* :func:`attribute` reads one profiled job's events: the device's idle time
  by the innermost program span of the thread that ran the job, and the
  kernel-launch records inside evaluation spans.

A record without spans, as from a program that has none, gives no
numbers and raises nothing.
"""

from __future__ import annotations

import bisect
import collections

OBJECTIVE = ("objective", "objective.grad", "objective.gram", "objective.linalg", "objective.prior")
EVALS = ("lbfgs.vg", "lbfgs.v")
OPTIMIZER = ("lbfgs.run",) + EVALS
READ = "lbfgs.read"
PROGRAM = ("lbfgs.run", "lbfgs.vg", "lbfgs.v", "lbfgs.read") + OBJECTIVE
# Kernel-launch records in the profiler: the CUDA runtime API's (cuda*) and the low-level API's (cu*).
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")


def job_numbers(collected):
    """One job's numbers from ``profiling.collect()``: host ms in the
    objective's spans (children included), in the optimizer's own work
    (``lbfgs.run``, ``lbfgs.vg`` and ``lbfgs.v`` less what the objective and
    read spans inside them cover), in reads, the ``lbfgs.run`` spans' sum,
    and the iteration and evaluation counters; None without spans."""
    if not collected.get("spans"):
        return None
    from gumbi_tpu_torch.utils.profiling import span_totals

    totals = span_totals(collected["spans"])
    counts = collected.get("counts", {})

    def total_ms(name):
        return totals.get(name, (0, 0, 0))[1] * 1e-6

    return dict(
        objective_host_ms=total_ms("objective") + total_ms("objective.grad"),
        optimizer_host_ms=sum(totals.get(k, (0, 0, 0))[2] for k in OPTIMIZER) * 1e-6,
        read_wait_ms=total_ms(READ),
        run_ms=total_ms("lbfgs.run"),
        iters=counts.get("lbfgs.iters", 0),
        vg=counts.get("lbfgs.vg", 0),
        v=counts.get("lbfgs.v", 0),
    )


def window_numbers(jobs):
    """Per-job means of the host-clock numbers over a window's ``jobs``
    (each :func:`job_numbers`), and evaluations per iteration summed over
    them; empty without spans or iterations."""
    jobs = [j for j in jobs if j is not None]
    iters = sum(j["iters"] for j in jobs)
    if not jobs or not iters:
        return {}
    out = {k: sum(j[k] for j in jobs) / len(jobs) for k in ("objective_host_ms", "optimizer_host_ms", "read_wait_ms")}
    out["evals_per_iter"] = sum(j["vg"] + j["v"] for j in jobs) / iters
    return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def innermost(spans):
    """``[(start, end, name)]``: where each of the properly nested ``spans``
    (``(name, start, end)`` of one thread) is the innermost one."""
    out, stack, t = [], [], None
    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][1] <= s:
            top, end = stack.pop()
            if t < end:
                out.append((t, end, top))
            t = max(t, end)
        if stack and t < s:
            out.append((t, s, stack[-1][0]))
        stack.append((name, e))
        t = s
    while stack:
        top, end = stack.pop()
        if t < end:
            out.append((t, end, top))
        t = max(t, end)
    return out


def is_device_op(e, cuda, skip):
    """A kernel, copy or set on the device's timeline: not a user annotation,
    which the profiler repeats there for every ``record_function`` range."""
    return e.device_type == cuda and not getattr(e, "is_user_annotation", False) and e.name not in skip


def attribute(events, unit, stages=()):
    """Idle seconds of the device by the innermost program span, and launch
    records inside evaluation spans, over the ``unit`` span(s) of a profile.

    ``events`` is ``prof.events()`` (or events with the same ``name``,
    ``time_range``, ``device_type``, ``is_user_annotation`` and ``thread``).
    Returns None without a unit span or a device operation, else
    ``window_s``, ``busy_s``, ``idle_s``, ``idle_by_span`` (innermost program
    span of the thread that ran ``lbfgs.run``), ``idle_outside_s`` (idle
    while that thread was in no program span), ``launches`` (by name in
    ``launches_by_name``) and ``evals``.
    """
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    skip = set(PROGRAM) | {unit, *stages}
    units, ops, program, launches = [], [], [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if is_device_op(e, cuda, skip):
            ops.append((s, t))
        elif e.device_type == cuda:
            continue
        elif e.name == unit:
            units.append((s, t))
        elif e.name in PROGRAM:
            program.append((e.name, s, t, e.thread))
        elif e.name in LAUNCHES:
            launches.append((e.name, s))
    if not units or not ops:
        return None
    w0, w1 = min(s for s, _ in units), max(t for _, t in units)
    busy = _merge([(max(s, w0), min(t, w1)) for s, t in ops if t > w0 and s < w1])
    busy_us = sum(t - s for s, t in busy)
    runs = [th for name, _, _, th in program if name == "lbfgs.run"]
    thread = collections.Counter(runs).most_common(1)[0][0] if runs else None
    segments = innermost([(n, s, t) for n, s, t, th in program if th == thread])

    idle = collections.Counter()
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(s, t) for s, t in zip(edges[::2], edges[1::2]) if t > s]
    k = 0
    for gs, ge in gaps:  # both sorted: walk the segments along the gaps
        while k < len(segments) and segments[k][1] <= gs:
            k += 1
        j = k
        while j < len(segments) and segments[j][0] < ge:
            a, b, name = segments[j]
            overlap = min(b, ge) - max(a, gs)
            if overlap > 0:
                idle[name] += overlap
            j += 1
    idle_us = (w1 - w0) - busy_us
    evals = sorted((s, t) for n, s, t, th in program if n in EVALS and th == thread)
    starts = [s for s, _ in evals]
    inside = collections.Counter()
    for name, s in launches:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= evals[i][1]:
            inside[name] += 1
    return dict(
        window_s=(w1 - w0) * 1e-6,
        busy_s=busy_us * 1e-6,
        idle_s=idle_us * 1e-6,
        idle_by_span={n: v * 1e-6 for n, v in idle.most_common()},
        idle_outside_s=(idle_us - sum(idle.values())) * 1e-6,
        launches=sum(inside.values()),
        launches_by_name=dict(inside),
        evals=len(evals),
    )


def trace_numbers(attributed):
    """The device-trace numbers of one profiled job: idle ms under the
    objective's spans, and launch records per evaluation; empty without
    program spans."""
    if not attributed or not attributed["evals"]:
        return {}
    return dict(
        objective_idle_ms=sum(attributed["idle_by_span"].get(k, 0.0) for k in OBJECTIVE) * 1e3,
        launches_per_eval=attributed["launches"] / attributed["evals"],
    )


class DeviceOnly:
    """A profile whose ``events()`` leave out the device-timeline copies of
    ``record_function`` ranges (``is_user_annotation``) and of the program's
    span names: ``trace.reduce`` over it takes only kernels, copies and sets
    as device operations."""

    def __init__(self, prof):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        self._events = [e for e in prof.events() if e.device_type != cuda or is_device_op(e, cuda, PROGRAM)]

    def events(self):
        return self._events
