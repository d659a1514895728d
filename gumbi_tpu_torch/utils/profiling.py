"""Phase timing, program spans and counters, device profiling hooks.

``Timings`` and ``phase`` are ``gumbi_tpu/utils/profiling.py``'s: named
wall-clock phases into a registry (``GP.fit`` times specify/build/find_MAP
with them). ``profile_trace`` wraps a region in ``torch.profiler``.

``span`` and ``count`` instrument the hot path (the optimizer and the
objectives). They record only inside ``tracing()``; off, the default, each
returns after one check of a module flag, ``span`` with one shared null
context. On, a span keeps its name, start and end
(``time.perf_counter_ns``), its enclosing span on the same thread and the
thread, and while a ``torch.profiler`` records it is also a
``record_function`` range, so that the profiler's timeline shows it beside
the device's kernels. A span never waits for the device: a blocking
read has a span of its own. ``collect`` hands over and clears what was
recorded; ``span_totals`` sums it by name.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

__all__ = [
    "Timings",
    "timings",
    "phase",
    "profile_trace",
    "SPAN_NAMES",
    "span",
    "count",
    "tracing",
    "collect",
    "span_totals",
]


class Timings:
    """Accumulates named phase durations (seconds)."""

    def __init__(self):
        self._records = defaultdict(list)

    def add(self, name: str, seconds: float):
        self._records[name].append(seconds)

    def totals(self) -> dict:
        return {k: sum(v) for k, v in self._records.items()}

    def last(self) -> dict:
        return {k: v[-1] for k, v in self._records.items()}

    def clear(self):
        self._records.clear()

    def report(self) -> str:
        lines = [f"{k:>24s}: {sum(v):8.3f} s  (n={len(v)})" for k, v in self._records.items()]
        return "\n".join(lines)


#: Global registry used by the models layer; swap or clear freely.
timings = Timings()


@contextmanager
def phase(name: str, registry: Timings = None):
    """Context manager timing one named phase into the registry."""
    reg = timings if registry is None else registry
    t0 = time.perf_counter()
    try:
        yield
    finally:
        reg.add(name, time.perf_counter() - t0)


@contextmanager
def profile_trace(log_dir: str):
    """Wrap a region in ``torch.profiler`` (CPU and, where present, CUDA
    activity), writing a TensorBoard-readable trace under ``log_dir``."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
    ):
        yield


# ------------------------------------------------------------------
# Program spans and counters
# ------------------------------------------------------------------

#: Every span the port records: one L-BFGS run, its value+grad and
#: value-only evaluations, its blocking device-to-host reads, the objective's
#: forward and backward enqueue, and the objective's Gram, linear algebra and
#: hyperprior.
SPAN_NAMES = (
    "lbfgs.run",
    "lbfgs.vg",
    "lbfgs.v",
    "lbfgs.read",
    "objective",
    "objective.grad",
    "objective.gram",
    "objective.linalg",
    "objective.prior",
)

_NULL = nullcontext()
_on = False


class _Recorder:
    """The spans and counts recorded since the last ``collect``.

    A span is ``[name, start_ns, end_ns, parent, thread]``; ``parent`` is the
    index of the enclosing span of the same thread in the same batch, or -1.
    """

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.spans = []
        self.counts = {}

    def stack(self):
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def take(self):
        with self.lock:
            out = {"spans": self.spans, "counts": self.counts}
            self.spans, self.counts = [], {}
        return out


_rec = _Recorder()


class _Span:
    __slots__ = ("name", "record", "range")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        import torch

        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        stack = _rec.stack()
        self.record = [self.name, 0, 0, stack[-1] if stack else -1, threading.get_ident()]
        with _rec.lock:
            stack.append(len(_rec.spans))
            _rec.spans.append(self.record)
        self.record[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.record[2] = time.perf_counter_ns()
        _rec.stack().pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """Context manager recording one span ``name`` while tracing is on (one
    of :data:`SPAN_NAMES` in the port); the shared null context when off."""
    if not _on:
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1):
    """Add ``n`` to counter ``name`` while tracing is on."""
    if not _on:
        return
    with _rec.lock:
        _rec.counts[name] = _rec.counts.get(name, 0) + n


@contextmanager
def tracing(on: bool = True):
    """Record spans and counters (``on``) or not inside the block; the
    previous setting returns on exit."""
    global _on
    was, _on = _on, bool(on)
    try:
        yield
    finally:
        _on = was


def collect() -> dict:
    """``{"spans": [...], "counts": {...}}`` recorded since the last call,
    which are then cleared. Call it outside any span: a span open across the
    call ends in the batch it began in."""
    return _rec.take()


def span_totals(spans) -> dict:
    """``{name: (n, total_ns, self_ns)}`` over collected ``spans``: how many,
    their summed durations, and their summed self time (a span's duration
    less the durations of the spans directly inside it)."""
    inner = [0] * len(spans)
    for _, start, end, parent, _ in spans:
        if parent >= 0:
            inner[parent] += end - start
    out = {}
    for (name, start, end, _, _), child in zip(spans, inner):
        n, total, own = out.get(name, (0, 0, 0))
        out[name] = (n + 1, total + end - start, own + end - start - child)
    return out
