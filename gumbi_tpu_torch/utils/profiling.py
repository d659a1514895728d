"""Phase timing + device profiling hooks.

``Timings`` and ``phase`` are ``gumbi_tpu/utils/profiling.py``'s: named
wall-clock phases into a registry (``GP.fit`` times specify/build/find_MAP
with them). ``profile_trace`` wraps a region in ``torch.profiler``.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

__all__ = ["Timings", "timings", "phase", "profile_trace"]


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
