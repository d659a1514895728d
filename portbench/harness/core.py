"""Registry, spans and the record a run hands to the metric readers.

Everything that belongs to one configuration, traffic mix, model family,
loop or metric sits in a file of its own under ``portbench/``, found here by
the name that ``BENCHMARK.json`` (or a configuration or mix file) gives it:

* ``configs/<config>.json`` — through the configuration's ``file`` entry;
* ``traffic/<mix>.json`` — a mix's parameters, with its ``loop``;
* ``loops/<loop>.py`` — the closed-loop client that a mix names;
* ``families/<family>.py`` — the stage driver that a configuration names,
  with ``reference/<family>.py`` its plain reference;
* ``metrics/<metric>.py`` — one reader per metric, ``read(record)``;
* ``limits/<workload>.json`` — each compared number's limit in that cell.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import time
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_benchmark(path=None):
    return json.loads(Path(path or ROOT / "BENCHMARK.json").read_text())


def find_workload(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {[w['name'] for w in bench['workloads']]}")


def load_config(bench, name):
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(name):
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def load_limits(workload):
    return json.loads((BENCH_DIR / "limits" / f"{workload}.json").read_text())


def load_loop(name):
    return importlib.import_module(f"portbench.loops.{name}")


def load_family(name):
    return importlib.import_module(f"portbench.families.{name}")


def load_reference(name):
    return importlib.import_module(f"portbench.reference.{name}")


def load_metric(name):
    """The reader module of metric ``name`` (file names may hold dots)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench, workload, trace):
    """The metrics a run of ``workload`` reports: its end-to-end metrics with
    ``trace`` 0, its per-layer metrics with ``trace`` 1."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or workload in m["workloads"]]


def seed_words(seed):
    """A whole-number seed of any size or sign as words for numpy's SeedSequence."""
    seed = int(seed) % (1 << 128)
    return [(seed >> (32 * i)) & 0xFFFFFFFF for i in range(4)]


def rng_for(seed, *path):
    """The generator of one draw of a run: the run's seed, then a path of
    small whole numbers (a stream tag, a job or query index)."""
    return np.random.default_rng([*seed_words(seed), *path])


class Sync:
    """Wait for the device (no-op on the CPU)."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        self._torch = torch

    def __call__(self):
        if self.cuda:
            self._torch.cuda.synchronize()


class Spans:
    """Host-clock spans of named stages, each ended by a device sync, and
    marked for the profiler by ``record_function`` when one is recording."""

    def __init__(self, sync):
        self.sync = sync
        self.times = {}

    @contextlib.contextmanager
    def __call__(self, name):
        import torch

        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            yield
            self.sync()
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0


@dataclasses.dataclass
class RunRecord:
    """What one run measured; the metric readers read only this.

    ``units`` holds one dict per job or query completed in the window
    (``spans``, ``evals``, ``flops``, ``latency_s``); ``trace`` the reduced
    profiler record of the traced units after the window, or None."""

    setup_s: float
    window_s: float
    units: list
    peak_bytes: int
    setup_parts: dict = dataclasses.field(default_factory=dict)
    trace: dict | None = None
    attempted: int = 0
    failed: int = 0
