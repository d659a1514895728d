"""Run one cell of the benchmark of gumbi_tpu_torch once, on this machine's card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Reads ``BENCHMARK.json`` at the checkout's root, finds the cell's
configuration, traffic mix, loop, model family, reference, limits and
metric readers by name (``harness/core.py``), sets up, runs the measured
window, and judges what the window produced against the plain reference.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its limit.
Everything else goes to standard error. Exits non-zero, printing no result,
without a card, with fewer cards than the cell asks for, or when a module
of jax, jaxlib, flax or gumbi_tpu is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gumbi_tpu")


def log(msg):
    print(f"[portbench {time.perf_counter() - T_START:8.3f}] {msg}", file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose whole top-level name is a forbidden one."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = ROOT / "portbench_out" / "cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def number(v):
    return v if math.isfinite(v) else (1e308 if v > 0 else -1e308)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def start_device(chips, parts):
    """Open the CUDA context and build or load the port's kernels, timing
    each into ``parts``; False without enough cards."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return False
    t = time.perf_counter()
    torch.cuda.init()
    torch.zeros(1, device="cuda").sum().item()
    parts["cuda_context_s"] = time.perf_counter() - t
    t = time.perf_counter()
    import gumbi_tpu_torch  # noqa: F401
    from gumbi_tpu_torch.ops import _build

    parts["import_port_s"] = time.perf_counter() - t
    t = time.perf_counter()
    _build.load_library("rbf_gram")
    parts["kernel_build_or_load_s"] = time.perf_counter() - t
    return True


def context(bench, cell, seed, seconds, trace, parts, t_start, products="exact", check_all=False):
    """Everything a loop needs for one run of ``cell``; ``products`` "tf32"
    judges the control in the program's place, ``check_all`` every answer."""
    from portbench.harness import core

    cfg = core.load_config(bench, cell["config"])
    return types.SimpleNamespace(
        family=core.load_family(cfg["family"]), reference=core.load_reference(cfg["family"]), cfg=cfg,
        traffic=core.load_traffic(cell["traffic"]), seed=seed, seconds=seconds, trace=bool(trace), device="cuda",
        cuda=True, t_start=t_start, setup_parts=dict(parts), log=log, products=products, check_all=check_all)


def main(argv=None):
    args = parse(argv)
    cache_dirs()
    parts = {}
    t = time.perf_counter()
    import torch

    parts["import_torch_s"] = time.perf_counter() - t
    sys.path.insert(0, str(ROOT))
    from portbench.harness import check, core

    bench = core.load_benchmark()
    cell = core.find_workload(bench, args.workload)
    limits = core.load_limits(cell["name"])
    readers = {m["name"]: (m, core.load_metric(m["name"])) for m in core.cell_metrics(bench, cell["name"], args.trace)}
    if not start_device(cell["chips"], parts):
        return 2
    ctx = context(bench, cell, args.seed, args.seconds, args.trace, parts, T_START)
    traffic = ctx.traffic
    rec, values, compared = core.load_loop(traffic["loop"]).run(ctx)

    found = forbidden_modules()
    if found:
        log(f"refusing to report: modules {found} are loaded")
        return 3
    correct, checks = check.judge(values, limits, rec.failed, compared)
    metrics = {}
    for name, (meta, reader) in readers.items():
        v = reader.read(rec)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": meta["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": int(rec.peak_bytes)}
    result = {"correct": bool(correct), "attempted": rec.attempted, "failed": rec.failed, "metrics": metrics,
              "device": device}
    if args.trace:
        if rec.trace is None:
            log("the profiler recorded no device operation in the traced units")
            return 4
        device.update(busy_s=rec.trace["busy_s"], window_s=rec.trace["window_s"])
        result["breakdown"] = {"device_ops": rec.trace["device_ops"], "idle_gaps": rec.trace["idle_gaps"]}
        out = ROOT / "portbench_out"
        out.mkdir(exist_ok=True)
        (out / f"trace-{cell['name']}.json").write_text(json.dumps(rec.trace, indent=1))
    log(f"setup_s {rec.setup_s:.3f} ({rec.setup_parts}); window {rec.window_s:.3f} s, {rec.attempted} answers")
    result["checks"] = {k: {"value": number(c["value"]), "limit": c["limit"]} for k, c in checks.items()}
    check.print_checks(checks)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
