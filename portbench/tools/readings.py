"""Read a cell's compared numbers on many seeds in one process: the program's
sound runs, its control (the reference in the program's place, in TF32)
and each planted fault. These readings set each limit (PERF.md).

    python3 portbench/tools/readings.py --workload se2.staged-16k --seconds 10 \
        --seeds 11,12,13 --control 21,22,23 --faults unchanged,half_batch,altered --fault-seeds 31,32,33

Each run is a short window of the cell at its own sizes and load, judged as
run.py judges it. One JSON line per run goes to standard output and to
``portbench_out/readings-<workload>.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402
from portbench.harness import core, faults  # noqa: E402


def ints(s):
    return [int(x) for x in s.split(",") if x]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=ints, default=[])
    p.add_argument("--control", type=ints, default=[])
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=ints, default=[])
    p.add_argument("--check-all", action="store_true", help="judge every job of the window, not a sample")
    args = p.parse_args(argv)
    run.cache_dirs()
    bench = core.load_benchmark()
    cell = core.find_workload(bench, args.workload)
    parts = {}
    if not run.start_device(cell["chips"], parts):
        return 2
    out = ROOT / "portbench_out"
    out.mkdir(exist_ok=True)
    sink = open(out / f"readings-{cell['name']}.jsonl", "a")
    plan = [("program", s, "exact") for s in args.seeds] + [("control", s, "tf32") for s in args.control]
    plan += [(f, s, "exact") for f in args.faults.split(",") if f for s in args.fault_seeds]
    for kind, seed, products in plan:
        ctx = run.context(bench, cell, seed, args.seconds, False, parts, time.perf_counter(), products,
                          args.check_all)
        loop = core.load_loop(ctx.traffic["loop"])
        t = time.perf_counter()
        if kind in faults.FAULTS:
            with faults.planted(kind, ctx.traffic["loop"]):
                rec, values, n = loop.run(ctx)
        else:
            rec, values, n = loop.run(ctx)
        line = dict(kind=kind, seed=seed, readings=values, compared=n, attempted=rec.attempted, failed=rec.failed,
                    window_s=rec.window_s, setup_s=rec.setup_s, seconds=time.perf_counter() - t,
                    evals=[sum(u["evals"].values()) for u in rec.units if "evals" in u],
                    job_s=[round(u["latency_s"], 4) for u in rec.units if "evals" in u],
                    latency_s=[u["latency_s"] for u in rec.units][:64])
        print(json.dumps(line), flush=True)
        sink.write(json.dumps(line) + "\n")
        sink.flush()
    sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
