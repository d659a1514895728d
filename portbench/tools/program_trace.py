"""Split the jobs of a job cell by the program's own spans and counters.

    python3 portbench/tools/program_trace.py --workload lmc2.staged-10k --seed 4100000002 --passes 2

Sets up the cell as its loop does (``loops/jobs.py``: the pool of tables in
the seed's order, the warm-up), then runs ``--passes`` passes over the pool
in which each table's job runs twice back to back, once with the program's
tracing (``gumbi_tpu_torch.utils.profiling``) off and once on, which first
in turns. The pairs give what tracing costs, free of the host's drift from
minute to minute; the traced jobs give the program's numbers by stage and
by job (``harness/program.py``), checked against the job's own stage spans
and evaluation count. Then one job is profiled with tracing off and one
with it on. On the first, ``trace.reduce`` over the whole profile and over
its device operations alone (``program.DeviceOnly``) must read the same; on
the second, the device's idle time is put down to the innermost program
span and the launch records inside evaluations are counted.

Prints a summary as one JSON line; everything, per job, goes to
``portbench_out/program-<cell>.json`` and the profiled job's span list to
``portbench_out/spans-<cell>.json``. Needs the card, as ``run.py`` does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402
from portbench.harness import core, program, trace  # noqa: E402
from portbench.harness.core import Sync, rng_for  # noqa: E402
from portbench.loops import jobs  # noqa: E402

FIT_STAGES = ("coarse", "mid", "polish")  # the stages that run L-BFGS
READINGS = ("busy_s", "window_s", "linalg_s", "rbf_device_s", "device_ops", "idle_gaps")


def setup(ctx):
    """The loop's set-up: state, the pool of tables, the seed's order, the
    warm-up."""
    fam, sync = ctx.family, Sync(ctx.device)
    state = fam.prepare(ctx.cfg, ctx.device)
    tables = [fam.make_table(state, rng_for(ctx.traffic["table_seed"], 1, j)) for j in range(ctx.traffic["tables"])]
    order = rng_for(ctx.seed, 1).permutation(len(tables)).tolist()
    fam.warm(state, tables[0])
    sync()
    return state, tables, order, sync


class StageSpans(core.Spans):
    """The loop's stage spans, which also hand over the program's spans and
    counters at each stage's end, reduced by :func:`program.job_numbers`."""

    def __init__(self, sync):
        super().__init__(sync)
        self.program = {}

    @contextlib.contextmanager
    def __call__(self, name):
        from gumbi_tpu_torch.utils import profiling

        profiling.collect()
        with super().__call__(name):
            yield
        got = program.job_numbers(profiling.collect())
        if got is not None:
            self.program[name] = got


def job(ctx, state, table, sync, on):
    """One job as ``loops/jobs.py`` runs it, with the program's tracing
    ``on`` or off: its latency, stage spans, evaluations and program numbers
    by stage and summed."""
    import torch

    from gumbi_tpu_torch.utils import profiling

    spans = StageSpans(sync)
    with profiling.tracing(on):
        t = time.perf_counter()
        with torch.profiler.record_function(jobs.UNIT):
            out = ctx.family.run_job(state, table, spans)
        latency = time.perf_counter() - t
    by_stage = spans.program
    total = {k: sum(v[k] for v in by_stage.values()) for k in next(iter(by_stage.values()), {})}
    return dict(latency_s=latency, stages=spans.times, evals=sum(out["evals"].values()), by_stage=by_stage,
                program=total or None)


def checks(j):
    """How one traced job's program numbers agree with its own accounts."""
    p = j["program"]
    parts = p["objective_host_ms"] + p["optimizer_host_ms"] + p["read_wait_ms"]
    stages_ms = 1e3 * sum(v for k, v in j["stages"].items() if k in FIT_STAGES)
    return dict(parts_vs_runs=parts / p["run_ms"] - 1.0, runs_vs_stages=p["run_ms"] / stages_ms - 1.0,
                evals_equal=p["vg"] + p["v"] == j["evals"])


def paired(ctx, state, tables, order, sync, passes):
    """``passes`` passes over the pool, each table's job run with tracing off
    and on back to back (which first in turns)."""
    pairs = []
    for p in range(passes):
        for k, j in enumerate(order):
            first_on = (p + k) % 2 == 1
            got = {on: job(ctx, state, tables[j], sync, on) for on in (first_on, not first_on)}
            got[True]["checks"] = checks(got[True])
            pairs.append(dict(table=j, off=got[False], on=got[True]))
            ctx.log(f"table {j}: off {got[False]['latency_s']:.3f} s, on {got[True]['latency_s']:.3f} s")
    return pairs


def tracing_cost(pairs):
    """What tracing on costs a job: the summed latencies' ratio less 1, and
    the median of the pairs' ratios less 1."""
    on, off = (sum(p[k]["latency_s"] for p in pairs) for k in ("on", "off"))
    return dict(total=on / off - 1.0, median_pair=statistics.median(p["on"]["latency_s"] / p["off"]["latency_s"]
                                                                    for p in pairs) - 1.0)


def profiled(ctx, state, table, sync, on):
    """One job under the profiler with the program's tracing ``on`` or off:
    the reductions of its profile, and (on) its spans."""
    import torch

    from gumbi_tpu_torch.utils import profiling

    fam = ctx.family
    with profiling.tracing(on):
        profiling.collect()
        with trace.traced() as got:
            jobs.one_job(fam, state, table, sync)
        spans = profiling.collect()
    prof = got["prof"]
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    annotations = sorted({e.name for e in events if e.device_type == cuda and getattr(e, "is_user_annotation", False)})
    unflagged = sorted({e.name for e in events if e.device_type == cuda and e.name in program.PROGRAM
                        and not getattr(e, "is_user_annotation", False)})
    whole = trace.reduce(prof, got["rbf_shapes"], jobs.UNIT, fam.STAGES, 1)
    device_only = trace.reduce(program.DeviceOnly(prof), got["rbf_shapes"], jobs.UNIT, fam.STAGES, 1)
    out = dict(tracing=on, device_annotations=annotations, program_names_unflagged=unflagged,
               reduce_whole={k: whole[k] for k in READINGS},
               reduce_device_only={k: device_only[k] for k in READINGS},
               reduce_equal={k: whole[k] == device_only[k] for k in READINGS})
    if on:
        attr = program.attribute(events, jobs.UNIT, fam.STAGES)
        idle = device_only["window_s"] - device_only["busy_s"]
        out.update(attributed=attr, numbers=program.trace_numbers(attr), job=program.job_numbers(spans),
                   idle_sum_vs_window=(sum(attr["idle_by_span"].values()) + attr["idle_outside_s"]) / idle - 1.0,
                   spans=spans)
    return out


def measure(ctx, passes):
    """Everything the tool reports for one cell and seed."""
    state, tables, order, sync = setup(ctx)
    pairs = paired(ctx, state, tables, order, sync, passes)
    traced = [p["on"] for p in pairs]
    res = dict(pairs=pairs, cost=tracing_cost(pairs), numbers=program.window_numbers([j["program"] for j in traced]))
    res["by_stage"] = {st: program.window_numbers([j["by_stage"][st] for j in traced if st in j["by_stage"]])
                       for st in FIT_STAGES if any(st in j["by_stage"] for j in traced)}
    if ctx.cuda:
        res["profile_off"] = profiled(ctx, state, tables[order[0]], sync, False)
        res["profile_on"] = profiled(ctx, state, tables[order[0]], sync, True)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--passes", type=int, default=2, help="passes over the pool, each job off and on")
    args = p.parse_args(argv)
    run.cache_dirs()
    bench = core.load_benchmark()
    cell = core.find_workload(bench, args.workload)
    parts = {}
    if not run.start_device(cell["chips"], parts):
        return 2
    import torch

    ctx = run.context(bench, cell, args.seed, 0.0, False, parts, time.perf_counter())
    res = measure(ctx, args.passes)
    out = ROOT / "portbench_out"
    out.mkdir(exist_ok=True)
    spans = res["profile_on"].pop("spans")
    (out / f"spans-{cell['name']}.json").write_text(json.dumps(spans))
    res.update(workload=cell["name"], seed=args.seed, passes=args.passes, device=torch.cuda.get_device_name(0))
    (out / f"program-{cell['name']}.json").write_text(json.dumps(res))
    print(json.dumps(summary(res)), flush=True)
    return 0


def summary(res):
    """The numbers of ``res`` without the per-job lists."""
    traced = [p["on"]["checks"] for p in res["pairs"]]
    out = {k: res[k] for k in ("workload", "seed", "passes", "device", "cost", "numbers", "by_stage") if k in res}
    out["latency_s"] = {side: [round(p[side]["latency_s"], 4) for p in res["pairs"]] for side in ("off", "on")}
    out["checks"] = dict(
        parts_vs_runs=max(abs(c["parts_vs_runs"]) for c in traced),
        runs_vs_stages=[min(c["runs_vs_stages"] for c in traced), max(c["runs_vs_stages"] for c in traced)],
        evals_equal=all(c["evals_equal"] for c in traced), jobs=len(traced))
    for side in ("profile_off", "profile_on"):
        if side in res:
            out[side] = {k: v for k, v in res[side].items() if k not in ("reduce_whole", "reduce_device_only")}
            out[side]["busy_s"] = [res[side]["reduce_whole"]["busy_s"], res[side]["reduce_device_only"]["busy_s"]]
    return out


if __name__ == "__main__":
    sys.exit(main())
