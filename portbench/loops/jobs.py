"""Closed loop, one client: whole fit-to-prediction jobs back to back.

Every run serves the same pool of ``tables`` tables, table j drawn from the
mix's ``table_seed`` and j; the run's seed sets the order in which a pass
serves them. Set-up draws the pool, builds the port's starting points and
warms every shape a job runs. The window then runs whole passes over the
pool until ``seconds`` have passed, finishing the pass in flight, so every
run does the same work whatever its seed: an f32 fit's length follows the
round-off of its data, and tables drawn from the seed made the work, not
the program, set the spread. Each job is timed whole on the host clock, its
stages in spans that end in a device sync. With tracing on, one more job
runs after the window under the profiler. The check samples finished jobs
from the seed and judges each against the float64 reference on its table
at the port's MAP.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from ..harness import check, trace
from ..harness.core import RunRecord, Spans, Sync, rng_for
from ..reference import common

UNIT = "job"


def finite(out):
    return math.isfinite(out["f"]) and bool(np.isfinite(out["mean"]).all() and np.isfinite(out["var"]).all())


def one_job(fam, state, tab, sync):
    spans = Spans(sync)
    with torch.profiler.record_function(UNIT):
        out = fam.run_job(state, tab, spans)
    out["spans"] = spans.times
    return out


def run(ctx):
    """(record, worst readings, answers compared) of one run."""
    fam, cfg, mix, sync = ctx.family, ctx.cfg, ctx.traffic, Sync(ctx.device)
    t = time.perf_counter()
    state = fam.prepare(cfg, ctx.device)
    tables = [fam.make_table(state, rng_for(mix["table_seed"], 1, j)) for j in range(mix["tables"])]
    order = rng_for(ctx.seed, 1).permutation(len(tables)).tolist()
    sync()
    ctx.setup_parts["tables_s"] = time.perf_counter() - t
    t = time.perf_counter()
    fam.warm(state, tables[0])
    sync()
    ctx.setup_parts["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"set-up {setup_s:.3f} s {ctx.setup_parts}")

    if ctx.cuda:
        torch.cuda.reset_peak_memory_stats()
    units = []
    w0 = time.perf_counter()
    while not units or time.perf_counter() - w0 < ctx.seconds:
        for j in order:
            t = time.perf_counter()
            out = one_job(fam, state, tables[j], sync)
            out.update(table=j, latency_s=time.perf_counter() - t)
            units.append(out)
            ctx.log(f"job {len(units) - 1} (table {j}): {out['latency_s']:.3f} s {out['spans']} evals {out['evals']}")
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if ctx.cuda else 0

    traced = None
    if ctx.trace:
        with trace.traced() as got:
            one_job(fam, state, tables[order[0]], sync)
        traced = trace.reduce(got["prof"], got["rbf_shapes"], UNIT, fam.STAGES, 1)
        del got

    failed = sum(not finite(u) for u in units)
    rec = RunRecord(setup_s=setup_s, window_s=window_s, units=units, peak_bytes=peak,
                    setup_parts=dict(ctx.setup_parts), trace=traced, attempted=len(units), failed=failed)

    refs = [dict(tab["ref"], device=ctx.device) for tab in tables]
    del tables, state
    gc.collect()
    if ctx.cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    k = len(units) if ctx.check_all else min(mix["check_jobs"], len(units))
    pick = sorted(rng_for(ctx.seed, 2).choice(len(units), k, replace=False).tolist())
    readings = []
    for i in pick:
        readings.append(judge(ctx.reference, refs[units[i]["table"]], units[i], ctx.products))
        ctx.log(f"check job {i}: {readings[-1]}")
    ctx.log(f"reference {time.perf_counter() - t:.3f} s for jobs {pick}")
    return rec, check.worst(readings), len(pick)


def judge(reference, table, out, products="exact"):
    """Readings of one job; with ``products`` "tf32" the control's at the
    same MAP (the reference in the program's place, in TF32)."""
    ref = common.readings(reference, table, out)
    if products == "exact":
        r = check.gaps(out, ref)
        r["map_gap"] = common.map_gap(reference, table, out)
        return r
    return check.gaps(common.readings(reference, table, out, products), ref)
