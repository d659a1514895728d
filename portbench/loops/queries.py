"""Closed loop, one client: grid queries against a model fitted in set-up.

Set-up draws one table from the seed, fits the model as the configuration's
family fits it for queries, caches its posterior and warms one query. Query
q asks for the predictive mean and variance on an m×m grid over a sub-box
of the data's box, its side a share in [side_min, side_max] of the box's
and its centre uniform where the sub-box fits, both drawn from the seed and
q. A query is timed on the host clock from drawing its grid to holding the
answer on the host. With tracing on, ``trace_queries`` more run after the
window under the profiler. The check samples finished queries from the seed
and judges each against the float64 reference posterior at the set-up's
hyperparameters.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..harness import check, frozen, trace
from ..harness.core import RunRecord, Spans, Sync, rng_for
from ..reference import common

UNIT = "query"
STAGES = ("predict",)


def box(seed, q, mix):
    rng = rng_for(seed, 3, q)
    lo, hi = mix["box"]
    side = (hi - lo) * rng.uniform(mix["side_min"], mix["side_max"])
    centre = rng.uniform(lo + side / 2, hi - side / 2, size=2)
    return centre - side / 2, centre + side / 2


def one_query(fam, state, model, pts, device, sync):
    spans = Spans(sync)
    with torch.profiler.record_function(UNIT):
        xq = torch.as_tensor(pts, device=device)
        with spans("predict"):
            mean, var = fam.query(state, model, xq)
    return mean, var


def run(ctx):
    """(record, worst readings, answers compared) of one run."""
    fam, cfg, mix, sync = ctx.family, ctx.cfg, ctx.traffic, Sync(ctx.device)
    t = time.perf_counter()
    state = fam.prepare(cfg, ctx.device)
    tab = fam.make_table(state, rng_for(ctx.seed, 1, 0))
    sync()
    ctx.setup_parts["tables_s"] = time.perf_counter() - t
    t = time.perf_counter()
    model = fam.fit_model(state, tab, Spans(sync))
    sync()
    ctx.setup_parts["fit_s"] = time.perf_counter() - t
    t = time.perf_counter()
    m = mix["grid"]
    one_query(fam, state, model, frozen.grid_points(m), ctx.device, sync)
    ctx.setup_parts["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"set-up {setup_s:.3f} s {ctx.setup_parts}")

    if ctx.cuda:
        torch.cuda.reset_peak_memory_stats()
    units = []
    w0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        pts = frozen.grid_points(m, *box(ctx.seed, len(units), mix))
        mean, var = one_query(fam, state, model, pts, ctx.device, sync)
        units.append(dict(latency_s=time.perf_counter() - t, grid=pts, mean=mean, var=var,
                          flops=fam.query_flops(cfg, m * m)))
        if time.perf_counter() - w0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if ctx.cuda else 0
    lat = np.array([u["latency_s"] for u in units])
    ctx.log(f"{len(units)} queries in {window_s:.3f} s; latency median {np.median(lat):.5f} s, max {lat.max():.5f} s")

    traced = None
    if ctx.trace:
        n = mix["trace_queries"]
        with trace.traced() as got:
            for q in range(n):
                one_query(fam, state, model, frozen.grid_points(m, *box(ctx.seed, len(units) + q, mix)),
                          ctx.device, sync)
        traced = trace.reduce(got["prof"], got["rbf_shapes"], UNIT, STAGES, n)
        del got

    failed = sum(not (np.isfinite(u["mean"]).all() and np.isfinite(u["var"]).all()) for u in units)
    rec = RunRecord(setup_s=setup_s, window_s=window_s, units=units, peak_bytes=peak,
                    setup_parts=dict(ctx.setup_parts), trace=traced, attempted=len(units), failed=failed)

    table, u = dict(tab["ref"], device=ctx.device), model["u"]
    del tab, model, state
    gc.collect()
    if ctx.cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    k = len(units) if ctx.check_all else min(mix["check_queries"], len(units))
    pick = sorted(rng_for(ctx.seed, 2).choice(len(units), k, replace=False).tolist())
    readings = judge(ctx.reference, table, u, [units[i] for i in pick], ctx.products)
    ctx.log(f"reference {time.perf_counter() - t:.3f} s for {k} queries: {check.worst(readings)}")
    return rec, check.worst(readings), len(pick)


def judge(reference, table, u, answers, products="exact"):
    """Readings of each answer against the float64 posterior at ``u``; with
    ``products`` "tf32" the control's answers at the same points instead."""
    ref = common.posterior(reference, table, u)
    ctl = common.posterior(reference, table, u, products) if products != "exact" else None
    out = []
    for a in answers:
        pts = torch.as_tensor(a["grid"], dtype=torch.float64, device=table["device"])
        mean, var = ref.predict(pts)
        if ctl is not None:
            with common.precision(products):
                cm, cv = ctl.predict(pts.float())
            a = dict(mean=cm.double(), var=cv.double())
        out.append(check.gaps(a, dict(mean=mean, var=var)))
    return out
