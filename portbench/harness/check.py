"""The comparison that decides ``correct``, and how it is printed.

Each cell compares a few numbers, each with a limit of its own in
``limits/<workload>.json`` (set from readings of the program and of its
control, as PERF.md records). A run is correct when every answer it
finished is finite and no number passes its limit.
"""

from __future__ import annotations

import math
import sys

import torch

INF = float("inf")


def gaps(prog, ref):
    """Readings of one answer against the float64 reference's: |Δf| per row
    (where both carry an objective), the largest |Δmean| and the largest
    |Δvar|/var over the grid; inf where the compared side is not finite."""
    r = {}
    if prog.get("f") is not None and ref.get("f") is not None:
        f, fr = prog["f"], ref["f"]
        r["obj_gap"] = abs(f - fr) / ref["rows"] if math.isfinite(f) and math.isfinite(fr) else INF
    mean = torch.as_tensor(prog["mean"], dtype=torch.float64).to(ref["mean"].device)
    var = torch.as_tensor(prog["var"], dtype=torch.float64).to(ref["var"].device)
    ok = bool(torch.isfinite(mean).all() and torch.isfinite(var).all())
    r["mean_gap"] = float((mean - ref["mean"]).abs().max()) if ok else INF
    r["var_gap"] = float(((var - ref["var"]).abs() / ref["var"]).max()) if ok else INF
    return r


def worst(readings):
    """The largest reading of each number over a list of per-answer dicts."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -INF), v)
    return out


def judge(values, limits, failed, compared):
    """(correct, checks): every number within its limit, every answer finite,
    and at least one answer compared."""
    checks = {k: {"value": values.get(k, INF), "limit": limits[k]["limit"]} for k in limits}
    checks["failed_answers"] = {"value": failed, "limit": 0}
    checks["answers_compared"] = {"value": compared, "limit": 1}
    ok = all(c["value"] <= c["limit"] for k, c in checks.items() if k != "answers_compared")
    return ok and compared >= 1, checks


def print_checks(checks):
    """Each compared number beside its limit, as the last lines on stderr."""
    for k, c in checks.items():
        cmp = ">=" if k == "answers_compared" else "<="
        print(f"check {k}: {c['value']!r} {cmp} {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
