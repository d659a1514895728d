"""job.inducing_s: mean seconds per job in the inducing-point selection,
from the benchmark's spans, each ended by a device sync; None in cells
whose jobs have no such stage."""


def read(rec):
    spans = [u["spans"] for u in rec.units if "inducing" in u.get("spans", {})]
    return sum(s["inducing"] for s in spans) / len(spans) if spans else None
