"""job.coarse_s: mean seconds per job in the coarse (and mid) stages, from
the benchmark's spans, each ended by a device sync."""


def read(rec):
    spans = [u["spans"] for u in rec.units if "spans" in u]
    return sum(s.get("coarse", 0.0) + s.get("mid", 0.0) for s in spans) / len(spans) if spans else None
