"""job.polish_s: mean seconds per job in the full-N polish, from the
benchmark's spans, each ended by a device sync."""


def read(rec):
    spans = [u["spans"] for u in rec.units if "spans" in u]
    return sum(s["polish"] for s in spans) / len(spans) if spans else None
