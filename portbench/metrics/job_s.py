"""job_s: the window's wall time over the jobs it completed (host clock)."""


def read(rec):
    return rec.window_s / len(rec.units) if rec.units else None
