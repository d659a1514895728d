"""query.linalg_ms: device ms per traced query in the linear-algebra layer's kernels:
factor, triangular solves and dense products (name patterns in harness/trace.py)."""


def read(rec):
    t = rec.trace
    return 1e3 * t["linalg_s"] / t["units"] if t and t["linalg_s"] > 0 else None
