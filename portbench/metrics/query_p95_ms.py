"""query_p95_ms: the 95th percentile (nearest rank) of every query's latency
in the window, in ms (host clock)."""

import math


def read(rec):
    lat = sorted(u["latency_s"] for u in rec.units)
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
