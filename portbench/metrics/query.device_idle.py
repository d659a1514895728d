"""query.device_idle: the share of the traced window in which no device
operation ran, in %."""


def read(rec):
    t = rec.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t and t["window_s"] > 0 else None
