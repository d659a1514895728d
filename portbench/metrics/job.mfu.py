"""job.mfu: the operations the window's jobs need (the family's count from
shapes and evaluations) over the window times the TF32 peak, in %."""

from portbench.harness.roofline import TF32_PEAK


def read(rec):
    if not rec.units or rec.window_s <= 0:
        return None
    return 100.0 * sum(u["flops"] for u in rec.units) / (rec.window_s * TF32_PEAK)
