"""job.rbf_gram_roofline: the least time of every rbf_gram launch in the
traced job (shapes from the counted launcher, harness/roofline.py's bound)
over the kernel's device time, in %."""


def read(rec):
    t = rec.trace
    if not t or t["rbf_device_s"] <= 0 or t["rbf_launches"] == 0:
        return None
    return 100.0 * t["rbf_bound_s"] / t["rbf_device_s"]
