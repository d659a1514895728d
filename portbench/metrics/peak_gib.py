"""peak_gib: the device allocator's peak over the window, in GiB."""


def read(rec):
    return rec.peak_bytes / 2**30 if rec.peak_bytes else None
