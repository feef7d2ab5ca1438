"""Shared arithmetic of the kernel roofline metrics: the bound of a kernel
family's work in the traced chunk (``counts``, one lane's step times the
chunk's lane-steps) over the device time of the kernels that did it, found
by name."""
import re


def share(rec, work_key, patterns):
    if rec.trace is None:
        return None
    flops, n_bytes = rec.counts[work_key]
    lane_steps = rec.steps_traced * rec.lanes
    if lane_steps <= 0 or (flops <= 0 and n_bytes <= 0):
        return None
    rx = re.compile("|".join(patterns))
    t = sum(s for name, s in rec.trace.kernels if rx.search(name))
    if t <= 0:
        return None
    from benchmark import peaks
    return 100.0 * peaks.bound_s(flops * lane_steps, n_bytes * lane_steps, rec.peak) / t
