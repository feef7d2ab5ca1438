"""Share of the traced chunk's wall time in which the device ran nothing:
1 - (union of kernel, copy and memset intervals) / (the chunk's span), from
the exported trace (``tracefile.read``). The host's dispatch, the chunk's
host read and anything the host waits on show here."""
UNIT = "%"


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
