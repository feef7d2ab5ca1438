"""Device kernels launched in the traced chunk over its steps: the step's
dispatch count, which CUDA graphs or fused kernels lower."""
UNIT = "count"


def read(rec):
    t = rec.trace
    if t is None or not t.kernels or rec.steps_traced <= 0:
        return None
    return len(t.kernels) / rec.steps_traced
