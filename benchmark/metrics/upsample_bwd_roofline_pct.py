"""The backward of the step's x2 trilinear upsamples (``ops/upsample.py``,
``csrc/upsample.cu``): the bound of its bytes (``counts.upsample_bwd``) over
the device time of the kernels that compute it, the port's or the library's
backward that would replace them."""
UNIT = "%"
PATTERNS = (r"upsample_bwd_tma", r"upsample_bwd_direct", r"upsample_trilinear3d_backward")


def read(rec):
    from benchmark.metrics._roofline import share
    return share(rec, "upsample_bwd", PATTERNS)
