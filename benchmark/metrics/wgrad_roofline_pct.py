"""The port's wgrad kernel (``ops/wgrad.py``, ``csrc/wgrad3d.cu``): the bound
of the weight gradients it computes (``counts.wgrad`` over
``counts.wgrad_convs``, the stride-1 3x3x3 convs: 2 * 27 * Ci * Co * V_out
FLOPs; x and dy read once, dW written once) over the device time of its
kernels, the tap kernels and the kernel that sums their partial results.
The strided and 1x1x1 convs' weight gradients run in cuDNN and are in
neither. The kernel launches once a counted conv a step (once for all lanes
under ``vmap``); where the traced chunk holds fewer launches than that, some
of the counted work ran elsewhere, and the metric is silent."""
import re

UNIT = "%"
PATTERNS = (r"wgrad3d_(mma|fma|sum)\b",)
LAUNCH = re.compile(r"wgrad3d_(mma|fma)\b")


def read(rec):
    from benchmark.metrics._roofline import share
    if rec.trace is None or rec.steps_traced <= 0:
        return None
    launches = sum(1 for name, _ in rec.trace.kernels if LAUNCH.search(name))
    if round(launches / rec.steps_traced) < rec.counts["wgrad_convs"]:
        return None
    return share(rec, "wgrad", PATTERNS)
