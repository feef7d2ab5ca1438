"""Device time a step of the library's weight-gradient kernels: every kernel
of the traced chunk whose name holds ``wgrad`` (any case) but the port's own
(``wgrad3d_mma``, ``wgrad3d_fma``, ``wgrad3d_sum``), over the chunk's steps.
It catches cuDNN's named engines (``sm90_xmma_wgrad_*``,
``convolveNd_wgrad_engine``, ``wgrad_alg1_nd_*``, ``wgrad2d_grouped_direct``,
CUTLASS ``*wgrad*``); a 1x1(x1) conv's dW that cuDNN runs as a plain GEMM
carries no such name and escapes it. 0 where a traced chunk launched none."""
import re

UNIT = "ms"
LIBRARY = re.compile(r"wgrad", re.IGNORECASE)
PORT = re.compile(r"wgrad3d_(mma|fma|sum)\b")


def read(rec):
    if rec.trace is None or rec.steps_traced <= 0:
        return None
    t = sum(s for name, s in rec.trace.kernels if LIBRARY.search(name) and not PORT.search(name))
    return 1e3 * t / rec.steps_traced
