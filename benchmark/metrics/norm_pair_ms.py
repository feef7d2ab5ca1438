"""Device time a step of the Norm's kernel pair (``ops/norm_act.py``,
``csrc/norm_act.cu``): ``norm_stats`` and ``norm_apply`` forward,
``norm_grad_sums`` and ``norm_grad`` backward (one-lane and lane launches
alike), summed over the traced chunk and divided by its steps. 0 where a
traced chunk launched none (every Norm on the tensor ops)."""
import re

UNIT = "ms"
PATTERN = re.compile(r"\bnorm_(stats|apply|grad_sums|grad)_kernel\b")


def read(rec):
    if rec.trace is None or rec.steps_traced <= 0:
        return None
    return 1e3 * sum(s for name, s in rec.trace.kernels if PATTERN.search(name)) \
        / rec.steps_traced
