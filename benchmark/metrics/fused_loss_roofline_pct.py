"""The masked misfit's sums and their gradient (``ops/fused_loss.py``,
``csrc/fused_loss.cu``): the bound of their bytes (``counts.fused_loss``)
over the device time of the kernels that compute them."""
UNIT = "%"
PATTERNS = (r"loss_sums_kernel", r"loss_grad_kernel")


def read(rec):
    from benchmark.metrics._roofline import share
    return share(rec, "fused_loss", PATTERNS)
