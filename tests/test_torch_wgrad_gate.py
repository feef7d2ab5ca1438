"""The gate of the port's 3D wgrad kernel (ops/wgrad.py) and the wrapper's
choice of its plain version for CPU tensors."""
import pytest
import torch

from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

torch.set_num_threads(1)


@pytest.mark.parametrize("x_shape,w_shape,stride,padding,ok", [
    ((1, 5, 6, 8, 16), (3, 5, 3, 3, 3), 1, 1, True),
    ((1, 5, 6, 9, 15), (3, 5, 3, 3, 3), 1, 1, True),       # no H, W % 8 rule
    ((1, 554, 32, 16, 16), (35, 554, 3, 3, 3), 1, 1, True),  # wide decoder input
    ((1, 5, 6, 8, 16), (3, 5, 5, 5, 5), 1, 2, True),
    ((1, 5, 6, 8, 16), (3, 5, 1, 1, 1), 1, 0, False),      # 1x1
    ((1, 5, 6, 8, 16), (3, 5, 3, 3, 3), 2, 1, False),      # stride 2
    ((2, 5, 6, 8, 16), (3, 5, 3, 3, 3), 1, 1, False),      # batch 2
    ((1, 5, 6, 8, 16), (3, 5, 4, 4, 4), 1, 1, False),      # even kernel
    ((1, 5, 6, 8, 16), (3, 5, 9, 9, 9), 1, 4, False),      # k > 7
    ((1, 5, 6, 8, 16), (3, 5, 3, 3, 3), 1, ((0, 2), (1, 1), (1, 1)), False),
    ((1, 5, 6, 8, 16), (3, 5, 3, 3, 3), 1, 0, False),      # not same-pad
    ((1, 5, 8, 16), (3, 5, 3, 3), 1, 1, False),            # 2D
])
def test_gate(x_shape, w_shape, stride, padding, ok):
    assert WG.wgrad_supported(x_shape, w_shape, stride, padding) is ok


def test_cpu_tensor_takes_the_plain_version():
    before = WG.wgrad3d.launches
    WG.wgrad3d(torch.randn(1, 2, 3, 4, 5), torch.randn(1, 3, 3, 4, 5), 3)
    assert WG.wgrad3d.launches == before
