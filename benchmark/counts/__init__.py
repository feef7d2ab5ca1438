"""Operations and bytes of the work that the benchmark's per-layer metrics
cover, computed from a cell's shapes on the reference net (on the ``meta``
device, so nothing is allocated):

* ``layers``: every conv (channels in and out, kernel, stride, voxels in and
  out) and every x2 linear upsample (channels, voxels in) of one lane's step;
* ``step_flops``: the conv FLOPs of one lane's step, forward and the
  backward the step takes (parameters only: the canvas is not optimised, so
  the two convs that read it have no input gradient), by
  ``torch.utils.flop_counter``;
* ``wgrad``, ``upsample_bwd``, ``fused_loss``: (FLOPs, bytes) of each
  kernel family's work in one lane's step, each input read once and each
  output written once; ``wgrad_convs`` the convs that ``wgrad`` counts.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode


def _meta_inputs(net, padded: Sequence[int], grad: bool):
    params = {n: torch.empty(s, device="meta", requires_grad=grad) for n, s, _ in net.spec()}
    x = torch.empty((1, net.in_channels) + tuple(padded), device="meta")
    return params, x


def layers(net, padded: Sequence[int]) -> Dict[str, List[Dict[str, int]]]:
    convs, ups = [], []
    conv, upsample = net.conv, net.upsample

    def rec_conv(p, name, x, stride=1):
        y = conv(p, name, x, stride)
        convs.append({"cin": x.shape[1], "cout": y.shape[1], "k": p[f"{name}.kernel"].shape[-1],
                      "stride": stride, "vin": math.prod(x.shape[2:]),
                      "vout": math.prod(y.shape[2:]), "ndim": x.ndim - 2})
        return y

    def rec_up(x):
        ups.append({"c": x.shape[1], "vin": math.prod(x.shape[2:]), "ndim": x.ndim - 2})
        return upsample(x)

    net.conv, net.upsample = rec_conv, rec_up
    try:
        with torch.no_grad():
            net(*_meta_inputs(net, padded, False))
    finally:
        del net.conv, net.upsample
    return {"convs": convs, "upsamples": ups if net.linear else []}


def step_flops(net, padded: Sequence[int], patch: Sequence[int]) -> int:
    params, x = _meta_inputs(net, padded, True)
    with FlopCounterMode(display=False) as fc:
        out = net(params, x)
        idx = [slice(None), slice(None)]
        for d, tgt in zip(out.shape[2:], patch):
            idx.append(slice((d - tgt) // 2, (d - tgt) // 2 + tgt))
        loss = out[tuple(idx)].abs().sum()
        torch.autograd.grad(loss, list(params.values()))
    return int(fc.get_total_flops())


def wgrad_convs(lay) -> List[Dict[str, int]]:
    """The convs whose weight gradient the port's wgrad kernel computes: 3D,
    stride 1, an odd cubic kernel larger than 1 (same-padded, as every conv
    of the net is). The strided and 1x1x1 convs' weight gradients run in the
    library and are not counted."""
    return [c for c in lay["convs"]
            if c["ndim"] == 3 and c["stride"] == 1 and c["k"] > 1 and c["k"] % 2 == 1]


def wgrad(lay, elem: int) -> Tuple[float, float]:
    """The weight gradients of ``wgrad_convs``: 2 k^3 Ci Co V_out FLOPs; x
    and dy read once, dW written once, in the compute dtype."""
    flops = n_bytes = 0.0
    for c in wgrad_convs(lay):
        taps = c["k"] ** 3
        flops += 2.0 * taps * c["cin"] * c["cout"] * c["vout"]
        n_bytes += elem * (c["cin"] * c["vin"] + c["cout"] * c["vout"]
                           + taps * c["cin"] * c["cout"])
    return flops, n_bytes


def upsample_bwd(lay, elem: int) -> Tuple[float, float]:
    """The x2 linear upsamples' backward: the output gradient (2^ndim V C)
    read once, the input gradient (V C) written once; 3D only."""
    n_bytes = sum(elem * u["c"] * u["vin"] * (2 ** u["ndim"] + 1)
                  for u in lay["upsamples"] if u["ndim"] == 3)
    return 0.0, float(n_bytes)


def fused_loss(n_out: int, elem: int) -> Tuple[float, float]:
    """The masked misfit's sums and their gradient over the cropped output
    (n_out elements; data and mask float32), the two kernels' work taken
    together: out, data and mask read once, the 8 sums written and read
    back, d out written once. (The backward kernel reads the three again,
    right after the forward, partly from L2.)"""
    return 0.0, float(n_out * (elem + 8) + 64 + n_out * elem)
