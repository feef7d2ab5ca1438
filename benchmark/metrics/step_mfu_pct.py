"""The whole step's share of the card's peak: the conv FLOPs of a step
(forward and the backward it takes, counted by ``torch.utils.flop_counter``
on the reference net at the cell's shapes, ``counts.step_flops``) times the
lane-iterations the window completed, over the window's wall time and the
configuration's peak (``peaks.FLOPS``). Recomputed work does not count."""
UNIT = "%"


def read(rec):
    if rec.lane_iters <= 0 or rec.window_s <= 0 or rec.counts["step_flops"] <= 0:
        return None
    from benchmark import peaks
    return 100.0 * rec.lane_iters * rec.counts["step_flops"] / (
        rec.window_s * peaks.FLOPS[rec.peak])
