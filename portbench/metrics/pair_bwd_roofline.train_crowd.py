"""Least time of the crowd window's pair-stage backwards (the forward's
recompute of every neighbour pair, bytes once; the winners' gradient left
out) over the device time of the pair-backward kernels."""

from portbench.metrics import layer

LAYER = "Kernels (pair stage)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_dets_per_s"


def read(bench):
    return layer.pair_roofline(bench, "pair_bwd")
