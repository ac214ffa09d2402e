"""Least time of the crowd window's pair-stage forwards (neighbour pairs x
operations a pair, bytes once) over the device time of the pair-forward
kernels."""

from portbench.metrics import layer

LAYER = "Kernels (pair stage)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_dets_per_s"


def read(bench):
    return layer.pair_roofline(bench, "pair_fwd")
