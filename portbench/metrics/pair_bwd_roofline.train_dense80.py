"""Least time of the 80-class window's pair-stage backwards (the forward's
recompute of every neighbour pair with its four in-pair features, bytes
once; the winners' gradient left out) over the device time of the
pair-backward kernels."""

from portbench.metrics import multiclass

LAYER = "Kernels (pair stage)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_dets_per_s"


def read(bench):
    return multiclass.pair_roofline(bench, "pair_bwd")
