"""Least time of the 80-class window's pair-stage forwards (neighbour pairs
x the operations of a pair with four in-pair features, the class match
among them; nine fields a side, bytes once) over the device time of the
pair-forward kernels."""

from portbench.metrics import multiclass

LAYER = "Kernels (pair stage)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_dets_per_s"


def read(bench):
    return multiclass.pair_roofline(bench, "pair_fwd")
