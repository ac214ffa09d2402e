"""Least time of the served forwards' pair stages over the device time of the
pair-forward kernels, closed-loop serving."""

from portbench.metrics import layer

LAYER = "Kernels (pair stage)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "serve_dets_per_s"


def read(bench):
    return layer.pair_roofline(bench, "pair_fwd")
