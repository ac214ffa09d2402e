"""The crowd training window's needed operations (forward, a backward of
twice the forward and Adam) at the bf16 peak, over the window."""

from portbench.metrics import layer

LAYER = "Step"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_dets_per_s"


def read(bench):
    return layer.mfu(bench, training=True)
