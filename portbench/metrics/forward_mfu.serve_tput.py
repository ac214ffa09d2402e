"""The served forwards' needed operations at the bf16 peak, over the closed-
loop window."""

from portbench.metrics import layer

LAYER = "Model (models/gossipnet.py)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "serve_dets_per_s"


def read(bench):
    return layer.mfu(bench, training=False)
