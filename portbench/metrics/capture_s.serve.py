"""Seconds of the server's start spent capturing its forward graphs: the sum of
ForwardGraphs.capture_seconds() (an eager run and a capture a shape)."""

from portbench.metrics import layer

LAYER = "Graphs (utils/cuda_graphs.py)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "setup_s"


def read(bench):
    return layer.capture_seconds(bench)
