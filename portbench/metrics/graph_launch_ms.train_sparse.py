"""The sparse training window's median duration of the span
``gossipnet.graphs.launch``: the host's cost of launching one captured
step (the replay call and the kernels' launch counters)."""

from portbench.metrics import spans

LAYER = "Graphs"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_dets_per_s.sparse"


def read(bench):
    return spans.launch_ms(bench)
