"""The 80-class training window's median host self time a step: the span
``gossipnet.train.step`` less its ``gossipnet.graphs.launch``,
``gossipnet.graphs.capture`` and ``gossipnet.train.sync`` descendants (the
draw, the staging of eight arrays with the classes among them, the
metrics' clones and the bookkeeping)."""

from portbench.metrics import spans

LAYER = "Trainer"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_dets_per_s"


def read(bench):
    return spans.step_host_ms(bench)
