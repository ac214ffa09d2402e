"""The 80-class training window's needed operations (the class-aware
forward, a backward of twice it and Adam) at the bf16 peak, over the
window."""

from portbench.metrics import multiclass

LAYER = "Step"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_dets_per_s"


def read(bench):
    return multiclass.mfu(bench)
