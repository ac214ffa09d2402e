"""The class-aware matching's device time a step in the 80-class training
window: the seconds of K3's kernels (stage ``match`` of
``kernels/match/*.json``; ten thresholds a launch here) inside the traced
window, over the steps dispatched in it, in ms. The window opens and
closes on a synchronisation, so each of its steps ran wholly inside it."""

from portbench.metrics import multiclass

LAYER = "Loss, matching"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_dets_per_s"


def read(bench):
    seconds, steps = multiclass.match_seconds(bench), bench.layer.get("steps")
    if seconds is None or not steps:
        return None
    return 1e3 * seconds / steps
