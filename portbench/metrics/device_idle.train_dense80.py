"""Share of the 80-class training window in which no kernel, copy or set
ran on the device (torch.profiler over the window)."""

from portbench.metrics import layer

LAYER = "Device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_dets_per_s"


def read(bench):
    return layer.device_idle(bench)
