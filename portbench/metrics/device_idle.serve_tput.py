"""Share of the closed-loop serving window in which the device ran nothing
(torch.profiler over the window)."""

from portbench.metrics import layer

LAYER = "Device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "serve_dets_per_s"


def read(bench):
    return layer.device_idle(bench)
