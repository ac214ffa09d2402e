"""Share of the open-loop serving window in which the device ran nothing
(torch.profiler over the window)."""

from portbench.metrics import layer

LAYER = "Device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "serve_p95_ms"


def read(bench):
    return layer.device_idle(bench)
