"""Images per dispatched batch over the open-loop window: the server's own
counters (TcpServer.stats images and batches), their change across the
window."""

from portbench.metrics import layer

LAYER = "Server (serving.py TcpServer)"
UNIT = "images"
SOURCE = "program_counter"
MOVES = "serve_p95_ms"


def read(bench):
    return layer.images_per_batch(bench)
