"""Images per dispatched batch over the closed-loop window, from
TcpServer.stats."""

from portbench.metrics import layer

LAYER = "Server (serving.py TcpServer)"
UNIT = "images"
SOURCE = "program_counter"
MOVES = "serve_dets_per_s"


def read(bench):
    return layer.images_per_batch(bench)
