"""Share of K1's and K2's row blocks with a step that took their pairs
from the forward's neighbour list rather than testing them, in percent:
the kernels' own device counts (``pair_pool.list_tiles()``). A row block
tests its pairs where a part of its row tile's list overflowed (rows with
more neighbours than the list holds: duplicate detections, crowds).

The counts cover every K1 and K2 launch of the process, warm-up and
captures' eager runs included, and are read after the run, so the
synchronisation that reading them takes times nothing. None in a program
that has no such count, or where no row block had a step."""

LAYER = "Kernels (pair stage)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "train_dets_per_s"


def read(bench):
    try:
        from gossipnet_tpu_torch.ops.cuda import pairwise2
    except ImportError:
        return None
    list_tiles = getattr(pairwise2.pair_pool, "list_tiles", None)
    if list_tiles is None:
        return None
    listed, tested = list_tiles()
    if listed + tested == 0:
        return None
    return 100.0 * listed / (listed + tested)
