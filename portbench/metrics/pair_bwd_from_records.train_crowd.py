"""Share of K2's column blocks with a step that summed d_b' from the row
pass's records rather than recomputing their neighbour pairs, in percent:
the kernel's own device counts (``pair_pool_backward.column_blocks()``).
A block recomputes where a region of its image's records overflowed
(exact ties: duplicate detections, the bf16 stream).

The counts cover every K2 launch of the process, warm-up and captures'
eager runs included, and are read after the run, so the synchronisation
that reading them takes times nothing. None in a program that has no such
count, or where no column block had a step."""

LAYER = "Kernels (pair stage)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "train_dets_per_s"


def read(bench):
    try:
        from gossipnet_tpu_torch.ops.cuda import pairwise2
    except ImportError:
        return None
    column_blocks = getattr(pairwise2.pair_pool_backward, "column_blocks",
                            None)
    if column_blocks is None:
        return None
    records, recomputed = column_blocks()
    if records + recomputed == 0:
        return None
    return 100.0 * records / (records + recomputed)
