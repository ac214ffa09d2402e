"""K2's blocks that had a step, as a share of the blocks its grids launched:
the kernel's own device count (``pair_pool_backward.blocks_with_work()``)
over the host's count of launched blocks (``blocks_launched``, added again
at each graph replay), in percent.

Both count every K2 launch of the process, warm-up and captures' eager
runs included, and are read after the run, so the synchronisation that
reading the device count takes times nothing. Warm-up and window cycle
the same 128 images, so the share is the window's. None in a program that
has no such count, or where no K2 block was launched."""

LAYER = "Kernels (pair stage)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "train_dets_per_s"


def read(bench):
    try:
        from gossipnet_tpu_torch.ops.cuda import pairwise2
    except ImportError:
        return None
    bwd = pairwise2.pair_pool_backward
    launched = getattr(bwd, "blocks_launched", 0)
    worked = getattr(bwd, "blocks_with_work", None)
    if not launched or worked is None:
        return None
    return 100.0 * worked() / launched
