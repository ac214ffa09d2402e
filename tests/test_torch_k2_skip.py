"""K2's skip rule on the CPU: ``ops/cuda/launch.py::work_blocks``, which
of the kernel's blocks the flags hand a step, on small hand-made flags.

The kernel's own count (``pair_pool_backward.blocks_with_work()``) is held
to this one on the card (``tests/test_torch_cuda.py``). A block owns 32
detections; it walks the other side's tiles of TJ, TJ / 8 items a tile,
items ``split, split + S, ...``; it has a step where one of them falls in
a tile its flags mark active.
"""

import pytest
import torch

from gossipnet_tpu_torch.ops.cuda import launch


def _flags(b, nfr, nfc, live=()):
    f = torch.zeros((b, nfr, nfc), dtype=torch.int32)
    for cell in live:
        f[cell] = 1
    return f


def test_a_dead_image_has_no_block_with_a_step():
    work = launch.work_blocks(_flags(2, 8, 4), 256, 256, 17, (32, 64))
    assert work.shape == (17, 2, 16)
    assert not work.any()


def test_one_live_tile_reaches_its_row_block_and_two_column_blocks():
    """N=256 at 32 x 64: the flag of rows 0-31 and columns 0-63 is set in
    image 1 only. Row block 0 sees column tile 0, items 0-7; column blocks
    0 and 1 (columns 0-31, 32-63) see row tile 0 (rows 0-63), items 0-7.
    At S = 17 only splits 0-7 meet those items."""
    work = launch.work_blocks(_flags(2, 8, 4, [(1, 0, 0)]), 256, 256, 17,
                              (32, 64))
    want = torch.zeros((17, 2, 16), dtype=torch.bool)
    want[:8, 1, 0] = True          # row block 0
    want[:8, 1, 8:10] = True       # column blocks 0 and 1
    assert torch.equal(work, want)
    # fewer splits than the live tile's items: every split has a step
    work = launch.work_blocks(_flags(1, 8, 4, [(0, 0, 0)]), 256, 256, 5,
                              (32, 64))
    assert work[:, 0, 0].all() and work[:, 0, 8:10].all()
    assert int(work.sum()) == 3 * 5


@pytest.mark.parametrize("splits, per_block", [(17, 17), (32, 32), (40, 32)])
def test_all_live_and_splits_beyond_the_steps(splits, per_block):
    """All flags set at N=256, 32 x 64: 4 tiles x 8 items = 32 items a
    block, so a split past the 32nd has no step."""
    flags = torch.ones((3, 8, 4), dtype=torch.int32)
    work = launch.work_blocks(flags, 256, 256, splits, (32, 64))
    assert int(work.sum()) == 3 * 16 * per_block
    assert work[:per_block].all() and not work[per_block:].any()


def test_tall_flag_rows_and_narrow_tiles():
    """N=64 at 64 x 16: one flag row covers both row blocks; the flag of
    columns 16-31 is set. Row blocks see column tile 1, items 2 and 3
    (splits 2 and 0 of 3); column block 0 (flag columns 0 and 1) sees all
    four row tiles, items 0-7 (every split); column block 1 none."""
    work = launch.work_blocks(_flags(1, 1, 4, [(0, 0, 1)]), 64, 64, 3,
                              (64, 16))
    want = torch.zeros((3, 1, 4), dtype=torch.bool)
    want[[0, 2], 0, 0:2] = True
    want[:, 0, 2] = True
    assert torch.equal(work, want)


def test_a_row_shard_keeps_the_square_launch_row_blocks():
    """A det shard's rows (NR = N / 2 against NC = N, the square launch's
    split count) have the steps of the square launch's same rows."""
    g = torch.Generator().manual_seed(0)
    flags = (torch.rand((2, 8, 4), generator=g) < 0.3).to(torch.int32)
    square = launch.work_blocks(flags, 256, 256, 9, (32, 64))
    shard = launch.work_blocks(flags[:, 4:].contiguous(), 128, 256, 9,
                               (32, 64))
    assert torch.equal(shard[:, :, :4], square[:, :, 4:8])
