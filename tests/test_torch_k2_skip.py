"""K2's skip rule on the CPU: ``ops/cuda/launch.py::work_blocks``, which
of the kernel's blocks the flags hand a step, on small hand-made flags;
the rule by which its column pass takes the row pass's records, against
it; the size of its scratch; and the launcher's counts.

The kernel's own count (``pair_pool_backward.blocks_with_work()``) is held
to this one on the card (``tests/test_torch_cuda.py``). A block owns 32
detections; it walks the other side's tiles of TJ, TJ / 8 items a tile,
items ``split, split + S, ...``; it has a step where one of them falls in
a tile its flags mark active.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import pytest
import torch

from gossipnet_tpu_torch.ops.cuda import launch
from gossipnet_tpu_torch.ops.cuda import pairwise2 as k1


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


def _records_split(rows: torch.Tensor, splits: int,
                   tj: int) -> torch.Tensor:
    """The split whose column blocks sum each row's records
    (``csrc/pairwise2_bwd.cu::records_split``): one that holds an item of
    the row's tile of TJ, item k for the k-th 32 rows of the tile (a tile
    has TJ / 8 items)."""
    return ((rows // tj) * (tj // 8) + (rows % tj) // 32) % splits


@pytest.mark.parametrize("tile", [(32, 16), (32, 64), (64, 32), (64, 128)])
@pytest.mark.parametrize("splits", [1, 5, 13, 40])
def test_every_record_lands_in_a_block_with_a_step(tile, splits):
    """K2's column blocks sum a record (i, j) in the block of j's 32
    columns and of i's split. Every neighbour pair lies in a set flag
    cell, and there the skip rule gives that block a step, so no record is
    left to a block that leaves at once; a row tile of 32 has one split
    (two at TJ = 16), so a block reads a share of the regions."""
    fi, tj = tile
    n = 256
    g = torch.Generator().manual_seed(splits)
    flags = (torch.rand((2, n // fi, n // tj), generator=g) < 0.25).to(
        torch.int32)
    work = launch.work_blocks(flags, n, n, splits, tile)
    ni = n // 32
    for img, fr, fc in flags.nonzero().tolist():
        rows = torch.arange(fr * fi, (fr + 1) * fi)
        for col_block in range(fc * tj // 32, ((fc + 1) * tj - 1) // 32 + 1):
            got = work[_records_split(rows, splits, tj), img, ni + col_block]
            assert bool(got.all()), (img, fr, fc, col_block)
    per_tile = _records_split(torch.arange(n), splits, tj).view(-1, 32)
    halves = per_tile.view(-1, 2, 16) if tj == 16 else per_tile[:, None]
    assert bool((halves == halves[..., :1]).all())


@pytest.mark.parametrize("s, b, n, p", [(5, 2, 4096, 32), (1, 2, 4096, 32),
                                        (3, 8, 1024, 32), (2, 1, 300, 64)])
def test_backward_scratch_is_sized_from_shapes(s, b, n, p):
    """The records take one region per image and row tile of 32, shared by
    the splits: 32 x P records (the tie-free bound: one winner a row and
    q) of P floats and a packed index, and a count per region and a word
    per image. At the crowd's shape (B=2, N=4096, P=32) that is 34.6 MB,
    whatever the split count; the rest as before."""
    k = 3
    got = launch.backward_scratch(s, b, n, n, p, k)
    ni = -(-n // 32)
    assert list(got) == ["da_part", "db_part", "wpart", "work", "rec_vr",
                         "rec_ij", "rec_fill"]
    assert got["da_part"] == ((s, b, n, p), torch.float32)
    assert got["db_part"] == ((s, b, n, p), torch.float32)
    assert got["wpart"] == ((s * b * ni, k * p + p * p + p), torch.float32)
    assert got["work"] == ((s, b, 2 * ni), torch.int32)
    assert got["rec_vr"] == ((b, ni, 32 * p, p), torch.float32)
    assert got["rec_ij"] == ((b, ni, 32 * p), torch.int32)
    assert got["rec_fill"] == ((b, ni + 1), torch.int32)
    record_bytes = sum(torch.Size(shape).numel() * 4 for name, (shape, _) in
                       got.items() if name.startswith("rec_"))
    if (b, n, p) == (2, 4096, 32):
        assert record_bytes == 34_604_040
    # a row shard's regions follow its own rows, not the columns
    shard = launch.backward_scratch(s, b, n // 2, n, p, k)
    assert shard["rec_vr"][0] == (b, -(-n // 64), 32 * p, p)


def test_k2_launcher_counts_its_blocks_and_keeps_one_counter(monkeypatch):
    """Each K2 call adds one launch and the blocks of its two grids, and
    hands the kernel the device's one int64 [5] counter and the
    geometry's neighbour list; the counts read from it: blocks with a
    step, column blocks that summed records and that recomputed, and row
    blocks that took their pairs from the list and that tested them."""
    seen = []
    lists = (torch.zeros(1), torch.zeros(2), torch.zeros(3))

    def fake_launch(geom, a2, b2, wg_k, w2, b2bias, m, dm, counts, *dts,
                    extra=()):
        seen.append(counts)
        assert all(x is y for x, y in zip(extra, lists, strict=True))
        counts += torch.tensor([7, 3, 1, 5, 2])
        return (a2, b2, wg_k, w2, b2bias), 2 * 5 * (4 + 6)

    monkeypatch.setattr(k1, "check_inputs", lambda *a, **kw: None)
    monkeypatch.setattr(k1, "check_packable", lambda *a: None)
    monkeypatch.setattr(k1, "_pairs_of", lambda label, geom: lists)
    monkeypatch.setattr(k1, "backward_launch",
                        lambda *a, **kw: fake_launch(*a[4:], **kw))
    monkeypatch.setattr(k1, "_COUNTS", {})
    bwd = k1.pair_pool_backward
    monkeypatch.setattr(bwd, "launches", 0)
    monkeypatch.setattr(bwd, "blocks_launched", 0)
    t = torch.zeros(1)
    for _ in range(2):
        k1.launch_backward_kernel(None, t, t, t, t, t, t, t, "float32")
    assert bwd.launches == 2 and bwd.blocks_launched == 200
    assert seen[0] is seen[1]
    assert seen[0].dtype == torch.int64 and seen[0].shape == (5,)
    assert bwd.blocks_with_work() == 14
    assert bwd.column_blocks() == (6, 2)
    assert k1.pair_pool.list_tiles() == (10, 4)


def test_a_row_tile_with_a_list_steps_where_its_groups_fall():
    """A row tile that takes its pairs from the forward's list deals its
    groups to the splits' four warps, group g to split g // 4 mod S: its
    row block of a split has a step where a group falls to it, whatever
    its flags; a dense tile (-1) keeps the flags' rule; the column blocks
    keep theirs."""
    flags = _flags(1, 8, 4, [(0, 0, 0), (0, 1, 0), (0, 2, 1)])
    groups = torch.tensor([[9, -1, 0, 25, 0, 0, 0, 0]])
    plain = launch.work_blocks(flags, 256, 256, 5, (32, 64))
    work = launch.work_blocks(flags, 256, 256, 5, (32, 64), groups=groups)
    assert work[:, 0, 0].tolist() == [True, True, True, False, False]
    assert torch.equal(work[:, 0, 1], plain[:, 0, 1])
    assert bool(plain[:, 0, 2].any()) and not bool(work[:, 0, 2].any())
    assert bool(work[:, 0, 3].all()) and not bool(plain[:, 0, 3].any())
    assert torch.equal(work[:, :, 8:], plain[:, :, 8:])
