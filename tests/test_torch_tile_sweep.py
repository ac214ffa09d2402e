"""The pair kernels' skip tile (``ops/cuda/launch.py`` TILES) on the CPU:
the flags at every tile against JAX's ``_tile_activity`` at the same
(FI, TJ), the launch plumbing that follows the tile (the flags' shape, the
split count, the tile words handed to the C entry, the backward's weight
partials per 32-row block), the refusal of any other shape, a model built
at a non-default tile against the default one and the JAX forward, and
``tools.tile_sweep`` at a tiny size.

On CPU tensors the pair stage runs its plain versions, which read no
flags: a model's logits are the same bits at every tile. The kernels'
arithmetic at each tile is held on the card
(``tests/test_torch_cuda.py::test_pair_kernels_at_every_tile_on_card``,
``chip_smoke.py --tiles``).

Tolerance against the JAX forward: rtol = atol = 1e-4, as
``tests/test_torch_model.py`` states it.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gossipnet_tpu.ops import pair_features as j_pf
from gossipnet_tpu.ops.pallas.pairwise import _tile_activity as j_tiles
from gossipnet_tpu_torch import config as t_config
from gossipnet_tpu_torch.ops.cuda import launch
from gossipnet_tpu_torch.ops.cuda import pairwise as k5
from gossipnet_tpu_torch.ops.cuda import pairwise2 as k1
from gossipnet_tpu_torch.params import params_from_jax
from gossipnet_tpu_torch.tools import tile_sweep
from gossipnet_tpu_torch.train import build_model
from tests.test_torch_model import TOL, _jax_logits, _random_tree
from tests.test_torch_pair_pool import THR, _case, _jax_cols, _torch_cols

TILES = [(32, 16), (32, 32), (32, 64), (32, 128), (64, 16), (64, 32),
         (64, 64), (64, 128)]
TILE_IDS = [f"{fi}x{tj}" for fi, tj in TILES]


def test_the_set_and_the_default():
    assert launch.TILES == tuple(TILES)
    assert launch.DEFAULT_TILE == (32, 64) == (launch.TILE_I, launch.TILE_J)
    assert launch.check_tile(None) == launch.DEFAULT_TILE
    assert launch.check_tile([64, 16]) == (64, 16)


@pytest.mark.parametrize("tile", [(16, 64), (32, 8), (32, 256), (128, 128),
                                  (48, 64), (64, 96)])
def test_a_tile_outside_the_set_raises(rng, tile):
    boxes, scores, valid, *_ = _case(rng, b=1, n=40)
    cs = _torch_cols(boxes, scores, valid)
    for build in (k1.pair_geometry, k5.pair_columns):
        with pytest.raises(ValueError, match=r"\(32, 16\)"):
            build(cs, cs, THR, tile=tile)
    with pytest.raises(ValueError, match="pair tile"):
        build_model(t_config.Config(), "kernel", "cpu", pair_tile=tile)


@pytest.mark.parametrize("tile", TILES, ids=TILE_IDS)
def test_tile_flags_match_jax_tile_activity_at_every_tile(rng, tile):
    fi, tj = tile
    boxes, scores, valid, *_ = _case(rng, b=2, n=128, n_valid=100)
    cs = _torch_cols(boxes, scores, valid)
    geom = k1.pair_geometry(cs, cs, THR, tile=tile)
    assert geom.tile == tile
    assert tuple(geom.flags.shape) == (2, 128 // fi, 128 // tj)
    jcs = j_pf.stack_columns(_jax_cols(boxes, scores, valid))
    want = np.asarray(j_tiles(jnp.swapaxes(jcs, 1, 2), jcs, fi,
                              tj)).reshape(geom.flags.shape)
    np.testing.assert_array_equal(geom.flags.numpy(), want)
    # K5's columns carry the same flags at the same tile
    cols = k5.pair_columns(cs, cs, THR, tile=tile)
    assert cols.tile == tile and torch.equal(cols.flags, geom.flags)


@pytest.mark.parametrize("block_sparse", [True, False])
@pytest.mark.parametrize("tile", TILES, ids=TILE_IDS)
def test_block_sparse_flags_are_conservative_at_every_tile(rng, tile,
                                                           block_sparse):
    """Every neighbour pair lies in an active cell at every tile, on a
    ragged N (150 rows: no tile divides it); x-sorted boxes make some
    cells inactive."""
    fi, tj = tile
    boxes, scores, valid, *_ = _case(rng, b=2, n=150, n_valid=140)
    boxes = np.take_along_axis(
        boxes, np.argsort(boxes[..., 0], axis=1)[..., None], axis=1)
    cs = _torch_cols(boxes, scores, valid)
    geom = k1.pair_geometry(cs, cs, THR, block_sparse=block_sparse,
                            tile=tile)
    flags = geom.flags.numpy()
    assert flags.shape == (2, -(-150 // fi), -(-150 // tj))
    _, mask = j_pf.dense_pair_tensor(_jax_cols(boxes, scores, valid), THR)
    bi, i, j = np.nonzero(np.asarray(mask))
    assert flags[bi, i // fi, j // tj].all()
    if block_sparse:
        assert flags.mean() < 1.0
    else:
        assert (flags == 1).all()


def _square(rng, b, n):
    xy = rng.uniform(0, 500, (b, n, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + 20], -1))
    from gossipnet_tpu_torch.ops import pair_features as pf

    return pf.stack_columns(pf.det_columns(
        boxes, torch.from_numpy(rng.uniform(0, 1, (b, n)).astype(
            np.float32)), torch.ones(b, n, dtype=torch.bool)))


@pytest.mark.parametrize("tile", TILES, ids=TILE_IDS)
def test_split_count_follows_the_tile(monkeypatch, tile):
    """The splits cap at one per step of two tests, nj * TJ / 8 over the
    flags' nj tiles of TJ (one column tile of N=40: TJ 16 has 3 tiles of 2
    steps, 128 one of 16), and count blocks of 32 rows whatever FI is."""
    fi, tj = tile
    monkeypatch.setattr(launch, "_sm_count", lambda index: 132)
    cols = _square(np.random.default_rng(0), 1, 40)
    geom = k1.pair_geometry(cols, cols, 0.2, tile=tile)
    nj = geom.flags.shape[2]
    assert nj == -(-40 // tj)
    want = {16: 6, 32: 8, 64: 8, 128: 16}[tj]
    assert launch.col_splits(2, nj, 132, tj) == want
    assert launch._splits(geom, torch.device("cpu")) == want
    assert launch._splits(k5.pair_columns(cols, cols, 0.2, tile=tile),
                          torch.device("cpu")) == want


@pytest.mark.parametrize("tile", TILES, ids=TILE_IDS)
def test_whole_matrix_counts_rows_of_32_at_every_tile(monkeypatch, tile):
    """A backward's split count follows the whole pair matrix in blocks of
    32 rows, so a det shard (NR = N / 2) splits as the square launch does
    at the same tile (F4's rule); blocks of FI = 64 rows would give 9
    splits at config 4's shape instead of 5."""
    fi, tj = tile
    monkeypatch.setattr(launch, "_sm_count", lambda index: 132)
    cols = _square(np.random.default_rng(1), 2, 4096)
    for build in (k1.pair_geometry, k5.pair_columns):
        square = build(cols, cols, 0.2, tile=tile)
        shard = build(cols[:, :, :2048].contiguous(), cols, 0.2, tile=tile)
        whole = launch._splits(shard, torch.device("cpu"), whole_matrix=True)
        assert whole == launch._splits(square, torch.device("cpu")) == 5
        assert launch._splits(shard, torch.device("cpu")) == \
            launch.col_splits(2 * 2048 // 32, 4096 // tj, 132, tj)


@pytest.mark.parametrize("tile", TILES, ids=TILE_IDS)
def test_launch_hands_the_entry_its_tile_words(monkeypatch, tile):
    """What reaches a pair kernel's C entry: the pointers, (B, NR, NC, P,
    K, S), the threshold, the mode word, then FI and TJ of the geometry's
    tile, then the stream."""
    fi, tj = tile
    seen = {}

    def entry(*args):
        seen["args"] = args
        return 0

    monkeypatch.setattr(launch, "_library", lambda *a: SimpleNamespace(
        gnet_entry=entry))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=77))
    cols = _square(np.random.default_rng(2), 2, 100)
    geom = k1.pair_geometry(cols[:, :, :70].contiguous(), cols, 0.2,
                            tile=tile)
    tensors = (geom.row, geom.col, geom.flags)
    launch._launch("lib", "K1", "gnet_entry", "tiles", geom, tensors, 16, 3,
                   5, 2)
    args = seen["args"]
    assert args[:3] == tuple(t.data_ptr() for t in tensors)
    assert args[3:9] == (2, 70, 100, 16, 3, 5)
    assert args[9] == pytest.approx(0.2)
    assert args[10:] == (2, fi, tj, 77)


@pytest.mark.parametrize("tile", [(64, 16), (64, 128)],
                         ids=["64x16", "64x128"])
def test_backward_partials_are_per_block_of_32_rows(monkeypatch, tile):
    """K2's weight partials leave per block of 32 rows and split, whatever
    FI the flags have (blocks own 32 rows, one per lane), as do its regions
    of records, and every block of the grids has an entry of ``work``; the
    kernel's own sum fills the weight gradients, which are views of its
    one output."""
    b, nr, nc, p, k, splits = 2, 70, 100, 16, 3, 3
    cols = _square(np.random.default_rng(3), b, nc)
    geom = k1.pair_geometry(cols[:, :, :nr].contiguous(), cols, 0.2,
                            tile=tile)
    assert geom.flags.shape[1] == -(-nr // tile[0])
    seen = {}

    def fake_launch(name, label, entry, tiles, geom_, tensors, p_, k_,
                    splits_, dtype):
        seen["shapes"] = [tuple(t.shape) for t in tensors]
        tensors[15].copy_(torch.arange(tensors[15].numel()))

    monkeypatch.setattr(launch, "_launch", fake_launch)
    monkeypatch.setattr(launch, "_splits", lambda geom_, device, **kw: splits)
    t = lambda *s: torch.zeros(*s)
    counts = torch.zeros(3, dtype=torch.int64)
    (_, _, dwg, dw2, db2), launched = launch.backward_launch(
        "pairwise2_bwd", "K2", "e", "t", geom, t(b, nr, p), t(b, nc, p),
        t(k, p), t(p, p), t(p), t(b, nr, p), t(b, nr, p), counts, "float32")
    ni, nct = -(-nr // 32), -(-nc // 32)
    words = k * p + p * p + p
    assert seen["shapes"][12:] == [(splits, b, nr, p), (splits, b, nc, p),
                                   (splits * b * ni, words), (words,),
                                   (splits, b, ni + nct), (3,),
                                   (b, ni, 32 * p, p), (b, ni, 32 * p),
                                   (b, ni + 1)]
    assert launched == splits * b * (ni + nct)
    whole = torch.arange(words, dtype=torch.float32)
    assert torch.equal(dwg, whole[:k * p].view(k, p))
    assert torch.equal(dw2, whole[k * p:k * p + p * p].view(p, p))
    assert torch.equal(db2, whole[k * p + p * p:])


def test_library_check_takes_exactly_the_set(monkeypatch):
    """``_library`` binds a kernel library once, after checking that it
    takes every tile of TILES and no other shape."""
    from gossipnet_tpu_torch.ops.cuda import build

    class Fn:   # a ctypes function: takes argtypes and restype
        def __init__(self, rule=None):
            self.rule = rule

        def __call__(self, fi, tj):
            return int(self.rule(fi, tj))

    def fake_lib(rule):
        return SimpleNamespace(entry=Fn(), tiles=Fn(rule))

    good = fake_lib(lambda fi, tj: (fi, tj) in TILES)
    monkeypatch.setattr(build, "load", lambda name: good)
    assert launch._library("k", "entry", "tiles", 9) is good
    assert good._gnet_bound
    old = fake_lib(lambda fi, tj: (fi, tj) == (32, 64))
    monkeypatch.setattr(build, "load", lambda name: old)
    with pytest.raises(RuntimeError, match="takes the tiles"):
        launch._library("k", "entry", "tiles", 9)


def test_model_at_another_tile_matches_default_and_jax(rng, monkeypatch):
    """``build_model(..., pair_tile=(64, 16))`` builds its flags at 64 x 16
    (the geometry every block launches on), and its logits are the default
    tile's bit for bit and the JAX forward's within TOL."""
    from tests.test_pallas_kernel import _problem

    cfg_kw = dict(num_blocks=2, feature_dim=32, reduced_dim=16,
                  pairwise_dim=16, expand_hidden_layers=3,
                  pair_matmul_dtype="float32")
    cfg = t_config.Config(model=t_config.ModelConfig(**cfg_kw))
    boxes, scores, valid, _ = _problem(rng, b=2, n=70)
    boxes, scores, valid = (np.array(x) for x in (boxes, scores, valid))
    valid[1, 55:] = False
    flat = _random_tree(cfg.model, seed=3)
    args = [torch.from_numpy(x) for x in (boxes, scores, valid)]
    seen = []
    real = k1.pair_geometry

    def recording(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(k1, "pair_geometry", recording)
    out = {}
    for tile in ((64, 16), None):
        model = build_model(cfg, "kernel", "cpu", pair_tile=tile)
        model.load_state_dict(params_from_jax(flat))
        with torch.inference_mode():
            out[tile] = model(*args).numpy()
    assert [g.tile for g in seen] == [(64, 16), (32, 64)]
    assert tuple(seen[0].flags.shape) == (2, 2, 5)
    np.testing.assert_array_equal(out[(64, 16)], out[None])
    want = _jax_logits(cfg_kw, flat, "pallas", boxes, scores, valid)
    np.testing.assert_allclose(out[(64, 16)], want, **TOL)


def test_tile_sweep_prints_every_case_on_cpu(capsys):
    results = tile_sweep.main(["--device", "cpu", "--batch", "1", "-n",
                               "32", "--blocks", "1", "--lengths", "1", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    keys = [f"{regime} {fi}x{tj}" for regime in ("dense", "sparse")
            for fi, tj in TILES]
    assert list(results) == keys
    assert lines[0].startswith("tile sweep on cpu")
    assert [ln.split(" {")[0] for ln in lines[1:17]] == keys
    import json

    assert json.loads(lines[17]) == results
    assert lines[18] == "DONE"
    for r in results.values():
        # a CPU host clock over chains of 1 and 2 is no measurement: the
        # difference may even come out negative on a loaded host
        assert np.isfinite(r["ms_per_fwd"]) and np.isfinite(
            r["dets_per_sec"])
        assert r["k1_iou_tests"] >= r["k1_neighbour_pairs"] > 0
    # dense: every valid pair is tested at every tile
    assert len({results[k]["k1_iou_tests"] for k in keys[:8]}) == 1


def test_tile_sweep_reports_a_failed_case_and_exits_nonzero(monkeypatch,
                                                            capsys):
    real = tile_sweep.run_case

    def failing(model_cfg, tile, *a):
        if tile == (64, 32):
            raise RuntimeError("launch failed: CUDA error 1")
        return real(model_cfg, tile, *a)

    monkeypatch.setattr(tile_sweep, "run_case", failing)
    with pytest.raises(SystemExit, match="2 case"):
        tile_sweep.main(["--device", "cpu", "--batch", "1", "-n", "32",
                         "--blocks", "1", "--lengths", "1", "2"])
    out = capsys.readouterr().out
    assert "dense 64x32 FAILED: RuntimeError: launch failed" in out
    assert out.strip().endswith("DONE")


def test_tile_sweep_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError):
        tile_sweep.main([])
