"""The CUDA kernels against their plain PyTorch versions, on the card: K1
(pair-pool forward), K2 (its backward: f32, bf16, the tie rule, two
launches bit-identical), K3/K4 (the matching scan, exactly: overflow rows,
G = 1024, 400 and 13, N = 4096 and N not a multiple of 32, T = 32, all-zero
IoU, two launches bit-identical, every output written), K5/K6 (the
unfolded pair pool and its backward, the same checks), K7 (the per-tile
ablation: six modes, three column tiles; bit-equal where FC2's order
cannot matter: W2 a permutation, or no FC2), one training step
of config 2 and one of config 3 through K5/K6, with their launch counts;
K5/K6 on the launch arguments of config 4's model (f32 bit-equal m and
winners, bf16 with dm zero at the near-tied maxima), two K6 launches
bit-identical there, and K6's column-permutation probe; K1/K2 and K5/K6
on the flagship model's launch arguments for the ``blob`` layout (B=2
N=256, B=1 N=1024, B=2 N=4096) and a coincident batch, where every pair
is a neighbour (the same checks); ``tools/bench.py``'s captured
loop body against a host chain, bit for bit; and
``AsyncBatch.wait()`` reading back its own batch alone (work enqueued on
the stream after the dispatch does not delay it); and K1/K2 with the bf16
stream (``pair_elementwise_dtype: bfloat16``) on the flagship's launch
arguments at the bench batch, config 2's training batch and ``blob`` at
B=2 N=256: m bf16 values, at most one bf16 ulp from the plain version's in
at most 1% of the entries; the backward at bf16's tolerances with dm zero
where the best two candidates lie within one bf16 ulp; and K1/K2 and
K5/K6 on the row shards of a det-sharded forward (parallel/spmd.py)
against the square launch: m and d_a' bit for bit, the shards' summed
d_b' and weight gradients within the weight-gradient gate; and config 2
trained and evaluated from the scale drill's real-format files, with its
launches counted; and K1/K2 and K5/K6 at every skip tile of
``ops/cuda/launch.py`` TILES against their plain versions, on banded
flags where at TJ = 16 neighbours straddle the 16-column cells of the
backwards' 32-column blocks.

These tests need an NVIDIA GPU (the kernel has no CPU mode) and skip
without one. The file imports no JAX, so it runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 rtol = atol = 1e-5 (the kernel and the plain version do
the same f32 arithmetic in another summation order); bf16 as in
tests/test_torch_pair_pool.py (one bf16 ulp of an h1 value may flip):
rtol = atol = 2e-2 everywhere and 1e-4 on 99% of the outputs. Neighbour
masks are exact by construction (explicitly rounded IoU). K2's weight
gradients sum over every pair in another order: 1e-4 of their largest
entry; K6's the same. The scan does comparisons only: exact.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from gossipnet_tpu_torch.models.gossipnet import PairParams
from gossipnet_tpu_torch.ops import pair_features as pf
from gossipnet_tpu_torch.ops.cuda import pairwise2 as k1

THR = 0.2


def _clustered(rng, b, n, n_valid=None, num_classes=0, canvas=300.0):
    centers = rng.uniform(0, canvas, (max(n // 6, 1), 2))
    size = rng.uniform(20, 60, (len(centers), 2))
    idx = rng.integers(0, len(centers), (b, n))
    xy = centers[idx] + rng.normal(0, 6.0, (b, n, 2))
    wh = np.maximum(size[idx] + rng.normal(0, 6.0, (b, n, 2)), 1.0)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    valid = np.ones((b, n), bool)
    if n_valid is not None:
        valid[:, n_valid:] = False
    classes = (rng.integers(0, num_classes, (b, n)) if num_classes else None)
    return boxes, scores, valid, classes


CASES = {
    "odd_padded": dict(b=2, n=301, n_valid=270),
    "rect": dict(b=2, n=200, rows=slice(7, 130)),
    "multiclass": dict(b=2, n=256, num_classes=5),
    "dense_tiles": dict(b=1, n=300, block_sparse=False),
    "p16": dict(b=2, n=150, p=16),
    "p64": dict(b=1, n=150, p=64),
    "all_padding": dict(b=2, n=128, all_invalid=1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_on_card(name, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    case = dict(CASES[name])
    p = case.pop("p", 32)
    rows = case.pop("rows", slice(None))
    block_sparse = case.pop("block_sparse", True)
    all_invalid = case.pop("all_invalid", None)
    rng = np.random.default_rng(len(name))
    boxes, scores, valid, classes = _clustered(rng, **case)
    if all_invalid is not None:
        valid[all_invalid] = False
    dev = torch.device("cuda")
    cs = pf.stack_columns(pf.det_columns(
        torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev),
        torch.from_numpy(valid).to(dev)))
    b, n = scores.shape
    g = pf.NUM_PAIR_FEATURES_MC if classes is not None else \
        pf.NUM_PAIR_FEATURES
    prm = PairParams(*[torch.from_numpy(
        rng.normal(0, 0.5, s).astype(np.float32)).to(dev)
        for s in ((p, p), (p, p), (g, p), (p,), (p, p), (p,))])
    a = torch.from_numpy(rng.normal(0, 1, (b, n, p)).astype(
        np.float32)).to(dev)
    bb = torch.from_numpy(rng.normal(0, 1, (b, n, p)).astype(
        np.float32)).to(dev)
    cls = None if classes is None else torch.from_numpy(classes).to(dev)
    kw = dict(classes=None if cls is None else cls[:, rows].contiguous(),
              col_classes=cls, compute_dtype=dtype)
    row_cs = cs[:, :, rows].contiguous()
    a_rows = a[:, rows].contiguous()
    before = k1.pair_pool.launches
    got = k1.pair_pool(row_cs, cs, a_rows, bb, prm, THR,
                       block_sparse=block_sparse, **kw)
    want = k1.pair_pool_reference(row_cs, cs, a_rows, bb, prm, THR, **kw)
    torch.cuda.synchronize()
    assert k1.pair_pool.launches == before + 1
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert (want > 0).any() or all_invalid is not None
    if all_invalid is not None:
        assert (got[all_invalid] == 0).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
        assert np.mean(np.abs(got - want) > 1e-4) < 0.01


# ---------------------------------------------------------------------------
# K2, K3/K4 and one training step
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _pair_args(rng, b, n, dev, p=32, dup_cols=False):
    boxes, scores, valid, _ = _clustered(rng, b, n)
    cs = pf.stack_columns(pf.det_columns(
        torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev),
        torch.from_numpy(valid).to(dev)))
    col = torch.repeat_interleave(cs, 2, dim=2) if dup_cols else cs
    geom = k1.pair_geometry(cs, col, THR)

    def t(*shape, scale=0.5):
        return torch.from_numpy(
            rng.normal(0, scale, shape).astype(np.float32)).to(dev)

    b2 = t(b, n, p, scale=1.0)
    if dup_cols:
        b2 = torch.repeat_interleave(b2, 2, dim=1).contiguous()
    return (geom, t(b, n, p, scale=1.0), b2, t(3, p), t(p, p), t(p)), \
        t(b, n, p, scale=1.0), cs


def _assert_grads(got, want, dtype):
    for name, x, y in zip(("d_a'", "d_b'", "dWg", "dW2", "db2"), got, want):
        x, y = x.cpu().numpy(), y.cpu().numpy()
        if name in ("d_a'", "d_b'"):
            if dtype == "float32":
                np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5,
                                           err_msg=name)
            else:
                np.testing.assert_allclose(x, y, rtol=2e-2, atol=2e-2,
                                           err_msg=name)
                assert np.mean(np.abs(x - y) > 1e-4) < 0.01, name
        else:
            np.testing.assert_allclose(x, y, rtol=0,
                                       atol=1e-4 * np.abs(y).max(),
                                       err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [16, 32, 64])
def test_k2_matches_plain_backward_on_card(dtype, p):
    dev = _card()
    rng = np.random.default_rng(p)
    args, dm, _ = _pair_args(rng, 2, 301, dev, p=p)
    m = k1.launch_kernel(*args, dtype)
    m_plain = k1._reference_core(*args, dtype)
    before = k1.pair_pool_backward.launches
    got = k1.pair_pool_backward(*args, m, dm, dtype)
    want = k1.pair_pool_backward_reference(*args, m_plain, dm, dtype)
    torch.cuda.synchronize()
    assert k1.pair_pool_backward.launches == before + 1
    _assert_grads(got, want, dtype)
    # determinism: a second launch gives the same bits
    again = k1.launch_backward_kernel(*args, m, dm, dtype)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_gives_each_tie_the_full_gradient_on_card(dtype):
    dev = _card()
    rng = np.random.default_rng(3)
    args_d, dm, cs = _pair_args(rng, 2, 200, dev, dup_cols=True)
    _, a2, b2_d, wg, w2, b2b = args_d
    args_s = (k1.pair_geometry(cs, cs, THR), a2,
              b2_d[:, 0::2].contiguous(), wg, w2, b2b)
    m_s = k1.launch_kernel(*args_s, dtype)
    m_d = k1.launch_kernel(*args_d, dtype)
    single = k1.launch_backward_kernel(*args_s, m_s, dm, dtype)
    dup = k1.launch_backward_kernel(*args_d, m_d, dm, dtype)
    torch.cuda.synchronize()
    assert torch.equal(m_s, m_d)
    assert torch.equal(dup[1][:, 0::2], dup[1][:, 1::2])
    _assert_grads(dup, (2 * single[0], single[1].repeat_interleave(2, dim=1),
                        2 * single[2], 2 * single[3], 2 * single[4]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 10])
def test_k3_k4_match_plain_scan_exactly_on_card(t):
    from gossipnet_tpu_torch.ops.cuda import matching_scan as k3

    dev = _card()
    rng = np.random.default_rng(t)
    iou = rng.uniform(0, 1, (4, 600, 112)).astype(np.float32)
    iou[rng.uniform(size=iou.shape) < 0.6] = 0.0
    iou = np.round(iou * 16) / 16                  # many exact ties
    iou_t = torch.from_numpy(iou).to(dev)
    thr = torch.tensor(np.linspace(0.5, 0.95, t), dtype=torch.float32)
    before = k3.greedy_scan_batched.launches, k3.greedy_scan.launches
    got = k3.greedy_scan_batched(iou_t, thr)
    one = k3.greedy_scan(iou_t[1], thr)
    want = k3.greedy_scan_reference(iou_t, thr)
    torch.cuda.synchronize()
    assert (k3.greedy_scan_batched.launches, k3.greedy_scan.launches) == \
        (before[0] + 1, before[1] + 1)
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y.cpu())
    for x, y in zip(one, want):
        assert torch.equal(x.cpu(), y[1].cpu())


def _sparse_iou(rng, b, n, g, per_row, dense_rows=()):
    """Pre-masked IoU in sixteenths (exact ties), about ``per_row``
    candidates a row, every fifth row masked, ``dense_rows`` with a
    candidate in every column (more than a candidate list holds)."""
    iou = np.round(rng.uniform(0.3, 1.0, (b, n, g)) * 16) / 16
    iou *= rng.uniform(size=(b, n, g)) < per_row / g
    iou[:, ::5] = 0.0
    rows = list(dense_rows)
    iou[:, rows] = np.round(rng.uniform(0.5, 1.0, (b, len(rows), g)) * 16) / 16
    return iou.astype(np.float32)


COCO_T = np.round(np.arange(0.5, 0.951, 0.05), 2).astype(np.float32)
T32 = np.round(np.linspace(0.05, 0.95, 32), 3).astype(np.float32)
SCAN_CASES = {   # name: (iou maker, thresholds)
    "overflow_rows": (lambda r: _sparse_iou(r, 2, 300, 112, 4, (3, 50, 51)),
                      COCO_T),
    "g1024_n1000": (lambda r: _sparse_iou(r, 2, 1000, 1024, 6, (7, 998)),
                    COCO_T),
    "g400_n4096": (lambda r: _sparse_iou(r, 2, 4096, 400, 3, (100,)),
                   np.float32([0.5])),
    "n_not_a_multiple_of_32": (lambda r: _sparse_iou(r, 3, 77, 16, 2),
                               COCO_T),
    "t32": (lambda r: _sparse_iou(r, 2, 500, 112, 8, (40,)), T32),
    "g_not_a_multiple_of_4": (lambda r: _sparse_iou(r, 2, 130, 13, 3, (9,)),
                              COCO_T[:3]),
    "all_zero": (lambda r: np.zeros((2, 257, 112), np.float32), COCO_T),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCAN_CASES))
def test_k3_k4_cases_exact_on_card(name):
    """K3 on each case, and K4 on its first image, exactly as the plain
    scan; two launches bit-identical."""
    from gossipnet_tpu_torch.ops.cuda import matching_scan as k3

    dev = _card()
    make, thr_np = SCAN_CASES[name]
    iou = torch.from_numpy(make(np.random.default_rng(5))).to(dev)
    thr = torch.from_numpy(thr_np)
    got = k3.greedy_scan_batched(iou, thr)
    again = k3.launch_kernel(iou, thr)
    one = k3.greedy_scan(iou[0], thr)
    want = k3.greedy_scan_reference(iou, thr)
    torch.cuda.synchronize()
    for x, y, z in zip(got, again, want):
        assert torch.equal(x, y)
        assert torch.equal(x.cpu(), z.cpu())
    for x, z in zip(one, want):
        assert torch.equal(x.cpu(), z[0].cpu())


@pytest.mark.cuda
def test_k3_writes_every_output_on_card():
    """The outputs come from torch.empty: filled blocks of their sizes in
    the caching allocator are reused, and the result is still exact."""
    from gossipnet_tpu_torch.ops.cuda import matching_scan as k3

    dev = _card()
    iou = torch.from_numpy(_sparse_iou(np.random.default_rng(6), 4, 700,
                                       112, 3, (11,))).to(dev)
    thr = torch.from_numpy(COCO_T)
    shape = (4, 700, len(COCO_T))
    junk = [x for _ in range(4) for x in (
        torch.ones(shape, dtype=torch.bool, device=dev),
        torch.full(shape, 0x5A5A5A5A, dtype=torch.int32, device=dev))]
    ptrs = {x.data_ptr() for x in junk}
    del junk
    got = k3.launch_kernel(iou, thr)
    want = k3.greedy_scan_reference(iou, thr)
    torch.cuda.synchronize()
    assert all(x.data_ptr() in ptrs for x in got)
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.cuda
def test_one_train_step_on_card_launches_k1_k2_k3():
    from gossipnet_tpu_torch import train as training
    from gossipnet_tpu_torch.config import experiment_path, load_config
    from gossipnet_tpu_torch.data.bucketing import BatchIterator
    from gossipnet_tpu_torch.data.synthetic import synthetic_roidb
    from gossipnet_tpu_torch.ops.cuda import matching_scan as k3

    dev = _card()
    cfg = load_config(experiment_path("coco_persons_full"),
                      {"data": {"dataset": "synthetic"}})
    roidb = synthetic_roidb(num_images=8, seed=0, num_gt=40, dets_per_gt=8,
                            num_clutter=40)
    batch = next(BatchIterator(roidb, 8, cfg.data.bucket_sizes))
    model = training.build_model(cfg, "kernel", dev)
    state = training.create_train_state(cfg, model)
    before = (k1.pair_pool.launches, k1.pair_pool_backward.launches,
              k3.greedy_scan_batched.launches)
    state, metrics = training.train_step(
        state, training.batch_to_device(batch, dev), cfg)
    torch.cuda.synchronize()
    after = (k1.pair_pool.launches, k1.pair_pool_backward.launches,
             k3.greedy_scan_batched.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (16, 16, 1)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert float(metrics["grad_norm"]) > 0


# ---------------------------------------------------------------------------
# K5/K6 (pair_kernel: 1) and one config-3 training step through them
# ---------------------------------------------------------------------------


def _k5_args(rng, b, n, dev, p=32, num_classes=0, dup_cols=False,
             n_valid=None, rows=slice(None)):
    """(PairColumns, a, b, Wg, W2, b2) of one unfolded pair stage on random
    weights, and a random cotangent dm."""
    from gossipnet_tpu_torch.ops.cuda import pairwise as k5

    boxes, scores, valid, classes = _clustered(rng, b, n, n_valid=n_valid,
                                               num_classes=num_classes)
    cs = pf.stack_columns(pf.det_columns(
        torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev),
        torch.from_numpy(valid).to(dev)))
    cls = None if classes is None else torch.from_numpy(classes).to(dev)
    col, col_cls = cs, cls
    if dup_cols:
        col = torch.repeat_interleave(cs, 2, dim=2)
        col_cls = None if cls is None else torch.repeat_interleave(cls, 2, 1)
    rcls = None if cls is None else cls[:, rows].contiguous()
    cols = k5.pair_columns(cs[:, :, rows].contiguous(), col, THR, rcls,
                           col_cls)
    nr, nc = cols.row.shape[2], cols.col.shape[2]

    def t(*shape, scale=0.5):
        return torch.from_numpy(
            rng.normal(0, scale, shape).astype(np.float32)).to(dev)

    bb = t(b, n, p, scale=1.0)
    if dup_cols:
        bb = torch.repeat_interleave(bb, 2, dim=1).contiguous()
    return (cols, t(b, nr, p, scale=1.0), bb, t(cols.num_features, p),
            t(p, p), t(p)), t(b, nr, p, scale=1.0)


K5_CASES = {
    "odd_padded": dict(b=2, n=301, n_valid=270),
    "rect": dict(b=2, n=200, rows=slice(7, 130)),
    "multiclass": dict(b=2, n=256, num_classes=5),
    "p16": dict(b=2, n=150, p=16),
    "p64_multiclass": dict(b=1, n=150, p=64, num_classes=3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(K5_CASES))
def test_k5_k6_match_plain_on_card(name, dtype):
    from gossipnet_tpu_torch.ops.cuda import pairwise as k5

    dev = _card()
    rng = np.random.default_rng(len(name))
    args, dm = _k5_args(rng, dev=dev, **K5_CASES[name])
    before = k5.pair_pool.launches, k5.pair_pool_backward.launches
    m = k5.launch_kernel(*args, dtype)
    m_plain = k5._reference_core(*args, dtype)
    got = k5.pair_pool_backward(*args, m, dm, dtype)
    want = k5.pair_pool_backward_reference(*args, m_plain, dm, dtype)
    torch.cuda.synchronize()
    assert (k5.pair_pool.launches, k5.pair_pool_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    x, y = m.cpu().numpy(), m_plain.cpu().numpy()
    assert (y > 0).any()
    if dtype == "float32":
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(x, y, rtol=2e-2, atol=2e-2)
        assert np.mean(np.abs(x - y) > 1e-4) < 0.01
    _assert_grads(got, want, dtype)
    again = k5.launch_backward_kernel(*args, m, dm, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_gives_each_tie_the_full_gradient_on_card(dtype):
    from gossipnet_tpu_torch.ops.cuda import pairwise as k5

    dev = _card()
    args_d, dm = _k5_args(np.random.default_rng(3), 2, 200, dev,
                          num_classes=4, dup_cols=True)
    args_s, _ = _k5_args(np.random.default_rng(3), 2, 200, dev,
                         num_classes=4)
    cols_d, a, b_d, wg, w2, b2b = args_d
    args_s = (args_s[0], a, b_d[:, 0::2].contiguous(), wg, w2, b2b)
    m_s = k5.launch_kernel(*args_s, dtype)
    m_d = k5.launch_kernel(*args_d, dtype)
    single = k5.launch_backward_kernel(*args_s, m_s, dm, dtype)
    dup = k5.launch_backward_kernel(*args_d, m_d, dm, dtype)
    torch.cuda.synchronize()
    assert torch.equal(m_s, m_d)
    assert torch.equal(dup[1][:, 0::2], dup[1][:, 1::2])
    _assert_grads(dup, (2 * single[0], single[1].repeat_interleave(2, dim=1),
                        2 * single[2], 2 * single[3], 2 * single[4]), dtype)


@pytest.mark.cuda
def test_one_config3_train_step_on_card_launches_k5_k6_k3():
    from gossipnet_tpu_torch import train as training
    from gossipnet_tpu_torch.config import experiment_path, load_config
    from gossipnet_tpu_torch.data.bucketing import BatchIterator
    from gossipnet_tpu_torch.data.synthetic import synthetic_roidb
    from gossipnet_tpu_torch.ops.cuda import matching_scan as k3
    from gossipnet_tpu_torch.ops.cuda import pairwise as k5

    dev = _card()
    cfg = load_config(experiment_path("coco_multiclass"),
                      {"data": {"dataset": "synthetic"},
                       "model": {"pair_kernel": 1}})
    roidb = synthetic_roidb(num_images=8, seed=0, num_gt=40, dets_per_gt=8,
                            num_clutter=40, num_classes=80)
    batch = next(BatchIterator(roidb, 8, cfg.data.bucket_sizes))
    model = training.build_model(cfg, "kernel", dev)
    state = training.create_train_state(cfg, model)
    before = (k5.pair_pool.launches, k5.pair_pool_backward.launches,
              k3.greedy_scan_batched.launches, k1.pair_pool.launches)
    state, metrics = training.train_step(
        state, training.batch_to_device(batch, dev), cfg)
    torch.cuda.synchronize()
    after = (k5.pair_pool.launches, k5.pair_pool_backward.launches,
             k3.greedy_scan_batched.launches, k1.pair_pool.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (16, 16, 1, 0)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert float(metrics["grad_norm"]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("tile_j", [32, 64, 128])
@pytest.mark.parametrize("mode", ["full", "nofeat", "nogw", "nofc2",
                                  "nomask", "bf3d"])
def test_k7_matches_plain_on_card(mode, tile_j):
    """K7 (the per-tile ablation) against its plain version at a ragged
    shape with invalid detections: the five f32 modes rtol = atol = 1e-5,
    ``bf3d`` within one bf16 step and bit-equal on 99%; rows without a
    neighbour at the same places; two launches bit-identical."""
    from gossipnet_tpu_torch.ops.cuda import ablate as k7
    from gossipnet_tpu_torch.tools.kernel_ablate import probe_inputs

    dev = _card()
    inputs = probe_inputs(2, 200, canvas=200.0, seed=1, device=dev)
    inputs["cols"][:, pf.DetColumns._fields.index("valid"), 150:170] = 0.0
    args = [inputs[k] for k in ("cols", "a", "b", "wg", "w2", "b2")]
    before = k7.pair_ablate.launches
    got = k7.pair_ablate(*args, mode, tile_j)
    again = k7.pair_ablate(*args, mode, tile_j)
    want = k7.pair_ablate_reference(*args, mode)
    torch.cuda.synchronize()
    assert k7.pair_ablate.launches == before + 2
    assert torch.equal(got, again)
    x, y = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(x < -1e29, y < -1e29)
    if mode != "nomask":
        assert (y < -1e29).all(-1)[:, 150:170].all()   # invalid rows
    if mode == "bf3d":
        np.testing.assert_allclose(x, y, rtol=2.0 ** -7, atol=0)
        assert np.mean(x == y) >= 0.99
    else:
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_j", [32, 64, 128])
@pytest.mark.parametrize("mode", ["full", "bf3d", "nofc2"])
def test_k7_fragment_layout_is_exact_on_card(mode, tile_j):
    """K7 bit-equal to its plain version where the order of FC2's sum
    cannot matter, at the ragged shape and at the probe's B=8 N=1024:
    ``full`` and ``bf3d`` with W2 a permutation matrix and b2 = 0 (each
    output one exact product, so any (slot, p, q) that a fragment misplaces
    shows), ``nofc2`` with the probe's weights (h1 as FC1 leaves it)."""
    from gossipnet_tpu_torch.ops.cuda import ablate as k7
    from gossipnet_tpu_torch.tools.kernel_ablate import probe_inputs

    dev = _card()
    small = probe_inputs(2, 200, canvas=200.0, seed=1, device=dev)
    small["cols"][:, pf.DetColumns._fields.index("valid"), 150:170] = 0.0
    for inputs in (small, probe_inputs(device=dev)):
        if mode != "nofc2":
            perm = torch.from_numpy(np.random.default_rng(3).permutation(32))
            inputs["w2"] = torch.zeros_like(inputs["w2"])
            inputs["w2"][torch.arange(32), perm.to(dev)] = 1.0
            inputs["b2"] = torch.zeros_like(inputs["b2"])
        args = [inputs[k] for k in ("cols", "a", "b", "wg", "w2", "b2")]
        got = k7.pair_ablate(*args, mode, tile_j)
        want = k7.pair_ablate_reference(*args, mode)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["full", "bf3d"])
def test_k7_takes_b_off_its_16_byte_alignment_on_card(mode):
    """b a contiguous view one float into its storage: the kernel stages
    it with 4-byte copies instead of 16-byte ones, with the same result."""
    from gossipnet_tpu_torch.ops.cuda import ablate as k7
    from gossipnet_tpu_torch.tools.kernel_ablate import probe_inputs

    inputs = probe_inputs(2, 200, canvas=200.0, seed=1, device=_card())
    b = inputs["b"]
    inputs["b"] = torch.cat([b.new_zeros(1), b.flatten()])[1:].view_as(b)
    assert inputs["b"].data_ptr() % 16 and inputs["b"].is_contiguous()
    args = [inputs[k] for k in ("cols", "a", "b", "wg", "w2", "b2")]
    got = k7.pair_ablate(*args, mode, 64)
    want = k7.pair_ablate(*[x.clone() for x in args], mode, 64)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_k7_refuses_what_it_is_not_built_for_on_card():
    from gossipnet_tpu_torch.ops.cuda import ablate as k7
    from gossipnet_tpu_torch.tools.kernel_ablate import probe_inputs

    inputs = probe_inputs(1, 64, device=_card())
    args = [inputs[k] for k in ("cols", "a", "b", "wg", "w2", "b2")]
    with pytest.raises(ValueError, match="32, 64, 128"):
        k7.pair_ablate(*args, "full", 48)
    with pytest.raises(ValueError, match="mode must be one of"):
        k7.pair_ablate(*args, "nofc1")


# ---------------------------------------------------------------------------
# the redesigned K1 / K2: queue, grouped FC2, winner queue, two passes
# ---------------------------------------------------------------------------

REDESIGN_CASES = {
    "square": dict(b=2, n=301),
    "ragged_rect": dict(b=2, n=203, rows=slice(7, 130)),
    "all_padding": dict(b=2, n=128, all_invalid=1),
    "dense_tiles": dict(b=1, n=300, block_sparse=False),
}


def _redesign_args(rng, dev, p, k, b, n, rows=slice(None), all_invalid=None,
                   block_sparse=True, perm=None):
    """K1/K2 launch arguments on random weights with K = 3 or 4 in-kernel
    features, rows a slice of the columns, optionally with the columns (and
    b') permuted, and a cotangent."""
    boxes, scores, valid, classes = _clustered(rng, b, n, num_classes=4)
    if all_invalid is not None:
        valid[all_invalid] = False
    cs = pf.stack_columns(pf.det_columns(
        torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev),
        torch.from_numpy(valid).to(dev)))
    cls = torch.from_numpy(classes).to(dev) if k == 4 else None

    def t(*shape, scale=0.5):
        return torch.from_numpy(
            rng.normal(0, scale, shape).astype(np.float32)).to(dev)

    nr = cs[:, :, rows].shape[2]
    a2, b2 = t(b, nr, p, scale=1.0), t(b, n, p, scale=1.0)
    weights = (t(k, p), t(p, p), t(p))
    dm = t(b, nr, p, scale=1.0)
    col, col_cls = cs, cls
    if perm is not None:
        col, b2 = cs[:, :, perm].contiguous(), b2[:, perm].contiguous()
        col_cls = None if cls is None else cls[:, perm].contiguous()
    geom = k1.pair_geometry(
        cs[:, :, rows].contiguous(), col, THR,
        None if cls is None else cls[:, rows].contiguous(), col_cls,
        block_sparse)
    return (geom, a2, b2, *weights), dm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("p", [8, 16, 32, 64])
@pytest.mark.parametrize("name", sorted(REDESIGN_CASES))
def test_redesigned_k1_k2_on_card(name, p, k, dtype):
    """K1 and K2 against their plain versions (f32: m and the winners bit
    for bit), every maximum finds a winner, and two launches of each give
    the same bits, over pairwise_dim 8-64, both feature counts, a ragged
    rectangle, an all-padding image and block-sparse off."""
    dev = _card()
    case = REDESIGN_CASES[name]
    args, dm = _redesign_args(np.random.default_rng(p + k), dev, p, k, **case)
    m = k1.launch_kernel(*args, dtype)
    m_plain = k1._reference_core(*args, dtype)
    got = k1.launch_backward_kernel(*args, m, dm, dtype)
    want = k1.pair_pool_backward_reference(*args, m_plain, dm, dtype)
    ones = k1.launch_backward_kernel(*args, m, torch.ones_like(dm), dtype)
    again = (k1.launch_kernel(*args, dtype),
             *k1.launch_backward_kernel(*args, m, dm, dtype))
    torch.cuda.synchronize()
    x, y = m.cpu().numpy(), m_plain.cpu().numpy()
    if "all_invalid" in case:
        assert (x[case["all_invalid"]] == 0).all()
    if dtype == "float32":
        assert torch.equal(m, m_plain)
    else:
        np.testing.assert_allclose(x, y, rtol=2e-2, atol=2e-2)
        assert np.mean(np.abs(x - y) > 1e-4) < 0.01
    _assert_grads(got, want, dtype)
    # dm = 1: db2[q] counts the winners of q, one per maximum or more
    assert bool((ones[4] >= (m > 0).sum(dim=(0, 1)).float()).all())
    if dtype == "float32":
        plain_ones = k1.pair_pool_backward_reference(
            *args, m_plain, torch.ones_like(dm), dtype)
        assert torch.equal(ones[4], plain_ones[4])
    assert all(torch.equal(u, v) for u, v in zip((m, *got), again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("p", [8, 16, 32, 64])
def test_column_permutation_probe_on_card(p, k, dtype):
    """The same problem with its columns (and b') permuted: m bit-equal (a
    pair's pre2 depends on nothing but the pair; the max is order-free),
    d_b' the permutation of the other bit for bit (a column adds its rows
    in an order the row indices fix), d_a' and the weight gradients within
    the tolerances of the plain comparison."""
    dev = _card()
    n = 260
    perm = torch.from_numpy(np.random.default_rng(1).permutation(n)).to(dev)
    args, dm = _redesign_args(np.random.default_rng(p * k), dev, p, k, 2, n)
    args_p, _ = _redesign_args(np.random.default_rng(p * k), dev, p, k, 2, n,
                               perm=perm)
    m, m_p = k1.launch_kernel(*args, dtype), k1.launch_kernel(*args_p, dtype)
    got = k1.launch_backward_kernel(*args, m, dm, dtype)
    got_p = k1.launch_backward_kernel(*args_p, m_p, dm, dtype)
    torch.cuda.synchronize()
    assert (m > 0).any()
    assert torch.equal(m, m_p)
    assert torch.equal(got_p[1], got[1][:, perm])
    _assert_grads(got_p, (got[0], got[1][:, perm], *got[2:]), dtype)


@pytest.mark.cuda
def test_k1_k2_refuse_more_detections_than_an_entry_packs_on_card():
    from gossipnet_tpu_torch.ops.cuda.launch import MAX_DETS

    dev = _card()
    n = MAX_DETS + 1
    cs = torch.zeros(1, pf.NUM_COLUMNS, n, device=dev)
    geom = k1.pair_geometry(cs, cs[:, :, :8].contiguous(), THR)
    z = lambda *s: torch.zeros(*s, device=dev)
    with pytest.raises(ValueError, match="at most"):
        k1.launch_kernel(geom, z(1, n, 8), z(1, 8, 8), z(3, 8), z(8, 8), z(8),
                         "float32")


# ---------------------------------------------------------------------------
# K5/K6 on config 4's launch arguments; the K6 permutation probe
# ---------------------------------------------------------------------------


def _near_ties(kern, args, dtype, rel=1e-5):
    """[B, NR, P] bool: the maxima whose best two candidates lie within
    ``rel`` of each other in the plain version. In bf16 the kernels' FC2
    sums on the tensor cores, the plain version in fmaf order: m agrees to
    ~1e-7 relative, and at such a maximum each side may crown another
    column (chip_smoke.near_ties)."""
    ties = []
    for _, nb, _, _, pre2 in kern._pair_chunks(*args, dtype):
        v = torch.where(nb[..., None], pre2, torch.full_like(pre2, -1e30))
        top = v.topk(2, dim=2).values
        best, second = top[:, :, 0], top[:, :, 1]
        ties.append((best > 0) & (best - second < rel * best))
    return torch.cat(ties, dim=1)


@pytest.fixture(scope="module")
def config4_args():
    """K5's last launch of one forward and backward of config 4
    (crowded_4096.yaml with pair_kernel 1: 16 blocks, 128/32/32, B=2
    N=4096, seeded weights) on its synthetic training batch: the pair
    stage's (columns, a, b, Wg, W2, b2) and the cotangent K6 got."""
    from gossipnet_tpu_torch import train as training
    from gossipnet_tpu_torch.config import experiment_path, load_config
    from gossipnet_tpu_torch.data.bucketing import BatchIterator
    from gossipnet_tpu_torch.data.synthetic import synthetic_roidb
    from gossipnet_tpu_torch.ops.cuda import pairwise as k5
    from gossipnet_tpu_torch.params import as_state_dict, init_params

    dev = _card()
    cfg = load_config(experiment_path("crowded_4096"),
                      {"model": {"pair_kernel": 1}})
    model = training.build_model(cfg, "kernel", dev)
    model.load_state_dict(as_state_dict(init_params(cfg.model, seed=0)))
    roidb = synthetic_roidb(num_images=2, seed=0, num_gt=400, dets_per_gt=8,
                            num_clutter=600, num_classes=1)
    batch = training.batch_to_device(
        next(BatchIterator(roidb, 2, cfg.data.bucket_sizes)), dev)
    seen = []
    launch_bwd = k5.launch_backward_kernel

    def record(*args):
        seen.append([x.clone() if torch.is_tensor(x) else x for x in args])
        return launch_bwd(*args)

    k5.launch_backward_kernel = record
    try:
        logits = model(batch["boxes"], batch["scores"], batch["valid"])
        cot = torch.randn(logits.shape, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)
        (logits * cot).sum().backward()
    finally:
        k5.launch_backward_kernel = launch_bwd
    torch.cuda.synchronize()
    args = seen[0]          # the last block's: the backward runs in reverse
    assert tuple(args[1].shape) == (2, 4096, 32)
    return tuple(args[:6]), args[7]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_k6_on_config4_launch_arguments_on_card(config4_args, dtype):
    """K5 and K6 at config 4's own shapes and data against their plain
    versions: in f32 m bit-equal and the same winners (dm = 1: db2 counts
    them, bit-equal); in bf16 m within tolerance and the gradients with dm
    zero at the near-tied maxima."""
    from gossipnet_tpu_torch.ops.cuda import pairwise as k5

    args, dm = config4_args
    m = k5.launch_kernel(*args, dtype)
    m_plain = k5._reference_core(*args, dtype)
    torch.cuda.synchronize()
    assert (m > 0).any()
    if dtype == "float32":
        assert torch.equal(m, m_plain)
        ones = torch.ones_like(dm)
        wins = k5.launch_backward_kernel(*args, m, ones, dtype)[4]
        plain_wins = k5.pair_pool_backward_reference(*args, m_plain, ones,
                                                     dtype)[4]
        assert torch.equal(wins, plain_wins)
    else:
        x, y = m.cpu().numpy(), m_plain.cpu().numpy()
        np.testing.assert_allclose(x, y, rtol=2e-2, atol=2e-2)
        assert np.mean(np.abs(x - y) > 1e-4) < 0.01
        dm = torch.where(_near_ties(k5, args, dtype), torch.zeros_like(dm),
                         dm)
    got = k5.launch_backward_kernel(*args, m, dm, dtype)
    want = k5.pair_pool_backward_reference(*args, m_plain, dm, dtype)
    torch.cuda.synchronize()
    _assert_grads(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_is_deterministic_on_card(config4_args, dtype):
    """Two K6 launches on config 4's arguments give the same bits: every
    sum is taken in an order the inputs fix (no float atomics; the splits'
    slices are added in order)."""
    from gossipnet_tpu_torch.ops.cuda import pairwise as k5

    args, dm = config4_args
    m = k5.launch_kernel(*args, dtype)
    one = k5.launch_backward_kernel(*args, m, dm, dtype)
    two = k5.launch_backward_kernel(*args, m, dm, dtype)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(one, two))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_classes", [0, 4])
@pytest.mark.parametrize("p", [8, 16, 32, 64])
def test_k6_column_permutation_probe_on_card(p, num_classes, dtype):
    """The same problem with its columns (and b) permuted: K5's m
    bit-equal, K6's d_b the permutation of the other bit for bit, d_a and
    the weight gradients within the plain comparison's tolerances. The
    features are not symmetric in the two detections, so a column pass
    that took its own column as the row would fail here."""
    from gossipnet_tpu_torch.ops.cuda import pairwise as k5

    dev = _card()
    n = 260
    args, dm = _k5_args(np.random.default_rng(p + num_classes), 2, n, dev,
                        p=p, num_classes=num_classes)
    cols, a, b, wg, w2, b2b = args
    perm = torch.from_numpy(np.random.default_rng(1).permutation(n)).to(dev)
    cols_p = k5.pair_columns(cols.row, cols.col[:, :, perm].contiguous(),
                             THR)
    args_p = (cols_p, a, b[:, perm].contiguous(), wg, w2, b2b)
    m, m_p = k5.launch_kernel(*args, dtype), k5.launch_kernel(*args_p, dtype)
    got = k5.launch_backward_kernel(*args, m, dm, dtype)
    got_p = k5.launch_backward_kernel(*args_p, m_p, dm, dtype)
    torch.cuda.synchronize()
    assert (m > 0).any()
    assert torch.equal(m, m_p)
    assert torch.equal(got_p[1], got[1][:, perm])
    _assert_grads(got_p, (got[0], got[1][:, perm], *got[2:]), dtype)


@pytest.mark.cuda
def test_wait_does_not_wait_for_work_enqueued_after_its_batch():
    """AsyncBatch.wait() reads its own batch back: half a second of work
    enqueued on the stream after the dispatch does not delay it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import time

    from gossipnet_tpu_torch.api import Rescorer
    from gossipnet_tpu_torch.config import experiment_path, load_config
    from gossipnet_tpu_torch.data.synthetic import layout_record
    from gossipnet_tpu_torch.params import init_params

    cfg = load_config(experiment_path("serving_bucketed"))
    rescorer = Rescorer(cfg, init_params(cfg.model, seed=0))
    rng = np.random.default_rng(0)
    images = [(r.det_boxes, r.det_scores, None) for r in
              (layout_record(rng, i, "clustered", 1024) for i in range(8))]
    want = rescorer.rescore_batch(images)
    # cycles per second of torch.cuda._sleep, measured with events
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10 ** 8)
    end.record()
    torch.cuda.synchronize()
    cycles = int(0.5 * 10 ** 8 / (start.elapsed_time(end) / 1e3))
    handle = rescorer.rescore_async(images)
    torch.cuda._sleep(cycles)
    t0 = time.perf_counter()
    got = handle.wait()
    waited = time.perf_counter() - t0
    torch.cuda.synchronize()
    slept = time.perf_counter() - t0
    assert slept > 0.3                # the sleep did run behind the batch
    assert waited < 0.25
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# captured graphs (utils/cuda_graphs.py) against the eager paths
# ---------------------------------------------------------------------------

GRAPH_CASES = {
    "k1_f32": dict(pair_kernel=2, pair_matmul_dtype="float32"),
    "k1_bf16": dict(pair_kernel=2, pair_matmul_dtype="bfloat16"),
    "k5_f32": dict(pair_kernel=1, pair_matmul_dtype="float32"),
    "k5_bf16": dict(pair_kernel=1, pair_matmul_dtype="bfloat16"),
    "multiclass_k1": dict(pair_kernel=2, num_classes=5, class_embed_dim=8),
    "multiclass_k5": dict(pair_kernel=1, num_classes=5, class_embed_dim=8),
}


def _graph_rescorer(**model):
    from gossipnet_tpu_torch.api import Rescorer
    from gossipnet_tpu_torch.config import experiment_path, load_config
    from gossipnet_tpu_torch.params import init_params

    cfg = load_config(experiment_path("serving_bucketed"),
                      {"model": {"num_blocks": 4, **model},
                       "data": {"bucket_sizes": [256, 512]}})
    return Rescorer(cfg, init_params(cfg.model, seed=0))


def _packed(rescorer, b, n, seed=0):
    """A packed (b, n) batch of clustered images of 7n/8 detections."""
    rng = np.random.default_rng(seed)
    nc = rescorer.cfg.model.num_classes
    boxes, scores, valid, classes = _clustered(
        rng, b, n, n_valid=7 * n // 8, num_classes=nc if nc > 1 else 0)
    classes = (np.zeros((b, n), np.int32) if classes is None
               else classes.astype(np.int32))
    return boxes, scores, valid, classes


def _launch_counts():
    from gossipnet_tpu_torch.utils.cuda_graphs import COUNTED

    return [fn.launches for fn in COUNTED]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRAPH_CASES))
def test_captured_forward_is_bit_equal_to_eager_on_card(name):
    """The replayed forward equals the eager forward at the same padded
    batch bit for bit, at three (b, n); a replay launches what an eager
    forward launches."""
    dev = _card()
    r = _graph_rescorer(**GRAPH_CASES[name])
    graphs = r._graphs
    for b, n in ((1, 256), (2, 512), (4, 256)):
        arrays = _packed(r, b, n, seed=b + n)
        got = graphs(*arrays).clone()         # captures, then replays
        before = _launch_counts()
        again = graphs(*arrays).clone()
        torch.cuda.synchronize()
        replayed = [a - b_ for a, b_ in zip(_launch_counts(), before)]
        before = _launch_counts()
        want = graphs.forward(*(torch.from_numpy(x).to(dev)
                                for x in arrays))
        torch.cuda.synchronize()
        eager = [a - b_ for a, b_ in zip(_launch_counts(), before)]
        assert torch.equal(got, want), (b, n)
        assert torch.equal(again, want), (b, n)
        assert replayed == eager and sum(eager) == 4, (b, n)
    assert graphs.shapes() == [(1, 256), (2, 512), (4, 256)]


@pytest.mark.cuda
def test_reload_between_replays_reaches_the_graph_on_card():
    from gossipnet_tpu_torch.params import init_params

    _card()
    r = _graph_rescorer(pair_matmul_dtype="float32")
    old = init_params(r.cfg.model, seed=0)
    new = init_params(r.cfg.model, seed=1)
    images = [(bx[v], sc[v], None) for bx, sc, v, _ in
              zip(*_packed(r, 3, 256))]
    r.warmup(batch_size=4)
    shapes = r._graphs.shapes()
    first = r.rescore_batch(images)
    r.reload(params=new)
    second = r.rescore_batch(images)
    r.reload(params=old)
    third = r.rescore_batch(images)
    assert r._graphs.shapes() == shapes       # no capture after warm-up
    fresh = type(r)(r.cfg, new)
    want = fresh.rescore_batch(images)
    for a, b, c, w in zip(first, second, third, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, w)
        assert not np.array_equal(a, b)


def _train_setup(pair_kernel=2, **train):
    from gossipnet_tpu_torch import train as training
    from gossipnet_tpu_torch.config import experiment_path, load_config
    from gossipnet_tpu_torch.data.bucketing import BatchIterator
    from gossipnet_tpu_torch.data.synthetic import synthetic_roidb

    dev = _card()
    cfg = load_config(experiment_path("coco_persons_full"),
                      {"data": {"dataset": "synthetic"},
                       "model": {"num_blocks": 4, "pair_kernel": pair_kernel},
                       "train": train})
    roidb = synthetic_roidb(num_images=16, seed=0, num_gt=40, dets_per_gt=8,
                            num_clutter=40)
    it = BatchIterator(roidb, 8, cfg.data.bucket_sizes)
    states = [training.create_train_state(
        cfg, training.build_model(cfg, "kernel", dev)) for _ in range(2)]
    return training, cfg, it, states, dev


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k1k2", "k5k6", "accum2"])
def test_captured_steps_are_bit_equal_to_eager_on_card(case):
    """5 replayed steps against 5 eager ``train_step``s: metrics each step,
    then parameters and optimizer slots, bit for bit; replays launch what
    eager steps launch."""
    kw = {"k1k2": {}, "k5k6": {"pair_kernel": 1},
          "accum2": {"grad_accum_steps": 2}}[case]
    training, cfg, it, (eager, stepped), dev = _train_setup(**kw)
    from gossipnet_tpu_torch.utils.cuda_graphs import StepGraphs

    steps = StepGraphs(stepped, cfg, training.step_body)
    batch = next(it)
    eager_counts = replay_counts = None
    for i in range(5):
        before = _launch_counts()
        _, want = training.train_step(
            eager, training.batch_to_device(batch, dev), cfg)
        torch.cuda.synchronize()
        mid = _launch_counts()
        got = steps(training.host_arrays(batch))
        torch.cuda.synchronize()
        after = _launch_counts()
        if i >= 2:   # every capture (one per update kind) is behind
            eager_counts = [b - a for a, b in zip(before, mid)]
            replay_counts = [b - a for a, b in zip(mid, after)]
            assert replay_counts == eager_counts
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
    assert sum(eager_counts) == 4 + 4 + 1
    for a, b in zip(stepped.model.parameters(), eager.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(stepped.optimizer.make_slots(),
                    eager.optimizer.make_slots()):
        assert torch.equal(a, b)
    assert steps.captures == (2 if case == "accum2" else 1)


@pytest.mark.cuda
def test_wait_after_a_replay_does_not_wait_for_later_work():
    """As ``test_wait_does_not_wait_for_work_enqueued_after_its_batch``,
    with the batch a replay of a graph captured by ``warmup``."""
    import time

    _card()
    r = _graph_rescorer()
    r.warmup(batch_size=8)
    shapes = r._graphs.shapes()
    images = [(bx[v], sc[v], None) for bx, sc, v, _ in
              zip(*_packed(r, 8, 256))]
    want = r.rescore_batch(images)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10 ** 8)
    end.record()
    torch.cuda.synchronize()
    cycles = int(0.5 * 10 ** 8 / (start.elapsed_time(end) / 1e3))
    handle = r.rescore_async(images)
    torch.cuda._sleep(cycles)
    t0 = time.perf_counter()
    got = handle.wait()
    waited = time.perf_counter() - t0
    torch.cuda.synchronize()
    assert time.perf_counter() - t0 > 0.3
    assert waited < 0.25
    assert r._graphs.shapes() == shapes
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the blob layout (every pair a neighbour) and the bench's captured loop
# ---------------------------------------------------------------------------

BLOB_CASES = [(k, b, n, layout) for k in (2, 1)
              for b, n, layout in ((2, 256, "blob"), (1, 1024, "blob"),
                                   (2, 4096, "blob"),
                                   (1, 1024, "coincident"))]


@pytest.fixture(scope="module", params=BLOB_CASES,
                ids=[f"pair_kernel{k}-{layout}-B{b}-N{n}"
                     for k, b, n, layout in BLOB_CASES])
def blob_args(request):
    """The first block's forward and the last block's backward launch
    arguments of the 16-block flagship model (128/32/32, seeded weights),
    through K1/K2 (``pair_kernel: 2``) or K5/K6 (``pair_kernel: 1``), and
    the cotangent of that backward, on a ``blob`` batch
    (``layout_batch("blob", B, N)``: all boxes overlap and 58% of the
    pairs are neighbours) or a coincident one (every pair a neighbour):
    ballots push up to 32 pairs and a warp's queue ring runs at its
    bound."""
    from gossipnet_tpu_torch.data.synthetic import layout_batch
    from gossipnet_tpu_torch.ops.cuda import pairwise as k5
    from gossipnet_tpu_torch.tools import entry

    dev = _card()
    kernel, b, n, layout = request.param
    kern = k1 if kernel == 2 else k5
    cfg = entry.flagship_cfg()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, pair_kernel=kernel))
    model = entry.seeded_model(cfg, dev)
    if layout == "coincident":
        boxes, scores, valid = (torch.from_numpy(x).to(dev)
                                for x in entry.coincident_arrays(b, n))
    else:
        boxes, scores, valid = entry.device_tensors(
            layout_batch(layout, b, n, seed=0), dev)
    seen = {"fwd": [], "bwd": []}
    launch_fwd, launch_bwd = kern.launch_kernel, kern.launch_backward_kernel

    def record(key, launch):
        def run(*args, **kw):
            seen[key].append([x.clone() if torch.is_tensor(x) else x
                              for x in args])
            return launch(*args, **kw)
        return run

    kern.launch_kernel = record("fwd", launch_fwd)
    kern.launch_backward_kernel = record("bwd", launch_bwd)
    try:
        logits = model(boxes, scores, valid)
        cot = torch.randn(logits.shape, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)
        (logits * cot).sum().backward()
    finally:
        kern.launch_kernel = launch_fwd
        kern.launch_backward_kernel = launch_bwd
    torch.cuda.synchronize()
    assert len(seen["fwd"]) == len(seen["bwd"]) == 16
    return kern, tuple(seen["fwd"][0][:6]), tuple(seen["bwd"][0][:6]), \
        seen["bwd"][0][7]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_kernels_on_blob_launch_arguments_on_card(blob_args, dtype):
    """K1/K2 and K5/K6 where every pair is a neighbour, against their
    plain versions on the model's own launch arguments: in f32 m
    bit-equal and the same winners (dm = 1: db2 counts them, bit-equal);
    in bf16 m within tolerance and the gradients with dm zero at the
    near-tied maxima."""
    kern, fwd, args, dm = blob_args
    for a6 in (fwd, args):
        m = kern.launch_kernel(*a6, dtype)
        m_plain = kern._reference_core(*a6, dtype)
        torch.cuda.synchronize()
        assert (m > 0).any()
        if dtype == "float32":
            assert torch.equal(m, m_plain)
        else:
            x, y = m.cpu().numpy(), m_plain.cpu().numpy()
            np.testing.assert_allclose(x, y, rtol=2e-2, atol=2e-2)
            assert np.mean(np.abs(x - y) > 1e-4) < 0.01
    if dtype == "float32":
        ones = torch.ones_like(dm)
        wins = kern.launch_backward_kernel(*args, m, ones, dtype)[4]
        plain_wins = kern.pair_pool_backward_reference(*args, m_plain, ones,
                                                       dtype)[4]
        assert torch.equal(wins, plain_wins)
    else:
        dm = torch.where(_near_ties(kern, args, dtype), torch.zeros_like(dm),
                         dm)
    got = kern.launch_backward_kernel(*args, m, dm, dtype)
    want = kern.pair_pool_backward_reference(*args, m_plain, dm, dtype)
    torch.cuda.synchronize()
    _assert_grads(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_captured_bench_loop_body_equals_the_host_chain_on_card(dtype):
    """``tools/bench.py``'s chain: one captured graph of the loop body
    (forward, sigmoid, + k * 1e-7 with k a device counter, written back
    into the graph's static scores), replayed 3 times, bit-equal to 3
    eager calls from the host; each replay launches K1 16 times."""
    from gossipnet_tpu_torch.tools import bench, entry

    dev = _card()
    cfg = entry.flagship_cfg()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, pair_matmul_dtype=dtype))
    model = entry.seeded_model(cfg, dev)
    boxes, scores, valid = entry.device_tensors(
        entry.synthetic_arrays(8, 1024), dev)
    step = bench.forward_step(model, boxes, valid)
    chain = bench.Chain(step, scores)
    assert chain.graph is not None
    before = k1.pair_pool.launches
    got = chain.run(scores, 3).clone()
    assert k1.pair_pool.launches == before + 3 * 16
    want = bench.host_chain(step, scores, 3)
    two = bench.host_chain(step, scores, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not torch.equal(two, want)
    assert chain.k.item() == 3.0


# ---------------------------------------------------------------------------
# the bf16 stream (pair_elementwise_dtype: bfloat16) of K1 and K2
# ---------------------------------------------------------------------------

STREAM = ("bfloat16", "bfloat16")     # compute and elementwise dtype


def _stream_batch(name, dev):
    from gossipnet_tpu_torch import train as training
    from gossipnet_tpu_torch.data.bucketing import BatchIterator
    from gossipnet_tpu_torch.data.synthetic import layout_batch, synthetic_roidb
    from gossipnet_tpu_torch.tools import entry

    if name == "bench":
        return entry.device_tensors(layout_batch("clustered", 8, 1024, 0), dev)
    if name == "blob":
        return entry.device_tensors(layout_batch("blob", 2, 256, 0), dev)
    roidb = synthetic_roidb(num_images=32, seed=0, num_gt=100, dets_per_gt=8,
                            num_clutter=200)       # config 2's batch
    arrays = training.batch_to_device(
        next(BatchIterator(roidb, 8, (256, 512, 1024))), dev)
    return arrays["boxes"], arrays["scores"], arrays["valid"]


@pytest.fixture(scope="module", params=["bench", "config2", "blob"])
def stream_args(request):
    """The first block's forward and the last block's backward launch
    arguments of the 16-block flagship (128/32/32, seeded weights) with the
    bf16 stream, and that backward's cotangent."""
    from gossipnet_tpu_torch.tools import entry

    dev = _card()
    cfg = entry.flagship_cfg()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, pair_elementwise_dtype="bfloat16"))
    model = entry.seeded_model(cfg, dev)
    boxes, scores, valid = _stream_batch(request.param, dev)
    seen = {"fwd": [], "bwd": []}
    launch_fwd, launch_bwd = k1.launch_kernel, k1.launch_backward_kernel

    def record(key, launch):
        def run(*args, **kw):
            assert kw == {"elementwise_dtype": "bfloat16"}
            seen[key].append([x.clone() if torch.is_tensor(x) else x
                              for x in args])
            return launch(*args, **kw)
        return run

    k1.launch_kernel = record("fwd", launch_fwd)
    k1.launch_backward_kernel = record("bwd", launch_bwd)
    try:
        logits = model(boxes, scores, valid)
        cot = torch.randn(logits.shape, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)
        (logits * cot).sum().backward()
    finally:
        k1.launch_kernel, k1.launch_backward_kernel = launch_fwd, launch_bwd
    torch.cuda.synchronize()
    assert len(seen["fwd"]) == len(seen["bwd"]) == 16
    return tuple(seen["fwd"][0][:6]), tuple(seen["bwd"][0][:6]), \
        seen["bwd"][0][7]


def _bf16_ulp(x):
    mag = x.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


@pytest.mark.cuda
def test_bf16_stream_k1_within_one_ulp_on_card(stream_args):
    """K1's bf16 stream against its plain version: every entry a bf16
    value, at most one bf16 ulp apart (the tensor cores and the fmaf chain
    sum FC2 in different orders, ~1e-7 apart before the stream rounds), in
    at most 1% of the entries."""
    fwd, args, _ = stream_args
    for a6 in (fwd, args):
        m = k1.launch_kernel(*a6, *STREAM)
        m_plain = k1._reference_core(*a6, *STREAM)
        torch.cuda.synchronize()
        assert (m > 0).any()
        assert torch.equal(m.to(torch.bfloat16).float(), m)
        diff = (m - m_plain).abs()
        assert bool((diff <= _bf16_ulp(m_plain)).all())
        assert (diff > 0).float().mean().item() <= 0.01
        assert not torch.equal(m, k1.launch_kernel(*a6, "bfloat16"))


@pytest.mark.cuda
def test_bf16_stream_k2_matches_plain_backward_on_card(stream_args):
    """K2's bf16 stream against its plain backward at bf16's tolerances,
    with dm zero where the best two candidates lie within one bf16 ulp
    (exact ties included: there one ulp of a differently ordered sum can
    crown another set); two launches bit-identical; each winner found
    (dm = 1: db2 counts at least one per positive maximum)."""
    _, args, dm = stream_args
    m = k1.launch_kernel(*args, *STREAM)
    m_plain = k1._reference_core(*args, *STREAM)
    ties = []
    for _, nb, _, _, pre2 in k1._pair_chunks(*args, *STREAM):
        v = torch.where(nb[..., None], pre2, torch.full_like(pre2, -1e30))
        top = v.topk(2, dim=2).values
        best, second = top[:, :, 0], top[:, :, 1]
        ties.append((best > 0) & (best - second <= _bf16_ulp(best)))
    dm = torch.where(torch.cat(ties, dim=1), torch.zeros_like(dm), dm)
    got = k1.launch_backward_kernel(*args, m, dm, *STREAM)
    again = k1.launch_backward_kernel(*args, m, dm, *STREAM)
    want = k1.pair_pool_backward_reference(*args, m_plain, dm, *STREAM)
    torch.cuda.synchronize()
    _assert_grads(got, want, "bfloat16")
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    db2 = k1.launch_backward_kernel(*args, m, torch.ones_like(dm),
                                    *STREAM)[4]
    assert bool((db2 >= (m > 0).sum(dim=(0, 1)).float()).all())


def _row_shard(kern, args, rows: slice) -> tuple:
    """A square launch's arguments cut to the rows ``rows`` against every
    column, as the det-sharded forward builds them (parallel/spmd.py)."""
    geom = args[0]
    row = geom.row[:, :, rows].contiguous()
    if kern is k1:
        geom = geom._replace(
            row=row, i_feats=geom.i_feats[:, rows].contiguous(),
            flags=k1.tile_activity(row, geom.col).contiguous())
    else:
        geom = geom._replace(row=row, flags=k1.tile_activity(
            row, geom.col, valid_field=pf.NUM_COLUMNS - 1).contiguous())
    return (geom, args[1][:, rows].contiguous(), *args[2:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_det", [2, 4])
@pytest.mark.parametrize("kernel", ["K1", "K5"])
def test_det_shards_match_the_square_launch_on_card(kernel, n_det, dtype):
    """The launches of a det-sharded forward: each shard's N / n_det rows
    against all N columns. Joined, the shards' m and d_a' equal the square
    launch's bit for bit; d_b' and the weight gradients summed over the
    shards are within the weight-gradient gate (1e-4 of the largest
    entry). B=4 N=1024: a shard has half or a quarter of the square's row
    tiles there, so it would split its columns differently if the split
    count followed its own row tiles."""
    from gossipnet_tpu_torch.ops.cuda import pairwise as k5

    dev = _card()
    rng = np.random.default_rng(n_det)
    if kernel == "K1":
        kern, (args, dm, _) = k1, _pair_args(rng, 4, 1024, dev)
    else:
        kern, (args, dm) = k5, _k5_args(rng, 4, 1024, dev)
    m = kern.launch_kernel(*args, dtype)
    grads = kern.launch_backward_kernel(*args, m, dm, dtype)
    rows = 1024 // n_det
    ms, parts = [], []
    for r in range(n_det):
        sl = slice(r * rows, (r + 1) * rows)
        shard = _row_shard(kern, args, sl)
        ms.append(kern.launch_kernel(*shard, dtype))
        parts.append(kern.launch_backward_kernel(
            *shard, m[:, sl].contiguous(), dm[:, sl].contiguous(), dtype))
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(ms, 1), m)
    assert torch.equal(torch.cat([g[0] for g in parts], 1), grads[0])
    for i in range(1, 5):
        total = torch.stack([g[i] for g in parts]).sum(0)
        np.testing.assert_allclose(
            total.cpu().numpy(), grads[i].cpu().numpy(), rtol=0,
            atol=1e-4 * grads[i].abs().max().item())


@pytest.mark.cuda
def test_drill_files_train_and_evaluate_config2_on_card(tmp_path):
    """The scale drill's real-format files (``tools/scale_drill.py gen``, 64
    images) through config 2 as the drill's ``run`` arm writes it:
    ``train()`` for 3 steps at 16 K1 + 16 K2 + 1 K3 a step (the eager step
    before each capture counts as a replay does), then ``evaluate.main`` on
    its checkpoint at 16 K1 a batch and no other kernel."""
    from gossipnet_tpu_torch import evaluate
    from gossipnet_tpu_torch import train as training
    from gossipnet_tpu_torch.config import load_config
    from gossipnet_tpu_torch.data.bucketing import eval_batches
    from gossipnet_tpu_torch.ops.cuda import matching_scan as k3
    from gossipnet_tpu_torch.tools import scale_drill

    dev = _card()
    scale_drill.gen(n_images=64, data_dir=tmp_path)
    _, path, _ = scale_drill.run_yamls(train_steps=3, data_dir=tmp_path)
    cfg = load_config(path)
    roidb, _ = training._datasets(cfg)
    counters = (k1.pair_pool, k1.pair_pool_backward, k3.greedy_scan_batched)
    before = [c.launches for c in counters]
    state = training.train(cfg, roidb, device=dev,
                           metrics_path=str(tmp_path / "m.jsonl"))
    torch.cuda.synchronize()
    runs = state.step + state.graphs.captures
    assert state.step == 3
    assert [c.launches - b for c, b in zip(counters, before)] == [
        16 * runs, 16 * runs, runs]

    batches = list(eval_batches(roidb, cfg.train.batch_size,
                                cfg.data.bucket_sizes))
    shapes = len({(b.batch_size, b.padded_n) for b in batches})
    before = [c.launches for c in counters]
    out = evaluate.main(["-c", path])
    assert [c.launches - b for c, b in zip(counters, before)] == [
        16 * (len(batches) + shapes), 0, 0]
    assert 0.0 <= out["gossipnet"]["AP"] <= 1.0
    assert out["raw_scores"]["AP"] > 0.0


@pytest.mark.cuda
def test_pets_files_train_and_evaluate_on_card(tmp_path):
    """The scale drill's PETS files (``gen_pets``: 64 frames of CVML XML
    ground truth and MOT CSV detections, 16 held out) through the pets
    arm's own YAML (``mt``: ten thresholds) cut to 3 steps with a
    validation pass at step 3: the train CLI at 16 K1 + 16 K2 + 1 K3 a
    step (the eager step before each capture counts as a replay does) and
    16 K1 a validation batch; then ``evaluate --best --nms-sweep`` on the
    best checkpoint at 16 K1 a batch and no other kernel, every AP
    finite."""
    import signal
    from pathlib import Path

    from gossipnet_tpu_torch import evaluate
    from gossipnet_tpu_torch import train as training
    from gossipnet_tpu_torch.config import load_config
    from gossipnet_tpu_torch.data.bucketing import eval_batches
    from gossipnet_tpu_torch.ops.cuda import matching_scan as k3
    from gossipnet_tpu_torch.tools import scale_drill

    _card()
    scale_drill.gen_pets(n_frames=64, data_dir=tmp_path)
    scale_drill.gen_pets(n_frames=16, seed=1, prefix="val_",
                         data_dir=tmp_path)
    path = scale_drill.pets_yaml(train_steps=3, tag="pets_mt", mt=True,
                                 data_dir=tmp_path)
    Path(path).write_text(Path(path).read_text().replace(
        "eval_every: 500", "eval_every: 3"))
    cfg = load_config(path)
    roidb, val = training._datasets(cfg)

    def runs(batches):
        return len(batches) + len({(b.batch_size, b.padded_n)
                                   for b in batches})

    counters = (k1.pair_pool, k1.pair_pool_backward, k3.greedy_scan_batched)
    before = [c.launches for c in counters]
    handlers = [signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)]
    try:
        training.main(["-c", path, "--metrics", str(tmp_path / "m.jsonl")])
    finally:
        for sig, h in zip((signal.SIGTERM, signal.SIGINT), handlers):
            signal.signal(sig, h)
    torch.cuda.synchronize()
    k1_n, k2_n, k3_n = (c.launches - b for c, b in zip(counters, before))
    val_runs = runs(list(eval_batches(val, cfg.train.batch_size,
                                      cfg.data.bucket_sizes)))
    assert k3_n >= 3 and k2_n == 16 * k3_n
    assert k1_n == k2_n + 16 * val_runs
    val_ap = [json.loads(x) for x in
              (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [(m["step"], np.isfinite(m["val_AP"])) for m in val_ap
            if "val_AP" in m] == [(3, True)]

    batches = list(eval_batches(roidb, cfg.train.batch_size,
                                cfg.data.bucket_sizes))
    before = [c.launches for c in counters]
    out = evaluate.main(["-c", path, "--best", "--nms-sweep"])
    assert [c.launches - b for c, b in zip(counters, before)] == [
        16 * runs(batches), 0, 0]
    assert list(out) == ["gossipnet", "raw_scores", "greedy_nms"]
    for block in out.values():
        assert all(np.isfinite(v) for v in block.values())
        assert 0.0 <= block["AP"] <= 1.0
    assert out["raw_scores"]["AP"] > 0.0


# ---------------------------------------------------------------------------
# The skip tile (ops/cuda/launch.py TILES) of K1/K2 and K5/K6
# ---------------------------------------------------------------------------


def _banded_cols(rng, dev, b=2, n=300, n_valid=280):
    """Boxes sorted along a 3000-pixel strip: each tile of the flags is
    narrow in x, so the flags are banded and differ between neighbouring
    tiles of 16 columns; n is no multiple of any tile and the tail is
    padding."""
    x1 = np.sort(rng.uniform(0, 3000, (b, n)), axis=1)
    y1 = rng.uniform(0, 60, (b, n))
    wh = rng.uniform(20, 70, (b, n, 2))
    boxes = np.stack([x1, y1, x1 + wh[..., 0], y1 + wh[..., 1]],
                     -1).astype(np.float32)
    valid = np.ones((b, n), bool)
    valid[:, n_valid:] = False
    return pf.stack_columns(pf.det_columns(
        torch.from_numpy(boxes).to(dev),
        torch.from_numpy(rng.uniform(0, 1, (b, n)).astype(np.float32)).to(
            dev), torch.from_numpy(valid).to(dev)))


def _straddling_pairs(geom) -> int:
    """Neighbour pairs (i, j) whose flag cell is set while the cell of the
    first column of j's 32-column block is not: the pairs that K2's and
    K6's column pass (a block of 32 columns) finds only by reading every
    flag column its 32 columns overlap. ``geom``: K1's geometry."""
    fi, tj = geom.tile
    rv, cv = geom.row[:, 7] > 0, geom.col[:, 7] > 0
    iou = k1.fields_iou(geom.row[..., None], geom.col[:, :, None, :])
    nb = (iou >= THR) & rv[:, :, None] & cv[:, None, :]
    bi, i, j = torch.nonzero(nb, as_tuple=True)
    own = geom.flags[bi, i // fi, j // tj]
    first = geom.flags[bi, i // fi, (j // 32 * 32) // tj]
    return int(((own > 0) & (first == 0)).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile", [(32, 16), (32, 32), (32, 64), (32, 128),
                                  (64, 16), (64, 32), (64, 64), (64, 128)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("kern_name", ["k1k2", "k5k6"])
def test_pair_kernels_at_every_tile_on_card(kern_name, tile, dtype):
    """K1/K2 and K5/K6 at each skip tile against their plain versions,
    which read no flags, on banded flags where at TJ = 16 neighbours
    straddle the 16-column cells of a 32-column block: f32 m and winners
    bit-equal, the gradients (d_b' from the column pass) at the gates
    above."""
    from gossipnet_tpu_torch.ops.cuda import launch
    from gossipnet_tpu_torch.ops.cuda import pairwise as k5

    dev = _card()
    assert tile in launch.TILES
    rng = np.random.default_rng(15)
    cs = _banded_cols(rng, dev)
    b, _, n = cs.shape
    p = 32

    def t(*shape, scale=0.5):
        return torch.from_numpy(
            rng.normal(0, scale, shape).astype(np.float32)).to(dev)

    if kern_name == "k1k2":
        kern, geom = k1, k1.pair_geometry(cs, cs, THR, tile=tile)
        wg = t(3, p)
    else:
        kern, geom = k5, k5.pair_columns(cs, cs, THR, tile=tile)
        wg = t(geom.num_features, p)
    assert geom.tile == tile and bool((geom.flags == 0).any())
    if tile[1] == 16:
        assert _straddling_pairs(k1.pair_geometry(cs, cs, THR,
                                                  tile=tile)) > 0
    args = (geom, t(b, n, p, scale=1.0), t(b, n, p, scale=1.0), wg, t(p, p),
            t(p))
    dm = t(b, n, p, scale=1.0)
    m = kern.launch_kernel(*args, dtype)
    m_plain = kern._reference_core(*args, dtype)
    got = kern.launch_backward_kernel(*args, m, dm, dtype)
    want = kern.pair_pool_backward_reference(*args, m_plain, dm, dtype)
    torch.cuda.synchronize()
    assert (m_plain > 0).any()
    if dtype == "float32":
        assert torch.equal(m, m_plain)
        ones = torch.ones_like(dm)
        assert torch.equal(
            kern.launch_backward_kernel(*args, m, ones, dtype)[4],
            kern.pair_pool_backward_reference(*args, m_plain, ones,
                                              dtype)[4])
    else:
        x, y = m.cpu().numpy(), m_plain.cpu().numpy()
        np.testing.assert_allclose(x, y, rtol=2e-2, atol=2e-2)
        assert np.mean(np.abs(x - y) > 1e-4) < 0.01
    _assert_grads(got, want, dtype)
