"""The CUDA kernels against their plain PyTorch versions, on the card: K1
(pair-pool forward), K2 (its backward: f32, bf16, the tie rule, two
launches bit-identical), K3/K4 (the matching scan, exactly), K5/K6 (the
unfolded pair pool and its backward, the same checks), K7 (the per-tile
ablation: six modes, three column tiles), one training step
of config 2 and one of config 3 through K5/K6, with their launch counts.

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
def test_k7_refuses_what_it_is_not_built_for_on_card():
    from gossipnet_tpu_torch.ops.cuda import ablate as k7
    from gossipnet_tpu_torch.tools.kernel_ablate import probe_inputs

    inputs = probe_inputs(1, 64, device=_card())
    args = [inputs[k] for k in ("cols", "a", "b", "wg", "w2", "b2")]
    with pytest.raises(ValueError, match="32, 64, 128"):
        k7.pair_ablate(*args, "full", 48)
    with pytest.raises(ValueError, match="mode must be one of"):
        k7.pair_ablate(*args, "nofc1")
