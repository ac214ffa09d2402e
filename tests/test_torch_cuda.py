"""The port's correctness on the card, all of it: the CUDA kernels
against their plain PyTorch versions, the captured paths against the
eager ones, the kernel paths against the dense plain path.

K1 (pair-pool forward), K2 (its backward: f32, bf16, the bf16 stream, the
tie rule, the column-permutation probe, two launches bit-identical), K3/K4
(the matching scan, exactly: overflow rows, G = 1024, 400 and 13, N = 4096
and N not a multiple of 32, T = 32, all-zero IoU, the inputs the main
paths build, two launches bit-identical, every output written), K2's
column pass from the row pass's records (the crowd's shape) and its
recompute where exact ties overflow them, K5/K6 (the unfolded pair pool
and its backward, the same checks), K7 (the per-tile ablation: six modes,
three column tiles, two sizes; bit-equal where FC2's order cannot matter:
W2 a permutation, or no FC2; its build without a spill and with HMMA
where FC2 runs). Probes with identity weights make m bit-exact only where
the neighbour masks match. K1/K2 and K5/K6 on the 16-block models' own
launch arguments: the ``blob`` layout and a coincident batch (every pair
a neighbour), and the main paths' batches (the serving bench batch,
configs 2 and 4, every evaluation batch, the training cells' fills, the
scale drill's files; the drill's and the evaluation's models trained two
steps first); with the bf16 stream (``pair_elementwise_dtype:
bfloat16``): m bf16 values within one bf16 ulp of the plain version's in
at most 1% of the entries; the row shards of a det-sharded forward
(parallel/spmd.py) against the square launch; every skip tile of
``ops/cuda/launch.py`` TILES, on banded flags where at TJ = 16 neighbours
straddle the 16-column cells of the backwards' 32-column blocks and on the
models' arguments. Whole models: captured forwards and training steps bit
for bit against eager ones (the reduced-precision knobs too), f32 logits
and gradients of the kernel paths against the dense plain path and of
K5/K6 against K1/K2; ``tools/bench.py``'s captured loop body against a
host chain; ``AsyncBatch.wait()`` reading back its own batch alone; one
training step of configs 2 and 3, and config 2 trained and evaluated from
the scale drill's real-format files, with their launches counted.

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
entry; K6's the same. The scan does comparisons only: exact. The
kernel checks are functions of ``chip_smoke.py`` (``check_launch_args``,
``check_scan``, ``check_k7``, ...), whose full run calls them once on
each kernel it times.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import dataclasses
import functools
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import (
    assert_grads,
    check_k7,
    check_launch_args,
    check_plain,
    check_scan,
    check_stream_k1,
    check_stream_k2,
    untied,
)
from gossipnet_tpu_torch.models.gossipnet import PairParams
from gossipnet_tpu_torch.ops import pair_features as pf
from gossipnet_tpu_torch.ops.cuda import launch
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
    # a = 0, b > 0, Wg = 0, W2 = I, b2 = 0: m is the max of b over the
    # neighbour set, exact in any order, so f32 m equals the plain
    # version's only if the neighbour masks do
    "mask_probe_b8_n1024": dict(b=8, n=1024, probe=True),
    "mask_probe_b1_n4096": dict(b=1, n=4096, probe=True),
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
    probe = case.pop("probe", False)
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
    if probe:
        a, bb = torch.zeros_like(a), bb.abs() + 1.0
        prm = prm._replace(wg=torch.zeros_like(prm.wg),
                           w2=torch.eye(p, device=dev),
                           b2=torch.zeros_like(prm.b2))
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
    if probe and dtype == "float32":
        np.testing.assert_array_equal(got, want)
    elif dtype == "float32":
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
    assert_grads(got, want, dtype)
    # determinism: a second launch gives the same bits
    again = k1.launch_backward_kernel(*args, m, dm, dtype)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def _dtypes(dtype) -> tuple:
    """The dtype arguments of a K1/K2 call for a test's ``dtype``
    ("stream": bf16 operands and the bf16 stream) and the tolerances of
    :func:`chip_smoke.assert_grads` that hold it."""
    if dtype == "stream":
        return STREAM, "bfloat16"
    return (dtype,), dtype


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "stream"])
@pytest.mark.parametrize("n", [200, 512])
def test_k2_gives_each_tie_the_full_gradient_on_card(n, dtype):
    """Every column duplicated: each maximum ties exactly between a column
    and its copy, and each gets the full dm (the TPU kernel's rule), so
    d_b' repeats the single problem's on both copies and the other
    gradients double; against the plain backward too, with dm zero where
    the single problem's best two candidates nearly tie (bf16)."""
    dev = _card()
    dts, tol = _dtypes(dtype)
    rng = np.random.default_rng(3)
    args_d, dm, cs = _pair_args(rng, 2, n, dev, dup_cols=True)
    _, a2, b2_d, wg, w2, b2b = args_d
    args_s = (k1.pair_geometry(cs, cs, THR), a2,
              b2_d[:, 0::2].contiguous(), wg, w2, b2b)
    m_s = k1.launch_kernel(*args_s, *dts)
    m_d = k1.launch_kernel(*args_d, *dts)
    single = k1.launch_backward_kernel(*args_s, m_s, dm, *dts)
    dup = k1.launch_backward_kernel(*args_d, m_d, dm, *dts)
    torch.cuda.synchronize()
    assert torch.equal(m_s, m_d)
    assert torch.equal(dup[1][:, 0::2], dup[1][:, 1::2])
    assert_grads(dup, (2 * single[0], single[1].repeat_interleave(2, dim=1),
                        2 * single[2], 2 * single[3], 2 * single[4]), tol)
    if dtype != "float32":
        dm = untied(args_s, dm, dts)
    got = k1.launch_backward_kernel(*args_d, m_d, dm, *dts)
    want = k1.pair_pool_backward_reference(
        *args_d, k1._reference_core(*args_d, *dts), dm, *dts)
    torch.cuda.synchronize()
    assert_grads(got, want, tol)


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


def _scan_input(name, dev, aware=False, seed=0, trained=None):
    """The pre-masked, score-ordered IoU [B, N, G] that the kernel path of
    ``greedy_match_batch`` hands K3 for the main-path batch ``name``
    (:func:`_main_batch`), class-aware with ``aware``: with random scores,
    or with ``trained`` (by default for the names of TRAINED) the logits of
    the trained model (:func:`_main_model`), as a training step scores
    them."""
    arrays = _main_batch(name, dev)[1]
    scores = None
    if name.startswith(TRAINED) if trained is None else trained:
        cfg, net = _main_model(name, dev, trained=True)
        classes = arrays["classes"] if cfg.model.num_classes > 1 else None
        with torch.no_grad():
            scores = net(arrays["boxes"], arrays["scores"], arrays["valid"],
                         classes)
    return _scan_input_of(arrays, dev, aware, seed, scores)


def _scan_input_of(arrays, dev, aware=False, seed=0, scores=None):
    from gossipnet_tpu_torch.ops import matching
    from gossipnet_tpu_torch.ops.cuda import matching_scan as k3

    if scores is None:
        scores = torch.from_numpy(np.random.default_rng(seed).uniform(
            -3, 3, arrays["scores"].shape).astype(np.float32)).to(dev)
    seen = []

    def scan(iou, thr):
        seen.append(iou.cpu().numpy())
        return k3.greedy_scan_batched(iou, thr)

    matching._match_kernel(
        arrays["boxes"], scores, arrays["valid"], arrays["gt_boxes"],
        arrays["gt_valid"], arrays["gt_crowd"],
        matching.split_thresholds([0.5], dev),
        arrays["classes"] if aware else None,
        arrays["gt_classes"] if aware else None, scan=scan)
    return seen[0]


def _one_image_input(dev):
    """The scan input of one clustered image of 4096 detections through
    ``greedy_match`` (K4's path), as a batch of one."""
    from gossipnet_tpu_torch import train as training
    from gossipnet_tpu_torch.data.bucketing import make_batch
    from gossipnet_tpu_torch.data.synthetic import layout_record

    rec = layout_record(np.random.default_rng(3), 0, "clustered", 4096)
    return _scan_input_of(training.batch_to_device(
        make_batch([rec], padded_n=4096), dev), dev)


def _duplicated_gt(iou):
    """Every GT column twice (the first copy must win), cut to G."""
    g = iou.shape[2]
    return np.ascontiguousarray(np.repeat(iou, 2, axis=2)[:, :, :g])


COCO_T = np.round(np.arange(0.5, 0.951, 0.05), 2).astype(np.float32)
T32 = np.round(np.linspace(0.05, 0.95, 32), 3).astype(np.float32)
T1 = np.float32([0.5])
SCAN_CASES = {   # name: (iou maker of (rng, device), thresholds)
    "overflow_rows": (lambda r, d: _sparse_iou(r, 2, 300, 112, 4,
                                               (3, 50, 51)), COCO_T),
    "g1024_n1000": (lambda r, d: _sparse_iou(r, 2, 1000, 1024, 6, (7, 998)),
                    COCO_T),
    "g1024_n1000_t32": (lambda r, d: _sparse_iou(r, 2, 1000, 1024, 6,
                                                 (7, 998)), T32),
    "g400_n4096": (lambda r, d: _sparse_iou(r, 2, 4096, 400, 3, (100,)), T1),
    "n_not_a_multiple_of_32": (lambda r, d: _sparse_iou(r, 3, 77, 16, 2),
                               COCO_T),
    "t32": (lambda r, d: _sparse_iou(r, 2, 500, 112, 8, (40,)), T32),
    "g_not_a_multiple_of_4": (lambda r, d: _sparse_iou(r, 2, 130, 13, 3,
                                                       (9,)), COCO_T[:3]),
    "tiny_n5_g3": (lambda r, d: _sparse_iou(r, 3, 5, 3, 2),
                   np.float32([0.5, 0.75])),
    "all_zero": (lambda r, d: np.zeros((2, 257, 112), np.float32), COCO_T),
    # the inputs the main paths build: config 2's and config 4's training
    # batches, one image of 4096 detections, and the drill's files
    "config2_t1": (lambda r, d: _scan_input("config2", d), T1),
    "config2_t10": (lambda r, d: _scan_input("config2", d, seed=1), COCO_T),
    "config2_t32": (lambda r, d: _scan_input("config2", d), T32),
    "config2_trained_t1": (
        lambda r, d: _scan_input("config2", d, trained=True), T1),
    "config2_trained_t10": (
        lambda r, d: _scan_input("config2", d, trained=True), COCO_T),
    "config2_duplicated_gt": (
        lambda r, d: _duplicated_gt(_scan_input("config2", d)), COCO_T),
    "config4_t1": (lambda r, d: _scan_input("config4", d), T1),
    "config4_t10": (lambda r, d: _scan_input("config4", d, seed=1), COCO_T),
    "config4_n4095": (lambda r, d: np.ascontiguousarray(
        _scan_input("config4", d, seed=1)[:, :4095]), COCO_T),
    "clustered_n4096_one_image": (lambda r, d: _one_image_input(d), T1),
    "drill_config3_classes": (
        lambda r, d: _scan_input("drill_config3", d, aware=True), T1),
    "pets_t10": (lambda r, d: _scan_input("pets", d), COCO_T),
    "dense80_classes_t10": (
        lambda r, d: _scan_input("dense80", d, aware=True), COCO_T),
    "dense4k_t10": (lambda r, d: _scan_input("dense4k", d), COCO_T),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCAN_CASES))
def test_k3_k4_cases_exact_on_card(name):
    """K3 on each case, and K4 on each of its images, exactly as the plain
    scan; two launches bit-identical."""
    from gossipnet_tpu_torch.ops.cuda import matching_scan as k3

    dev = _card()
    make, thr_np = SCAN_CASES[name]
    iou = torch.from_numpy(make(np.random.default_rng(5), dev)).to(dev)
    check_scan(iou, torch.from_numpy(thr_np))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sparse_4x700", "config2_t1", "config2_t10",
                                  "config4_t1", "all_zero"])
def test_k3_writes_every_output_on_card(name):
    """The outputs come from torch.empty: filled blocks of their sizes in
    the caching allocator are reused, and the result is still exact."""
    from gossipnet_tpu_torch.ops.cuda import matching_scan as k3

    dev = _card()
    if name == "sparse_4x700":
        iou, thr_np = _sparse_iou(np.random.default_rng(6), 4, 700, 112, 3,
                                  (11,)), COCO_T
    else:
        make, thr_np = SCAN_CASES[name]
        iou = make(np.random.default_rng(6), dev)
    iou = torch.from_numpy(iou).to(dev)
    thr = torch.from_numpy(thr_np)
    shape = iou.shape[:2] + (len(thr_np),)
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
             n_valid=None, rows=slice(None), block_sparse=True,
             all_invalid=None, probe=False):
    """(PairColumns, a, b, Wg, W2, b2) of one unfolded pair stage on random
    weights, and a random cotangent dm. ``probe``: a = 0, b > 0, Wg = 0,
    W2 = I, b2 = 0, so that m is the max of b over the neighbour set,
    exact in any order."""
    from gossipnet_tpu_torch.ops.cuda import pairwise as k5

    boxes, scores, valid, classes = _clustered(rng, b, n, n_valid=n_valid,
                                               num_classes=num_classes)
    if all_invalid is not None:
        valid[all_invalid] = False
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
                           col_cls, block_sparse)
    nr, nc = cols.row.shape[2], cols.col.shape[2]

    def t(*shape, scale=0.5):
        return torch.from_numpy(
            rng.normal(0, scale, shape).astype(np.float32)).to(dev)

    bb = t(b, n, p, scale=1.0)
    if dup_cols:
        bb = torch.repeat_interleave(bb, 2, dim=1).contiguous()
    args = (cols, t(b, nr, p, scale=1.0), bb, t(cols.num_features, p),
            t(p, p), t(p))
    if probe:
        args = (cols, torch.zeros_like(args[1]), bb.abs() + 1.0,
                torch.zeros_like(args[3]), torch.eye(p, device=dev),
                torch.zeros_like(args[5]))
    return args, t(b, nr, p, scale=1.0)


K5_CASES = {
    "odd_padded": dict(b=2, n=301, n_valid=270),
    "rect": dict(b=2, n=200, rows=slice(7, 130)),
    "rect_multiclass": dict(b=2, n=200, rows=slice(37, 150), num_classes=4),
    "multiclass": dict(b=2, n=256, num_classes=5),
    "p16": dict(b=2, n=150, p=16),
    "p64_multiclass": dict(b=1, n=150, p=64, num_classes=3),
    "dense_tiles": dict(b=1, n=300, block_sparse=False),
    "all_padding": dict(b=2, n=128, all_invalid=1),
    "mask_probe_b8_n1024": dict(b=8, n=1024, probe=True),
    "mask_probe_b1_n4096": dict(b=1, n=4096, probe=True),
    "mask_probe_multiclass": dict(b=2, n=256, num_classes=4, probe=True),
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
    assert_grads(got, want, dtype)
    again = k5.launch_backward_kernel(*args, m, dm, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,num_classes", [(200, 4), (512, 0), (512, 4)])
def test_k6_gives_each_tie_the_full_gradient_on_card(n, num_classes, dtype):
    """As :func:`test_k2_gives_each_tie_the_full_gradient_on_card`, for
    K5/K6."""
    from gossipnet_tpu_torch.ops.cuda import pairwise as k5

    dev = _card()
    args_d, dm = _k5_args(np.random.default_rng(3), 2, n, dev,
                          num_classes=num_classes, dup_cols=True)
    args_s, _ = _k5_args(np.random.default_rng(3), 2, n, dev,
                         num_classes=num_classes)
    cols_d, a, b_d, wg, w2, b2b = args_d
    args_s = (args_s[0], a, b_d[:, 0::2].contiguous(), wg, w2, b2b)
    m_s = k5.launch_kernel(*args_s, dtype)
    m_d = k5.launch_kernel(*args_d, dtype)
    single = k5.launch_backward_kernel(*args_s, m_s, dm, dtype)
    dup = k5.launch_backward_kernel(*args_d, m_d, dm, dtype)
    torch.cuda.synchronize()
    assert torch.equal(m_s, m_d)
    assert torch.equal(dup[1][:, 0::2], dup[1][:, 1::2])
    assert_grads(dup, (2 * single[0], single[1].repeat_interleave(2, dim=1),
                        2 * single[2], 2 * single[3], 2 * single[4]), dtype)
    if dtype != "float32":
        dm = untied(args_s, dm, (dtype,), k5)
    got = k5.launch_backward_kernel(*args_d, m_d, dm, dtype)
    want = k5.pair_pool_backward_reference(
        *args_d, k5._reference_core(*args_d, dtype), dm, dtype)
    torch.cuda.synchronize()
    assert_grads(got, want, dtype)


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
@pytest.mark.parametrize("size", ["ragged", "probe"])
@pytest.mark.parametrize("tile_j", [32, 64, 128])
@pytest.mark.parametrize("mode", ["full", "nofeat", "nogw", "nofc2",
                                  "nomask", "bf3d"])
def test_k7_matches_plain_on_card(mode, tile_j, size):
    """K7 (the per-tile ablation) against its plain version at a ragged
    shape with invalid detections and at the probe's own B=8 N=1024: the
    five f32 modes rtol = atol = 1e-5, ``bf3d`` within one bf16 step and
    bit-equal on 99%; rows without a neighbour at the same places; two
    launches bit-identical."""
    from gossipnet_tpu_torch.ops.cuda import ablate as k7
    from gossipnet_tpu_torch.tools.kernel_ablate import probe_inputs

    dev = _card()
    if size == "probe":
        inputs = probe_inputs(device=dev)
    else:
        inputs = probe_inputs(2, 200, canvas=200.0, seed=1, device=dev)
        inputs["cols"][:, pf.DetColumns._fields.index("valid"),
                       150:170] = 0.0
    args = [inputs[k] for k in ("cols", "a", "b", "wg", "w2", "b2")]
    before = k7.pair_ablate.launches
    want = check_k7(args, mode, tile_j)
    assert k7.pair_ablate.launches == before + 2
    if mode != "nomask" and size == "ragged":
        assert (want < -1e29).all(-1)[:, 150:170].all()   # invalid rows


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
def test_k7_build_spills_nothing_and_puts_fc2_on_the_tensor_cores_on_card(
        tmp_path, monkeypatch):
    """pair_ablate.cu built afresh: ptxas reports no spill in any of its
    18 instantiations (six modes x three column tiles), and the SASS
    (cuobjdump) has HMMA, the tensor cores' mma.sync, in every mode that
    keeps FC2 and none in ``nofc2``."""
    import re
    import subprocess

    from gossipnet_tpu_torch.ops.cuda import ablate as k7
    from gossipnet_tpu_torch.ops.cuda import build

    _card()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    lib = build.build(["pair_ablate"])["pair_ablate"]
    spills = [line for line in build.build_logs["pair_ablate"].splitlines()
              if "spill" in line and "0 bytes spill stores, 0 bytes spill "
              "loads" not in line]
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    hmma, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*pair_ablate_kernelILi(\d+)ELi(\d+)E",
                      line)
        if m:
            name = (k7.MODES[int(m.group(1))], int(m.group(2)))
            hmma[name] = 0
        elif name and "HMMA" in line:
            hmma[name] += 1
    assert not spills
    assert set(hmma) == {(mode, tj) for mode in k7.MODES
                         for tj in k7.TILE_JS}
    assert all((n == 0) == (mode == "nofc2") for (mode, _), n in hmma.items())


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
    assert_grads(got, want, dtype)
    # dm = 1: db2[q] counts the winners of q, one per maximum or more
    assert bool((ones[4] >= (m > 0).sum(dim=(0, 1)).float()).all())
    if dtype == "float32":
        plain_ones = k1.pair_pool_backward_reference(
            *args, m_plain, torch.ones_like(dm), dtype)
        assert torch.equal(ones[4], plain_ones[4])
    assert all(torch.equal(u, v) for u, v in zip((m, *got), again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "stream"])
@pytest.mark.parametrize("b,n", [(2, 260), (8, 1024)])
@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("p", [8, 16, 32, 64])
def test_column_permutation_probe_on_card(p, k, b, n, dtype):
    """The same problem with its columns (and b') permuted: m bit-equal (a
    pair's pre2 depends on nothing but the pair; the max is order-free),
    d_b' the permutation of the other bit for bit (a column adds its rows
    in an order the row indices fix), d_a' and the weight gradients within
    the tolerances of the plain comparison."""
    dev = _card()
    dts, tol = _dtypes(dtype)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(n)).to(dev)
    args, dm = _redesign_args(np.random.default_rng(p * k), dev, p, k, b, n)
    args_p, _ = _redesign_args(np.random.default_rng(p * k), dev, p, k, b, n,
                               perm=perm)
    m, m_p = k1.launch_kernel(*args, *dts), k1.launch_kernel(*args_p, *dts)
    got = k1.launch_backward_kernel(*args, m, dm, *dts)
    got_p = k1.launch_backward_kernel(*args_p, m_p, dm, *dts)
    torch.cuda.synchronize()
    assert (m > 0).any()
    assert torch.equal(m, m_p)
    assert torch.equal(got_p[1], got[1][:, perm])
    assert_grads(got_p, (got[0], got[1][:, perm], *got[2:]), tol)


# K2 at the fills of the training cells: blocks with no step leave at once
FILL_CASES = {   # valid detections an image, first (invalid ones sort last)
    "sparse_fill": dict(b=8, n=256, n_valid=(1, 7, 13, 22, 22, 29, 35, 40)),
    "all_padding_image": dict(b=2, n=256, n_valid=(0, 30)),
    "one_live_tile": dict(b=1, n=256, n_valid=(20,)),
    "dense_1024": dict(b=2, n=1024, n_valid=(710, 1024)),
    "row_shard": dict(b=2, n=256, n_valid=(200, 90), rows=slice(128, 256)),
}
FILL_MODES = {"f32": ("float32", "float32"), "bf16": ("bfloat16", "float32"),
              "ew": ("bfloat16", "bfloat16")}


def _fill_args(rng, dev, k, b, n, n_valid, rows=slice(None), p=32):
    """K1/K2 launch arguments (K = 3 or 4 in-kernel features) of images
    whose first ``n_valid[i]`` detections are valid, rows a slice of the
    columns, and a cotangent."""
    boxes, scores, valid, classes = _clustered(rng, b, n, num_classes=4)
    for i, nv in enumerate(n_valid):
        valid[i, nv:] = False
    cs = pf.stack_columns(pf.det_columns(
        torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev),
        torch.from_numpy(valid).to(dev)))
    cls = torch.from_numpy(classes).to(dev) if k == 4 else None

    def t(*shape, scale=0.5):
        return torch.from_numpy(
            rng.normal(0, scale, shape).astype(np.float32)).to(dev)

    nr = cs[:, :, rows].shape[2]
    geom = k1.pair_geometry(cs[:, :, rows].contiguous(), cs, THR,
                            None if cls is None else cls[:, rows].contiguous(),
                            cls)
    return (geom, t(b, nr, p, scale=1.0), t(b, n, p, scale=1.0), t(k, p),
            t(p, p), t(p)), t(b, nr, p, scale=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(FILL_MODES))
@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("name", sorted(FILL_CASES))
def test_k2_skips_the_blocks_without_a_step_on_card(name, k, mode):
    """K2 where most of the padded grid has no work (the sparse cell's
    fill, an all-padding image, one live tile, a row shard) and where most
    has (N=1024 dense): against the plain backward at the usual
    tolerances, two launches bit-identical, and the blocks the kernel
    counts as having a step those of the plain skip rule
    (``launch.work_blocks``)."""
    dev = _card()
    dts = FILL_MODES[mode]
    args, dm = _fill_args(np.random.default_rng(k), dev, k,
                          **FILL_CASES[name])
    m = k1.launch_kernel(*args, *dts)
    m_plain = k1._reference_core(*args, *dts)
    if mode == "ew":
        dm = untied(args, dm)
    bwd = k1.pair_pool_backward
    before = (bwd.blocks_launched, bwd.blocks_with_work())
    got = k1.launch_backward_kernel(*args, m, dm, *dts)
    after = (bwd.blocks_launched, bwd.blocks_with_work())
    again = k1.launch_backward_kernel(*args, m, dm, *dts)
    want = k1.pair_pool_backward_reference(*args, m_plain, dm, *dts)
    torch.cuda.synchronize()
    assert (m > 0).any()
    assert_grads(got, want, dts[0])
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    geom = args[0]
    work = launch.work_blocks(
        geom.flags, geom.row.shape[2], geom.col.shape[2],
        launch._splits(geom, dev, whole_matrix=True), geom.tile)
    assert after[0] - before[0] == work.numel()
    assert after[1] - before[1] == int(work.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(FILL_MODES))
def test_k2_row_shards_at_the_sparse_fill_join_bit_equal_on_card(mode):
    """Row shards of a sparse fill (N=256, halves of 128 rows, most blocks
    without a step): joined, their d_a' equals the square launch's bit for
    bit."""
    dev = _card()
    dts = FILL_MODES[mode]
    args, dm = _fill_args(np.random.default_rng(5), dev, 3, 4, 256,
                          (200, 90, 13, 0))
    m = k1.launch_kernel(*args, *dts)
    square = k1.launch_backward_kernel(*args, m, dm, *dts)
    parts = []
    for sl in (slice(0, 128), slice(128, 256)):
        shard = _row_shard(k1, args, sl)
        parts.append(k1.launch_backward_kernel(
            *shard, m[:, sl].contiguous(), dm[:, sl].contiguous(), *dts)[0])
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts, 1), square[0])


def _column_blocks_of(call):
    """(column blocks that summed records, that recomputed) of ``call``,
    from K2's own counts."""
    before = k1.pair_pool_backward.column_blocks()
    out = call()
    after = k1.pair_pool_backward.column_blocks()
    return out, (after[0] - before[0], after[1] - before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_recomputes_where_ties_overflow_the_records_on_card(dtype):
    """Image 0 is 40 overlapping detections each repeated 8 times, so each
    of its rows ties 8 ways at every maximum and a row tile's winning pairs
    pass the 32 x P records a tile holds: its column blocks recompute their
    pairs, while image 1's (no duplicates) sum records. Against the plain
    backward at the usual tolerances, two launches bit-identical, and a
    column and its copies get the same bits."""
    dev = _card()
    rng = np.random.default_rng(11)
    b, n, rep, p = 2, 320, 8, 32
    boxes, scores, valid, _ = _clustered(rng, b, n)
    xy = 150.0 + rng.normal(0, 3.0, (n // rep, 2))
    one = np.concatenate([xy, xy + 40.0 + rng.normal(0, 3.0, (n // rep, 2))],
                         -1)
    boxes[0] = np.repeat(one, rep, axis=0).astype(np.float32)
    scores[0] = np.repeat(scores[0, :n // rep], rep)
    cs = pf.stack_columns(pf.det_columns(
        torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev),
        torch.from_numpy(valid).to(dev)))

    def t(*shape, scale=0.5):
        x = rng.normal(0, scale, shape).astype(np.float32)
        if len(shape) == 3:   # per detection: image 0's copies alike
            x[0] = np.repeat(x[0, :n // rep], rep, axis=0)
        return torch.from_numpy(x).to(dev)

    args = (k1.pair_geometry(cs, cs, THR), t(b, n, p, scale=1.0),
            t(b, n, p, scale=1.0), t(3, p), t(p, p), t(p))
    dm = t(b, n, p, scale=1.0)
    m = k1.launch_kernel(*args, dtype)
    m_plain = k1._reference_core(*args, dtype)
    got, (records, recomputed) = _column_blocks_of(
        lambda: k1.launch_backward_kernel(*args, m, dm, dtype))
    again = k1.launch_backward_kernel(*args, m, dm, dtype)
    want = k1.pair_pool_backward_reference(*args, m_plain, dm, dtype)
    torch.cuda.synchronize()
    assert recomputed > 0 and records > 0
    assert_grads(got, want, dtype)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    copies = got[1][0].view(n // rep, rep, p)
    assert torch.equal(copies, copies[:, :1].expand_as(copies))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_sums_records_at_the_crowd_shape_on_card(dtype):
    """B=2 N=4096 with 2,250 valid detections an image, as the crowd
    cell's images: every column block with a step sums the row pass's
    records; against the plain backward, two launches bit-identical."""
    dev = _card()
    args, dm = _fill_args(np.random.default_rng(4096), dev, 3, 2, 4096,
                          (2250, 2250))
    m = k1.launch_kernel(*args, dtype)
    m_plain = k1._reference_core(*args, dtype)
    got, (records, recomputed) = _column_blocks_of(
        lambda: k1.launch_backward_kernel(*args, m, dm, dtype))
    again = k1.launch_backward_kernel(*args, m, dm, dtype)
    want = k1.pair_pool_backward_reference(*args, m_plain, dm, dtype)
    torch.cuda.synchronize()
    assert (m > 0).any()
    assert records > 0 and recomputed == 0
    assert_grads(got, want, dtype)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


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


@pytest.fixture(scope="module")
def config4_args():
    """K5's last launch of one forward and backward of config 4
    (crowded_4096.yaml with pair_kernel 1: 16 blocks, 128/32/32, B=2
    N=4096, seeded weights) on its synthetic training batch: the pair
    stage's (columns, a, b, Wg, W2, b2) and the cotangent K6 got."""
    _, _, args, dm, _ = _model_launch("K5", "config4", _card())
    assert tuple(args[1].shape) == (2, 4096, 32)
    return args, dm


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
        dm = untied(args, dm, (dtype,), k5)
    got = k5.launch_backward_kernel(*args, m, dm, dtype)
    want = k5.pair_pool_backward_reference(*args, m_plain, dm, dtype)
    torch.cuda.synchronize()
    assert_grads(got, want, dtype)


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
@pytest.mark.parametrize("n", [260, 1024])
@pytest.mark.parametrize("num_classes", [0, 4])
@pytest.mark.parametrize("p", [8, 16, 32, 64])
def test_k6_column_permutation_probe_on_card(p, num_classes, n, dtype):
    """The same problem with its columns (and b) permuted: K5's m
    bit-equal, K6's d_b the permutation of the other bit for bit, d_a and
    the weight gradients within the plain comparison's tolerances. The
    features are not symmetric in the two detections, so a column pass
    that took its own column as the row would fail here."""
    from gossipnet_tpu_torch.ops.cuda import pairwise as k5

    dev = _card()
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
    assert_grads(got_p, (got[0], got[1][:, perm], *got[2:]), dtype)


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
    # the 16-block serving model at the bench batch and at config 4's, and
    # with each reduced-precision knob
    "bench_k1_f32": dict(num_blocks=16, pair_matmul_dtype="float32",
                         shapes=((8, 1024),)),
    "bench_k1_bf16": dict(num_blocks=16, shapes=((8, 1024),)),
    "bench_k5_f32": dict(num_blocks=16, pair_kernel=1,
                         pair_matmul_dtype="float32", shapes=((8, 1024),)),
    "bench_k5_bf16": dict(num_blocks=16, pair_kernel=1, shapes=((8, 1024),)),
    "config4_k5_bf16": dict(num_blocks=16, pair_kernel=1,
                            shapes=((2, 4096),)),
    "bench_stream": dict(num_blocks=16, pair_elementwise_dtype="bfloat16",
                         shapes=((8, 1024),)),
    "bench_model_bf16": dict(num_blocks=16, dtype="bfloat16",
                             shapes=((8, 1024),)),
    "bench_stream_model_bf16": dict(num_blocks=16, dtype="bfloat16",
                                    pair_elementwise_dtype="bfloat16",
                                    shapes=((8, 1024),)),
}


def _graph_rescorer(buckets=(256, 512), **model):
    from gossipnet_tpu_torch.api import Rescorer
    from gossipnet_tpu_torch.config import experiment_path, load_config
    from gossipnet_tpu_torch.params import init_params

    cfg = load_config(experiment_path("serving_bucketed"),
                      {"model": {"num_blocks": 4, **model},
                       "data": {"bucket_sizes": list(buckets)}})
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
    """Every kernel's launches, and those of K1's and K2's bf16 stream
    apart (also in K1's and K2's own)."""
    from gossipnet_tpu_torch.utils.cuda_graphs import COUNTED

    return [fn.launches for fn in COUNTED] + [
        k1.pair_pool.launches_ew, k1.pair_pool_backward.launches_ew]


def _stream_blocks(cfg) -> int:
    """The K1 (or K2) launches of the bf16 stream a forward (backward) of
    ``cfg`` counts apart."""
    stream = cfg.model.pair_elementwise_dtype == "bfloat16"
    return cfg.model.num_blocks if stream else 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRAPH_CASES))
def test_captured_forward_is_bit_equal_to_eager_on_card(name):
    """The replayed forward equals the eager forward at the same padded
    batch bit for bit, at three (b, n) of a 4-block model or at the bench
    batch and config 4's of the 16-block one; a replay launches what an
    eager forward launches."""
    dev = _card()
    case = dict(GRAPH_CASES[name])
    shapes = case.pop("shapes", ((1, 256), (2, 512), (4, 256)))
    r = _graph_rescorer(buckets=sorted({n for _, n in shapes}), **case)
    blocks = r.cfg.model.num_blocks + _stream_blocks(r.cfg)
    graphs = r._graphs
    for b, n in shapes:
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
        assert replayed == eager and sum(eager) == blocks, (b, n)
    assert graphs.shapes() == list(shapes)


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


# synthetic_roidb arguments: a small set, config 2's training data (B=8
# N=1024 G=112) and config 4's (B=2 N=4096 G=400)
SMALL_DATA = dict(num_images=16, seed=0, num_gt=40, dets_per_gt=8,
                  num_clutter=40)
CONFIG2_DATA = dict(num_images=32, seed=0, num_gt=100, dets_per_gt=8,
                    num_clutter=200)
CONFIG4_DATA = dict(num_images=2, seed=0, num_gt=400, dets_per_gt=8,
                    num_clutter=600, num_classes=1)
STEP_CASES = {
    # a 4-block config 2, the same small batch each step
    "k1k2": dict(),
    "k5k6": dict(model=dict(pair_kernel=1)),
    "accum2": dict(train=dict(grad_accum_steps=2)),
    # the 16-block configs on their own data, the next batch each step
    "config2": dict(model=dict(num_blocks=16), data=CONFIG2_DATA, steps=20),
    "config4_k5k6": dict(experiment="crowded_4096",
                         model=dict(num_blocks=16, pair_kernel=1),
                         data=CONFIG4_DATA, batch=2),
    "config2_accum2": dict(model=dict(num_blocks=16), data=CONFIG2_DATA,
                           train=dict(grad_accum_steps=2), steps=4),
    "config2_stream": dict(model=dict(num_blocks=16,
                                      pair_elementwise_dtype="bfloat16"),
                           data=CONFIG2_DATA),
    "config2_model_bf16": dict(model=dict(num_blocks=16, dtype="bfloat16"),
                               data=CONFIG2_DATA),
    "config2_stream_model_bf16": dict(
        model=dict(num_blocks=16, dtype="bfloat16",
                   pair_elementwise_dtype="bfloat16"), data=CONFIG2_DATA),
    "config3_model_bf16": dict(experiment="coco_multiclass",
                               model=dict(num_blocks=16, dtype="bfloat16"),
                               data=dict(CONFIG2_DATA, num_classes=80)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_captured_steps_are_bit_equal_to_eager_on_card(case):
    """Replayed steps against eager ``train_step``s on a twin state:
    metrics each step, then parameters and optimizer slots, bit for bit;
    a replay launches what an eager step launches; one graph a shape and
    update kind."""
    from gossipnet_tpu_torch import train as training
    from gossipnet_tpu_torch.config import experiment_path, load_config
    from gossipnet_tpu_torch.data.bucketing import BatchIterator
    from gossipnet_tpu_torch.data.synthetic import synthetic_roidb
    from gossipnet_tpu_torch.utils.cuda_graphs import StepGraphs

    dev = _card()
    kw = STEP_CASES[case]
    cfg = load_config(experiment_path(kw.get("experiment",
                                             "coco_persons_full")),
                      {"data": {"dataset": "synthetic"},
                       "model": {"num_blocks": 4, **kw.get("model", {})},
                       "train": kw.get("train", {})})
    it = BatchIterator(synthetic_roidb(**kw.get("data", SMALL_DATA)),
                       kw.get("batch", 8), cfg.data.bucket_sizes)
    eager, stepped = (training.create_train_state(
        cfg, training.build_model(cfg, "kernel", dev)) for _ in range(2))
    steps = StepGraphs(stepped, cfg, training.step_body)
    first = next(it)
    batches = [first] + [next(it) if "data" in kw else first
                         for _ in range(kw.get("steps", 5) - 1)]
    eager_counts = None
    for i, batch in enumerate(batches):
        captures = steps.captures
        before = _launch_counts()
        _, want = training.train_step(
            eager, training.batch_to_device(batch, dev), cfg)
        torch.cuda.synchronize()
        mid = _launch_counts()
        got = steps(training.host_arrays(batch))
        torch.cuda.synchronize()
        after = _launch_counts()
        if steps.captures == captures:     # a replay, no capture
            eager_counts = [b - a for a, b in zip(before, mid)]
            assert [b - a for a, b in zip(mid, after)] == eager_counts
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
    blocks = cfg.model.num_blocks + _stream_blocks(cfg)
    assert sum(eager_counts) == 2 * blocks + 1
    for a, b in zip(stepped.model.parameters(), eager.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(stepped.optimizer.make_slots(),
                    eager.optimizer.make_slots()):
        assert torch.equal(a, b)
    accum = cfg.train.grad_accum_steps
    assert steps.captures == len({
        ((i + 1) % accum == 0,
         tuple(v.shape for v in training.host_arrays(batch).values()))
        for i, batch in enumerate(batches)})


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
# the models' own launch arguments: the blob layout (every pair a
# neighbour), the main paths' batches; the bench's captured loop
# ---------------------------------------------------------------------------


def _launch_args(kern, model, boxes, scores, valid, classes=None):
    """One forward and backward of the 16-block ``model`` through ``kern``
    (K1/K2, or K5/K6) -> the first block's forward launch arguments, the
    last block's backward ones (the backward runs the blocks in reverse),
    that launch's cotangent dm and its dtype arguments; tensors copied."""
    seen = {"fwd": [], "bwd": []}
    launch_fwd, launch_bwd = kern.launch_kernel, kern.launch_backward_kernel

    def record(key, launch):
        def run(*args, **kw):
            seen[key].append([x.clone() if torch.is_tensor(x) else x
                              for x in args] + list(kw.values()))
            return launch(*args, **kw)
        return run

    kern.launch_kernel = record("fwd", launch_fwd)
    kern.launch_backward_kernel = record("bwd", launch_bwd)
    try:
        logits = model(boxes, scores, valid, classes)
        cot = torch.randn(logits.shape, generator=torch.Generator(
            device=logits.device).manual_seed(0), device=logits.device)
        (logits * cot).sum().backward()
    finally:
        kern.launch_kernel = launch_fwd
        kern.launch_backward_kernel = launch_bwd
    torch.cuda.synchronize()
    assert len(seen["fwd"]) == len(seen["bwd"]) == 16
    fwd, bwd = seen["fwd"][0], seen["bwd"][0]
    return tuple(fwd[:6]), tuple(bwd[:6]), bwd[7], tuple(bwd[8:])


EVAL_BATCHES = 8     # config 2's evaluation set: 64 images, B=8 N=256
# the main-path batches whose model trains two train() steps first, as
# chip_smoke.py's drill phases and the evaluating training run trained
# theirs: trained features move the neighbour structure and the near ties
# that the bf16 tie rule and K2's records see, where seeded weights leave
# them as drawn
TRAINED = ("evaluation", "drill_", "pets", "dense80", "dense4k")


def _main_batch(name, dev):
    """A batch of one of the port's main paths on ``dev`` and the
    configuration that runs it -> (config, arrays by name)."""
    return _main_data(name, dev)[:2]


@functools.lru_cache(maxsize=None)
def _main_data(name, dev):
    """A batch of one of the port's main paths on ``dev``, the
    configuration that runs it and the training set it comes from (None
    where the path does not train) -> (config, arrays by name, roidb).
    ``bench``: the serving bench's 8 clustered images (N=1024);
    ``blob_b8_n1024``: 8 ``blob`` images (most pairs neighbours);
    ``config2``, ``config4``: the first synthetic training batch of
    config 2 (B=8 N=1024 G=112) and of config 4 (B=2 N=4096 G=400);
    ``evaluation_<i>``: batch i of config 2's evaluation set (B=8 N=256;
    trained on config 2's training set); ``sparse_fill``, ``crowd_fill``:
    images of the sparse and crowd training cells' pools (B=8 N=256, B=2
    N=4096; boxes, scores and valid only); ``drill_config2``,
    ``drill_config3``: the first batch of the scale drill's ``run`` arm on
    its files (64 images); ``pets``, ``dense80``, ``dense4k``: the widest
    training batch of the drill's arms on their real-format files
    (``chip_smoke.drill_file_sets``)."""
    from gossipnet_tpu_torch import evaluate
    from gossipnet_tpu_torch import train as training
    from gossipnet_tpu_torch.config import experiment_path, load_config
    from gossipnet_tpu_torch.data.bucketing import BatchIterator, eval_batches
    from gossipnet_tpu_torch.data.synthetic import (layout_batch,
                                                    synthetic_roidb)
    from gossipnet_tpu_torch.tools import scale_drill

    cfg2 = load_config(experiment_path("coco_persons_full"),
                       {"data": {"dataset": "synthetic"}})
    cfg4 = load_config(experiment_path("crowded_4096"))
    if name in ("bench", "blob_b8_n1024"):
        layout = "clustered" if name == "bench" else "blob"
        return load_config(experiment_path("serving_bucketed")), \
            training.batch_to_device(layout_batch(layout, 8, 1024), dev), None
    if name == "config2":
        roidb = synthetic_roidb(**CONFIG2_DATA)
        return cfg2, training.batch_to_device(
            next(BatchIterator(roidb, 8, (256, 512, 1024))), dev), roidb
    if name == "config4":
        roidb = synthetic_roidb(**CONFIG4_DATA)
        return cfg4, training.batch_to_device(
            next(BatchIterator(roidb, 2, cfg4.data.bucket_sizes)), dev), roidb
    if name.startswith("evaluation_"):
        batches = list(eval_batches(evaluate.load_roidb(cfg2),
                                    cfg2.train.batch_size,
                                    cfg2.data.bucket_sizes))
        assert len(batches) == EVAL_BATCHES
        return cfg2, training.batch_to_device(
            batches[int(name.split("_")[1])], dev), \
            _main_data("config2", dev)[2]
    if name in ("sparse_fill", "crowd_fill"):
        sparse = name == "sparse_fill"
        fill = chip_smoke.sparse_fill_batch if sparse \
            else chip_smoke.crowd_fill_batch
        return (cfg2 if sparse else cfg4), dict(zip(("boxes", "scores",
                                                     "valid"), fill(dev))), None
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp)
        if name.startswith("drill_"):
            scale_drill.gen(n_images=64, data_dir=data)
            _, path2, path3 = scale_drill.run_yamls(data_dir=data)
            cfg = load_config(path2 if name == "drill_config2" else path3)
            roidb, _ = training._datasets(cfg)
            return cfg, training.batch_to_device(
                next(BatchIterator(roidb, 8, cfg.data.bucket_sizes)), dev), \
                roidb
        sets = chip_smoke.drill_file_sets(data)
        cfg = load_config(next(path for label, path in sets.items()
                               if label.startswith(name)))
        roidb, _ = training._datasets(cfg)
        it = BatchIterator(roidb, cfg.train.batch_size,
                           cfg.data.bucket_sizes, seed=cfg.train.seed)
        batches = [next(it) for _ in range(len(roidb))]
        widest = max(b.padded_n for b in batches)
        return cfg, training.batch_to_device(
            next(b for b in batches if b.padded_n == widest), dev), roidb


@functools.lru_cache(maxsize=None)
def _trained_weights(name, dev):
    """The weights of the model of the main-path batch ``name``
    (:func:`_main_data`) after two ``train()`` steps on its training set
    from seed 0, through the pair kernel and captured graphs."""
    from gossipnet_tpu_torch import train as training

    cfg, _, roidb = _main_data(name, dev)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, checkpoint_dir=tmp))
        state = training.train(cfg, roidb, pool_impl="kernel", max_steps=2,
                               device=dev)
    assert state.step == 2
    return {k: v.detach().clone()
            for k, v in state.model.state_dict().items()}


def _main_model(name, dev, trained=None, **model):
    """The 16-block model of the main-path batch ``name`` on ``dev`` with
    ``model``'s overrides -> (config, model): seeded weights, or with
    ``trained`` (by default for the names of TRAINED) those of
    :func:`_trained_weights`, evaluation batches taking config 2's."""
    from gossipnet_tpu_torch.tools import entry

    cfg, _ = _main_batch(name, dev)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             **model))
    net = entry.seeded_model(cfg, dev)
    if name.startswith(TRAINED) if trained is None else trained:
        net.load_state_dict(_trained_weights(
            "config2" if name.startswith("evaluation_") else name, dev))
    return cfg, net


def _model_launch(kernel, name, dev, **model):
    """The launch arguments (:func:`_launch_args`) of the 16-block model of
    the main-path batch ``name`` (:func:`_main_model`) through K1/K2
    (``kernel`` "K1") or K5/K6 ("K5"), with ``model``'s overrides ->
    (kern, forward args, backward args, dm, dtypes)."""
    from gossipnet_tpu_torch.ops.cuda import pairwise as k5

    kern = k1 if kernel == "K1" else k5
    cfg, net = _main_model(name, dev, pair_kernel=2 if kern is k1 else 1,
                           **model)
    arrays = _main_batch(name, dev)[1]
    classes = arrays["classes"] if cfg.model.num_classes > 1 else None
    return (kern, *_launch_args(kern, net, arrays["boxes"], arrays["scores"],
                                arrays["valid"], classes))


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
    return (kern, *_launch_args(kern, model, boxes, scores, valid)[:3])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_kernels_on_blob_launch_arguments_on_card(blob_args, dtype):
    """K1/K2 and K5/K6 where every pair is a neighbour, against their
    plain versions on the model's own launch arguments
    (:func:`chip_smoke.check_launch_args`)."""
    check_launch_args(*blob_args, dtype)


MAIN_CASES = [("K1", name) for name in (
    "bench", "config2", "config4", *(f"evaluation_{i}"
                                     for i in range(EVAL_BATCHES)),
    "sparse_fill", "crowd_fill", "drill_config2", "pets", "dense80",
    "dense4k")] + [("K5", "bench"), ("K5", "config4")]


@pytest.fixture(scope="module", params=MAIN_CASES,
                ids=[f"{k}-{name}" for k, name in MAIN_CASES])
def main_args(request):
    """The first block's forward and the last block's backward launch
    arguments, and that backward's cotangent, of the 16-block model of a
    main path's batch (:func:`_main_batch`; seeded weights)."""
    return _model_launch(*request.param, _card())[:4]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_kernels_on_main_path_launch_arguments_on_card(main_args,
                                                            dtype):
    """K1/K2 (and K5/K6 at the bench batch and config 4's) on the launch
    arguments the models give them on the main paths' batches -- serving,
    training of configs 2 and 4, evaluation, the training cells' fills,
    the scale drill's files -- against their plain versions
    (:func:`chip_smoke.check_launch_args`)."""
    check_launch_args(*main_args, dtype)


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


@pytest.fixture(scope="module", params=["bench", "config2", "blob"])
def stream_args(request):
    """The first block's forward and the last block's backward launch
    arguments of the 16-block flagship (128/32/32, seeded weights) with the
    bf16 stream, and that backward's cotangent: at the serving bench
    batch, config 2's training batch and ``blob`` B=2 N=256."""
    from gossipnet_tpu_torch.data.synthetic import layout_batch
    from gossipnet_tpu_torch.tools import entry

    dev = _card()
    stream = dict(pair_elementwise_dtype="bfloat16")
    if request.param == "blob":
        cfg = entry.flagship_cfg()
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                 **stream))
        fwd, args, dm, dts = _launch_args(
            k1, entry.seeded_model(cfg, dev),
            *entry.device_tensors(layout_batch("blob", 2, 256, 0), dev))
    else:
        _, fwd, args, dm, dts = _model_launch("K1", request.param, dev,
                                              **stream)
    assert dts == STREAM
    return fwd, args, dm


@pytest.mark.cuda
def test_bf16_stream_k1_within_one_ulp_on_card(stream_args):
    """K1's bf16 stream against its plain version: every entry a bf16
    value, at most one bf16 ulp apart (the tensor cores and the fmaf chain
    sum FC2 in different orders, ~1e-7 apart before the stream rounds), in
    at most 1% of the entries."""
    fwd, args, _ = stream_args
    check_stream_k1(fwd, args)


@pytest.mark.cuda
def test_bf16_stream_k2_matches_plain_backward_on_card(stream_args):
    """K2's bf16 stream against its plain backward at bf16's tolerances,
    with dm zero where the best two candidates lie within one bf16 ulp
    (exact ties included: there one ulp of a differently ordered sum can
    crown another set); two launches bit-identical; each winner found
    (dm = 1: db2 counts at least one per positive maximum)."""
    _, args, dm = stream_args
    check_stream_k2(args, dm)


def _row_shard(kern, args, rows: slice) -> tuple:
    """A square launch's arguments cut to the rows ``rows`` against every
    column, as the det-sharded forward builds them (parallel/spmd.py), at
    the square launch's skip tile."""
    geom = args[0]
    row = geom.row[:, :, rows].contiguous()
    if kern is k1:
        geom = geom._replace(
            row=row, i_feats=geom.i_feats[:, rows].contiguous(),
            flags=k1.tile_activity(row, geom.col, *geom.tile).contiguous())
    else:
        geom = geom._replace(row=row, flags=k1.tile_activity(
            row, geom.col, *geom.tile,
            valid_field=pf.NUM_COLUMNS - 1).contiguous())
    return (geom, args[1][:, rows].contiguous(), *args[2:])


def _at_tile(args, tile):
    """Launch arguments with the flags rebuilt at skip tile ``tile`` by the
    model's rule (``tile_activity`` at that shape), and that tile."""
    from gossipnet_tpu_torch.ops.cuda import pairwise as k5

    geom = args[0]
    valid = k5._VALID if isinstance(geom, k5.PairColumns) else k1._VALID
    flags = k1.tile_activity(geom.row, geom.col, *tile, valid_field=valid)
    return (geom._replace(flags=flags.contiguous(), tile=tuple(tile)),
            *args[1:])


class _ModelLaunches:
    """The last block's backward launch arguments of the 16-block models on
    the main paths' batches (:func:`_model_launch`) and the results of the
    plain versions on them, each made at first use and kept for the
    module's tests."""

    def __init__(self, dev):
        self.dev, self._args, self._plain = dev, {}, {}

    def args(self, kernel: str, name: str) -> tuple:
        """-> (kern, the launch arguments, their cotangent dm)."""
        if (kernel, name) not in self._args:
            kern, _, args, dm, _ = _model_launch(kernel, name, self.dev)
            self._args[kernel, name] = kern, args, dm
        return self._args[kernel, name]

    def plain(self, kernel: str, name: str, dtype: str) -> tuple:
        """-> (the plain m, the dm held to (bf16: zero at the near-tied
        maxima), the plain gradients, in f32 the winners: db2 at dm =
        1)."""
        key = kernel, name, dtype
        if key not in self._plain:
            kern, args, dm = self.args(kernel, name)
            if dtype != "float32":
                dm = untied(args, dm, (dtype,), kern)
            m = kern._reference_core(*args, dtype)
            wins = None if dtype != "float32" else \
                kern.pair_pool_backward_reference(
                    *args, m, torch.ones_like(dm), dtype)[4]
            self._plain[key] = (m, dm, kern.pair_pool_backward_reference(
                *args, m, dm, dtype), wins)
        return self._plain[key]


@pytest.fixture(scope="module")
def model_launches():
    return _ModelLaunches(_card())


SHARD_CASES = [("random", launch.DEFAULT_TILE)] + [
    ("model", t) for t in launch.TILES]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_det", [2, 4])
@pytest.mark.parametrize("kernel", ["K1", "K5"])
@pytest.mark.parametrize("data,tile", SHARD_CASES,
                         ids=[f"{d}-{t[0]}x{t[1]}" for d, t in SHARD_CASES])
def test_det_shards_match_the_square_launch_on_card(data, tile, kernel,
                                                    n_det, dtype,
                                                    model_launches):
    """The launches of a det-sharded forward: each shard's N / n_det rows
    against all N columns. Joined, the shards' m and d_a' equal the square
    launch's bit for bit; d_b' and the weight gradients summed over the
    shards are within the weight-gradient gate (1e-4 of the largest
    entry); at the default tile each shard also against its plain version
    (bf16: dm zero at the near-tied maxima). B=4 N=1024 random: a shard
    has half or a quarter of the square's row tiles there, so it would
    split its columns differently if the split count followed its own row
    tiles. And the 16-block models' own launch arguments, K1/K2 at the
    bench batch and K5/K6 at config 4's, at every skip tile."""
    from gossipnet_tpu_torch.ops.cuda import pairwise as k5

    dev = _card()
    rng = np.random.default_rng(n_det)
    if data == "model":
        kern, args, dm = model_launches.args(
            kernel, "bench" if kernel == "K1" else "config4")
        args = _at_tile(args, tile)
    elif kernel == "K1":
        kern, (args, dm, _) = k1, _pair_args(rng, 4, 1024, dev)
    else:
        kern, (args, dm) = k5, _k5_args(rng, 4, 1024, dev)
    m = kern.launch_kernel(*args, dtype)
    grads = kern.launch_backward_kernel(*args, m, dm, dtype)
    rows = args[1].shape[1] // n_det
    ms, parts = [], []
    for r in range(n_det):
        sl = slice(r * rows, (r + 1) * rows)
        shard = _row_shard(kern, args, sl)
        ms.append(kern.launch_kernel(*shard, dtype))
        parts.append(kern.launch_backward_kernel(
            *shard, m[:, sl].contiguous(), dm[:, sl].contiguous(), dtype))
        if tile == launch.DEFAULT_TILE:
            check_plain(kern, shard, dm[:, sl].contiguous(), dtype)
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
@pytest.mark.parametrize("tile", launch.TILES,
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("kern_name", ["k1k2", "k5k6"])
@pytest.mark.parametrize("data", ["banded", "bench", "config4",
                                  "blob_b8_n1024"])
def test_pair_kernels_at_every_tile_on_card(data, kern_name, tile, dtype,
                                            model_launches):
    """K1/K2 and K5/K6 at each skip tile against their plain versions,
    which read no flags: on banded flags where at TJ = 16 neighbours
    straddle the 16-column cells of a 32-column block, and on the last
    block's backward launch arguments of the 16-block models at the bench
    batch, config 4's and ``blob`` B=8 N=1024, their flags rebuilt at the
    tile by the model's rule (bf16: dm zero at the near-tied maxima). f32
    m and winners bit-equal, the gradients (d_b' from the column pass) at
    the gates above."""
    from gossipnet_tpu_torch.ops.cuda import pairwise as k5

    dev = _card()
    if data == "banded":
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
        args = (geom, t(b, n, p, scale=1.0), t(b, n, p, scale=1.0), wg,
                t(p, p), t(p))
        dm = t(b, n, p, scale=1.0)
        m_plain = kern._reference_core(*args, dtype)
        want = kern.pair_pool_backward_reference(*args, m_plain, dm, dtype)
        wins = kern.pair_pool_backward_reference(
            *args, m_plain, torch.ones_like(dm), dtype)[4]
    else:
        kernel = "K1" if kern_name == "k1k2" else "K5"
        kern, square, _ = model_launches.args(kernel, data)
        assert torch.equal(_at_tile(square, launch.DEFAULT_TILE)[0].flags,
                           square[0].flags)
        args = _at_tile(square, tile)
        m_plain, dm, want, wins = model_launches.plain(kernel, data, dtype)
    m = kern.launch_kernel(*args, dtype)
    got = kern.launch_backward_kernel(*args, m, dm, dtype)
    torch.cuda.synchronize()
    assert (m_plain > 0).any()
    if dtype == "float32":
        assert torch.equal(m, m_plain)
        assert torch.equal(kern.launch_backward_kernel(
            *args, m, torch.ones_like(dm), dtype)[4], wins)
    else:
        x, y = m.cpu().numpy(), m_plain.cpu().numpy()
        np.testing.assert_allclose(x, y, rtol=2e-2, atol=2e-2)
        assert np.mean(np.abs(x - y) > 1e-4) < 0.01
    assert_grads(got, want, dtype)


# ---------------------------------------------------------------------------
# whole models: the kernel path against the dense plain path, and K5/K6
# against K1/K2, in f32
# ---------------------------------------------------------------------------


def _path_batches(name, dev) -> list:
    """(boxes, scores, valid, classes or None) on ``dev`` of each batch a
    comparison runs: ``serving``, a clustered image of 7/8 N detections
    in each of the serving buckets N = 256-4096; ``evaluation``,
    every batch of config 2's evaluation set (64 images, B=8 N=256);
    ``crowd_b1`` and ``crowd_b2``, the reference's N=4096 oracle batch
    (clustered, detections from 3,900 on padding) of one and two images;
    ``config3``, the first 80-class training batch of config 3 (B=8),
    with its classes."""
    from gossipnet_tpu_torch import evaluate
    from gossipnet_tpu_torch import train as training
    from gossipnet_tpu_torch.config import experiment_path, load_config
    from gossipnet_tpu_torch.data.bucketing import (BatchIterator,
                                                    eval_batches, make_batch)
    from gossipnet_tpu_torch.data.synthetic import (layout_batch,
                                                    layout_record,
                                                    synthetic_roidb)

    def arrays(batch, classes=False):
        t = training.batch_to_device(batch, dev)
        return (t["boxes"], t["scores"], t["valid"],
                t["classes"] if classes else None)

    if name == "serving":
        rng = np.random.default_rng(0)
        return [arrays(make_batch([layout_record(rng, i, "clustered", n)],
                                  padded_n=n))
                for i, n in enumerate((256, 512, 1024, 2048, 4096))]
    if name == "evaluation":
        cfg = load_config(experiment_path("coco_persons_full"),
                          {"data": {"dataset": "synthetic"}})
        return [arrays(b) for b in eval_batches(
            evaluate.load_roidb(cfg), cfg.train.batch_size,
            cfg.data.bucket_sizes)]
    if name in ("crowd_b1", "crowd_b2"):
        batch = layout_batch("clustered", int(name[-1]), 4096, seed=0)
        batch.valid[:, 3900:] = False
        return [arrays(batch)]
    roidb = synthetic_roidb(**dict(CONFIG2_DATA, num_classes=80))
    return [arrays(next(BatchIterator(roidb, 8, (256, 512, 1024))), True)]


def _path_models(experiment, sides, dev) -> list:
    """The two models of a comparison: ``experiment``'s config in f32 with
    each side's (model overrides, pool implementation), on the same
    parameters (``init_params`` of the first side, seed 0)."""
    from gossipnet_tpu_torch import train as training
    from gossipnet_tpu_torch.config import experiment_path, load_config
    from gossipnet_tpu_torch.params import as_state_dict, init_params

    models, params = [], None
    for model, impl in sides:
        cfg = load_config(experiment_path(experiment), {
            "data": {"dataset": "synthetic"},
            "model": {"pair_matmul_dtype": "float32", **model}})
        params = params or as_state_dict(init_params(cfg.model, seed=0))
        net = training.build_model(cfg, impl, dev)
        net.load_state_dict(params)
        models.append((cfg, net))
    return models


TWO_BLOCKS = dict(num_blocks=2, feature_dim=64)   # tests/test_tpu_hw.py:366
# name: (experiment, the two sides, batches, rtol = atol); 1e-3 where 16
# blocks compound the f32 sums' other order, 2e-4 at the reference's
# two-block oracle shape
PATH_CASES = {
    "serving_k1_vs_dense": ("serving_bucketed",
                            (({}, "kernel"), ({}, "dense")), "serving", 1e-3),
    "evaluation_k1_vs_dense": ("coco_persons_full",
                               (({}, "kernel"), ({}, "dense")), "evaluation",
                               1e-3),
    "crowd_two_blocks_k5_vs_k1": (
        "crowded_4096", ((dict(TWO_BLOCKS, pair_kernel=1), "kernel"),
                         (dict(TWO_BLOCKS, pair_kernel=2), "kernel")),
        "crowd_b1", 2e-4),
    "crowd_k5_vs_k1": ("crowded_4096", (({"pair_kernel": 1}, "kernel"),
                                        ({"pair_kernel": 2}, "kernel")),
                       "crowd_b2", 1e-3),
    "config3_k5_vs_k1": ("coco_multiclass", (({"pair_kernel": 1}, "kernel"),
                                             ({"pair_kernel": 2}, "kernel")),
                         "config3", 1e-3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PATH_CASES))
def test_model_paths_agree_on_card(name):
    """f32 logits of two paths through the same model and parameters, on
    every batch: the pair kernel against the dense plain path (the serving
    model in each bucket, config 2 on its evaluation set), and K5 against
    K1 (config 4 at N=4096, also at the reference's two-block oracle
    shape; config 3 with 80 classes); each side launches 16 (or 2) of its
    own pair kernel a forward and the dense path none; on the evaluation
    set, the two APs within 1e-3."""
    from gossipnet_tpu_torch.ops.cuda import pairwise as k5

    dev = _card()
    experiment, sides, batches, tol = PATH_CASES[name]
    models = _path_models(experiment, sides, dev)
    for arrays in _path_batches(batches, dev):
        logits = []
        for (cfg, net), (_, impl) in zip(models, sides):
            before = k1.pair_pool.launches, k5.pair_pool.launches
            with torch.inference_mode():
                logits.append(net(*arrays))
            torch.cuda.synchronize()
            blocks = cfg.model.num_blocks if impl == "kernel" else 0
            pk1 = cfg.model.pair_kernel == 1
            assert (k1.pair_pool.launches - before[0],
                    k5.pair_pool.launches - before[1]) == \
                ((0, blocks) if pk1 else (blocks, 0))
        valid = arrays[2]
        assert bool(torch.isfinite(logits[0][valid]).all())
        torch.testing.assert_close(logits[0], logits[1], rtol=tol, atol=tol)
    if batches == "evaluation":
        # and the AP that evaluate.main reports of each side's scores
        aps = [_evaluation_ap(cfg, net) for cfg, net in models]
        assert 0.0 <= aps[0] <= 1.0
        assert abs(aps[0] - aps[1]) <= 1e-3, aps


def _evaluation_ap(cfg, net) -> float:
    """The COCO AP of ``net``'s scores on ``cfg``'s evaluation set."""
    from gossipnet_tpu_torch import evaluate

    roidb = evaluate.load_roidb(cfg)
    scores = evaluate.rescore_roidb(None, net, roidb, cfg.train.batch_size,
                                    cfg.data.bucket_sizes)
    return evaluate._evaluator_for(roidb, scores_by_image=scores) \
        .summarize()["AP"]


# f32 gradients of two paths, leaf by leaf: elementwise at rtol = atol =
# 1e-3, and each leaf's largest difference at most 1e-3 of its own largest
# entry, so that a leaf of small entries is held to its own scale
GRAD_CASES = {   # name: (experiment, the two sides, synthetic data, batch)
    "config2_kernel_vs_dense": (
        "coco_persons_full", (({}, "kernel"), ({}, "dense")),
        dict(num_images=2, seed=0, num_gt=50, dets_per_gt=8, num_clutter=50),
        2),
    "config4_k5k6_vs_k1k2": (
        "crowded_4096", (({"pair_kernel": 1}, "kernel"),
                         ({"pair_kernel": 2}, "kernel")), CONFIG4_DATA, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_model_gradients_agree_on_card(name):
    """f32 parameter gradients of the training loss through two paths of
    the 16-block model on the same parameters and batch: K1/K2 against the
    dense plain path (config 2, B=2 N=512), and K5/K6 against K1/K2
    (config 4, B=2 N=4096)."""
    from gossipnet_tpu_torch import train as training
    from gossipnet_tpu_torch.data.bucketing import BatchIterator
    from gossipnet_tpu_torch.data.synthetic import synthetic_roidb

    dev = _card()
    experiment, sides, data, b = GRAD_CASES[name]
    grads = []
    for cfg, net in _path_models(experiment, sides, dev):
        batch = training.batch_to_device(next(BatchIterator(
            synthetic_roidb(**data), b, cfg.data.bucket_sizes)), dev)
        loss, _ = training.loss_and_metrics(net, batch, cfg)
        loss.backward()
        grads.append({k: p.grad for k, p in net.named_parameters()})
    assert len(grads[0]) == len(grads[1])
    for k, g in grads[0].items():
        want = grads[1][k]
        torch.testing.assert_close(g, want, rtol=1e-3, atol=1e-3, msg=k)
        assert (g - want).abs().max() <= 1e-3 * want.abs().max(), k
