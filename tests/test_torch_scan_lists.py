"""The matching scan kernel's algorithm (candidate lists at the lowest
threshold, a prefix per threshold, the overflow path, the walk) in plain
torch, ``matching_scan.scan_lists_reference``, against the JAX Pallas scan
kernels in interpret mode (batched and per image) and the port's plain
scan, ``scan_loop``. Everything compares exactly: matched and best."""

import torch_cpu  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipnet_tpu.ops.pallas.matching_kernel import (
    greedy_scan_pallas,
    greedy_scan_pallas_batched,
)
from gossipnet_tpu_torch.data.bucketing import BatchIterator
from gossipnet_tpu_torch.data.synthetic import synthetic_roidb
from gossipnet_tpu_torch.ops import matching as tm
from gossipnet_tpu_torch.ops.cuda import matching_scan as k3
from tests.test_torch_matching import COCO, _premasked


def _every_row(rng):
    """Every row has a candidate at every COCO threshold."""
    iou = _premasked(rng, 2, 60, 11)
    iou[np.arange(2)[:, None], np.arange(60)[None, :],
        rng.integers(0, 11, (2, 60))] = 0.97
    return iou


def _clustered(rng):
    """What greedy_match_batch hands the scan for a config-2-like batch
    (8 detections per GT around each, clutter, score-sorted, pre-masked),
    at N=128."""
    del rng
    roidb = synthetic_roidb(num_images=2, seed=0, num_gt=12, dets_per_gt=8,
                            num_clutter=16)
    batch = next(BatchIterator(roidb, 2, (128,)))
    scores = np.random.default_rng(0).uniform(
        -3, 3, batch.scores.shape).astype(np.float32)
    seen, keep = [], k3.greedy_scan_batched

    def record(iou, thr):
        seen.append(iou)
        return keep(iou, thr)

    k3.greedy_scan_batched = record
    try:
        tm.greedy_match_batch(
            torch.from_numpy(batch.boxes), torch.from_numpy(scores),
            torch.from_numpy(batch.valid), torch.from_numpy(batch.gt_boxes),
            torch.from_numpy(batch.gt_valid), torch.from_numpy(batch.gt_crowd),
            [0.5], impl="kernel")
    finally:
        k3.greedy_scan_batched = keep
    return seen[0].numpy()


INPUTS = {
    "random": lambda rng: _premasked(rng, 2, 70, 14),
    "ties": lambda rng: _premasked(rng, 2, 70, 14, ties=True),
    "all_zero": lambda rng: np.zeros((2, 40, 9), np.float32),
    "every_row": _every_row,
    "clustered": _clustered,
}
CASES = [(name, 32) for name in INPUTS] + [("random", 2), ("ties", 2)]


@pytest.mark.parametrize("thr", [[0.5], list(COCO)], ids=["t1", "t10"])
@pytest.mark.parametrize("name,cap", CASES,
                         ids=[f"{n}_cap{c}" for n, c in CASES])
def test_scan_lists_match_the_reference_scans(rng, name, cap, thr):
    thr = np.asarray(thr, np.float32)
    iou = INPUTS[name](rng)
    iou_t, thr_t = torch.from_numpy(iou), torch.from_numpy(thr)
    got = k3.scan_lists_reference(iou_t, thr_t, cap=cap)
    want = greedy_scan_pallas_batched(jnp.asarray(iou), jnp.asarray(thr),
                                      interpret=True)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for x, y in zip(got, k3.scan_loop(iou_t, thr_t)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    one = greedy_scan_pallas(jnp.asarray(iou[1]), jnp.asarray(thr),
                             interpret=True)
    for x, y in zip(got, one):
        np.testing.assert_array_equal(x[1].numpy(), np.asarray(y))
    count = (iou >= thr.min()).sum(axis=2)
    if name == "all_zero":
        assert not got[0].any() and bool((got[1] == -1).all())
    else:
        assert got[0].any()
    if cap == 2:   # the overflow path ran, and so did the list path
        assert (count > cap).any() and ((count > 0) & (count <= cap)).any()
    if name == "every_row":
        assert (count > 0).all()
