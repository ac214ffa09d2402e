"""Greedy matching: the port's scan and kernel routes (the kernel's plain
version on the CPU) against the JAX scan and the JAX Pallas scan kernels in
interpret mode. Everything compares exactly: labels, ignore, matched_gt,
and the kernels' matched/best."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gossipnet_tpu.ops.matching import greedy_match as j_match
from gossipnet_tpu.ops.matching import greedy_match_batch as j_match_batch
from gossipnet_tpu.ops.pallas.matching_kernel import (
    greedy_scan_pallas,
    greedy_scan_pallas_batched,
)
from gossipnet_tpu_torch.ops import matching as tm
from gossipnet_tpu_torch.ops.cuda import matching_scan as k3
from tests.test_matching import _random_problem

COCO = np.round(np.arange(0.5, 0.951, 0.05), 2).astype(np.float32)


def _batch(rng, b=2, n=48, g=12, crowd_frac=0.2, classes=0, pad_g=0):
    probs = [_random_problem(rng, n=n, g=g, crowd_frac=crowd_frac)
             for _ in range(b)]
    arrays = [np.stack([p[k] for p in probs]) for k in range(6)]
    if pad_g:                                       # padded GT columns
        arrays[3] = np.concatenate(
            [arrays[3], np.zeros((b, pad_g, 4), np.float32)], axis=1)
        for k in (4, 5):
            arrays[k] = np.concatenate(
                [arrays[k], np.zeros((b, pad_g), bool)], axis=1)
    cls = None
    if classes:
        cls = (rng.integers(0, classes, (b, n)).astype(np.int32),
               rng.integers(0, classes, (b, g + pad_g)).astype(np.int32))
    return arrays, cls


def _assert_same(port, jax_result):
    for got, want in zip(port, jax_result):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


CASES = {
    "t1": dict(thr=[0.5]),
    "t10_crowded": dict(thr=COCO, crowd_frac=0.4, n=64, g=16),
    "class_aware": dict(thr=[0.5, 0.75], classes=3),
    "padded_gt": dict(thr=[0.5], pad_g=5),
    "class_aware_t10": dict(thr=COCO, classes=2, pad_g=3),
}


@pytest.mark.parametrize("impl", ["scan", "kernel"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_batch_matches_jax(rng, name, impl):
    case = dict(CASES[name])
    thr = np.asarray(case.pop("thr"), np.float32)
    arrays, cls = _batch(rng, **case)
    j_cls = (None, None) if cls is None else tuple(map(jnp.asarray, cls))
    t_cls = (None, None) if cls is None else tuple(map(torch.from_numpy, cls))
    want = j_match_batch(*map(jnp.asarray, arrays), jnp.asarray(thr), *j_cls,
                         impl="pallas" if impl == "kernel" else "scan")
    got = tm.greedy_match_batch(*map(torch.from_numpy, arrays),
                                torch.from_numpy(thr), *t_cls, impl=impl)
    _assert_same(got, want)
    assert got.labels.sum() > 0


@pytest.mark.parametrize("impl", ["scan", "kernel"])
def test_single_image_matches_jax(rng, impl):
    boxes, scores, valid, gt, gt_valid, gt_crowd = _random_problem(
        rng, n=40, g=10, crowd_frac=0.3)
    args = (boxes, scores, valid, gt, gt_valid, gt_crowd, COCO[:4])
    want = j_match(*map(jnp.asarray, args),
                   impl="pallas" if impl == "kernel" else "scan")
    got = tm.greedy_match(*map(torch.from_numpy, args), impl=impl)
    _assert_same(got, want)


def test_default_routes_and_zero_threshold(rng):
    """impl=None: the scan on CPU tensors, and t <= 0 always to the scan
    (the reference's own routing); impl='kernel' with t <= 0 raises."""
    arrays, _ = _batch(rng)
    for thr in ([0.0, 0.5], [-0.1]):
        t_thr = np.asarray(thr, np.float32)
        want = j_match_batch(*map(jnp.asarray, arrays), jnp.asarray(t_thr))
        got = tm.greedy_match_batch(*map(torch.from_numpy, arrays), thr)
        _assert_same(got, want)
        with pytest.raises(ValueError, match="thresholds > 0"):
            tm.greedy_match_batch(*map(torch.from_numpy, arrays), thr,
                                  impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        tm.greedy_match_batch(*map(torch.from_numpy, arrays), [0.5],
                              impl="pallas")


def _premasked(rng, b, n, g, ties=False):
    iou = rng.uniform(0, 1, (b, n, g)).astype(np.float32)
    iou[rng.uniform(size=(b, n, g)) < 0.5] = 0.0
    iou[:, ::5] = 0.0                              # masked detections
    if ties:                                        # duplicated values
        iou = np.round(iou * 8) / 8
        iou[..., 1::2] = iou[..., 0::2][..., :g // 2]
    return iou


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("thr", [[0.5], list(COCO)], ids=["t1", "t10"])
def test_plain_scan_kernels_match_pallas_interpret(rng, ties, thr):
    """K3/K4's plain version against the JAX Pallas kernels in interpret
    mode, duplicated IoU values exercising the first-index tie-break."""
    thr = np.asarray(thr, np.float32)
    iou = _premasked(rng, 2, 70, 14, ties=ties)
    want = greedy_scan_pallas_batched(jnp.asarray(iou), jnp.asarray(thr),
                                      interpret=True)
    got = k3.greedy_scan_batched(torch.from_numpy(iou), torch.from_numpy(thr))
    _assert_same(got, want)
    want1 = greedy_scan_pallas(jnp.asarray(iou[0]), jnp.asarray(thr),
                               interpret=True)
    got1 = k3.greedy_scan(torch.from_numpy(iou[0]), torch.from_numpy(thr))
    _assert_same(got1, want1)
    if ties:
        assert (got[1] >= 0).any()


def test_scan_kernels_never_fall_back_off_cpu():
    iou = torch.zeros((1, 4, 3))
    thr = torch.tensor([0.5])
    before = (k3.greedy_scan_batched.launches, k3.greedy_scan.launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        k3.launch_kernel(iou, thr)
    with pytest.raises(ValueError, match="> 0"):
        k3.greedy_scan_batched(iou, torch.tensor([0.0]))
    assert (k3.greedy_scan_batched.launches, k3.greedy_scan.launches) == before
