"""Classic greedy NMS, the baseline GossipNet replaces (port of
``gossipnet_tpu/ops/nms.py``).

GreedyNMS remains the baseline every evaluation compares against. Provided
in two forms:

- ``greedy_nms_np``, ``greedy_nms_multi_np``, ``greedy_nms_host``: host
  numpy (float64), the reference's code unchanged, used by the evaluation
  baselines; ``greedy_nms_host`` takes the native C++ sweep when the
  library loads.
- ``greedy_nms``: a torch version over padded arrays on the tensors' own
  device (suppression as a keep mask over the score-sorted order), for a
  pipeline that wants the heuristic beside the learned rescorer.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from gossipnet_tpu_torch.ops.geometry import pairwise_iou


def greedy_nms_np(
    boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.5
) -> np.ndarray:
    """Indices of kept boxes, descending score order. O(N^2) host loop."""
    order = np.argsort(-scores, kind="stable")
    boxes = boxes.astype(np.float64)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    keep = []
    suppressed = np.zeros(len(scores), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order])
        yy1 = np.maximum(y1[i], y1[order])
        xx2 = np.minimum(x2[i], x2[order])
        yy2 = np.minimum(y2[i], y2[order])
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        union = areas[i] + areas[order] - inter
        iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
        suppressed[order[iou > iou_threshold]] = True
        suppressed[i] = False
    return np.asarray(keep, np.int64)


def greedy_nms_multi_np(
    boxes: np.ndarray, scores: np.ndarray, thresholds: np.ndarray
) -> list[np.ndarray]:
    """Greedy NMS keep-indices for MANY thresholds in one pass.

    Equivalent to ``[greedy_nms_np(boxes, scores, t) for t in
    thresholds]`` but computes the O(N^2) IoU matrix once and runs a
    single score-ordered scan with a [T] threshold axis (a det can be
    alive under one threshold and suppressed under another; the alive
    mask per threshold gates who suppresses). This is what makes the
    eval CLI's ``--nms-sweep`` baseline one IoU pass instead of T.
    """
    thresholds = np.asarray(thresholds, np.float64)
    order = np.argsort(-scores, kind="stable")
    b = boxes.astype(np.float64)[order]
    n, t = len(order), len(thresholds)
    if n == 0:
        return [np.empty(0, np.int64) for _ in range(t)]
    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    areas = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    # full IoU in sorted order, computed once
    xx1 = np.maximum(x1[:, None], x1[None, :])
    yy1 = np.maximum(y1[:, None], y1[None, :])
    xx2 = np.minimum(x2[:, None], x2[None, :])
    yy2 = np.minimum(y2[:, None], y2[None, :])
    inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
    union = areas[:, None] + areas[None, :] - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)

    suppressed = np.zeros((t, n), bool)
    later = np.zeros(n, bool)
    for i in range(n):
        alive = ~suppressed[:, i]                      # [T]
        if not alive.any():
            continue
        later[:] = False
        later[i + 1:] = True
        # thresholds where i survives suppress every LATER det whose
        # IoU with i exceeds that threshold
        supp = (alive[:, None]
                & later[None, :]
                & (iou[i][None, :] > thresholds[:, None]))
        suppressed |= supp
    return [order[~suppressed[k]] for k in range(t)]


def greedy_nms_host(
    boxes: np.ndarray, scores: np.ndarray, thresholds: np.ndarray
) -> list[np.ndarray]:
    """Host-side threshold sweep, fastest available implementation:
    the native C++ shared-IoU scan
    (``native/gossip_native.cc::greedy_nms_multi``, one IoU pass for
    all T thresholds, ~25x the numpy loop at N=700) when the .so is
    loadable, else :func:`greedy_nms_multi_np`. Both paths compute in
    f64 with the identical formula, so the keep sets are BIT-IDENTICAL
    regardless of whether the native build is present (pinned in
    tests/test_nms_sweep.py) — the swept-NMS baseline cannot depend on
    the host.

    Precondition: scores must be FINITE. The C++ comparator now sorts
    NaN last like np.argsort (a raw ``>`` with NaN is not a strict
    weak ordering, which is UB for std::stable_sort), but +/-inf can
    still interact with the -1e30 sentinel conventions, so the
    host-independence guarantee is stated only on its real domain —
    detector scores — and this entry refuses anything else.
    """
    scores = np.asarray(scores)
    if scores.size and not np.isfinite(scores).all():
        raise ValueError(
            "greedy_nms_host requires finite scores (NaN/inf break the "
            "bit-identical native/numpy ordering guarantee)")
    from gossipnet_tpu_torch import native

    if native.available():
        return native.greedy_nms_multi(boxes, scores, thresholds)
    return greedy_nms_multi_np(boxes, scores, thresholds)


def greedy_nms(
    boxes: Tensor,
    scores: Tensor,
    valid: Tensor,
    iou_threshold: float = 0.5,
) -> Tensor:
    """Greedy NMS over padded inputs -> keep mask [N] (bool), on the
    device of ``boxes``.

    Detections are scanned in descending-score order (stable, padding
    last); each kept detection suppresses later ones with IoU > threshold.
    The scan queues N small operations and never waits for the device.
    """
    n = scores.shape[0]
    order = torch.argsort(
        -torch.where(valid, scores, torch.full_like(scores, -torch.inf)),
        stable=True)
    iou = pairwise_iou(boxes[order], boxes[order])
    thr = torch.tensor(iou_threshold, dtype=iou.dtype, device=iou.device)
    # over[i, j]: i would suppress the later j
    over = torch.triu(iou > thr, diagonal=1)
    valid_sorted = valid[order]
    keep = valid_sorted.clone()
    for i in range(n):
        keep_i = valid_sorted[i] & keep[i]
        keep = keep & ~(over[i] & keep_i)
    out = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    out[order] = keep
    return out
