"""Greedy det<->GT matching (port of ``gossipnet_tpu/ops/matching.py``).

Detections sorted by descending predicted score each take the best
still-unmatched ground truth with IoU >= threshold, per threshold,
mirroring COCO evaluation matching (paper §4). Labels are targets: the
scores arrive detached. Crowd GTs follow pycocotools: a detection that
matches no real GT but lies inside an ``iscrowd`` region (IoF >= t) is
ignored (zero loss weight), not counted negative.

Two implementations, both exact and with the same tie-break (first GT
index among maxima):

- ``"scan"``: the reference's ``lax.scan`` body as a loop over the sorted
  detections, with the exclusions (real GT, same class, valid detection)
  explicit, so it stays right for any threshold, t <= 0 included;
- ``"kernel"``: the exclusions fold into zeroed IoU and the scan runs in
  K3 (batched) or K4 (one image), ``ops/cuda/matching_scan.py``. It needs
  every threshold > 0.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import Tensor

from gossipnet_tpu_torch.ops.cuda import matching_scan
from gossipnet_tpu_torch.ops.cuda.matching_scan import (
    Thresholds,
    split_thresholds,
)
from gossipnet_tpu_torch.ops.geometry import pairwise_iof, pairwise_iou

NEG_INF = -1e30
IMPLS = ("scan", "kernel")


class MatchResult(NamedTuple):
    """Per-threshold matching outcome, all ``[T, N]`` (batched ``[B, T, N]``).

    labels:     1.0 where the detection matched a (non-crowd) GT, else 0.0.
    ignore:     True where the detection gets zero loss weight (padding,
                or an unmatched detection covered by a crowd region).
    matched_gt: index of the matched GT, -1 if unmatched.
    """

    labels: Tensor
    ignore: Tensor
    matched_gt: Tensor


def kernel_domain_ok(thresholds: Tensor) -> bool:
    """The kernel folds every exclusion into zeroed IoU, so t <= 0 would
    match padding, crowd and wrong-class GTs: True when all t > 0."""
    return bool((thresholds > 0.0).all())


def _require_kernel_domain(thresholds: Tensor) -> None:
    if not kernel_domain_ok(thresholds):
        raise ValueError(
            "matching impl='kernel' requires all IoU thresholds > 0 "
            "(exclusions are folded into zeroed IoU rows; t <= 0 would "
            "match padding/crowd rows) — use impl='scan' for t <= 0, "
            f"got {thresholds.tolist()}")


def _by_score(scores: Tensor, valid: Tensor) -> tuple[Tensor, Tensor]:
    """(order, inverse) of the descending-score sort, padding last."""
    key = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.argsort(-key, dim=-1, stable=True)
    return order, torch.argsort(order, dim=-1)


def _rows(x: Tensor, order: Tensor) -> Tensor:
    """x [B, N, ...] in ``order`` along N."""
    idx = order.reshape(order.shape + (1,) * (x.ndim - 2)).expand_as(x)
    return torch.gather(x, 1, idx)


def _unsort(x_sorted: Tensor, inv: Tensor) -> Tensor:
    """[B, N, T] in score order -> [B, T, N] in detection order."""
    return _rows(x_sorted, inv).transpose(1, 2)


def _overlaps(boxes, gt_boxes, det_classes, gt_classes):
    iou = pairwise_iou(boxes, gt_boxes)                     # [B, N, G]
    iof = pairwise_iof(boxes, gt_boxes)
    same = None
    if det_classes is not None and gt_classes is not None:
        same = det_classes[:, :, None] == gt_classes[:, None, :]
        iou = torch.where(same, iou, torch.zeros_like(iou))
        iof = torch.where(same, iof, torch.zeros_like(iof))
    return iou, iof, same


def _match_scan(boxes, scores, valid, gt_boxes, gt_valid, gt_crowd, thr,
                det_classes, gt_classes) -> MatchResult:
    """The scan path, batched -> [B, T, N] (``matching.py:120-233``)."""
    iou, iof, same = _overlaps(boxes, gt_boxes, det_classes, gt_classes)
    if same is None:
        same = torch.ones(iou.shape, dtype=torch.bool, device=iou.device)
    real_gt = gt_valid & ~gt_crowd                          # [B, G]
    crowd_gt = gt_valid & gt_crowd
    thr_d = thr.device
    order, inv = _by_score(scores, valid)
    eligible = (real_gt[:, None, :] & _rows(same, order)
                & _rows(valid, order)[..., None])
    matched_s, best_s = matching_scan.scan_loop(_rows(iou, order), thr_d,
                                                eligible)
    matched = _unsort(matched_s, inv)                       # [B, T, N]
    # Ignore: padding; unmatched detections covered by a same-class crowd
    # GT with IoF >= t, in the EXISTENCE form (right at t <= 0 too).
    crowd_hit = (crowd_gt[:, None, None, :] & same[:, None]
                 & (iof[:, None] >= thr_d[None, :, None, None]))
    ignore = (~valid)[:, None, :] | (~matched & crowd_hit.any(dim=3))
    return MatchResult(labels=matched.float(), ignore=ignore,
                       matched_gt=_unsort(best_s, inv))


def _match_kernel(boxes, scores, valid, gt_boxes, gt_valid, gt_crowd, thr,
                  det_classes, gt_classes, scan) -> MatchResult:
    """The kernel path, batched -> [B, T, N]
    (``_greedy_match_batched_pallas:236``): IoU, sort and unsort in torch
    around the scan kernel ``scan`` (K3, or K4 per image)."""
    _require_kernel_domain(thr.host)
    iou, iof, _ = _overlaps(boxes, gt_boxes, det_classes, gt_classes)
    real_gt = gt_valid & ~gt_crowd
    crowd_gt = gt_valid & gt_crowd
    crowd_overlap = torch.where(crowd_gt[:, None, :], iof,
                                torch.zeros_like(iof))
    max_crowd = (crowd_overlap.amax(dim=2) if crowd_overlap.shape[2]
                 else torch.zeros_like(scores))             # [B, N]
    order, inv = _by_score(scores, valid)
    iou_masked = (_rows(iou, order)
                  * _rows(valid, order)[..., None].to(iou.dtype)
                  * real_gt[:, None, :].to(iou.dtype))
    matched_s, best_s = scan(iou_masked.contiguous(), thr)
    matched = _unsort(matched_s, inv)
    thr_d = thr.device
    crowd_ignore = ~matched & (max_crowd[:, None, :] >= thr_d[None, :, None])
    ignore = (~valid)[:, None, :] | crowd_ignore
    return MatchResult(labels=matched.float(), ignore=ignore,
                       matched_gt=_unsort(best_s, inv))


def _k4(iou_masked: Tensor, thr: Thresholds):
    matched, best = matching_scan.greedy_scan(iou_masked[0], thr)
    return matched[None], best[None]


def greedy_match(boxes: Tensor, scores: Tensor, valid: Tensor,
                 gt_boxes: Tensor, gt_valid: Tensor, gt_crowd: Tensor,
                 thresholds: Tensor | Sequence[float] | Thresholds,
                 det_classes: Tensor | None = None,
                 gt_classes: Tensor | None = None,
                 impl: str | None = None) -> MatchResult:
    """Greedy score-ordered matching of N detections to G ground truths of
    one image -> MatchResult of [T, N].

    boxes [N, 4] xyxy, scores [N] (current predictions), valid [N] bool,
    gt_boxes [G, 4], gt_valid [G], gt_crowd [G], thresholds [T];
    det_classes [N] / gt_classes [G] make it class-aware.
    ``impl``: None = "scan" (the reference's unbatched default), "kernel"
    = K4 (thresholds > 0; its plain version on CPU tensors).
    """
    impl = impl or "scan"
    if impl not in IMPLS:
        raise ValueError(f"unknown matching impl {impl!r}; options: {IMPLS}")
    thr = split_thresholds(thresholds, boxes.device)

    def batch(x):
        return None if x is None else x[None]

    args = (boxes[None], scores[None], valid[None], gt_boxes[None],
            gt_valid[None], gt_crowd[None], thr, batch(det_classes),
            batch(gt_classes))
    out = (_match_kernel(*args, scan=_k4) if impl == "kernel"
           else _match_scan(*args))
    return MatchResult(*(x[0] for x in out))


def greedy_match_batch(boxes: Tensor, scores: Tensor, valid: Tensor,
                       gt_boxes: Tensor, gt_valid: Tensor, gt_crowd: Tensor,
                       thresholds: Tensor | Sequence[float] | Thresholds,
                       det_classes: Tensor | None = None,
                       gt_classes: Tensor | None = None,
                       impl: str | None = None) -> MatchResult:
    """Batched matching -> MatchResult of [B, T, N]; the entry the training
    loss uses. ``thresholds`` as a :class:`Thresholds` pair reach the
    device without a copy (a captured step passes them so).

    ``impl``: None = K3 ("kernel") on CUDA tensors, the scan on CPU
    tensors; thresholds t <= 0 go to the scan either way (reference
    semantics: the kernel cannot represent them). "scan" | "kernel" force
    a path; "kernel" with t <= 0 raises.
    """
    thr = split_thresholds(thresholds, boxes.device)
    if impl is None:
        impl = "kernel" if boxes.device.type == "cuda" else "scan"
        if not kernel_domain_ok(thr.host):
            impl = "scan"
    if impl not in IMPLS:
        raise ValueError(f"unknown matching impl {impl!r}; options: {IMPLS}")
    args = (boxes, scores, valid, gt_boxes, gt_valid, gt_crowd, thr,
            det_classes, gt_classes)
    if impl == "kernel":
        return _match_kernel(*args, scan=matching_scan.greedy_scan_batched)
    return _match_scan(*args)
