"""Static-shape batch assembly (numpy copy of
``gossipnet_tpu.data.bucketing``'s ``Batch``, ``bucket_for`` and
``make_batch``).

Every image is padded to the smallest bucket of
``DataConfig.bucket_sizes`` that fits it; images sharing a bucket stack
into [B, N, ...] batches. The training iterators come with the training
slice.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from gossipnet_tpu_torch.data.roidb import ImageRecord


class Batch(NamedTuple):
    """Padded host-side batch; field names match model/matching inputs."""

    image_ids: np.ndarray    # [B]
    boxes: np.ndarray        # [B, N, 4] xyxy
    scores: np.ndarray       # [B, N]
    valid: np.ndarray        # [B, N] bool
    classes: np.ndarray      # [B, N] int32
    gt_boxes: np.ndarray     # [B, G, 4]
    gt_classes: np.ndarray   # [B, G] int32
    gt_valid: np.ndarray     # [B, G] bool
    gt_crowd: np.ndarray     # [B, G] bool


def bucket_for(n: int, bucket_sizes: Sequence[int]) -> int:
    """Smallest bucket >= n (largest bucket if none fits — caller should
    have capped detections already)."""
    for b in sorted(bucket_sizes):
        if n <= b:
            return b
    return max(bucket_sizes)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def make_batch(
    records: Sequence[ImageRecord],
    padded_n: int,
    padded_g: int | None = None,
    gt_align: int = 16,
) -> Batch:
    """Stack records into one padded batch.

    GT padding is rounded up to ``gt_align`` across the batch unless
    ``padded_g`` is forced.
    """
    b = len(records)
    if padded_g is None:
        max_g = max((len(r.gt_classes) for r in records), default=0)
        padded_g = max(_round_up(max_g, gt_align), gt_align)

    out = Batch(
        image_ids=np.zeros(b, np.int64),
        boxes=np.zeros((b, padded_n, 4), np.float32),
        scores=np.zeros((b, padded_n), np.float32),
        valid=np.zeros((b, padded_n), bool),
        classes=np.zeros((b, padded_n), np.int32),
        gt_boxes=np.zeros((b, padded_g, 4), np.float32),
        gt_classes=np.zeros((b, padded_g), np.int32),
        gt_valid=np.zeros((b, padded_g), bool),
        gt_crowd=np.zeros((b, padded_g), bool),
    )
    for i, r in enumerate(records):
        n = min(r.num_dets, padded_n)
        g = min(len(r.gt_classes), padded_g)
        out.image_ids[i] = r.image_id
        out.boxes[i, :n] = r.det_boxes[:n]
        out.scores[i, :n] = r.det_scores[:n]
        out.valid[i, :n] = True
        out.classes[i, :n] = r.det_classes[:n]
        out.gt_boxes[i, :g] = r.gt_boxes[:g]
        out.gt_classes[i, :g] = r.gt_classes[:g]
        out.gt_valid[i, :g] = True
        out.gt_crowd[i, :g] = r.gt_crowd[:g]
    return out
