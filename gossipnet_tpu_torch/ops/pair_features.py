"""Handcrafted pair features g_ij (port of ``gossipnet_tpu.ops.pair_features``).

The feature math is written over broadcastable column tensors, so one
definition serves the dense path (full [N, N] broadcasting) and the pair
kernel's plain version. Order: iou, dx/w_i, dy/h_i, log(w_j/w_i),
log(h_j/h_i), log-aspect diff, s_i, s_j[, class-match].
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

NUM_PAIR_FEATURES = 8
NUM_PAIR_FEATURES_MC = 9

_EPS = 1e-6       # union clamp of the IoU
_MIN_SIZE = 1e-3  # width/height clamp of a degenerate box


class DetColumns(NamedTuple):
    """Per-detection geometry columns, each ``[..., N]``."""

    x1: Tensor
    y1: Tensor
    x2: Tensor
    y2: Tensor
    cx: Tensor
    cy: Tensor
    w: Tensor
    h: Tensor
    log_w: Tensor
    log_h: Tensor
    log_aspect: Tensor
    area: Tensor
    score: Tensor
    valid: Tensor  # 1.0 / 0.0


NUM_COLUMNS = len(DetColumns._fields)


def det_columns(boxes: Tensor, scores: Tensor, valid: Tensor) -> DetColumns:
    """Build DetColumns from ``[..., N, 4]`` xyxy boxes + ``[..., N]`` scores."""
    x1, y1 = boxes[..., 0], boxes[..., 1]
    x2, y2 = boxes[..., 2], boxes[..., 3]
    w = torch.clamp(x2 - x1, min=_MIN_SIZE)
    h = torch.clamp(y2 - y1, min=_MIN_SIZE)
    return DetColumns(
        x1=x1, y1=y1, x2=x2, y2=y2,
        cx=x1 + 0.5 * w, cy=y1 + 0.5 * h,
        w=w, h=h,
        log_w=torch.log(w), log_h=torch.log(h),
        log_aspect=torch.log(w) - torch.log(h),
        area=w * h,
        score=scores,
        valid=valid.to(boxes.dtype),
    )


def stack_columns(cols: DetColumns) -> Tensor:
    """Stack to ``[..., NUM_COLUMNS, N]``."""
    return torch.stack(list(cols), dim=-2)


def unstack_columns(arr: Tensor) -> DetColumns:
    """Inverse of :func:`stack_columns` over the -2 axis."""
    return DetColumns(*[arr[..., k, :] for k in range(NUM_COLUMNS)])


def pair_iou(ci: DetColumns, cj: DetColumns) -> Tensor:
    """IoU between broadcastable row/col columns (e.g. [N,1] vs [1,N]).

    Each operation is its own eager op, so nothing contracts into an FMA:
    the pair kernel computes the same bits with ``__fmul_rn`` and friends.
    """
    ix = torch.clamp(torch.minimum(ci.x2, cj.x2)
                     - torch.maximum(ci.x1, cj.x1), min=0.0)
    iy = torch.clamp(torch.minimum(ci.y2, cj.y2)
                     - torch.maximum(ci.y1, cj.y1), min=0.0)
    inter = ix * iy
    union = ci.area + cj.area - inter
    return inter / torch.clamp(union, min=_EPS)


def pair_feature_list(
    ci: DetColumns,
    cj: DetColumns,
    iou: Tensor | None = None,
    class_match: Tensor | None = None,
) -> list[Tensor]:
    """Pair features as a list of broadcast ``[..., NI, NJ]`` tensors."""
    if iou is None:
        iou = pair_iou(ci, cj)
    feats = [
        iou,
        (cj.cx - ci.cx) / ci.w,
        (cj.cy - ci.cy) / ci.h,
        cj.log_w - ci.log_w,
        cj.log_h - ci.log_h,
        cj.log_aspect - ci.log_aspect,
        torch.broadcast_to(ci.score, iou.shape),
        torch.broadcast_to(cj.score, iou.shape),
    ]
    if class_match is not None:
        feats.append(torch.broadcast_to(class_match, iou.shape).to(iou.dtype))
    return feats


def pair_features(ci: DetColumns, cj: DetColumns, iou: Tensor | None = None,
                  class_match: Tensor | None = None) -> Tensor:
    """Pair feature tensor ``[..., G]`` (stacked :func:`pair_feature_list`)."""
    return torch.stack(
        pair_feature_list(ci, cj, iou=iou, class_match=class_match), dim=-1)


def _rows(cols: DetColumns) -> DetColumns:
    return DetColumns(*[c[..., :, None] for c in cols])


def _cols(cols: DetColumns) -> DetColumns:
    return DetColumns(*[c[..., None, :] for c in cols])


def dense_pair_tensor(
    cols: DetColumns,
    neighbor_iou: float,
    classes: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """Full dense pair features + neighbor mask for one batch of images.

    Returns ``(g [..., N, N, G], mask [..., N, N])``; mask is True for
    IoU >= threshold (self-pairs included) with both detections valid.
    """
    ri, cj = _rows(cols), _cols(cols)
    iou = pair_iou(ri, cj)
    class_match = None
    if classes is not None:
        class_match = classes[..., :, None] == classes[..., None, :]
    g = pair_features(ri, cj, iou=iou, class_match=class_match)
    # the threshold as a Python number, compared in float32 as a tensor
    # of it would be: a captured forward cannot hold a host tensor's copy
    mask = (iou >= neighbor_iou) & (ri.valid > 0) & (cj.valid > 0)
    return g, mask
