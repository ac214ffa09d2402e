"""Box geometry: areas, pairwise IoU / IoF, format conversion (port of
``gossipnet_tpu/ops/geometry.py``).

Box format: ``[x1, y1, x2, y2]`` float, with ``x2 >= x1`` and ``y2 >= y1``
for non-degenerate boxes. Degenerate/padded boxes (zeros) yield zero area
and zero IoU against everything, so padding is inert by construction. The
operations are the reference's, in its order, so the results agree with it
bit for bit.
"""

from __future__ import annotations

import torch
from torch import Tensor


def box_area(boxes: Tensor) -> Tensor:
    """Area of ``[..., 4]`` xyxy boxes; clamped at zero for degenerate boxes."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def _pairwise_intersection(a: Tensor, b: Tensor) -> Tensor:
    """Intersection areas of ``[..., N, 4]`` x ``[..., M, 4]`` -> ``[..., N, M]``."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(a: Tensor, b: Tensor) -> Tensor:
    """Dense IoU matrix ``[..., N, M]`` for xyxy boxes ``a: [..., N, 4]``,
    ``b: [..., M, 4]`` (leading batch dimensions broadcast).

    Zero-area pairs return IoU 0 (guarded divide), so padded rows/cols are 0.
    """
    inter = _pairwise_intersection(a, b)
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return torch.where(union > 0.0, inter / torch.clamp(union, min=1e-12),
                       torch.zeros_like(inter))


def pairwise_iof(a: Tensor, b: Tensor) -> Tensor:
    """Intersection-over-foreground ``inter(a, b) / area(a)`` -> ``[..., N, M]``:
    COCO's crowd overlap, how much of the detection a crowd region covers."""
    inter = _pairwise_intersection(a, b)
    area = box_area(a)[..., :, None]
    return torch.where(area > 0.0, inter / torch.clamp(area, min=1e-12),
                       torch.zeros_like(inter))


def xywh_to_xyxy(boxes: Tensor) -> Tensor:
    """COCO ``[x, y, w, h]`` -> ``[x1, y1, x2, y2]``."""
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([x, y, x + w, y + h], dim=-1)


def xyxy_to_xywh(boxes: Tensor) -> Tensor:
    """``[x1, y1, x2, y2]`` -> COCO ``[x, y, w, h]``."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)


def box_center_size(boxes: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Centers and sizes ``(cx, cy, w, h)`` of xyxy boxes, each ``[...]``."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h, w, h
