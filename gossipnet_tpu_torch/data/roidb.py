"""Host-side detection records (numpy copy of ``gossipnet_tpu.data.roidb``).

:class:`ImageRecord` and :class:`Roidb` are ported; the COCO loaders come
with the evaluation slice (ROADMAP.md item 10).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ImageRecord:
    """One image's detections + ground truth, unpadded, host numpy.

    Boxes are xyxy float32. ``det_classes``/``gt_classes`` are contiguous
    labels in [0, num_classes). ``gt_crowd`` marks COCO iscrowd regions.
    """

    image_id: int
    det_boxes: np.ndarray      # [n, 4]
    det_scores: np.ndarray     # [n]
    det_classes: np.ndarray    # [n] int32
    gt_boxes: np.ndarray       # [g, 4]
    gt_classes: np.ndarray     # [g] int32
    gt_crowd: np.ndarray       # [g] bool

    @property
    def num_dets(self) -> int:
        return len(self.det_scores)


@dataclass
class Roidb:
    """A dataset: per-image records + class metadata."""

    records: list[ImageRecord]
    class_names: list[str] = field(default_factory=lambda: ["object"])
    # contiguous label -> original COCO category id (for result export)
    cat_ids: list[int] = field(default_factory=lambda: [1])

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self):
        return iter(self.records)
