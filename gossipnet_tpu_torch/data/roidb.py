"""Host-side detection records (numpy copy of ``gossipnet_tpu.data.roidb``).

Only :class:`ImageRecord` is ported so far; the COCO loaders come with the
evaluation slice (ROADMAP.md item 10).
"""

from __future__ import annotations

from dataclasses import dataclass

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
