"""Host-side dataset records ("roidb") and COCO-format loaders (numpy copy
of ``gossipnet_tpu.data.roidb``, code unchanged).

COCO annotation and result JSON is parsed with the stdlib (no
pycocotools), detections load from COCO-results JSON or NPZ, and
everything stays host-side numpy. Detections are capped per image by
score; ``iscrowd`` GT is kept and flagged; class ids are remapped to a
contiguous [0, num_classes) label space (persons only, or all 80).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

PERSON_CATEGORY_ID = 1  # COCO category id for 'person'


@dataclass
class ImageRecord:
    """One image's detections + ground truth, unpadded, host numpy.

    Boxes are xyxy float32. ``det_classes``/``gt_classes`` are contiguous
    labels in [0, num_classes). ``gt_crowd`` marks COCO iscrowd regions
    (excluded from matching as positives; overlap with them ignores a
    detection — SURVEY.md §2.1 #3, #6).
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

    def capped(self, max_dets: int) -> "ImageRecord":
        """Keep the top-``max_dets`` detections by score (reference's
        per-image score-based capping)."""
        if self.num_dets <= max_dets:
            return self
        keep = np.argsort(-self.det_scores, kind="stable")[:max_dets]
        return ImageRecord(
            image_id=self.image_id,
            det_boxes=self.det_boxes[keep],
            det_scores=self.det_scores[keep],
            det_classes=self.det_classes[keep],
            gt_boxes=self.gt_boxes,
            gt_classes=self.gt_classes,
            gt_crowd=self.gt_crowd,
        )


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


def _xywh_to_xyxy_np(b: np.ndarray) -> np.ndarray:
    b = np.asarray(b, np.float32).reshape(-1, 4)
    out = b.copy()
    out[:, 2] = b[:, 0] + b[:, 2]
    out[:, 3] = b[:, 1] + b[:, 3]
    return out


def _coco_categories(coco: dict, person_only: bool) -> list[dict]:
    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    if person_only:
        cats = [c for c in cats if c["id"] == PERSON_CATEGORY_ID]
        if not cats:
            cats = [{"id": PERSON_CATEGORY_ID, "name": "person"}]
    return cats


def coco_cat_ids(coco: dict, person_only: bool = True) -> list[int]:
    """The training label rule: label k = k-th id of the sorted category
    list (persons subset or all). Exposed so serving-time category
    mapping (scripts/serve.py) uses EXACTLY the same rule as training."""
    return [c["id"] for c in _coco_categories(coco, person_only)]


def load_coco_gt(
    ann_file: str, person_only: bool = True
) -> tuple[dict[int, dict], list[str], list[int]]:
    """Parse a COCO annotation JSON (stdlib only).

    Returns (per-image gt dict keyed by image_id, class_names, cat_ids).
    """
    with open(ann_file) as f:
        coco = json.load(f)
    cats = _coco_categories(coco, person_only)
    cat_ids = [c["id"] for c in cats]
    class_names = [c["name"] for c in cats]
    cat_to_label = {cid: i for i, cid in enumerate(cat_ids)}

    per_image: dict[int, dict] = {
        img["id"]: {"boxes": [], "classes": [], "crowd": []}
        for img in coco.get("images", [])
    }
    for ann in coco.get("annotations", []):
        cid = ann["category_id"]
        if cid not in cat_to_label:
            continue
        rec = per_image.setdefault(
            ann["image_id"], {"boxes": [], "classes": [], "crowd": []}
        )
        rec["boxes"].append(ann["bbox"])           # xywh
        rec["classes"].append(cat_to_label[cid])
        rec["crowd"].append(bool(ann.get("iscrowd", 0)))
    return per_image, class_names, cat_ids


def load_detections(
    det_file: str, cat_ids: list[int]
) -> dict[int, dict]:
    """Load precomputed detections (the FRCN outputs of the reference).

    Formats:
      - COCO results JSON: list of {image_id, category_id, bbox(xywh),
        score}.
      - NPZ with arrays image_ids [M], boxes [M, 4] (xyxy), scores [M],
        classes [M] (contiguous labels already).
    """
    cat_to_label = {cid: i for i, cid in enumerate(cat_ids)}
    per_image: dict[int, dict] = {}

    def _entry(img_id):
        return per_image.setdefault(
            img_id, {"boxes": [], "scores": [], "classes": []}
        )

    if det_file.endswith(".npz"):
        data = np.load(det_file)
        for img_id, box, score, cls in zip(
            data["image_ids"], data["boxes"], data["scores"], data["classes"]
        ):
            e = _entry(int(img_id))
            e["boxes"].append(np.asarray(box, np.float32))
            e["scores"].append(float(score))
            e["classes"].append(int(cls))
    else:
        with open(det_file) as f:
            dets = json.load(f)
        for d in dets:
            if d["category_id"] not in cat_to_label:
                continue
            e = _entry(int(d["image_id"]))
            e["boxes"].append(_xywh_to_xyxy_np(d["bbox"])[0])
            e["scores"].append(float(d["score"]))
            e["classes"].append(cat_to_label[d["category_id"]])
    return per_image


def build_roidb(
    ann_file: str,
    det_file: str,
    person_only: bool = True,
    max_dets: int = 1024,
    skip_empty: bool = True,
) -> Roidb:
    """Assemble the roidb: one record per image.

    Iterates the UNION of detection and annotation image ids: an image
    with ground truth but no detections must still contribute its GTs
    to the AP recall denominator (dropping it would inflate AP vs
    pycocotools). ``skip_empty`` drops only images with neither
    detections nor ground truth; zero-detection records are handled
    throughout (tests/test_edge_cases.py).
    """
    gt, class_names, cat_ids = load_coco_gt(ann_file, person_only)
    dets = load_detections(det_file, cat_ids)
    empty_det = {"boxes": [], "scores": [], "classes": []}
    records = []
    for img_id in sorted(set(dets) | set(gt)):
        d = dets.get(img_id, empty_det)
        g = gt.get(img_id, {"boxes": [], "classes": [], "crowd": []})
        if skip_empty and not d["scores"] and not g["boxes"]:
            continue
        gt_boxes = (
            _xywh_to_xyxy_np(np.asarray(g["boxes"], np.float32))
            if g["boxes"] else np.zeros((0, 4), np.float32)
        )
        rec = ImageRecord(
            image_id=img_id,
            det_boxes=np.asarray(d["boxes"], np.float32).reshape(-1, 4),
            det_scores=np.asarray(d["scores"], np.float32),
            det_classes=np.asarray(d["classes"], np.int32),
            gt_boxes=gt_boxes,
            gt_classes=np.asarray(g["classes"], np.int32),
            gt_crowd=np.asarray(g["crowd"], bool),
        ).capped(max_dets)
        records.append(rec)
    return Roidb(records=records, class_names=class_names, cat_ids=cat_ids)
