"""PETS crowded-pedestrian dataset loaders (paper benchmark #3).

The reference evaluates GossipNet on the PETS surveillance sequences in
addition to COCO persons (SURVEY.md §0, arXiv:1705.02950 §5): crowded
scenes where greedy NMS must trade missed occluded pedestrians against
double detections — the regime learned rescoring wins.

PETS2009 ground truth is distributed as CVML XML (one ``<frame>`` per
video frame, boxes given center-form)::

    <dataset name="...">
      <frame number="0">
        <objectlist>
          <object id="3">
            <box xc="262.5" yc="156.5" w="25.0" h="62.0"/>
          </object>
        </objectlist>
      </frame>
      ...
    </dataset>

Detections are accepted in any of three formats:

- MOT-style CSV (``frame,id,x,y,w,h,score,...``; 1-based frame numbers,
  top-left box form — the de-facto interchange format for the PETS
  sequences via MOT15),
- CVML XML with a per-object ``confidence`` attribute (same schema as
  the GT; score defaults to 1.0 when absent),
- NPZ with ``image_ids/boxes(xyxy)/scores/classes`` arrays (the same
  layout roidb.load_detections accepts).

Everything is converted into the shared ``ImageRecord``/``Roidb``
shape (single class "person"), so training, evaluation, sharding and
serving run unchanged on PETS — train/val splits are separate files,
as is standard for the PETS sequences (different views/time windows).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from gossipnet_tpu_torch.data.roidb import ImageRecord, Roidb


def _center_to_xyxy(xc, yc, w, h) -> list[float]:
    return [xc - w / 2.0, yc - h / 2.0, xc + w / 2.0, yc + h / 2.0]


def load_cvml(path: str) -> dict[int, dict]:
    """Parse a CVML XML file -> {frame: {"boxes": [xyxy], "scores": [f]}}.

    Works for both ground truth (no ``confidence`` attribute; scores
    filled with 1.0) and CVML-format detections.
    """
    root = ET.parse(path).getroot()
    frames: dict[int, dict] = {}
    for fr in root.iter("frame"):
        num = int(fr.get("number"))
        rec = frames.setdefault(num, {"boxes": [], "scores": []})
        for obj in fr.iter("object"):
            box = obj.find("box")
            if box is None:
                continue
            rec["boxes"].append(_center_to_xyxy(
                float(box.get("xc")), float(box.get("yc")),
                float(box.get("w")), float(box.get("h")),
            ))
            conf = obj.get("confidence", box.get("confidence"))
            rec["scores"].append(1.0 if conf is None else float(conf))
    return frames


def load_mot_csv(path: str) -> dict[int, dict]:
    """Parse a MOT-style detection CSV -> {frame: {"boxes", "scores"}}.

    Rows are ``frame,id,x,y,w,h,score[,...]`` with 1-based frames and
    top-left (x, y, w, h) boxes; extra trailing columns are ignored.
    """
    frames: dict[int, dict] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(";", ",").split(",")
            if len(parts) < 7:
                raise ValueError(
                    f"MOT det row needs >=7 fields, got {len(parts)}: "
                    f"{line[:80]!r}")
            fr = int(float(parts[0]))
            x, y, w, h = (float(v) for v in parts[2:6])
            rec = frames.setdefault(fr, {"boxes": [], "scores": []})
            rec["boxes"].append([x, y, x + w, y + h])
            rec["scores"].append(float(parts[6]))
    return frames


def load_pets_detections(det_file: str) -> dict[int, dict]:
    """Dispatch on extension: .xml -> CVML, .npz -> roidb NPZ layout,
    anything else -> MOT CSV."""
    if det_file.endswith(".xml"):
        return load_cvml(det_file)
    if det_file.endswith(".npz"):
        data = np.load(det_file)
        frames: dict[int, dict] = {}
        for img_id, box, score in zip(
            data["image_ids"], data["boxes"], data["scores"]
        ):
            rec = frames.setdefault(
                int(img_id), {"boxes": [], "scores": []})
            rec["boxes"].append(np.asarray(box, np.float32))
            rec["scores"].append(float(score))
        return frames
    return load_mot_csv(det_file)


def build_pets_roidb(
    gt_file: str,
    det_file: str,
    max_dets: int = 1024,
    skip_empty: bool = True,
    frame_offset: int | None = None,
) -> Roidb:
    """Assemble a single-class person Roidb from PETS-format files.

    Frame-number alignment: CVML GT frames are typically 0-based while
    MOT CSV detections are 1-based. ``frame_offset`` is SUBTRACTED from
    every detection frame number before matching against GT frames
    (1 = det files one ahead of GT, the MOT-vs-CVML case; 0 = verbatim).
    ``None`` auto-detects: the shift in {0, +1, -1} whose det frames
    overlap the GT frames best wins (ties prefer 0); a warning is
    emitted whenever a nonzero shift is chosen, so silent realignment
    is visible in logs.
    """
    gt = load_cvml(gt_file)
    dets = load_pets_detections(det_file)
    if frame_offset is None and gt and dets:
        gt_keys = set(gt)
        overlap = {
            off: len({fr - off for fr in dets} & gt_keys)
            for off in (0, 1, -1)
        }
        frame_offset = max(overlap, key=lambda o: (overlap[o], o == 0))
        if frame_offset != 0:
            import warnings

            warnings.warn(
                f"PETS loader: detection frames realigned by "
                f"-{frame_offset} (frame overlap with GT: {overlap}); "
                "pass frame_offset explicitly to silence",
                stacklevel=2,
            )
    if frame_offset:
        dets = {fr - frame_offset: rec for fr, rec in dets.items()}
    empty = {"boxes": [], "scores": []}
    records = []
    # Union of frames: a frame with GT but no detections must still
    # contribute its GTs to the AP recall denominator (see build_roidb).
    for fr in sorted(set(dets) | set(gt)):
        d = dets.get(fr, empty)
        g = gt.get(fr, {"boxes": []})
        if skip_empty and not d["scores"] and not g["boxes"]:
            continue
        n = len(d["scores"])
        ng = len(g["boxes"])
        rec = ImageRecord(
            image_id=fr,
            det_boxes=np.asarray(d["boxes"], np.float32).reshape(-1, 4),
            det_scores=np.asarray(d["scores"], np.float32),
            det_classes=np.zeros(n, np.int32),
            gt_boxes=np.asarray(g["boxes"], np.float32).reshape(-1, 4),
            gt_classes=np.zeros(ng, np.int32),
            gt_crowd=np.zeros(ng, bool),
        ).capped(max_dets)
        records.append(rec)
    return Roidb(records=records, class_names=["person"], cat_ids=[1])
