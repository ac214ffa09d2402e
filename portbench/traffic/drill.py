"""Detector output drawn from a seed: a frozen copy of the scale drill's
per-image draw.

Source: ``gossipnet_tpu_torch/tools/scale_drill.py::gen`` at commit
278085c491085865767fbb28b435e49130c47800 (itself the reference's
``scripts/scale_drill.py gen``, line for line). The loop body below is that
function's draw for one image, in the same order of random calls; what it
wrote as COCO JSON is kept in memory, and the person filter and the
score-ranked cap of ``data/roidb.py`` (``build_roidb``, ``capped``) are
applied as the drill's person arms load their files. Numpy only.

Presets (``PRESETS``) are the drill's: ``full`` is ``gen``'s defaults,
``dense_p`` its ``DENSE_P`` and ``dense_4k`` its ``DENSE_4K`` (RESULTS.md's
``full``, ``dense`` and ``dense4k`` arms, persons kept).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

CANVAS_W, CANVAS_H = 640, 480
PERSON_ID = 1
CAT_IDS = [1] + [i for i in range(2, 91) if i not in
                 (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)][:79]

PRESETS = {
    "full": dict(gt_range=(2, 22), dets_per_gt=(3, 8), fp_range=(10, 30),
                 person_p=0.3),
    "dense_p": dict(gt_range=(30, 71), dets_per_gt=(10, 17),
                    fp_range=(80, 201), person_p=0.95),
    "dense_4k": dict(gt_range=(120, 221), dets_per_gt=(10, 17),
                     fp_range=(200, 401), person_p=0.95),
}


class Image(NamedTuple):
    """One image's person detections and ground truth, xyxy float32."""

    boxes: np.ndarray      # [n, 4]
    scores: np.ndarray     # [n]
    gt_boxes: np.ndarray   # [g, 4]
    gt_crowd: np.ndarray   # [g] bool


def _xyxy(xywh: list) -> np.ndarray:
    b = np.asarray(xywh, np.float32).reshape(-1, 4)
    out = b.copy()
    out[:, 2] = b[:, 0] + b[:, 2]
    out[:, 3] = b[:, 1] + b[:, 3]
    return out


def _category_cdf(person_p: float) -> np.ndarray:
    cat_p = np.full(len(CAT_IDS), (1.0 - person_p) / (len(CAT_IDS) - 1))
    cat_p[0] = person_p
    cdf = cat_p.cumsum()
    cdf /= cdf[-1]
    return cdf


def draw_image(rng: np.random.Generator, gt_range, dets_per_gt, fp_range,
               person_p, max_dets: int) -> Image:
    """One image of ``gen`` (score_corr 0), persons only, capped at the
    ``max_dets`` best scores (stable, as ``ImageRecord.capped``)."""
    cdf = _category_cdf(person_p)

    def category() -> int:
        # Generator.choice(CAT_IDS, p=cat_p) for one draw: one double
        # against the normalised cumulative sum, searched from the right
        return CAT_IDS[int(cdf.searchsorted(rng.random(), side="right"))]

    gts, crowds, dets, scores = [], [], [], []
    n_gt = int(rng.integers(*gt_range))
    for _ in range(n_gt):
        cid = category()
        w = float(rng.uniform(12, 200)); h = float(rng.uniform(12, 200))
        x = float(rng.uniform(0, CANVAS_W - w))
        y = float(rng.uniform(0, CANVAS_H - h))
        crowd = int(rng.uniform() < 0.04)
        if cid == PERSON_ID:
            gts.append([x, y, w, h])
            crowds.append(bool(crowd))
        if not crowd:
            # per detection gen draws normal(0, s, size=4) then
            # normal(0.55, 0.22): five standard normals in a row, each
            # scaled and shifted as Generator.normal does
            k = int(rng.integers(*dets_per_gt))
            z = rng.standard_normal(5 * k).reshape(k, 5)
            if cid == PERSON_ID:
                jit = 0.12 * min(w, h) * z[:, :4]
                dets += [[x + j[0], y + j[1], max(w + j[2], 4.0),
                          max(h + j[3], 4.0)] for j in jit.tolist()]
                scores += (0.55 + 0.22 * z[:, 4]).tolist()
    for _ in range(int(rng.integers(*fp_range))):
        cid = category()
        w = float(rng.uniform(12, 160)); h = float(rng.uniform(12, 160))
        box = [float(rng.uniform(0, CANVAS_W - w)),
               float(rng.uniform(0, CANVAS_H - h)), w, h]
        noise = float(rng.normal(0.35, 0.2))
        if cid == PERSON_ID:
            dets.append(box)
            scores.append(noise)
    sc = np.clip(np.asarray(scores, np.float64), 0.01, 0.999).astype(
        np.float32)
    boxes = _xyxy(dets) if dets else np.zeros((0, 4), np.float32)
    if len(sc) > max_dets:
        keep = np.argsort(-sc, kind="stable")[:max_dets]
        boxes, sc = boxes[keep], sc[keep]
    gt = _xyxy(gts) if gts else np.zeros((0, 4), np.float32)
    return Image(boxes, sc, gt, np.asarray(crowds, bool))


def draw(seed: int, stream: str, preset: str, count: int,
         max_dets: int) -> list[Image]:
    """``count`` images of ``preset`` from one generator keyed by the run's
    seed and a stream name, so each pool of a cell draws apart."""
    key = [int(seed) & 0xFFFFFFFF, int(seed) >> 32,
           *(ord(c) for c in stream)]
    rng = np.random.default_rng(key)
    return [draw_image(rng, max_dets=max_dets, **PRESETS[preset])
            for _ in range(count)]
