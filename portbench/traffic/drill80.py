"""Detector output of all 80 COCO classes drawn from a seed: a frozen copy
of the scale drill's per-image draw with every class kept.

Source: ``gossipnet_tpu_torch/tools/scale_drill.py::gen`` at commit
fe709818db8e48f1b0f5578bd90c6efc9b9bfe41. The loop body below is that
function's draw for one image, in the same order of random calls as
``traffic/drill.py`` makes them; where ``drill.py`` drops every class but
the person, this copy keeps each detection and ground truth with its
class, mapped to 0..79 as ``data/roidb.py::build_roidb`` maps a category
(its index in the sorted category ids). The score-ranked cap of
``ImageRecord.capped`` is applied as the drill's ``dense80`` arm loads its
files. Numpy only.

Preset ``dense80`` is the drill's ``DENSE`` with ``gen``'s default person
share of 0.3 (RESULTS.md's ``dense80`` arm): about 670 detections an
image, 30-70 ground truths of about 65 classes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from portbench.traffic.drill import (CANVAS_H, CANVAS_W, CAT_IDS,
                                     _category_cdf, _xyxy)
from portbench.traffic.generate import stream_rng

# a category's training label: its index among the sorted category ids
LABEL = {cid: k for k, cid in enumerate(sorted(CAT_IDS))}
NUM_CLASSES = len(CAT_IDS)

PRESETS = {
    "dense80": dict(gt_range=(30, 71), dets_per_gt=(8, 15),
                    fp_range=(80, 201), person_p=0.3),
}


class Image(NamedTuple):
    """One image's detections and ground truth, xyxy float32, classes in
    [0, 80)."""

    boxes: np.ndarray        # [n, 4]
    scores: np.ndarray       # [n]
    classes: np.ndarray      # [n] int32
    gt_boxes: np.ndarray     # [g, 4]
    gt_classes: np.ndarray   # [g] int32
    gt_crowd: np.ndarray     # [g] bool


def draw_image(rng: np.random.Generator, gt_range, dets_per_gt, fp_range,
               person_p, max_dets: int) -> Image:
    """One image of ``gen`` (score_corr 0), every class kept, capped at
    the ``max_dets`` best scores (stable, as ``ImageRecord.capped``)."""
    cdf = _category_cdf(person_p)

    def category() -> int:
        # Generator.choice(CAT_IDS, p=cat_p) for one draw
        return CAT_IDS[int(cdf.searchsorted(rng.random(), side="right"))]

    gts, gt_cls, crowds, dets, cls, scores = [], [], [], [], [], []
    for _ in range(int(rng.integers(*gt_range))):
        cid = category()
        w = float(rng.uniform(12, 200)); h = float(rng.uniform(12, 200))
        x = float(rng.uniform(0, CANVAS_W - w))
        y = float(rng.uniform(0, CANVAS_H - h))
        crowd = int(rng.uniform() < 0.04)
        gts.append([x, y, w, h])
        gt_cls.append(LABEL[cid])
        crowds.append(bool(crowd))
        if not crowd:
            # per detection gen draws normal(0, s, size=4) then
            # normal(0.55, 0.22): five standard normals in a row
            k = int(rng.integers(*dets_per_gt))
            z = rng.standard_normal(5 * k).reshape(k, 5)
            jit = 0.12 * min(w, h) * z[:, :4]
            dets += [[x + j[0], y + j[1], max(w + j[2], 4.0),
                      max(h + j[3], 4.0)] for j in jit.tolist()]
            cls += [LABEL[cid]] * k
            scores += (0.55 + 0.22 * z[:, 4]).tolist()
    for _ in range(int(rng.integers(*fp_range))):
        cid = category()
        w = float(rng.uniform(12, 160)); h = float(rng.uniform(12, 160))
        dets.append([float(rng.uniform(0, CANVAS_W - w)),
                     float(rng.uniform(0, CANVAS_H - h)), w, h])
        cls.append(LABEL[cid])
        scores.append(float(rng.normal(0.35, 0.2)))
    sc = np.clip(np.asarray(scores, np.float64), 0.01, 0.999).astype(
        np.float32)
    boxes = _xyxy(dets) if dets else np.zeros((0, 4), np.float32)
    classes = np.asarray(cls, np.int32)
    if len(sc) > max_dets:
        keep = np.argsort(-sc, kind="stable")[:max_dets]
        boxes, sc, classes = boxes[keep], sc[keep], classes[keep]
    gt = _xyxy(gts) if gts else np.zeros((0, 4), np.float32)
    return Image(boxes, sc, classes, gt, np.asarray(gt_cls, np.int32),
                 np.asarray(crowds, bool))


def draw(seed: int, stream: str, preset: str, count: int,
         max_dets: int) -> list[Image]:
    """``count`` images of ``preset`` from one generator keyed by the seed
    and a stream name, as ``drill.draw`` keys its own."""
    rng = stream_rng(seed, stream)
    return [draw_image(rng, max_dets=max_dets, **PRESETS[preset])
            for _ in range(count)]


def roidb_images(seed: int, mix: dict, max_dets: int) -> list[Image]:
    """A training set, as ``generate.roidb_images`` makes one: each pool
    drawn from the mix's fixed ``pool_seed``, every run's images the same,
    in an order drawn from the run's seed."""
    base = int(mix.get("pool_seed", seed))
    ims = [im for preset, count in sorted(mix["pool"].items())
           for im in draw(base, f"pool.{preset}", preset, int(count),
                          max_dets)]
    order = stream_rng(seed, "roidb").permutation(len(ims))
    return [ims[i] for i in order]
