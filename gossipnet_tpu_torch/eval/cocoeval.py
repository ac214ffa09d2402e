"""Vendored pure-numpy COCO detection AP (bbox only).

The reference evaluates with pycocotools' COCOeval
(SURVEY.md §1 "Evaluation"); pycocotools is NOT available in this
environment (§4.6), so this module reimplements the COCO bbox protocol
from its published specification: greedy per-image matching in descending
score order at IoU thresholds 0.50:0.05:0.95, crowd regions matched by
intersection-over-foreground and usable by multiple detections, ignored
GTs/detections excluded from the precision-recall curve, 101-point interpolated AP,
area-range splits (all/small/medium/large) and max-detection caps
(1/10/100), means taken over classes with at least one non-ignored GT.

It operates directly on numpy arrays (no JSON round trip needed). The
matching core is vectorized over IoU thresholds and GTs (one short
python loop over the <=100 score-capped detections per image), IoU
matrices are computed once per (image, class) and shared across every
area-range/maxDet combination, and the optional C++ fast path
(native/gossip_native.cc eval_match) is differential-fuzzed against the
numpy path bit-for-bit in tests/test_cocoeval_fuzz.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)          # [10]
RECALL_THRS = np.linspace(0.0, 1.0, 101)                    # [101]
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)
# Every (area, maxDet) cell summarize() needs; evaluated in one pass.
_COMBOS = (
    ("all", 100), ("all", 1), ("all", 10),
    ("small", 100), ("medium", 100), ("large", 100),
)


@dataclass
class EvalImage:
    """Everything the evaluator needs for one image."""

    image_id: int
    det_boxes: np.ndarray     # [n, 4] xyxy
    det_scores: np.ndarray    # [n]
    det_classes: np.ndarray   # [n]
    gt_boxes: np.ndarray      # [g, 4] xyxy
    gt_classes: np.ndarray    # [g]
    gt_crowd: np.ndarray      # [g] bool


def _np_iou_xyxy(det: np.ndarray, gt: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    """IoU [n, g]; crowd GTs use intersection / det_area (pycocotools
    iscrowd semantics)."""
    if len(det) == 0 or len(gt) == 0:
        return np.zeros((len(det), len(gt)))
    lt = np.maximum(det[:, None, :2], gt[None, :, :2])
    rb = np.minimum(det[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    det_a = np.clip(det[:, 2] - det[:, 0], 0, None) * np.clip(
        det[:, 3] - det[:, 1], 0, None
    )
    gt_a = np.clip(gt[:, 2] - gt[:, 0], 0, None) * np.clip(
        gt[:, 3] - gt[:, 1], 0, None
    )
    union = det_a[:, None] + gt_a[None, :] - inter
    denom = np.where(crowd[None, :], det_a[:, None], union)
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


def _box_area(boxes: np.ndarray) -> np.ndarray:
    return np.clip(boxes[:, 2] - boxes[:, 0], 0, None) * np.clip(
        boxes[:, 3] - boxes[:, 1], 0, None
    )


def match_image_np(
    ious: np.ndarray,       # [n, g] dets in DESC-score order, gts with
                            # non-ignored FIRST (stable)
    gt_crowd: np.ndarray,   # [g] bool (sorted like ious columns)
    gt_ignore: np.ndarray,  # [g] bool (sorted: all False before True)
    thrs: np.ndarray = IOU_THRS,
) -> tuple[np.ndarray, np.ndarray]:
    """Greedy COCO matching, vectorized over thresholds and GTs.

    Semantics (== pycocotools, == the C++ eval_match): walk detections
    in descending score; a detection takes the best still-available GT
    with IoU >= threshold, later GT index winning exact-IoU ties; crowd
    GTs stay available after matching; ignored GTs are only eligible
    when no non-ignored GT clears the threshold (the sorted-ignored-last
    'break' rule). Returns (dt_matched, dt_ignore), both [T, n].
    """
    t = len(thrs)
    n, g = ious.shape
    dt_matched = np.zeros((t, n), bool)
    dt_ignore = np.zeros((t, n), bool)
    if g == 0 or n == 0:
        return dt_matched, dt_ignore
    gt_matched = np.zeros((t, g), bool)
    floor = np.minimum(thrs, 1 - 1e-10)[:, None]            # [T, 1]
    nonign = ~gt_ignore[None, :]                             # [1, g]
    crowd = gt_crowd[None, :]
    trange = np.arange(t)
    # Detections whose best IoU clears no threshold can never match nor
    # alter gt_matched — skipping them is exact and fast-paths the
    # common no-overlap case.
    cand = np.nonzero(ious.max(axis=1) >= floor.min())[0]
    for d in cand:
        c = np.broadcast_to(ious[d][None, :], (t, g))        # [T, g]
        elig = ~(gt_matched & ~crowd) & (c >= floor)
        elig_non = elig & nonign
        has_non = elig_non.any(axis=1)                       # [T]
        pool = np.where(has_non[:, None], elig_non, elig)
        cm = np.where(pool, c, -1.0)
        m = cm.max(axis=1)                                   # [T]
        found = m > -0.5
        # Iterative greedy keeps the LAST argmax on ties.
        win = g - 1 - np.argmax(cm[:, ::-1] == m[:, None], axis=1)
        tf, wf = trange[found], win[found]
        gt_matched[tf, wf] = True
        dt_matched[found, d] = True
        dt_ignore[found, d] = gt_ignore[wf]
    return dt_matched, dt_ignore


@dataclass
class _ImgResult:
    dt_scores: np.ndarray   # [n]
    dt_matched: np.ndarray  # [T, n] bool
    dt_ignore: np.ndarray   # [T, n] bool
    num_gt: int             # non-ignored GT count


def _pr_curves(scores, matched, ignored, npig):
    """Precision-recall curves for ONE class from its concatenated (image-major)
    detection columns: stable desc-score sort, per-threshold cumulative
    TP/FP, monotone precision envelope, 101-point sampling. Shared by
    the per-image numpy path and the batched native path so both are
    bit-identical by construction. Returns (precision [T, 101],
    recall [T])."""
    t = matched.shape[0]
    precision = np.zeros((t, len(RECALL_THRS)))
    recall = np.zeros(t)
    order = np.argsort(-scores, kind="mergesort")
    matched = matched[:, order]
    ignored = ignored[:, order]
    for ti in range(t):
        m = matched[ti][~ignored[ti]]
        tp = np.cumsum(m)
        fp = np.cumsum(~m)
        if len(tp) == 0:
            continue
        rc = tp / npig
        pr = tp / np.maximum(tp + fp, 1e-12)
        recall[ti] = rc[-1]
        # Monotone-decreasing envelope, then 101-pt sampling.
        pr = np.maximum.accumulate(pr[::-1])[::-1]
        inds = np.searchsorted(rc, RECALL_THRS, side="left")
        q = np.zeros(len(RECALL_THRS))
        valid = inds < len(pr)
        q[valid] = pr[inds[valid]]
        precision[ti, :] = q
    return precision, recall


def _evaluate_combo(
    det_boxes, det_scores, det_area, ious,          # dets DESC-score sorted
    gt_boxes, gt_area, gt_crowd,
    area_rng, max_det, is_all_area=False,
) -> _ImgResult | None:
    """One (area range, maxDet) cell from the shared per-(image, class)
    sorted detections + IoU matrix — the pure-numpy REFERENCE path (the
    batched C++ path in _evaluate_all_batch is differential-fuzzed
    against it).

    ``is_all_area`` short-circuits the area tests ('all' covers every
    finite box, so gt_ignore == gt_crowd and no det is out of range).
    """
    n_all, g = len(det_scores), len(gt_boxes)
    if n_all == 0 and g == 0:
        return None
    if is_all_area:
        gt_ignore = gt_crowd
    else:
        gt_ignore = gt_crowd | (gt_area < area_rng[0]) \
            | (gt_area > area_rng[1])
    n = min(n_all, max_det)
    t = len(IOU_THRS)

    if g == 0:
        dt_matched = np.zeros((t, n), bool)
    else:
        # GTs: non-ignored first (stable) — required by the matching
        # rule. Skip the permutation when nothing is ignored.
        if gt_ignore.any():
            gord = np.argsort(gt_ignore, kind="stable")
            gt_crowd_s, gt_ignore_s = gt_crowd[gord], gt_ignore[gord]
            ious_s = ious[:, gord]
        else:
            gt_crowd_s, gt_ignore_s, ious_s = gt_crowd, gt_ignore, ious
        dt_matched, dt_ignore = match_image_np(
            ious_s[:n], gt_crowd_s, gt_ignore_s, IOU_THRS
        )

    # Unmatched detections outside the area range are ignored.
    if is_all_area:
        if g == 0:
            dt_ignore = np.zeros((t, n), bool)
    else:
        out_of_range = (det_area[:n] < area_rng[0]) \
            | (det_area[:n] > area_rng[1])
        if g == 0:
            dt_ignore = np.broadcast_to(out_of_range[None, :], (t, n)).copy()
        else:
            dt_ignore = dt_ignore | ((~dt_matched) & out_of_range[None, :])

    return _ImgResult(
        dt_scores=det_scores[:n],
        dt_matched=dt_matched,
        dt_ignore=dt_ignore,
        num_gt=int((~gt_ignore).sum()),
    )


def _prefix_result(r: _ImgResult | None, max_det: int) -> _ImgResult | None:
    """maxDet cap of an 'all'-area result: greedy matching is sequential
    in the detections, so capping is EXACTLY a column prefix."""
    if r is None or len(r.dt_scores) <= max_det:
        return r
    return _ImgResult(
        dt_scores=r.dt_scores[:max_det],
        dt_matched=r.dt_matched[:, :max_det],
        dt_ignore=r.dt_ignore[:, :max_det],
        num_gt=r.num_gt,
    )


def _packed_eval(images, k, n_threads=1):
    """Pack every (image, class) segment of ``images`` into flat arrays
    and run ONE native eval_match_many call over all area ranges,
    sharded over ``n_threads`` C++ threads INSIDE the library.

    Host parallelism deliberately lives in the native layer, not in
    Python processes: ``multiprocessing`` 'fork' deadlocks once jax's
    threads exist (observed live — a forked eval worker hung the whole
    test suite on a futex), and 'spawn' would re-import the CLI main
    module (jax init per worker). C++ threads over disjoint output
    slices have neither hazard and stay bit-identical at any thread
    count (tests/test_cocoeval_fuzz.py).

    Returns (seg_cls [S], num_gt [A, S], col_scores [C],
    col_within [C], col_cls [C], dt_matched [A, T, C],
    dt_ignore [A, T, C]) where S = segments, C = score-capped packed
    detection columns in image-major order (the numpy path's exact
    per-class concatenation order).
    """
    from gossipnet_tpu_torch import native

    db_p, ds_p, gb_p, gc_p = [], [], [], []
    seg_cls_p, d_lo_p, d_hi_p, g_lo_p, g_hi_p = [], [], [], [], []
    d_base = g_base = 0
    for img in images:
        # Same sort/group as the numpy path: one desc-score stable sort,
        # then stable group-by-class (stable sorts compose).
        dord = np.argsort(-img.det_scores, kind="stable")
        dgrp = np.argsort(img.det_classes[dord], kind="stable")
        dsel = dord[dgrp]
        dcls_s = img.det_classes[dsel]
        ggrp = np.argsort(img.gt_classes, kind="stable")
        gcls_s = img.gt_classes[ggrp]
        present = np.union1d(dcls_s, gcls_s)
        keep = (present >= 0) & (present < k)
        present = present[keep]
        if len(present) == 0:
            continue
        d_lo_p.append(np.searchsorted(dcls_s, present, "left") + d_base)
        d_hi_p.append(np.searchsorted(dcls_s, present, "right") + d_base)
        g_lo_p.append(np.searchsorted(gcls_s, present, "left") + g_base)
        g_hi_p.append(np.searchsorted(gcls_s, present, "right") + g_base)
        seg_cls_p.append(present.astype(np.int64))
        db_p.append(img.det_boxes[dsel])
        ds_p.append(img.det_scores[dsel])
        gb_p.append(img.gt_boxes[ggrp])
        gc_p.append(img.gt_crowd[ggrp])
        d_base += len(dcls_s)
        g_base += len(gcls_s)

    a, t = len(AREA_RANGES), len(IOU_THRS)
    if not seg_cls_p:
        z = np.zeros(0)
        return (np.zeros(0, np.int64), np.zeros((a, 0), np.int32),
                z, np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros((a, t, 0), bool), np.zeros((a, t, 0), bool))

    db = np.concatenate(db_p).reshape(-1, 4)
    ds = np.concatenate(ds_p)
    gb = (np.concatenate(gb_p).reshape(-1, 4)
          if g_base else np.zeros((0, 4)))
    gc = (np.concatenate(gc_p) if g_base else np.zeros(0, bool))
    seg_cls = np.concatenate(seg_cls_p)
    d_lo = np.concatenate(d_lo_p).astype(np.int32)
    d_hi = np.concatenate(d_hi_p).astype(np.int32)
    g_lo = np.concatenate(g_lo_p).astype(np.int32)
    g_hi = np.concatenate(g_hi_p).astype(np.int32)

    max_det = max(MAX_DETS)
    n_cap = np.minimum(d_hi - d_lo, max_det)
    out_off = np.zeros(len(n_cap), np.int64)
    np.cumsum(n_cap[:-1], out=out_off[1:])
    c_tot = int(n_cap.sum())
    # Per packed column: source det index, class, within-segment rank
    # (the maxDet-1/10 caps are exact prefixes of the capped columns).
    col2det = np.repeat(d_lo.astype(np.int64) - out_off, n_cap) \
        + np.arange(c_tot)
    col_cls = np.repeat(seg_cls, n_cap)
    col_within = np.arange(c_tot) - np.repeat(out_off, n_cap)
    area_ranges = np.asarray(list(AREA_RANGES.values()), np.float64)

    dt_matched, dt_ignore, num_gt = native.eval_match_many(
        db, _box_area(db), gb, _box_area(gb), gc,
        d_lo, d_hi, g_lo, g_hi, IOU_THRS, area_ranges,
        max_det, out_off.astype(np.int32), c_tot, n_threads=n_threads)
    return (seg_cls, num_gt, ds[col2det], col_within, col_cls,
            dt_matched, dt_ignore)


@dataclass
class COCOEvaluator:
    """Accumulates images and produces COCO AP/AR statistics.

    Usage::

        ev = COCOEvaluator(num_classes=1)
        for img in images: ev.add(img)
        stats = ev.summarize()   # {'AP': ..., 'AP50': ..., ...}
    """

    num_classes: int = 1
    images: list[EvalImage] = field(default_factory=list)
    # force_numpy=True disables the C++ fast path (tests/fuzzing).
    force_numpy: bool = False
    # C++ threads for the batched native path: None = auto (cpu_count
    # up to 8), 1 = serial, n = n std::threads inside eval_match_many.
    # Output is bit-identical at any worker count (disjoint output
    # slices per segment; pinned in tests/test_cocoeval_fuzz.py). Has
    # no effect on the numpy fallback path (always serial).
    workers: int | None = None
    _results: dict | None = field(default=None, repr=False)

    def add(self, img: EvalImage) -> None:
        self.images.append(img)
        self._results = None

    def add_arrays(self, image_id, det_boxes, det_scores, det_classes,
                   gt_boxes, gt_classes, gt_crowd) -> None:
        self.add(EvalImage(
            image_id=image_id,
            det_boxes=np.asarray(det_boxes, np.float64).reshape(-1, 4),
            det_scores=np.asarray(det_scores, np.float64).reshape(-1),
            det_classes=np.asarray(det_classes).reshape(-1),
            gt_boxes=np.asarray(gt_boxes, np.float64).reshape(-1, 4),
            gt_classes=np.asarray(gt_classes).reshape(-1),
            gt_crowd=np.asarray(gt_crowd, bool).reshape(-1),
        ))

    # --- core evaluation, one pass over (image, class) ---

    def _use_native(self) -> bool:
        if self.force_numpy:
            return False
        from gossipnet_tpu_torch import native

        return native.available()

    def _evaluate_all(self) -> dict:
        """{(area, maxDet): (precision [T, 101, K], recall [T, K])} for
        every combo summarize() needs. Two implementations, bit-identical
        (differential-fuzzed): the batched C++ path (one native call for
        the whole image set, sharded over C++ threads) when the .so is
        loadable, else the vectorized per-image numpy reference
        path."""
        if self._results is not None:
            return self._results
        if self._use_native():
            self._results = self._evaluate_all_batch()
        else:
            self._results = self._evaluate_all_numpy()
        return self._results

    def _evaluate_all_numpy(self) -> dict:
        """Pure-numpy reference path: IoU matrices and score sorts are
        computed once per (image, class) and shared across combos."""
        t, k = len(IOU_THRS), self.num_classes
        per_combo: dict = {c: [[] for _ in range(k)] for c in _COMBOS}

        for img in self.images:
            # One desc-score stable sort per image, then a stable
            # group-by-class: within each class the relative order is
            # identical to a per-class `argsort(-scores, kind="stable")`
            # (stable sorts compose), so results are bit-equal to the
            # per-class-mask formulation but cost O(1) sorts per image
            # instead of O(num_classes).
            dord = np.argsort(-img.det_scores, kind="stable")
            dgrp = np.argsort(img.det_classes[dord], kind="stable")
            dsel = dord[dgrp]
            db_s, ds_s = img.det_boxes[dsel], img.det_scores[dsel]
            dcls_s = img.det_classes[dsel]
            det_area_s = _box_area(db_s)
            # GTs: stable group-by-class preserves original order within
            # a class (the tie rule depends on it).
            ggrp = np.argsort(img.gt_classes, kind="stable")
            gb_s, gcls_s = img.gt_boxes[ggrp], img.gt_classes[ggrp]
            gc_s = img.gt_crowd[ggrp]
            gt_area_s = _box_area(gb_s)
            present = np.union1d(dcls_s, gcls_s)
            d_lo = np.searchsorted(dcls_s, present, side="left")
            d_hi = np.searchsorted(dcls_s, present, side="right")
            g_lo = np.searchsorted(gcls_s, present, side="left")
            g_hi = np.searchsorted(gcls_s, present, side="right")
            for pi, ci in enumerate(present):
                ci = int(ci)
                if not 0 <= ci < k:
                    continue
                dsl = slice(d_lo[pi], d_hi[pi])
                gsl = slice(g_lo[pi], g_hi[pi])
                db, ds = db_s[dsl], ds_s[dsl]
                gb, gc = gb_s[gsl], gc_s[gsl]
                det_area, gt_area = det_area_s[dsl], gt_area_s[gsl]
                ious = _np_iou_xyxy(db, gb, gc)
                # 'all' area once at maxDet=100; the 1/10 caps are
                # exact column prefixes (greedy is sequential in d).
                r100 = _evaluate_combo(
                    db, ds, det_area, ious, gb, gt_area, gc,
                    AREA_RANGES["all"], 100, is_all_area=True,
                )
                if r100 is not None:
                    per_combo[("all", 100)][ci].append(r100)
                    per_combo[("all", 1)][ci].append(
                        _prefix_result(r100, 1))
                    per_combo[("all", 10)][ci].append(
                        _prefix_result(r100, 10))
                for area in ("small", "medium", "large"):
                    rng = AREA_RANGES[area]
                    gt_in = ((gt_area >= rng[0]) & (gt_area <= rng[1]))
                    if bool(gt_in.all()):
                        # Every GT inside the range (or no GT at all) ⇒
                        # gt_ignore equals the 'all' range's (== gt_crowd)
                        # ⇒ the greedy matching is bit-identical to r100;
                        # only the det out-of-range ignore clause differs.
                        n = len(r100.dt_scores)
                        oor = ((det_area[:n] < rng[0])
                               | (det_area[:n] > rng[1]))
                        r = _ImgResult(
                            dt_scores=r100.dt_scores,
                            dt_matched=r100.dt_matched,
                            dt_ignore=r100.dt_ignore
                            | ((~r100.dt_matched) & oor[None, :]),
                            num_gt=r100.num_gt,
                        )
                    else:
                        r = _evaluate_combo(
                            db, ds, det_area, ious, gb, gt_area, gc,
                            rng, 100,
                        )
                    if r is not None:
                        per_combo[(area, 100)][ci].append(r)

        out = {}
        for combo, by_class in per_combo.items():
            precision = -np.ones((t, len(RECALL_THRS), k))
            recall = -np.ones((t, k))
            for cls in range(k):
                results = by_class[cls]
                if not results:
                    continue
                npig = sum(r.num_gt for r in results)
                if npig == 0:
                    continue
                scores = np.concatenate([r.dt_scores for r in results])
                matched = np.concatenate(
                    [r.dt_matched for r in results], axis=1)
                ignored = np.concatenate(
                    [r.dt_ignore for r in results], axis=1)
                precision[:, :, cls], recall[:, cls] = _pr_curves(
                    scores, matched, ignored, npig)
            out[combo] = (precision, recall)
        return out

    def _evaluate_all_batch(self) -> dict:
        """Batched C++ path: pack every (image, class) segment into flat
        arrays (one Python pass over images), run ONE
        native.eval_match_many call — sharded over `workers` C++
        threads inside the library — then accumulate the packed columns
        per class with the shared _pr_curves math. Bit-identical to
        _evaluate_all_numpy (differential-fuzzed)."""
        t, k = len(IOU_THRS), self.num_classes
        n_workers = self.workers
        if n_workers is None:
            import os

            n_workers = min(os.cpu_count() or 1, 8)
        (seg_cls, num_gt, col_scores, col_within, col_cls,
         dt_matched, dt_ignore) = _packed_eval(
            self.images, k, n_threads=max(n_workers, 1))

        # Column selectors: class-grouped (stable => image-major within
        # a class, exactly the numpy path's concatenation order).
        csel = np.argsort(col_cls, kind="stable")
        cls_sorted = col_cls[csel]
        c_lo = np.searchsorted(cls_sorted, np.arange(k), side="left")
        c_hi = np.searchsorted(cls_sorted, np.arange(k), side="right")
        seg_has = np.zeros(k, bool)
        if len(seg_cls):
            seg_has[seg_cls] = True
        npig_by = np.zeros((len(AREA_RANGES), k), np.int64)
        for a in range(len(AREA_RANGES)):
            if len(seg_cls):
                np.add.at(npig_by[a], seg_cls, num_gt[a])

        area_idx = {name: i for i, name in enumerate(AREA_RANGES)}
        out = {}
        for combo in _COMBOS:
            area, max_det = combo
            a = area_idx[area]
            precision = -np.ones((t, len(RECALL_THRS), k))
            recall = -np.ones((t, k))
            for cls in range(k):
                if not seg_has[cls]:
                    continue
                npig = int(npig_by[a, cls])
                if npig == 0:
                    continue
                cols = csel[c_lo[cls]:c_hi[cls]]
                if max_det < 100:
                    cols = cols[col_within[cols] < max_det]
                precision[:, :, cls], recall[:, cls] = _pr_curves(
                    col_scores[cols], dt_matched[a][:, cols],
                    dt_ignore[a][:, cols], npig)
            out[combo] = (precision, recall)
        return out

    def _accumulate(
        self, area: str, max_det: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (precision [T, 101, K], recall [T, K]); -1 = undefined."""
        return self._evaluate_all()[(area, max_det)]

    def summarize(self) -> dict[str, float]:
        def _mean(x):
            x = x[x > -1]
            return float(x.mean()) if x.size else -1.0

        p_all, r_all = self._accumulate("all", 100)
        stats = {
            "AP": _mean(p_all),
            "AP50": _mean(p_all[np.where(IOU_THRS == 0.5)[0]]),
            "AP75": _mean(p_all[np.where(IOU_THRS == 0.75)[0]]),
            "AR100": _mean(r_all),
        }
        for name in ("small", "medium", "large"):
            p, _ = self._accumulate(name, 100)
            stats[f"AP{name[0]}"] = _mean(p)
        for md in (1, 10):
            _, r = self._accumulate("all", md)
            stats[f"AR{md}"] = _mean(r)
        return stats

    def per_class_ap(self) -> np.ndarray:
        """AP per class (−1 where undefined), area=all, maxDet=100."""
        p, _ = self._accumulate("all", 100)
        out = np.full(self.num_classes, -1.0)
        for cls in range(self.num_classes):
            v = p[:, :, cls]
            v = v[v > -1]
            if v.size:
                out[cls] = float(v.mean())
        return out
