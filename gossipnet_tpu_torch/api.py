"""Serving API: rescore raw detections, NMS-free (port of
``gossipnet_tpu/api.py``).

    rescorer = Rescorer(cfg, params)                # device="cuda"
    new_scores = rescorer(boxes, scores)            # one image
    kept = boxes[new_scores > 0.5]                  # thresholding IS NMS
    results = rescorer.rescore_batch(list_of_images)  # bucketed batches

Images are padded to shape buckets and batched per bucket; results come
back per detection in input order. ``params`` is a PyTorch ``state_dict``
or a JAX parameter tree of numpy arrays (bridged by ``params.py``). On
CUDA the default pool path is the K1 kernel; there is no CPU fallback —
``device="cpu"`` must be asked for.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from gossipnet_tpu_torch.config import Config
from gossipnet_tpu_torch.data.bucketing import bucket_for
from gossipnet_tpu_torch.models.gossipnet import resolve_device
from gossipnet_tpu_torch.params import as_state_dict


def _scatter_scores(host_row: np.ndarray, n: int, keep) -> np.ndarray:
    """Map one padded output row back to input length ``n``.

    ``keep`` is the kept-index array ``_pack`` produced for this row
    (indices into the ORIGINAL input, ascending) when the image was
    truncated to the bucket size, or None when it fit. Truncated-away
    detections get score 0.0 ("suppressed"), so the output length always
    equals the input length.
    """
    if keep is None:
        return np.asarray(host_row[:n], np.float32)
    out = np.zeros(n, np.float32)
    out[keep] = host_row[: len(keep)]
    return out


class Rescorer:
    """Bucketed detection rescorer on one device.

    PyTorch runs eagerly, so there is nothing to compile per shape and no
    batch padding: a partial batch runs at its own size.
    """

    def __init__(self, cfg: Config, params, pool_impl: str | None = None,
                 device="cuda"):
        from gossipnet_tpu_torch.train import build_model

        self.cfg = cfg
        self.device = resolve_device(device)
        if pool_impl is None:
            pool_impl = "kernel" if self.device.type == "cuda" else "dense"
        self.model = build_model(cfg, pool_impl, self.device).eval()
        self.reload(params=params)

    # --- internals ---
    def _dispatch(self, boxes_a, scores_a, valid_a, classes_a):
        """Enqueue one padded batch on the device; returns (device tensor
        of probabilities, row count). CUDA work is asynchronous: the
        caller can pack the next batch while this one computes."""
        del classes_a  # class-agnostic only (ROADMAP.md item 11)

        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        with torch.inference_mode():
            logits = self.model(dev(boxes_a), dev(scores_a), dev(valid_a))
            return torch.sigmoid(logits), scores_a.shape[0]

    def _run(self, boxes_a, scores_a, valid_a, classes_a) -> np.ndarray:
        """Dispatch one padded batch and block for the result."""
        out, b = self._dispatch(boxes_a, scores_a, valid_a, classes_a)
        return out.cpu().numpy()[:b]

    def reload(self, params) -> None:
        """Swap serving weights in place (a ``state_dict`` or a JAX tree).

        The copy is ordered on the device's stream after every batch
        already dispatched, so those finish on the old weights and every
        later dispatch uses the new ones. Loading a checkpoint directory
        comes with the checkpoint slice (ROADMAP.md item 13).
        """
        sd = as_state_dict(params)
        want = self.model.state_dict()
        got_shapes = {k: tuple(v.shape) for k, v in sd.items()}
        want_shapes = {k: tuple(v.shape) for k, v in want.items()}
        if got_shapes != want_shapes:
            missing = sorted(set(want_shapes) - set(got_shapes))
            extra = sorted(set(got_shapes) - set(want_shapes))
            bad = sorted(k for k in set(want_shapes) & set(got_shapes)
                         if want_shapes[k] != got_shapes[k])
            raise ValueError(
                f"new params do not match the serving model: missing "
                f"{missing[:5]}, unexpected {extra[:5]}, shape {bad[:5]}")
        with torch.no_grad():
            self.model.load_state_dict(sd)

    def warmup(self, batch_size: int = 8) -> None:
        """Run one full batch per bucket, so the kernel build, the
        library handles and the allocator's pools are in place before the
        first real request."""
        for n in self.cfg.data.bucket_sizes:
            self._run(np.zeros((batch_size, n, 4), np.float32),
                      np.zeros((batch_size, n), np.float32),
                      np.zeros((batch_size, n), bool),
                      np.zeros((batch_size, n), np.int32))

    def _check_image(self, idx, scores, classes, truncate):
        if self.cfg.model.num_classes > 1 and classes is None:
            raise ValueError(
                f"image {idx}: multiclass config "
                f"(num_classes={self.cfg.model.num_classes}) requires "
                "per-detection class ids; got classes=None"
            )
        if classes is not None and len(classes) != len(scores):
            # Caught here (not in _pack) so servers answer a per-request
            # error instead of failing the whole co-batched group.
            raise ValueError(
                f"image {idx}: classes length {len(classes)} != "
                f"detections {len(scores)}"
            )
        max_bucket = max(self.cfg.data.bucket_sizes)
        if len(scores) > max_bucket and not truncate:
            raise ValueError(
                f"image {idx} has {len(scores)} detections > largest "
                f"bucket {max_bucket}; raise data.bucket_sizes or pass "
                "truncate=True (lowest-scored overflow gets score 0.0)"
            )

    def _pack(self, group, padded_n):
        """group: list of (idx, boxes, scores, classes) -> padded arrays
        plus one kept-index array (or None) per row.

        An oversized image (n > padded_n) keeps its TOP ``padded_n``
        detections BY SCORE (stable sort: ties go to the earliest input
        index); the kept indices stay in input order so results scatter
        straight back.
        """
        b = len(group)
        boxes_a = np.zeros((b, padded_n, 4), np.float32)
        scores_a = np.zeros((b, padded_n), np.float32)
        valid_a = np.zeros((b, padded_n), bool)
        classes_a = np.zeros((b, padded_n), np.int32)
        keeps: list = []
        for row, (_, bx, sc, cl) in enumerate(group):
            bx = np.asarray(bx, np.float32)
            sc = np.asarray(sc, np.float32)
            cl = None if cl is None else np.asarray(cl, np.int32)
            keep = None
            if len(sc) > padded_n:
                keep = np.sort(
                    np.argsort(-sc, kind="stable")[:padded_n])
                bx, sc = bx[keep], sc[keep]
                cl = None if cl is None else cl[keep]
            keeps.append(keep)
            n = len(sc)
            boxes_a[row, :n] = bx
            scores_a[row, :n] = sc
            valid_a[row, :n] = True
            if cl is not None:
                classes_a[row, :n] = cl
        return (boxes_a, scores_a, valid_a, classes_a), keeps

    # --- public API ---
    def __call__(self, boxes, scores, classes=None) -> np.ndarray:
        """Rescore one image's detections -> new scores [n] in [0, 1]."""
        return self.rescore_batch([(boxes, scores, classes)])[0]

    def rescore_stream(self, images, batch_size: int = 8,
                       truncate: bool = False):
        """Generator over (index, new_scores) in INPUT ORDER with
        double-buffered dispatch: while the device computes batch k, the
        host packs batch k+1. Consecutive images sharing a shape bucket
        are batched together up to ``batch_size``."""
        pending = None   # (device_out, row_count, metas)

        def emit(entry):
            out, b, metas = entry
            host = out.cpu().numpy()[:b]
            for row, (idx, n, keep) in enumerate(metas):
                yield idx, _scatter_scores(host[row], n, keep)

        def dispatch(group, padded_n):
            arrays, keeps = self._pack(group, padded_n)
            out, b = self._dispatch(*arrays)
            metas = [(idx, len(sc), keeps[row])
                     for row, (idx, _, sc, _) in enumerate(group)]
            return out, b, metas

        cur: list = []
        cur_bucket = None
        for idx, (bx, sc, cl) in enumerate(images):
            self._check_image(idx, sc, cl, truncate)
            bkt = bucket_for(len(sc), self.cfg.data.bucket_sizes)
            if cur and (bkt != cur_bucket or len(cur) == batch_size):
                entry = dispatch(cur, cur_bucket)
                if pending is not None:
                    yield from emit(pending)
                pending = entry
                cur = []
            cur_bucket = bkt
            cur.append((idx, bx, sc, cl))
        if cur:
            entry = dispatch(cur, cur_bucket)
            if pending is not None:
                yield from emit(pending)
            pending = entry
        if pending is not None:
            yield from emit(pending)

    def rescore_async(self, images: Sequence[tuple],
                      padded_n: int | None = None,
                      truncate: bool = False) -> "AsyncBatch":
        """Dispatch ONE batch (all images must share a shape bucket)
        without blocking for the result; :meth:`AsyncBatch.wait` blocks.

        ``padded_n``: the shape bucket to pad to (default: smallest
        configured bucket that fits the largest image in the batch).
        """
        for idx, (_, scores, classes) in enumerate(images):
            self._check_image(idx, scores, classes, truncate)
            if (padded_n is not None and len(scores) > padded_n
                    and not truncate):
                raise ValueError(
                    f"image {idx} has {len(scores)} detections > explicit "
                    f"padded_n={padded_n}; pick a larger bucket or pass "
                    "truncate=True (lowest-scored overflow gets score 0.0)"
                )
        if padded_n is None:
            padded_n = bucket_for(max(len(sc) for _, sc, _ in images),
                                  self.cfg.data.bucket_sizes)
        group = [(i,) + tuple(img) for i, img in enumerate(images)]
        arrays, keeps = self._pack(group, padded_n)
        out, b = self._dispatch(*arrays)
        metas = [(len(sc), keeps[i]) for i, (_, sc, _) in enumerate(images)]
        return AsyncBatch(out, b, metas)

    def rescore_batch(self, images: Sequence[tuple], batch_size: int = 8,
                      truncate: bool = False) -> list[np.ndarray]:
        """Rescore many images; images grouped by shape bucket.

        Each element is (boxes [n,4] xyxy, scores [n], classes [n] | None).
        Returns new scores aligned with each image's input order. Images
        with more detections than the largest bucket raise unless
        ``truncate=True``: then the top-bucket-size detections BY SCORE are
        rescored and the overflow gets score 0.0.
        """
        buckets: dict[int, list[int]] = {}
        for idx, (boxes, scores, classes) in enumerate(images):
            self._check_image(idx, scores, classes, truncate)
            buckets.setdefault(
                bucket_for(len(scores), self.cfg.data.bucket_sizes), []
            ).append(idx)

        out: list[np.ndarray | None] = [None] * len(images)
        for padded_n, idxs in buckets.items():
            for s in range(0, len(idxs), batch_size):
                group = [(idx,) + tuple(images[idx])
                         for idx in idxs[s : s + batch_size]]
                arrays, keeps = self._pack(group, padded_n)
                new_scores = self._run(*arrays)
                for row, (idx, _, sc, _) in enumerate(group):
                    out[idx] = _scatter_scores(
                        new_scores[row], len(sc), keeps[row])
        return out  # type: ignore[return-value]


class AsyncBatch:
    """Handle for one in-flight :meth:`Rescorer.rescore_async` batch;
    ``wait()`` copies the result to the host (the only synchronizing
    step) and returns per-image new-score arrays in dispatch order."""

    def __init__(self, device_out, row_count: int, metas):
        self._out = device_out
        self._b = row_count
        self._metas = metas

    def wait(self) -> list[np.ndarray]:
        host = self._out.cpu().numpy()[: self._b]
        return [_scatter_scores(host[row], n, keep)
                for row, (n, keep) in enumerate(self._metas)]
