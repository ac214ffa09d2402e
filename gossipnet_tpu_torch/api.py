"""Serving API: rescore raw detections, NMS-free (port of
``gossipnet_tpu/api.py``).

    rescorer = Rescorer.from_checkpoint(cfg, "checkpoints/")  # device="cuda"
    new_scores = rescorer(boxes, scores)            # one image
    kept = boxes[new_scores > 0.5]                  # thresholding IS NMS
    results = rescorer.rescore_batch(list_of_images)  # bucketed batches

Images are padded to shape buckets and batched per bucket; results come
back per detection in input order. ``params`` is a PyTorch ``state_dict``
or a JAX parameter tree of numpy arrays (bridged by ``params.py``);
``from_checkpoint`` reads the best (or latest) checkpoint a training run
of this package wrote. On
CUDA the default pool path is the pair kernel of ``model.pair_kernel`` (K1
or K5); there is no CPU fallback —
``device="cpu"`` must be asked for.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from gossipnet_tpu_torch.config import Config
from gossipnet_tpu_torch.data.bucketing import bucket_for
from gossipnet_tpu_torch.models.gossipnet import resolve_device
from gossipnet_tpu_torch.params import as_state_dict
from gossipnet_tpu_torch.utils.cuda_graphs import forward_graphs


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


def zero_batch(b: int, n: int) -> tuple:
    """An all-padding (b, n) batch of packed arrays: warm-up and timing
    runs."""
    return (np.zeros((b, n, 4), np.float32), np.zeros((b, n), np.float32),
            np.zeros((b, n), bool), np.zeros((b, n), np.int32))


class _HostCopy:
    """One dispatched batch's probabilities on their way to the host.

    On the card the copy into pinned host memory is enqueued right behind
    the batch's forward and an event marks its end, so reading it waits
    for this batch alone, not for batches enqueued after it on the same
    stream. On the CPU the tensor is already on the host."""

    def __init__(self, probs: torch.Tensor):
        self._ready = None
        if probs.is_cuda:
            self._host = torch.empty(probs.shape, dtype=probs.dtype,
                                     pin_memory=True)
            self._host.copy_(probs, non_blocking=True)
            self._ready = torch.cuda.Event()
            self._ready.record()
        else:
            self._host = probs

    def numpy(self) -> np.ndarray:
        if self._ready is not None:
            self._ready.synchronize()
        return self._host.numpy()


class Rescorer:
    """Bucketed detection rescorer on one device.

    A batch dispatches at its padded shape (``_pad_batch``: the next power
    of two, as the reference pads), and on the card each (padded batch,
    bucket) replays a graph captured at its first dispatch
    (``utils/cuda_graphs.py::ForwardGraphs``, kept on the model), as the
    reference compiles one executable per shape; :meth:`warmup` captures
    the whole set.
    """

    def __init__(self, cfg: Config, params, pool_impl: str | None = None,
                 device="cuda"):
        from gossipnet_tpu_torch.train import build_model

        self.cfg = cfg
        self.device = resolve_device(device)
        if pool_impl is None:
            pool_impl = "kernel" if self.device.type == "cuda" else "dense"
        self.model = build_model(cfg, pool_impl, self.device).eval()
        self._graphs = forward_graphs(self.model)
        # held while a batch's forward is enqueued and while reload copies:
        # a batch never runs on a mix of old and new weights
        self._lock = threading.Lock()
        self._load(params)

    # --- constructors ---
    @staticmethod
    def load_checkpoint_params(cfg: Config, checkpoint_dir: str,
                               best: bool = True) -> dict:
        """The trained parameters (a ``state_dict`` on the CPU) of the
        best-AP checkpoint, or of the latest periodic one when ``best`` is
        false or no best exists. Builds the model on the CPU only, so
        tools that need weights alone (the artifact export) need no card.
        """
        from gossipnet_tpu_torch.train import build_model, create_train_state
        from gossipnet_tpu_torch.utils.checkpoint import CheckpointManager

        if not Path(checkpoint_dir).is_dir():   # the manager would make it
            raise FileNotFoundError(f"no checkpoint in {checkpoint_dir}")
        ckpt = CheckpointManager(checkpoint_dir)
        if not (best and ckpt.has_best()) and ckpt.latest_step() is None:
            raise FileNotFoundError(f"no checkpoint in {checkpoint_dir}")
        state = create_train_state(
            cfg, build_model(cfg, "dense", torch.device("cpu")))
        if best and ckpt.has_best():
            state = ckpt.restore_best(state)
        else:
            state, _ = ckpt.restore(state)
        return state.model.state_dict()

    @classmethod
    def from_checkpoint(cls, cfg: Config, checkpoint_dir: str,
                        pool_impl: str | None = None, best: bool = True,
                        device="cuda") -> "Rescorer":
        """Serve the best-AP (or latest periodic) checkpoint."""
        params = cls.load_checkpoint_params(cfg, checkpoint_dir, best=best)
        return cls(cfg, params, pool_impl, device=device)

    # --- internals ---
    def _pad_batch(self, b: int) -> int:
        """The padded batch a b-image group dispatches at: the next power
        of two, so the set of captured shapes stays (log2(batch_size) + 1)
        x buckets (``gossipnet_tpu/api.py:164``). Overridden by
        ``ArtifactRescorer``, whose shape set is fixed at export time."""
        return 1 << max(b - 1, 0).bit_length()

    def _dispatch(self, boxes_a, scores_a, valid_a, classes_a):
        """Enqueue one padded batch on the device; returns (a
        :class:`_HostCopy` of the probabilities, row count). CUDA work is
        asynchronous: the caller can pack the next batch while this one
        computes. The class ids reach a multi-class model and nothing
        else.

        Under the lock: the copy into the graph's static inputs, the
        replay and the read-back, which stream order puts before the next
        replay overwrites the graph's output."""
        b = scores_a.shape[0]
        b_pad = self._pad_batch(b)
        if b_pad != b:   # inert rows: valid=False
            pad = ((0, b_pad - b),)
            boxes_a = np.pad(boxes_a, pad + ((0, 0), (0, 0)))
            scores_a = np.pad(scores_a, pad + ((0, 0),))
            valid_a = np.pad(valid_a, pad + ((0, 0),))
            classes_a = np.pad(classes_a, pad + ((0, 0),))
        with self._lock:
            return _HostCopy(self._graphs(boxes_a, scores_a, valid_a,
                                          classes_a)), b

    def _run(self, boxes_a, scores_a, valid_a, classes_a) -> np.ndarray:
        """Dispatch one padded batch and block for the result."""
        out, b = self._dispatch(boxes_a, scores_a, valid_a, classes_a)
        return out.numpy()[:b]

    def reload(self, params=None, *, checkpoint_dir: str | None = None,
               best: bool = True) -> None:
        """Swap serving weights in place: new ``params`` (a ``state_dict``
        or a JAX tree), or the best-AP (``best``) or latest checkpoint of
        ``checkpoint_dir``.

        Safe to call from an admin thread or a signal handler while other
        threads serve. The copy takes the lock that ``_dispatch`` holds
        while it enqueues a batch's forward, so it waits for a batch being
        enqueued and no batch runs on a mix of old and new weights. It is
        ordered on the device's stream after every batch already
        dispatched, so those finish on the old weights, and every later
        dispatch uses the new ones.
        """
        if (params is None) == (checkpoint_dir is None):
            raise ValueError("pass exactly one of params / checkpoint_dir")
        if checkpoint_dir is not None:
            params = self.load_checkpoint_params(self.cfg, checkpoint_dir,
                                                 best=best)
        self._load(params)

    def _load(self, params) -> None:
        """Copy ``params`` into the live model under the dispatch lock,
        after checking that every name and shape matches."""
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
        with self._lock, torch.no_grad():
            self.model.load_state_dict(sd)

    def warmup(self, batch_size: int = 8) -> None:
        """Dispatch every (batch, bucket) shape reachable for requests
        served at ``batch_size`` (batches padded to powers of two), so
        each graph is captured before the first real request
        (``gossipnet_tpu/api.py:204``)."""
        batches = sorted({self._pad_batch(b)
                          for b in range(1, batch_size + 1)})
        for n in self.cfg.data.bucket_sizes:
            for b in batches:
                self._run(*zero_batch(b, n))

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
        nc = self.cfg.model.num_classes
        if nc > 1 and len(classes) and not (
                0 <= np.min(classes) and np.max(classes) < nc):
            # An id the class embedding lacks would fault the device.
            raise ValueError(f"image {idx}: class ids must lie in "
                             f"[0, {nc})")
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
            host = out.numpy()[:b]
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
    ``wait()`` blocks until this batch's result is on the host (the only
    synchronizing step; it does not wait for batches dispatched after it)
    and returns per-image new-score arrays in dispatch order."""

    def __init__(self, host_copy: _HostCopy, row_count: int, metas):
        self._out = host_copy
        self._b = row_count
        self._metas = metas

    def wait(self) -> list[np.ndarray]:
        host = self._out.numpy()[: self._b]
        return [_scatter_scores(host[row], n, keep)
                for row, (n, keep) in enumerate(self._metas)]
