"""Static-shape batch assembly and the resumable training iterator (numpy
copy of ``gossipnet_tpu.data.bucketing``: ``Batch``, ``bucket_for``,
``make_batch``, ``IteratorState``, ``BatchIterator``).

Every image is padded to the smallest bucket of
``DataConfig.bucket_sizes`` that fits it; images sharing a bucket stack
into [B, N, ...] batches. The iterator's code is the reference's, so both
packages draw the same batches from the same seed, and its state is
(epoch, cursor) plus the seed, so a resumed run replays the exact stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, NamedTuple, Sequence

import numpy as np

from gossipnet_tpu_torch.data.roidb import ImageRecord, Roidb


class Batch(NamedTuple):
    """Padded host-side batch; field names match model/matching inputs."""

    image_ids: np.ndarray    # [B]
    boxes: np.ndarray        # [B, N, 4] xyxy
    scores: np.ndarray       # [B, N]
    valid: np.ndarray        # [B, N] bool
    classes: np.ndarray      # [B, N] int32
    gt_boxes: np.ndarray     # [B, G, 4]
    gt_classes: np.ndarray   # [B, G] int32
    gt_valid: np.ndarray     # [B, G] bool
    gt_crowd: np.ndarray     # [B, G] bool

    @property
    def batch_size(self) -> int:
        return self.boxes.shape[0]

    @property
    def padded_n(self) -> int:
        return self.boxes.shape[1]

    @property
    def padded_g(self) -> int:
        return self.gt_boxes.shape[1]


def bucket_for(n: int, bucket_sizes: Sequence[int]) -> int:
    """Smallest bucket >= n (largest bucket if none fits — caller should
    have capped detections already)."""
    for b in sorted(bucket_sizes):
        if n <= b:
            return b
    return max(bucket_sizes)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def make_batch(
    records: Sequence[ImageRecord],
    padded_n: int,
    padded_g: int | None = None,
    gt_align: int = 16,
) -> Batch:
    """Stack records into one padded batch.

    GT padding is rounded up to ``gt_align`` across the batch unless
    ``padded_g`` is forced.
    """
    b = len(records)
    if padded_g is None:
        max_g = max((len(r.gt_classes) for r in records), default=0)
        padded_g = max(_round_up(max_g, gt_align), gt_align)

    out = Batch(
        image_ids=np.zeros(b, np.int64),
        boxes=np.zeros((b, padded_n, 4), np.float32),
        scores=np.zeros((b, padded_n), np.float32),
        valid=np.zeros((b, padded_n), bool),
        classes=np.zeros((b, padded_n), np.int32),
        gt_boxes=np.zeros((b, padded_g, 4), np.float32),
        gt_classes=np.zeros((b, padded_g), np.int32),
        gt_valid=np.zeros((b, padded_g), bool),
        gt_crowd=np.zeros((b, padded_g), bool),
    )
    for i, r in enumerate(records):
        n = min(r.num_dets, padded_n)
        g = min(len(r.gt_classes), padded_g)
        out.image_ids[i] = r.image_id
        out.boxes[i, :n] = r.det_boxes[:n]
        out.scores[i, :n] = r.det_scores[:n]
        out.valid[i, :n] = True
        out.classes[i, :n] = r.det_classes[:n]
        out.gt_boxes[i, :g] = r.gt_boxes[:g]
        out.gt_classes[i, :g] = r.gt_classes[:g]
        out.gt_valid[i, :g] = True
        out.gt_crowd[i, :g] = r.gt_crowd[:g]
    return out


@dataclass
class IteratorState:
    """Resumable position in the shuffled stream."""

    epoch: int = 0
    cursor: int = 0


class BatchIterator:
    """Infinite shuffled iterator over bucketed, padded batches.

    Images are grouped by bucket each epoch; whole batches are drawn from
    one bucket so every batch has a single static shape. Partial tail
    groups are padded by repeating images (marked via duplicate image_ids).
    """

    def __init__(
        self,
        roidb: Roidb,
        batch_size: int,
        bucket_sizes: Sequence[int],
        seed: int = 0,
        shuffle: bool = True,
        state: IteratorState | None = None,
    ):
        if len(roidb) == 0:
            raise ValueError("empty roidb")
        self.roidb = roidb
        self.batch_size = batch_size
        self.bucket_sizes = tuple(sorted(bucket_sizes))
        self.seed = seed
        self.shuffle = shuffle
        self.state = state or IteratorState()
        self._plan: list[tuple[int, tuple[int, ...]]] | None = None
        self._plan_epoch = -1

    def _epoch_plan(self, epoch: int) -> list[tuple[int, tuple[int, ...]]]:
        """Deterministic list of (bucket_n, record_indices) batches."""
        if self._plan is not None and self._plan_epoch == epoch:
            return self._plan
        rng = np.random.default_rng((self.seed, epoch))
        order = np.arange(len(self.roidb))
        if self.shuffle:
            rng.shuffle(order)
        buckets: dict[int, list[int]] = {}
        for idx in order:
            n = self.roidb.records[idx].num_dets
            buckets.setdefault(bucket_for(n, self.bucket_sizes), []).append(idx)
        plan: list[tuple[int, tuple[int, ...]]] = []
        for bn in sorted(buckets):
            idxs = buckets[bn]
            for s in range(0, len(idxs), self.batch_size):
                group = idxs[s : s + self.batch_size]
                while len(group) < self.batch_size:  # repeat-pad tail
                    group = group + group[: self.batch_size - len(group)]
                plan.append((bn, tuple(group)))
        if self.shuffle:
            rng.shuffle(plan)  # interleave buckets
        self._plan, self._plan_epoch = plan, epoch
        return plan

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        plan = self._epoch_plan(self.state.epoch)
        if self.state.cursor >= len(plan):
            self.state = IteratorState(epoch=self.state.epoch + 1, cursor=0)
            plan = self._epoch_plan(self.state.epoch)
        bn, group = plan[self.state.cursor]
        self.state = IteratorState(self.state.epoch, self.state.cursor + 1)
        return make_batch([self.roidb.records[i] for i in group], padded_n=bn)

    # --- checkpointable state ---
    def get_state(self) -> dict:
        return {"epoch": self.state.epoch, "cursor": self.state.cursor,
                "seed": self.seed}

    def set_state(self, s: dict) -> None:
        if s.get("seed", self.seed) != self.seed:
            raise ValueError("iterator seed mismatch on restore")
        self.state = IteratorState(int(s["epoch"]), int(s["cursor"]))
        self._plan = None
