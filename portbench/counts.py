"""The work a cell's inputs need, counted by the benchmark from what it
sent: neighbour pairs, operations and bytes of the pair stage and of the
whole model, and the published peaks they are held to.

Nothing here depends on how the program computes: no skip tile, no
padding, no IoU test that a tile makes. A pair stage's work is its
neighbour pairs (IoU >= 0.2, self included) times the operations one
pair needs; its bytes are each input and output read or written once.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())
IN_PAIR_FEATURES = 3     # IoU, cx_j / w_i, cy_j / h_i (the rest fold per row)
SEPARABLE = 10           # the folded features: six row terms, four column
FIELDS = 8               # per-detection fields the pair stage reads a side


def neighbour_pairs(boxes: np.ndarray, threshold: float = 0.2,
                    chunk: int = 512) -> int:
    """Ordered pairs (i, j), i == j included, of one image's detections
    with IoU >= threshold, in float32 as the model computes it."""
    b = np.asarray(boxes, np.float32)
    if len(b) == 0:
        return 0
    one = np.float32(1e-3)
    w = np.maximum(b[:, 2] - b[:, 0], one)
    h = np.maximum(b[:, 3] - b[:, 1], one)
    area = w * h
    total = 0
    for s in range(0, len(b), chunk):
        r = b[s:s + chunk]
        ix = np.maximum(np.minimum(r[:, None, 2], b[None, :, 2])
                        - np.maximum(r[:, None, 0], b[None, :, 0]),
                        np.float32(0))
        iy = np.maximum(np.minimum(r[:, None, 3], b[None, :, 3])
                        - np.maximum(r[:, None, 1], b[None, :, 1]),
                        np.float32(0))
        inter = ix * iy
        union = area[s:s + chunk, None] + area[None] - inter
        iou = inter / np.maximum(union, np.float32(1e-6))
        total += int((iou >= np.float32(threshold)).sum())
    return total


def pair_flops(p: int, k: int = IN_PAIR_FEATURES) -> int:
    """Operations of one neighbour pair in one block's pair stage: FC1
    over the in-pair features (2kP), a'_i + b'_j + FC1 (2P), FC2 (2P^2),
    its bias (P) and the running max (P)."""
    return 2 * p * p + 2 * k * p + 4 * p


def detection_flops(model: dict) -> int:
    """Operations of one detection in one block outside the pairs: the
    reduce, a and b, the folded row and column terms, the expansion and
    the residual add."""
    fd, rd = model["feature_dim"], model["reduced_dim"]
    p = model["pairwise_dim"]
    linears = [(fd, rd), (rd, p), (p, p), (p, fd)]
    hidden = model.get("expand_hidden_layers", 2) - 2
    linears += [(p, p)] * hidden
    return (sum(2 * i * o + o for i, o in linears) + 2 * rd * p
            + 2 * SEPARABLE * p + fd)


def forward_flops(model: dict, dets: int, pairs: int) -> int:
    """The model's forward over ``dets`` detections with ``pairs``
    neighbour pairs in all: every block, the input and the head."""
    fd = model["feature_dim"]
    phi = 1 + int(model.get("score_rank_feature", True))
    per_block = pairs * pair_flops(model["pairwise_dim"]) + dets * (
        detection_flops(model))
    return model["num_blocks"] * per_block + dets * (
        2 * phi * fd + fd + 2 * fd + 1)


def pair_forward_bytes(p: int, dets: int, launches: int) -> int:
    """One launch per block reads the row and column fields, a' and b' of
    each detection and writes m; each launch also reads its weights."""
    weights = (IN_PAIR_FEATURES * p + p * p + p) * 4
    return dets * (2 * FIELDS + 3 * p) * 4 + launches * weights


def pair_backward_bytes(p: int, dets: int, launches: int) -> int:
    """Reads the fields, a', b', m and dm; writes d_a' and d_b'; each
    launch reads its weights and writes their gradients."""
    weights = (IN_PAIR_FEATURES * p + p * p + p) * 4 * 2
    return dets * (2 * FIELDS + 6 * p) * 4 + launches * weights


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    at the bf16 tensor-core peak and the bytes at the memory peak."""
    return max(flops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"])
