"""The work of the multi-class model (config 3), counted as ``counts.py``
counts config 2's: from what the benchmark sent, whatever the program
does with it.

The class match is a ninth pair feature that no fold can take per
detection, so a neighbour pair has four in-pair features (IoU, two centre
ratios, the class match) where config 2's has three, and a pair-stage
launch reads nine fields a side, the class beside config 2's eight. A
detection's input is its score, its rank and its class's 32-wide
embedding, so ``init_fc`` takes 34 inputs; the embedding itself is a
lookup, no operation.
"""

from __future__ import annotations

from portbench import counts

IN_PAIR_FEATURES = 4     # IoU, cx_j / w_i, cy_j / h_i, [c_i == c_j]
FIELDS = 9               # config 2's eight and the class, a side


def pair_flops(p: int) -> int:
    """Operations of one neighbour pair in one block's pair stage."""
    return counts.pair_flops(p, k=IN_PAIR_FEATURES)


def input_width(model: dict) -> int:
    """``init_fc``'s inputs: the score, the rank and the embedding."""
    return (1 + int(model.get("score_rank_feature", True))
            + model["class_embed_dim"])


def forward_flops(model: dict, dets: int, pairs: int) -> int:
    """The multi-class forward over ``dets`` detections with ``pairs``
    neighbour pairs in all: every block, the input and the head."""
    fd = model["feature_dim"]
    per_block = pairs * pair_flops(model["pairwise_dim"]) + dets * (
        counts.detection_flops(model))
    return model["num_blocks"] * per_block + dets * (
        2 * input_width(model) * fd + fd + 2 * fd + 1)


def _weight_bytes(p: int) -> int:
    return (IN_PAIR_FEATURES * p + p * p + p) * 4


def pair_forward_bytes(p: int, dets: int, launches: int) -> int:
    """One launch per block reads the nine row and column fields, a' and
    b' of each detection and writes m; each launch reads its weights."""
    return dets * (2 * FIELDS + 3 * p) * 4 + launches * _weight_bytes(p)


def pair_backward_bytes(p: int, dets: int, launches: int) -> int:
    """Reads the fields, a', b', m and dm; writes d_a' and d_b'; each
    launch reads its weights and writes their gradients."""
    return dets * (2 * FIELDS + 6 * p) * 4 + launches * 2 * _weight_bytes(p)
