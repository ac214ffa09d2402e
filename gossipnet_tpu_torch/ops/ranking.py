"""Sort-based per-detection score rank (port of ``gossipnet_tpu.ops.ranking``).

rank_i = #{j : valid_j, class_j == class_i, score_j > score_i}
         / max(#{j : valid_j, class_j == class_i}, 1)

with key = -inf at padding (a padding row's rank is its class's valid
count, normalised to 1 or 0), and no [N, N] tensor:
- class-agnostic: one ascending sort and ``searchsorted(right=True)``;
- per class: one lexsort by (class, -key), then the strict rank is the
  tie group's start minus the class segment's start; the denominators are
  per-class counts of the valid detections.
"""

from __future__ import annotations

import torch
from torch import Tensor


def _rank_per_class(key: Tensor, classes: Tensor) -> Tensor:
    """[R, N] key / classes -> strictly-greater-within-class counts [R, N]."""
    n = key.shape[-1]
    # lexsort (class ascending, key descending) as two stable sorts
    by_key = torch.argsort(-key, dim=-1, stable=True)
    order = torch.gather(by_key, -1, torch.argsort(
        torch.gather(classes, -1, by_key), dim=-1, stable=True))
    sk = torch.gather(key, -1, order)
    sc = torch.gather(classes, -1, order)
    pos = torch.arange(n, device=key.device).expand_as(order)
    first = torch.ones_like(sc[:, :1], dtype=torch.bool)
    new_class = torch.cat([first, sc[:, 1:] != sc[:, :-1]], dim=-1)
    new_tie = new_class | torch.cat([first, sk[:, 1:] != sk[:, :-1]], dim=-1)
    zero = torch.zeros_like(pos)
    class_start = torch.cummax(torch.where(new_class, pos, zero), -1).values
    tie_start = torch.cummax(torch.where(new_tie, pos, zero), -1).values
    rank_sorted = (tie_start - class_start).to(torch.float32)
    return torch.empty_like(rank_sorted).scatter_(-1, order, rank_sorted)


def score_rank(scores: Tensor, valid: Tensor, classes: Tensor | None = None,
               num_classes: int = 1) -> Tensor:
    """Normalized score rank in [0, 1], float32, shape = scores.shape.

    ``classes=None`` is the class-agnostic variant; otherwise class ids in
    [0, num_classes) of the same shape rank within their class.
    """
    key = torch.where(valid, scores.float(),
                      torch.full_like(scores, float("-inf"), dtype=torch.float32))
    n = key.shape[-1]
    flat = key.reshape(-1, n)
    flat_valid = valid.reshape(-1, n).to(torch.float32)
    if classes is None:
        asc = torch.sort(flat, dim=-1).values
        le = torch.searchsorted(asc, flat, right=True)      # entries <= key_i
        rank = (n - le).to(torch.float32)
        denom = flat_valid.sum(dim=-1, keepdim=True)
    else:
        cls = classes.reshape(-1, n).long()
        rank = _rank_per_class(flat, cls)
        counts = torch.zeros((flat.shape[0], num_classes), dtype=torch.float32,
                             device=flat.device).scatter_add_(-1, cls,
                                                              flat_valid)
        denom = torch.gather(counts, -1, cls)
    return (rank / torch.clamp(denom, min=1.0)).reshape(key.shape)
