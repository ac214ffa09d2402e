"""Sort-based per-detection score rank (port of ``gossipnet_tpu.ops.ranking``).

rank_i = #{j : valid_j, score_j > score_i} / max(#{j : valid_j}, 1), from
one ascending sort and ``searchsorted(right=True)``, with -inf at padding
(a padding row's rank is the valid count, normalised to 1 or 0).
"""

from __future__ import annotations

import torch
from torch import Tensor


def score_rank(scores: Tensor, valid: Tensor) -> Tensor:
    """Normalized score rank in [0, 1], float32, shape = scores.shape.

    Only the class-agnostic variant is ported; the per-class rank comes
    with the multi-class model (ROADMAP.md item 11).
    """
    key = torch.where(valid, scores.float(),
                      torch.full_like(scores, float("-inf"), dtype=torch.float32))
    n = key.shape[-1]
    flat = key.reshape(-1, n)
    asc = torch.sort(flat, dim=-1).values
    le = torch.searchsorted(asc, flat, right=True)      # entries <= key_i
    rank = (n - le).to(torch.float32)
    denom = torch.clamp(
        valid.reshape(-1, n).sum(dim=-1, keepdim=True).to(torch.float32),
        min=1.0)
    return (rank / denom).reshape(key.shape)
