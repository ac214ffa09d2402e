"""Morton (Z-order) sort key of box centers (port of ``gossipnet_tpu.ops.order``).

GossipNet is permutation-equivariant per detection, so sorting its inputs
(and unsorting the logits) only changes speed: a Morton key clusters each
kernel tile in both axes, so the block-sparse pair kernel's tile bbox test
can skip. PyTorch's uint32 support is thin, so the key is computed in
int64 with the same bits as the JAX uint32 key: 16-bit quantized centers
capped at 65534, interleaved, and 0xFFFFFFFF for invalid rows.
"""

from __future__ import annotations

import torch
from torch import Tensor

SENTINEL = 0xFFFFFFFF


def _part1by1(x: Tensor) -> Tensor:
    """Spread the low 16 bits of x to even bit positions (int64)."""
    x = x & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _quantize(c: Tensor, valid: Tensor) -> Tensor:
    inf = torch.full_like(c, float("inf"))
    lo = torch.where(valid, c, inf).amin(dim=-1, keepdim=True)
    hi = torch.where(valid, c, -inf).amax(dim=-1, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-6)
    # The 65534 cap keeps the max-corner box's key below the sentinel.
    q = torch.clamp((c - lo) / span * 65535.0, 0.0, 65534.0)
    return q.to(torch.int64)


def morton_sort_key(boxes: Tensor, valid: Tensor) -> Tensor:
    """Z-order key of box centers, int64 in [0, 2^32); invalid rows sort LAST."""
    cx = 0.5 * (boxes[..., 0] + boxes[..., 2])
    cy = 0.5 * (boxes[..., 1] + boxes[..., 3])
    key = (_part1by1(_quantize(cy, valid)) << 1) | _part1by1(_quantize(cx, valid))
    return torch.where(valid, key, torch.full_like(key, SENTINEL))
