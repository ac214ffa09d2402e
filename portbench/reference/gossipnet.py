"""GossipNet's forward (Hosang et al., CVPR 2017), written from the
published description and the configuration's stated precision.

Per image with n detections and neighbour set E = {(i, j): IoU >= 0.2,
self included}, K residual blocks::

    c_i    = FC_init([s_i, rank_i])                     2 -> 128
    r_i    = relu(FC_reduce(c_i))                       128 -> 32
    h_ij   = relu(r_i Wa + b1 + r_j Wb + g_ij Wg)
    m_i    = relu(max_{j in E(i)} W2^T h_ij + b2)
    c_i   += FC_out(relu(FC_expand(m_i)))               32 -> 32 -> 128
    logit_i = FC_head(c_i)

with the eight pair features g_ij = [IoU, (cx_j - cx_i)/w_i,
(cy_j - cy_i)/h_i, log w_j/w_i, log h_j/h_i, log-aspect difference, s_i,
s_j] and rank_i the share of detections scoring strictly higher.

Precision, as ``model.pair_matmul_dtype: bfloat16`` states it: the pair
stage's two products take bfloat16 operands with float32 sums. Five of the
eight features are sums of a row term and a column term, so their products
are taken per detection in float32 (the row terms join r_i Wa + b1, the
column terms join r_j Wb); the column sum b'_j, the three per-pair
features (IoU, cx_j / w_i, cy_j / h_i), their rows of Wg, h1 and W2 are
rounded to bfloat16. Everything else is float32 with TF32 off. The
rounding passes the gradient straight through, so a backward is the
float32 gradient of this forward. ``elementwise="bfloat16"`` also rounds
a', the FC1 sum and pre2 (``model.pair_elementwise_dtype: bfloat16``):
the control of the comparison, one precision below the configuration's.
"""

from __future__ import annotations

import torch
from torch import Tensor

NEIGHBOR_IOU = 0.2
_SEP_I = (1, 2, 3, 4, 5, 6)
_SEP_J = (3, 4, 5, 7)
_IN_PAIR = (0, 1, 2)


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _bf16(x: Tensor) -> Tensor:
    """x rounded to bfloat16 in the forward, the identity in the backward."""
    return x + (x.to(torch.bfloat16).float() - x).detach()


class Geometry:
    """What depends only on one image's detections: columns, the rank
    feature, the neighbour pairs (I, J) and their in-pair features."""

    def __init__(self, boxes: Tensor, scores: Tensor):
        boxes, scores = boxes.float(), scores.float()
        x1, y1, x2, y2 = boxes.unbind(-1)
        w = torch.clamp(x2 - x1, min=1e-3)
        h = torch.clamp(y2 - y1, min=1e-3)
        cx, cy = x1 + 0.5 * w, y1 + 0.5 * h
        lw, lh = torch.log(w), torch.log(h)
        la = lw - lh
        area = w * h
        n = scores.shape[0]
        ix = torch.clamp(torch.minimum(x2[:, None], x2[None])
                         - torch.maximum(x1[:, None], x1[None]), min=0.0)
        iy = torch.clamp(torch.minimum(y2[:, None], y2[None])
                         - torch.maximum(y1[:, None], y1[None]), min=0.0)
        inter = ix * iy
        union = area[:, None] + area[None] - inter
        iou = inter / torch.clamp(union, min=1e-6)
        self.I, self.J = torch.nonzero(iou >= NEIGHBOR_IOU, as_tuple=True)
        inv_w, inv_h = 1.0 / w, 1.0 / h
        self.pair_feats = torch.stack(
            [iou[self.I, self.J], cx[self.J] * inv_w[self.I],
             cy[self.J] * inv_h[self.I]], dim=-1)
        self.row_feats = torch.stack([-cx / w, -cy / h, -lw, -lh, -la,
                                      scores], dim=-1)
        self.col_feats = torch.stack([lw, lh, la, scores], dim=-1)
        rank = (scores[None, :] > scores[:, None]).sum(-1).float() / max(n, 1)
        self.phi = torch.stack([scores, rank], dim=-1)
        self.n = n

    @property
    def pairs(self) -> int:
        return int(self.I.shape[0])


def _rows(w: Tensor, rows: tuple) -> Tensor:
    return torch.stack([w[r] for r in rows])


def pair_stage(geom: Geometry, a: Tensor, b: Tensor, wg: Tensor, w2: Tensor,
               b2: Tensor, elementwise: str = "float32") -> Tensor:
    """m [n, P] of one block from a = r Wa + b1 and b = r Wb."""
    ew = _bf16 if elementwise == "bfloat16" else (lambda x: x)
    a2 = a + geom.row_feats @ _rows(wg, _SEP_I)
    b2c = b + geom.col_feats @ _rows(wg, _SEP_J)
    fc1 = (_bf16(b2c)[geom.J]
           + _bf16(geom.pair_feats) @ _bf16(_rows(wg, _IN_PAIR)))
    h1 = _bf16(torch.relu(ew(ew(a2)[geom.I] + ew(fc1))))
    if elementwise == "bfloat16":
        pre2 = ew(ew(h1 @ _bf16(w2)) + ew(b2))
    else:
        pre2 = h1 @ _bf16(w2) + b2
    m = torch.zeros((geom.n, pre2.shape[1]), dtype=pre2.dtype,
                    device=pre2.device)
    idx = geom.I[:, None].expand_as(pre2)
    return m.scatter_reduce(0, idx, pre2, reduce="amax", include_self=True)


def linear(x: Tensor, params: dict, name: str) -> Tensor:
    return x @ params[f"{name}.weight"].T + params[f"{name}.bias"]


def forward(params: dict, geom: Geometry, num_blocks: int,
            elementwise: str = "float32") -> Tensor:
    """Logits [n] of one image. ``params`` by the names of the benchmark's
    weights (``portbench/weights.py``)."""
    c = linear(geom.phi, params, "init_fc")
    for k in range(num_blocks):
        p = f"blocks.{k}."
        r = torch.relu(linear(c, params, p + "reduce"))
        a = r @ params[p + "pair_wa"] + params[p + "pair_b1"]
        b = r @ params[p + "pair_wb"]
        m = pair_stage(geom, a, b, params[p + "pair_wg"],
                       params[p + "pair_w2"], params[p + "pair_b2"],
                       elementwise)
        e = torch.relu(linear(m, params, p + "expand"))
        c = c + linear(e, params, p + "expand_out")
    return linear(c, params, "head")[:, 0]
