"""The multi-class GossipNet (this project's config 3) and its training
step, written plainly from the published description, as
``gossipnet.py`` and ``training.py`` write config 2's.

Per image with n detections of classes c_i in [0, 80) and the neighbour
set E = {(i, j): IoU >= 0.2, self included} of every class::

    rank_i  = #{j: c_j == c_i, s_j > s_i} / max(#{j: c_j == c_i}, 1)
    c_i     = FC_init([s_i, rank_i, E[c_i]])            2 + 32 -> 128
    h_ij    = relu(r_i Wa + b1 + r_j Wb + g_ij Wg)      g_ij: nine features
    ...                                                 (config 2's blocks)

The nine pair features are config 2's eight and the class match
[c_i == c_j], which, like the IoU, is a feature of the pair alone: it
joins the three per-pair features (IoU, cx_j / w_i, cy_j / h_i), and
their four rows of Wg, in the rounding to bfloat16 that
``model.pair_matmul_dtype: bfloat16`` states (0 and 1 are exact in
bfloat16). Everything else is as ``gossipnet.py`` says: the five
separable features fold per detection in float32, b'_j, h1 and W2 are
rounded, the rest is float32 with TF32 off, and the rounding passes the
gradient straight through.

Training (``loss_and_grads``): greedy matching within each class at every
threshold (numpy, on the host): detections in descending score order
each take the still-free real ground truth of their own class with the
highest IoU >= t (the first on a tie); an unmatched detection is ignored
only inside a crowd region of its own class (IoF >= t). The balanced
loss, its mean over thresholds and images, clipping and Adam are
``training.py``'s. The matching may follow another forward's logits
(``order``), so that a gradient is compared on the program's targets.

Departures from the paper, each this project's configuration:
- the input: the paper gives the score and the class (an embedding or a
  one-hot); here a learned 32-wide embedding, and each detection's rank
  among the detections of its own class beside its score;
- a detection has one class and one score (the detector's box of that
  class), where the paper speaks of the scores for the relevant class;
- the neighbour set takes every class; the class enters only as the
  ninth feature;
- the loss weights balance positives and negatives per image and
  threshold, not per class;
- matching at COCO's ten thresholds 0.5:0.95, the scale drill's ``mt``
  recipe, where the paper trains at 0.5;
- the pair stage's products in bfloat16 operands, as the configuration
  states.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from portbench.reference import gossipnet as ref
from portbench.reference.training import image_loss, overlaps

IN_PAIR = (0, 1, 2, 8)     # the per-pair features' rows of Wg


class Geometry(ref.Geometry):
    """Config 2's geometry, with the class match as a fourth per-pair
    feature and the rank taken within each class."""

    def __init__(self, boxes: Tensor, scores: Tensor, classes: Tensor):
        super().__init__(boxes, scores)
        classes = classes.long()
        same = (classes[self.I] == classes[self.J]).float()
        self.pair_feats = torch.cat([self.pair_feats, same[:, None]], -1)
        s = scores.float()
        own = classes[:, None] == classes[None, :]
        higher = (own & (s[None, :] > s[:, None])).sum(-1).float()
        rank = higher / own.sum(-1).float().clamp(min=1.0)
        self.phi = torch.stack([s, rank], dim=-1)
        self.classes = classes


def pair_stage(geom: Geometry, a: Tensor, b: Tensor, wg: Tensor,
               w2: Tensor, b2: Tensor, elementwise: str = "float32"
               ) -> Tensor:
    """m [n, P] of one block from a = r Wa + b1 and b = r Wb, with four
    per-pair features (``gossipnet.pair_stage``'s arithmetic)."""
    ew = ref._bf16 if elementwise == "bfloat16" else (lambda x: x)
    a2 = a + geom.row_feats @ ref._rows(wg, ref._SEP_I)
    b2c = b + geom.col_feats @ ref._rows(wg, ref._SEP_J)
    fc1 = (ref._bf16(b2c)[geom.J]
           + ref._bf16(geom.pair_feats) @ ref._bf16(ref._rows(wg, IN_PAIR)))
    h1 = ref._bf16(torch.relu(ew(ew(a2)[geom.I] + ew(fc1))))
    if elementwise == "bfloat16":
        pre2 = ew(ew(h1 @ ref._bf16(w2)) + ew(b2))
    else:
        pre2 = h1 @ ref._bf16(w2) + b2
    m = torch.zeros((geom.n, pre2.shape[1]), dtype=pre2.dtype,
                    device=pre2.device)
    idx = geom.I[:, None].expand_as(pre2)
    return m.scatter_reduce(0, idx, pre2, reduce="amax", include_self=True)


def forward(params: dict, geom: Geometry, num_blocks: int,
            elementwise: str = "float32") -> Tensor:
    """Logits [n] of one image. ``params`` by the names of the benchmark's
    weights (``portbench/weights_multiclass.py``)."""
    emb = params["class_embed.weight"][geom.classes]
    c = ref.linear(torch.cat([geom.phi, emb], dim=-1), params, "init_fc")
    for k in range(num_blocks):
        p = f"blocks.{k}."
        r = torch.relu(ref.linear(c, params, p + "reduce"))
        a = r @ params[p + "pair_wa"] + params[p + "pair_b1"]
        b = r @ params[p + "pair_wb"]
        m = pair_stage(geom, a, b, params[p + "pair_wg"],
                       params[p + "pair_w2"], params[p + "pair_b2"],
                       elementwise)
        e = torch.relu(ref.linear(m, params, p + "expand"))
        c = c + ref.linear(e, params, p + "expand_out")
    return ref.linear(c, params, "head")[:, 0]


def match(boxes, logits, classes, gt_boxes, gt_classes, gt_crowd,
          thresholds):
    """One image, within classes -> (labels [T, n] float32, ignore [T, n]
    bool)."""
    n, t = len(logits), len(thresholds)
    labels = np.zeros((t, n), np.float32)
    ignore = np.zeros((t, n), bool)
    if n == 0:
        return labels, ignore
    iou, iof = overlaps(boxes, gt_boxes)
    same = np.asarray(classes)[:, None] == np.asarray(gt_classes)[None, :]
    real, crowd = ~gt_crowd, gt_crowd
    order = np.argsort(-logits, kind="stable")
    for k, thr in enumerate(np.asarray(thresholds, np.float32)):
        free = real.copy()
        for i in order:
            cand = np.where(free & same[i] & (iou[i] >= thr), iou[i],
                            -np.inf)
            if cand.size and cand.max() > -np.inf:
                free[int(np.argmax(cand))] = False
                labels[k, i] = 1.0
            elif (crowd & same[i] & (iof[i] >= thr)).any():
                ignore[k, i] = True
    return labels, ignore


def loss_and_grads(params: dict, images: list, num_blocks: int, thresholds,
                   elementwise: str = "float32", order: list | None = None):
    """images: (boxes, scores, classes, gt_boxes, gt_classes, gt_crowd)
    numpy, valid rows only -> (loss, grads by name), as
    ``training.loss_and_grads``: the images' losses averaged, each image's
    backward on its own.

    ``order``: per image, the logits whose descending order the greedy
    matching follows, in place of this forward's own. The labels are
    targets of detached logits and jump where two logits tie: where the
    program's forward and this one differ in the last bits, two detections
    of one ground truth with nearly equal logits can take it in the other
    order. The check passes the program's own logits, so that both
    gradients are taken on the same targets."""
    ref.no_tf32()
    names = list(params)
    leaves = [params[k].detach().requires_grad_(True) for k in names]
    live = dict(zip(names, leaves))
    dev = leaves[0].device
    total = 0.0
    grads = [torch.zeros_like(p) for p in leaves]
    for n, (boxes, scores, classes, gt_boxes, gt_classes,
            gt_crowd) in enumerate(images):
        geom = Geometry(torch.as_tensor(boxes, device=dev),
                        torch.as_tensor(scores, device=dev),
                        torch.as_tensor(classes, device=dev))
        logits = forward(live, geom, num_blocks, elementwise)
        key = (logits.detach().cpu().numpy() if order is None
               else np.asarray(order[n], np.float32))
        labels, ignore = match(boxes, key, classes, gt_boxes, gt_classes,
                               gt_crowd, thresholds)
        loss = image_loss(logits, labels, ignore) / len(images)
        for g, d in zip(grads, torch.autograd.grad(loss, leaves,
                                                   allow_unused=True)):
            if d is not None:
                g += d
        total += float(loss.detach())
    return total, dict(zip(names, grads))
