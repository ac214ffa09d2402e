"""The training step of config 2 written plainly: greedy det<->GT matching
at the IoU thresholds (numpy, on the host), the balanced weighted logistic
loss per image, the float32 backward of ``gossipnet.forward``, clipping by
the global norm and Adam (optax's: eps outside the square root, both
moments bias-corrected).

Matching (paper §4, COCO's rule): detections in descending score order
each take the still-free real ground truth of highest IoU >= t (the first
on a tie); an unmatched detection inside a crowd region (IoF >= t) is
ignored. Loss weights: per image and threshold, positives and negatives
each carry half, renormalised to sum to one; the loss is the mean over
images and thresholds of sum_i w_i log(1 + exp(-y_i logit_i)).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.gossipnet import Geometry, forward


def _areas(b: np.ndarray) -> np.ndarray:
    return (np.maximum(b[:, 2] - b[:, 0], np.float32(0))
            * np.maximum(b[:, 3] - b[:, 1], np.float32(0)))


def overlaps(dets: np.ndarray, gts: np.ndarray) -> tuple[np.ndarray,
                                                         np.ndarray]:
    """(IoU, IoF) [n, g] of xyxy float32 boxes, in float32."""
    lt = np.maximum(dets[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dets[:, None, 2:], gts[None, :, 2:])
    wh = np.maximum(rb - lt, np.float32(0))
    inter = wh[..., 0] * wh[..., 1]
    ad, ag = _areas(dets)[:, None], _areas(gts)[None]
    union = ad + ag - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / np.maximum(union, np.float32(1e-12)),
                       np.float32(0))
        iof = np.where(ad > 0, inter / np.maximum(ad, np.float32(1e-12)),
                       np.float32(0))
    return iou.astype(np.float32), iof.astype(np.float32)


def match(boxes, logits, gt_boxes, gt_crowd, thresholds):
    """One image -> (labels [T, n] float32, ignore [T, n] bool)."""
    n, t = len(logits), len(thresholds)
    labels = np.zeros((t, n), np.float32)
    ignore = np.zeros((t, n), bool)
    if n == 0:
        return labels, ignore
    iou, iof = overlaps(boxes, gt_boxes)
    real, crowd = ~gt_crowd, gt_crowd
    order = np.argsort(-logits, kind="stable")
    for k, thr in enumerate(np.asarray(thresholds, np.float32)):
        free = real.copy()
        for i in order:
            cand = np.where(free & (iou[i] >= thr), iou[i], -np.inf)
            if cand.size and cand.max() > -np.inf:
                free[int(np.argmax(cand))] = False
                labels[k, i] = 1.0
            elif (crowd & (iof[i] >= thr)).any():
                ignore[k, i] = True
    return labels, ignore


def image_loss(logits: torch.Tensor, labels, ignore) -> torch.Tensor:
    dev = logits.device
    y = torch.as_tensor(labels, device=dev)
    active = torch.as_tensor(~ignore, device=dev).float()
    pos, neg = y * active, (1 - y) * active
    n_pos = pos.sum(-1, keepdim=True)
    n_neg = neg.sum(-1, keepdim=True)
    w = (torch.where(n_pos > 0, 0.5 / n_pos.clamp(min=1), 0) * pos
         + torch.where(n_neg > 0, 0.5 / n_neg.clamp(min=1), 0) * neg)
    total = w.sum(-1, keepdim=True)
    w = torch.where(total > 0, w / total.clamp(min=1e-12), 0)
    z = (2 * y - 1) * logits[None]
    return (w * torch.nn.functional.softplus(-z)).sum(-1).mean()


def loss_and_grads(params: dict, images: list, num_blocks: int, thresholds,
                   elementwise: str = "float32"):
    """images: (boxes, scores, gt_boxes, gt_crowd) numpy, valid rows only
    -> (loss, grads by name). The images' losses are averaged; each
    image's backward runs on its own, so one image's graph is held at a
    time."""
    names = list(params)
    leaves = [params[k].detach().requires_grad_(True) for k in names]
    live = dict(zip(names, leaves))
    dev = leaves[0].device
    total = 0.0
    grads = [torch.zeros_like(p) for p in leaves]
    for boxes, scores, gt_boxes, gt_crowd in images:
        geom = Geometry(torch.as_tensor(boxes, device=dev),
                        torch.as_tensor(scores, device=dev))
        logits = forward(live, geom, num_blocks, elementwise)
        labels, ignore = match(boxes, logits.detach().cpu().numpy(),
                               gt_boxes, gt_crowd, thresholds)
        loss = image_loss(logits, labels, ignore) / len(images)
        for g, d in zip(grads, torch.autograd.grad(loss, leaves,
                                                   allow_unused=True)):
            if d is not None:
                g += d
        total += float(loss.detach())
    return total, dict(zip(names, grads))


class Adam:
    """clip_by_global_norm(max_norm) then optax.adam(lr)."""

    def __init__(self, params: dict, lr: float, max_norm: float,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.max_norm = lr, max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    def clip(self, grads: dict) -> dict:
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads.values()]))
        if self.max_norm > 0 and norm >= self.max_norm:
            return {k: g / norm * self.max_norm for k, g in grads.items()}
        return grads

    def step(self, params: dict, grads: dict) -> tuple[dict, dict]:
        """-> (new params, the clipped gradient the moments took)."""
        g = self.clip(grads)
        self.count += 1
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        out = {}
        for k, p in params.items():
            self.mu[k] = self.b1 * self.mu[k] + (1 - self.b1) * g[k]
            self.nu[k] = self.b2 * self.nu[k] + (1 - self.b2) * g[k] ** 2
            upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + self.eps)
            out[k] = (p - self.lr * upd).detach()
        return out, g
