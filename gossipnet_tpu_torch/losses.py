"""Training loss: matching-driven weighted logistic loss (port of
``gossipnet_tpu/losses.py``).

Each detection gets a binary target from greedy det<->GT matching at one or
more IoU thresholds; the loss is ``sum_i w_i * log(1 + exp(-y_i * logit_i))``
with ``y_i in {-1, +1}``, weights balancing positives against negatives and
zeroing ignored detections. With T thresholds the per-threshold losses are
averaged.
"""

from __future__ import annotations

import torch
from torch import Tensor

from gossipnet_tpu_torch.config import Config, LossConfig
from gossipnet_tpu_torch.ops.matching import (
    MatchResult,
    Thresholds,
    greedy_match_batch,
)


def _normalised(weights: Tensor) -> Tensor:
    total = weights.sum(dim=-1, keepdim=True)
    return torch.where(total > 0, weights / torch.clamp(total, min=1e-12),
                       torch.zeros_like(weights))


def detection_weights(labels: Tensor, ignore: Tensor,
                      cfg: LossConfig) -> Tensor:
    """Per-detection loss weights ``[..., T, N]``.

    'balanced': positives and negatives carry equal total weight per image
    and threshold, renormalised so each sums to 1 even when one side is
    empty. 'fixed': positives scaled by ``fixed_pos_weight``. 'none':
    uniform over the detections not ignored.
    """
    active = (~ignore).float()
    pos = labels * active
    neg = (1.0 - labels) * active
    if cfg.pos_weight_mode == "balanced":
        n_pos = pos.sum(dim=-1, keepdim=True)
        n_neg = neg.sum(dim=-1, keepdim=True)
        zero = torch.zeros_like(n_pos)
        w_pos = torch.where(n_pos > 0, 0.5 / torch.clamp(n_pos, min=1.0), zero)
        w_neg = torch.where(n_neg > 0, 0.5 / torch.clamp(n_neg, min=1.0), zero)
        return _normalised(pos * w_pos + neg * w_neg)
    if cfg.pos_weight_mode == "fixed":
        return _normalised(pos * cfg.fixed_pos_weight + neg)
    if cfg.pos_weight_mode == "none":
        return _normalised(active)
    raise ValueError(f"unknown pos_weight_mode: {cfg.pos_weight_mode!r}")


def weighted_logistic_loss(logits: Tensor, match: MatchResult,
                           cfg: LossConfig) -> tuple[Tensor, dict]:
    """Scalar loss + metrics (0-d tensors, not synced to the host).

    logits ``[..., N]``; ``match`` holds ``[..., T, N]`` labels/ignore.
    """
    labels, ignore = match.labels, match.ignore
    if cfg.normalize == "per_batch" and labels.ndim == 3:
        # One weighting problem over the batch: [B, T, N] -> [T, B*N].
        t = labels.shape[1]
        labels = labels.transpose(0, 1).reshape(t, -1)
        ignore = ignore.transpose(0, 1).reshape(t, -1)
        logits = logits.reshape(-1)
    elif cfg.normalize not in ("per_image", "per_batch"):
        raise ValueError(f"unknown LossConfig.normalize: {cfg.normalize!r}")
    weights = detection_weights(labels, ignore, cfg)
    z = (2.0 * labels - 1.0) * logits[..., None, :]
    per_det = torch.logaddexp(torch.zeros_like(z), -z)   # log(1 + e^-z)
    per_img = (weights * per_det).sum(dim=-1).mean(dim=-1)
    loss = per_img.mean()
    active = (~ignore).float()
    num_pos = (labels * active).sum()
    metrics = {
        "loss": loss.detach(),
        "pos_frac": num_pos / torch.clamp(active.sum(), min=1.0),
        "num_pos": num_pos,
    }
    return loss, metrics


def matching_loss(logits: Tensor, batch_arrays: dict, cfg: Config,
                  thresholds: Thresholds | None = None) -> tuple[Tensor, dict]:
    """Greedy matching on the CURRENT logits (detached: labels are targets)
    + the weighted logistic loss.

    ``MatchingConfig.crowd_as_ignore``: True leaves crowd GTs in matching
    as ignore regions; False removes them, so the detections they cover
    train as plain negatives. ``class_aware`` matches within classes.
    ``thresholds``: ``cfg.matching.thresholds`` already on the device (a
    captured step passes them; by default they are copied on each call).
    """
    m = cfg.matching
    gt_valid = batch_arrays["gt_valid"]
    gt_crowd = batch_arrays["gt_crowd"]
    if not m.crowd_as_ignore:
        gt_valid = gt_valid & ~gt_crowd
        gt_crowd = torch.zeros_like(gt_crowd)
    match = greedy_match_batch(
        batch_arrays["boxes"], logits.detach(), batch_arrays["valid"],
        batch_arrays["gt_boxes"], gt_valid, gt_crowd,
        m.thresholds if thresholds is None else thresholds,
        det_classes=batch_arrays["classes"] if m.class_aware else None,
        gt_classes=batch_arrays["gt_classes"] if m.class_aware else None)
    return weighted_logistic_loss(logits, match, cfg.loss)
