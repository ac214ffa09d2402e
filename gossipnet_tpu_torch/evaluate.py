"""Evaluation: rescore a roidb with a trained model and compute COCO AP
(port of ``gossipnet_tpu/evaluate.py``).

Forward-only over the val set: collect (boxes, new_scores, classes), run
COCO AP. No NMS is applied: ranking by the rescored output IS the
suppression. Also the two baselines the paper compares against: raw
detector scores (no suppression) and tuned GreedyNMS.

    python -m gossipnet_tpu_torch.evaluate -c experiments/coco_persons_full.yaml

runs the model on the CUDA device (16 K1 launches per batch at config 2; K5
with ``pair_kernel: 1``) and raises when there is none; ``--device cpu``
runs the plain path. The COCO matching and the GreedyNMS sweep are host
code (``eval/cocoeval.py``, ``ops/nms.py``; C++ through ``native.py`` when
the library loads, numpy otherwise, with identical results).

On the card the forward replays one captured graph per (batch_size,
bucket) (``utils/cuda_graphs.py::ForwardGraphs``), as the reference jits
its local forward per model. The graphs live on the model, not in a
module-level cache, and read its parameters as they stand, so a training
run's periodic evaluation sees the weights its steps update in place.
``forward_fn`` is the hook for another forward: ``--artifact`` evaluates
a serving artifact through ``ArtifactRescorer.forward`` at its exported
batch sizes. Not ported yet and refused by the CLI: evaluation over a
device mesh (``parallel.enable: "on"``, ROADMAP.md item 14).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

import numpy as np

from gossipnet_tpu_torch.data.bucketing import eval_batches
from gossipnet_tpu_torch.data.roidb import Roidb
from gossipnet_tpu_torch.eval.cocoeval import COCOEvaluator
from gossipnet_tpu_torch.models.gossipnet import GossipNet, resolve_device
from gossipnet_tpu_torch.params import as_state_dict
from gossipnet_tpu_torch.utils.cuda_graphs import forward_graphs


def _local_forward(params, model: GossipNet):
    """(boxes, scores, valid, classes) numpy -> sigmoid scores numpy, on
    the model's device, through its captured forwards. ``params`` (a
    state_dict or a JAX tree), when given, is loaded into ``model``
    first, in place."""
    if params is not None:
        model.load_state_dict(as_state_dict(params))
    graphs = forward_graphs(model)

    def forward(boxes, scores, valid, classes):
        return graphs(boxes, scores, valid, classes).cpu().numpy()

    return forward


def rescore_roidb(
    params,
    model: GossipNet,
    roidb: Roidb,
    batch_size: int = 8,
    bucket_sizes: Sequence[int] = (256, 512, 1024),
    forward_fn=None,
) -> dict[int, np.ndarray]:
    """New scores per image id: sigmoid(logit), aligned with the record's
    detection order.

    ``params=None`` evaluates ``model`` as it stands (a training run's
    own); otherwise they are loaded into it. ``forward_fn(boxes, scores,
    valid, classes) -> scores`` overrides the model's forward; ``model``
    may be None when it is given.
    """
    if forward_fn is None:
        forward_fn = _local_forward(params, model)

    out: dict[int, np.ndarray] = {}
    for batch in eval_batches(roidb, batch_size, bucket_sizes):
        new_scores = np.asarray(forward_fn(
            batch.boxes, batch.scores, batch.valid, batch.classes
        ))
        for i, img_id in enumerate(batch.image_ids):
            if int(img_id) in out:   # repeat-padded tail
                continue
            n_valid = int(batch.valid[i].sum())
            out[int(img_id)] = new_scores[i, :n_valid]
    return out


def _evaluator_for(
    roidb: Roidb, scores_by_image: dict[int, np.ndarray] | None = None,
    keep_by_image: dict[int, np.ndarray] | None = None,
) -> COCOEvaluator:
    ev = COCOEvaluator(num_classes=roidb.num_classes)
    for rec in roidb:
        scores = rec.det_scores
        boxes, classes = rec.det_boxes, rec.det_classes
        if scores_by_image is not None:
            scores = scores_by_image[rec.image_id]
        if keep_by_image is not None:
            keep = keep_by_image[rec.image_id]
            boxes, scores, classes = boxes[keep], scores[keep], classes[keep]
        ev.add_arrays(
            rec.image_id, boxes, scores, classes,
            rec.gt_boxes, rec.gt_classes, rec.gt_crowd,
        )
    return ev


def evaluate_model(
    params, model: GossipNet, roidb: Roidb,
    batch_size: int = 8, bucket_sizes: Sequence[int] = (256, 512, 1024),
    forward_fn=None,
) -> dict[str, float]:
    """COCO stats for the rescored detections."""
    rescored = rescore_roidb(params, model, roidb, batch_size, bucket_sizes,
                             forward_fn=forward_fn)
    return _evaluator_for(roidb, scores_by_image=rescored).summarize()


def export_coco_results(
    roidb: Roidb, scores_by_image: dict[int, np.ndarray], path: str,
    score_threshold: float = 0.0,
) -> int:
    """Write rescored detections as COCO results JSON (the reference's
    eval interchange format). Returns the number of exported detections."""
    results = []
    for rec in roidb:
        new_scores = scores_by_image[rec.image_id]
        for i in range(rec.num_dets):
            s = float(new_scores[i])
            if s < score_threshold:
                continue
            x1, y1, x2, y2 = (float(v) for v in rec.det_boxes[i])
            results.append({
                "image_id": int(rec.image_id),
                "category_id": int(roidb.cat_ids[int(rec.det_classes[i])]),
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "score": s,
            })
    with open(path, "w") as f:
        json.dump(results, f)
    return len(results)


def evaluate_raw_scores(roidb: Roidb) -> dict[str, float]:
    """Baseline: rank by raw detector scores, no suppression at all."""
    return _evaluator_for(roidb).summarize()


def evaluate_greedy_nms(
    roidb: Roidb, iou_threshold: float = 0.5
) -> dict[str, float]:
    """Baseline: classic per-class GreedyNMS at the given threshold
    (the reference tunes this threshold; sweep externally)."""
    return evaluate_greedy_nms_sweep(roidb, [iou_threshold])[0][1]


def evaluate_greedy_nms_sweep(
    roidb: Roidb, thresholds: Sequence[float]
) -> list[tuple[float, dict[str, float]]]:
    """GreedyNMS baseline stats at each threshold, sharing one IoU
    matrix + score-ordered scan per (image, class) across the whole
    sweep (:func:`greedy_nms_host`: native C++ ``greedy_nms_multi``
    when the .so is loadable, shared-IoU numpy otherwise; both f64,
    bit-identical keep sets): the tuned-baseline sweep in one roidb
    pass instead of T."""
    from gossipnet_tpu_torch.ops.nms import greedy_nms_host

    thr = np.asarray(list(thresholds), np.float64)
    keeps: list[dict[int, np.ndarray]] = [{} for _ in thr]
    for rec in roidb:
        keep_mask = np.zeros((len(thr), rec.num_dets), bool)
        for cls in np.unique(rec.det_classes):
            sel = np.where(rec.det_classes == cls)[0]
            kept = greedy_nms_host(
                rec.det_boxes[sel], rec.det_scores[sel], thr
            )
            for k in range(len(thr)):
                keep_mask[k, sel[kept[k]]] = True
        for k in range(len(thr)):
            keeps[k][rec.image_id] = np.where(keep_mask[k])[0]
    return [
        (float(thr[k]),
         _evaluator_for(roidb, keep_by_image=keeps[k]).summarize())
        for k in range(len(thr))
    ]


def load_roidb(cfg) -> Roidb:
    """The evaluation set ``cfg.data`` names: 64 synthetic images, PETS or
    COCO files."""
    if cfg.data.dataset == "synthetic":
        from gossipnet_tpu_torch.data.synthetic import synthetic_roidb

        return synthetic_roidb(num_images=64, seed=123,
                               num_classes=cfg.model.num_classes)
    if cfg.data.dataset == "pets":
        from gossipnet_tpu_torch.data.pets import build_pets_roidb

        return build_pets_roidb(cfg.data.ann_file, cfg.data.det_file,
                                max_dets=cfg.data.max_detections)
    from gossipnet_tpu_torch.data.roidb import build_roidb

    return build_roidb(cfg.data.ann_file, cfg.data.det_file,
                       person_only=cfg.data.person_only,
                       max_dets=cfg.data.max_detections)


def main(argv=None) -> dict:
    """CLI: rescore a val set with a trained checkpoint and print COCO AP
    alongside the raw-score and (tuned) GreedyNMS baselines. Returns what
    it prints."""
    import argparse

    from gossipnet_tpu_torch.config import load_config

    p = argparse.ArgumentParser(
        description="Evaluate GossipNet rescoring (PyTorch/CUDA)")
    p.add_argument("-c", "--config", default=None)
    p.add_argument("--checkpoint-dir", default=None,
                   help="override cfg.train.checkpoint_dir")
    p.add_argument("--nms-sweep", action="store_true",
                   help="sweep GreedyNMS thresholds for the tuned baseline")
    p.add_argument("--best", action="store_true",
                   help="evaluate the best-val-AP checkpoint instead of the "
                        "latest periodic snapshot")
    p.add_argument("--pool-impl", default=None, choices=["dense", "kernel"],
                   help="pair stage (default: the CUDA pair kernels on the "
                        "card, dense on the CPU)")
    p.add_argument("--random-init", action="store_true",
                   help="seeded random weights instead of a checkpoint "
                        "(smoke tests only)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--artifact", default=None,
                   help="evaluate a serving artifact "
                        "(utils/model_artifact.py) instead of a checkpoint; "
                        "-c still selects the evaluation set (default: the "
                        "artifact's own config)")
    args = p.parse_args(argv)

    artifact = None
    if args.artifact:
        from gossipnet_tpu_torch.utils.model_artifact import ArtifactRescorer

        artifact = ArtifactRescorer(args.artifact,
                                    device=resolve_device(args.device))
    if args.config or artifact is None:
        cfg = load_config(args.config)
    else:
        cfg = artifact.cfg
    if cfg.parallel.enable == "on":
        raise SystemExit("evaluation over a device mesh (parallel.enable: "
                         "'on') is not ported yet: ROADMAP.md item 14")
    device = resolve_device(args.device)
    roidb = load_roidb(cfg)

    batch_size = cfg.train.batch_size
    bucket_sizes = cfg.data.bucket_sizes
    model, fwd = None, None
    if artifact is not None:
        # eval_batches pads every batch to exactly batch_size, and the
        # artifact serves only its exported (b, n) shapes: batch_size is
        # the largest exported batch <= the configured one (else the
        # smallest exported)
        exported_bs = sorted({b for b, _ in artifact.exported_shapes()})
        fitting = [b for b in exported_bs if b <= cfg.train.batch_size]
        batch_size = fitting[-1] if fitting else exported_bs[0]
        bucket_sizes = tuple(artifact.cfg.data.bucket_sizes)
        fwd = artifact.forward
        print(f"evaluating artifact {args.artifact} "
              f"({len(artifact.meta['shapes'])} shapes)")
    else:
        model = _restore_model(args, cfg, device)
    out = {
        "gossipnet": evaluate_model(
            None, model, roidb,
            batch_size=batch_size,
            bucket_sizes=bucket_sizes,
            forward_fn=fwd,
        ),
        "raw_scores": evaluate_raw_scores(roidb),
    }
    thrs = np.arange(0.3, 0.75, 0.05) if args.nms_sweep else [0.5]
    best = max(evaluate_greedy_nms_sweep(roidb, [float(t) for t in thrs]),
               key=lambda ts: ts[1]["AP"])
    out["greedy_nms"] = {"iou_threshold": best[0], **best[1]}
    print(json.dumps(out, indent=2))
    return out


def _restore_model(args, cfg, device) -> GossipNet:
    """The CLI's model on ``device``: seeded random weights, the best or
    the latest checkpoint."""
    from gossipnet_tpu_torch.params import init_params
    from gossipnet_tpu_torch.train import build_model, create_train_state
    from gossipnet_tpu_torch.utils.checkpoint import CheckpointManager

    pool_impl = args.pool_impl or (
        "kernel" if device.type == "cuda" else "dense")
    model = build_model(cfg, pool_impl, device)
    if args.random_init:
        model.load_state_dict(as_state_dict(init_params(cfg.model, seed=0)))
        print("evaluating seeded random weights (--random-init)")
    else:
        state = create_train_state(cfg, model)
        ckpt_dir = args.checkpoint_dir or cfg.train.checkpoint_dir
        ckpt = CheckpointManager(ckpt_dir)
        if args.best and ckpt.has_best():
            state = ckpt.restore_best(state)
            print(f"restored best-AP checkpoint (step {state.step}) "
                  f"from {Path(ckpt_dir) / 'best'}")
        elif args.best:
            raise SystemExit(f"--best: no best checkpoint in {ckpt_dir} "
                             "(training saves one when a val split is "
                             "configured)")
        elif ckpt.latest_step() is not None:
            state, _ = ckpt.restore(state)
            print(f"restored step {state.step} from {ckpt_dir}")
        else:
            print(f"WARNING: no checkpoint in {ckpt_dir}; evaluating init")
    return model


if __name__ == "__main__":
    main()
