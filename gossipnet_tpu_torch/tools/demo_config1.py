"""Config 1: 1-block GossipNet inference, end to end (port of
``scripts/demo_config1.py``).

    python -m gossipnet_tpu_torch.tools.demo_config1 [--ann A --dets D]
        [--checkpoint-dir DIR] [--out rescored_results.json] [--device cpu]

Loads (or makes) detections, rescores them with a 1-block model (128/32/32,
buckets 256/512/1024, batch 8), evaluates COCO AP against the raw detector
scores and exports the rescored detections as COCO-results JSON: the
workflow of the reference's evaluation pass. Without ``--ann/--dets`` it
uses the synthetic fixture set (16 images, seed 5). The weights are the
seeded initial ones (``train.seed``) unless ``--checkpoint-dir`` holds a
checkpoint.

On the card the model takes the kernel path (K1, one captured graph per
padded shape); there is no fallback for lack of a card. ``--device cpu``
runs the dense plain path, the reference's leg off its accelerator.
"""

from __future__ import annotations

import argparse
import json

from gossipnet_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from gossipnet_tpu_torch.evaluate import (
    evaluate_model,
    evaluate_raw_scores,
    export_coco_results,
    rescore_roidb,
)
from gossipnet_tpu_torch.models.gossipnet import resolve_device
from gossipnet_tpu_torch.train import build_model, create_train_state


def config1() -> Config:
    """The 1-block model of config 1 (``scripts/demo_config1.py``)."""
    return Config(
        model=ModelConfig(num_blocks=1, feature_dim=128, reduced_dim=32,
                          pairwise_dim=32),
        data=DataConfig(bucket_sizes=(256, 512, 1024)),
        train=TrainConfig(batch_size=8),
    )


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ann", default=None, help="COCO annotation json")
    p.add_argument("--dets", default=None, help="detections json/npz")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--out", default="rescored_results.json")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = config1()
    if args.ann and args.dets:
        from gossipnet_tpu_torch.data.roidb import build_roidb

        roidb = build_roidb(args.ann, args.dets, person_only=True)
    else:
        from gossipnet_tpu_torch.data.synthetic import synthetic_roidb

        print("no --ann/--dets given; using the synthetic fixture set")
        roidb = synthetic_roidb(num_images=16, seed=5)

    model = build_model(cfg, "kernel" if device.type == "cuda" else "dense",
                        device)
    state = create_train_state(cfg, model)
    if args.checkpoint_dir:
        from gossipnet_tpu_torch.utils.checkpoint import CheckpointManager

        state, _ = CheckpointManager(args.checkpoint_dir).restore(state)

    stats = evaluate_model(None, model, roidb,
                           batch_size=cfg.train.batch_size,
                           bucket_sizes=cfg.data.bucket_sizes)
    raw = evaluate_raw_scores(roidb)
    rescored = rescore_roidb(None, model, roidb, cfg.train.batch_size,
                             cfg.data.bucket_sizes)
    n = export_coco_results(roidb, rescored, args.out)
    out = {"gossipnet": stats, "raw_scores": raw, "exported": n,
           "out": args.out}
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
