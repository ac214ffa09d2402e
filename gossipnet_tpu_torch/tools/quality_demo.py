"""The RESULTS.md quality runs, one per paper benchmark family (port of
``scripts/quality_demo.py``):

    python -m gossipnet_tpu_torch.tools.quality_demo clustered  [--steps 600]
    python -m gossipnet_tpu_torch.tools.quality_demo multiclass [--steps 600]
    python -m gossipnet_tpu_torch.tools.quality_demo crowd      [--steps 600]
    python -m gossipnet_tpu_torch.tools.quality_demo long       [--steps 2400]

Each trains the flagship (16 blocks, 128/32/32) on its seeded synthetic
family through ``train`` on the kernel path (K1/K2, K3; captured steps on
the card), then reports COCO-protocol AP for the trained rescorer against
the raw detector scores and the best threshold-swept GreedyNMS. ``long``
is the stability run: periodic evaluation and best-AP checkpoints through
the full ``train`` path. The families, configs, seeds and output files
(``<prefix>_metrics.jsonl``, ``<prefix>_results.json``, ``<prefix>_ckpt``)
are the reference's; the prefix defaults to ``<tag>`` in the temporary
directory. ``--device cpu`` runs the plain path (slow at this width).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from gossipnet_tpu_torch.config import (
    Config,
    DataConfig,
    LossConfig,
    MatchingConfig,
    ModelConfig,
    TrainConfig,
)
from gossipnet_tpu_torch.data.synthetic import crowd_roidb, synthetic_roidb
from gossipnet_tpu_torch.evaluate import (
    evaluate_greedy_nms_sweep,
    evaluate_model,
    evaluate_raw_scores,
)
from gossipnet_tpu_torch.models.gossipnet import resolve_device
from gossipnet_tpu_torch.train import train

FAMILIES = {
    # name: (data maker, maker kwargs, train-cfg overrides, result tag)
    "clustered": (synthetic_roidb,
                  dict(num_gt=40, dets_per_gt=8, num_clutter=60),
                  dict(log_every=50), "demo"),
    "multiclass": (synthetic_roidb,
                   dict(num_gt=40, dets_per_gt=8, num_clutter=60,
                        num_classes=8),
                   dict(log_every=100, steps_per_call=4), "demo_mc"),
    "crowd": (crowd_roidb,
              dict(num_people=40, dets_per_person=10, occlusion=0.6),
              dict(log_every=100, steps_per_call=4), "demo_crowd"),
    "long": (crowd_roidb,
             dict(num_people=40, dets_per_person=10, occlusion=0.6),
             dict(log_every=200, steps_per_call=8, snapshot_every=800,
                  eval_every=800, keep_checkpoints=2), "long"),
}


def family_config(family: str, steps: int, prefix: str) -> Config:
    """The (seeded, RESULTS.md-pinned) config for one demo family."""
    maker, mk, tcfg, _ = FAMILIES[family]
    num_classes = mk.get("num_classes", 1)
    return Config(
        model=ModelConfig(num_blocks=16, feature_dim=128, reduced_dim=32,
                          pairwise_dim=32, num_classes=num_classes),
        matching=MatchingConfig(thresholds=(0.5,),
                                class_aware=num_classes > 1),
        loss=LossConfig(),
        train=TrainConfig(**{
            "batch_size": 8, "learning_rate": 3e-4,
            "lr_schedule": "cosine", "max_steps": steps,
            "snapshot_every": 0, "eval_every": 0,
            "grad_clip_norm": 10.0, "seed": 0,
            "checkpoint_dir": f"{prefix}_ckpt", **tcfg}),
        data=DataConfig(bucket_sizes=(512,)),
    )


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("family", choices=sorted(FAMILIES))
    p.add_argument("--steps", type=int, default=None,
                   help="train steps (default 600; long: 2400)")
    p.add_argument("--out-prefix", default=None,
                   help="output path prefix (default <family tag> in the "
                        "temporary directory)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    maker, mk, tcfg, tag = FAMILIES[args.family]
    steps = args.steps or (2400 if args.family == "long" else 600)
    prefix = args.out_prefix or os.path.join(tempfile.gettempdir(), tag)
    num_classes = mk.get("num_classes", 1)
    cfg = family_config(args.family, steps, prefix)
    n_train = 512 if args.family == "long" else 256
    train_db = maker(num_images=n_train, seed=0, **mk)
    val_db = maker(num_images=64, seed=777, **mk)

    t0 = time.time()
    state = train(cfg, train_db,
                  val_roidb=val_db if args.family == "long" else None,
                  pool_impl="kernel", device=device,
                  metrics_path=f"{prefix}_metrics.jsonl")
    wall = time.time() - t0
    print(f"trained {steps} steps in {wall:.0f}s "
          f"({steps / wall:.1f} steps/s)", flush=True)

    out = {
        "gossipnet": evaluate_model(None, state.model, val_db,
                                    batch_size=8,
                                    bucket_sizes=cfg.data.bucket_sizes),
        "raw": evaluate_raw_scores(val_db),
        "family": args.family, "steps": steps, "wall_s": round(wall, 1),
    }
    if num_classes > 1:
        out["num_classes"] = num_classes
    t_best, s_best = max(
        evaluate_greedy_nms_sweep(
            val_db, [float(t) for t in np.arange(0.25, 0.75, 0.05)]),
        key=lambda ts: ts[1]["AP"])
    out["greedy_nms"] = {"thr": round(t_best, 2), **s_best}
    print(json.dumps(out, indent=2), flush=True)
    with open(f"{prefix}_results.json", "w") as f:
        json.dump(out, f)
    print("DONE", flush=True)
    return out


if __name__ == "__main__":
    main()
