"""AP-parity calibration sweep (port of ``scripts/calibrate.py``).

The accuracy half of the north star is COCO-persons AP within 0.1 of the
TF reference. This is the calibration procedure for the day real data is
present, runnable on the synthetic proxy: short training runs over the
knobs whose reference settings are paper-derived guesses, reporting the
validation AP of each cell:

  - matching thresholds: single 0.5 vs COCO multi-threshold 0.5:0.95
  - positive/negative weighting: balanced vs none
  - loss normalization: per_image vs per_batch
  - score-rank input feature: on vs off
  - learning rate x schedule
  - num_blocks (model capacity)

Two modes, over the same knobs and cells as the reference:

  default (one at a time): the base config once, then each knob's other
  options alone, with each cell's AP delta against the base.
  ``--grid``: the full cartesian product over the four
  reference-ambiguity knobs.

Usage::

  python -m gossipnet_tpu_torch.tools.calibrate             # synthetic, 300 steps
  python -m gossipnet_tpu_torch.tools.calibrate -c experiments/coco_persons_full.yaml \\
      --steps 20000                                         # real data, when present

Output: one JSON line per cell and a ranked table; the best cell is the
config to train fully for the parity claim. Training runs on the card
(K1/K2, K3) unless ``--device cpu``; ``--pool-impl`` picks the model path
(default: kernel on the card, dense on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import tempfile

import numpy as np

from gossipnet_tpu_torch.config import Config, load_config

# The four reference-ambiguity knobs (the grid) and the one-at-a-time
# additions (learning rate and schedule, capacity).
GRID = {
    "matching.thresholds": [
        (0.5,), tuple(np.round(np.arange(0.5, 1.0, 0.05), 2).tolist())],
    "loss.pos_weight_mode": ["balanced", "none"],
    "loss.normalize": ["per_image", "per_batch"],
    "model.score_rank_feature": [True, False],
}
OAT_EXTRA = {
    "train.learning_rate": [3e-5, 1e-4, 3e-4, 1e-3],
    "train.lr_schedule": ["constant", "cosine", "step"],
}


def cells(base: Config, grid: bool, blocks_axis=(8, 16, 24)) -> list[dict]:
    """The cells of a sweep, in the order they run: each a {"section.field":
    value} override dict; ``{}`` is the base config (first, one at a time
    only)."""
    if grid:
        return [dict(zip(GRID, combo))
                for combo in itertools.product(*GRID.values())]
    base_vals = {
        "matching.thresholds": tuple(base.matching.thresholds),
        "loss.pos_weight_mode": base.loss.pos_weight_mode,
        "loss.normalize": base.loss.normalize,
        "model.score_rank_feature": base.model.score_rank_feature,
        "train.learning_rate": base.train.learning_rate,
        "train.lr_schedule": base.train.lr_schedule,
        "model.num_blocks": base.model.num_blocks,
    }
    out = [{}]
    axes = {**GRID, **OAT_EXTRA, "model.num_blocks": list(blocks_axis)}
    for key, options in axes.items():
        out.extend({key: v} for v in options if v != base_vals.get(key))
    return out


def cell_config(config_path, cell: dict, steps: int, workdir: str) -> Config:
    """The training config of one cell: the base file with the cell's
    overrides, ``steps`` steps, checkpoints under ``workdir``, no periodic
    evaluation or snapshots."""
    overrides: dict = {}
    for k, v in cell.items():
        sect, field = k.split(".")
        overrides.setdefault(sect, {})[field] = v
    cfg = load_config(config_path, overrides=overrides)
    tr_over = dict(max_steps=steps, checkpoint_dir=f"{workdir}/ck",
                   eval_every=0, snapshot_every=0, log_every=max(steps, 1))
    if cfg.train.lr_schedule == "step" and not cfg.train.lr_decay_steps:
        tr_over["lr_decay_steps"] = (steps * 2 // 3,)
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, **tr_over))


def datasets(base: Config):
    """(train, validation) roidbs for the base config's data."""
    if base.data.dataset == "synthetic":
        from gossipnet_tpu_torch.data.synthetic import synthetic_roidb

        return (synthetic_roidb(num_images=128, seed=0,
                                num_classes=base.model.num_classes),
                synthetic_roidb(num_images=32, seed=1,
                                num_classes=base.model.num_classes))
    if base.data.dataset == "pets":
        from gossipnet_tpu_torch.data.pets import build_pets_roidb

        db = build_pets_roidb(base.data.ann_file, base.data.det_file,
                              max_dets=base.data.max_detections)
        cut = max(len(db.records) * 4 // 5, 1)
        return (dataclasses.replace(db, records=db.records[:cut]),
                dataclasses.replace(db, records=db.records[cut:]))
    from gossipnet_tpu_torch.data.roidb import build_roidb

    db = build_roidb(base.data.ann_file, base.data.det_file,
                     person_only=base.data.person_only,
                     max_dets=base.data.max_detections)
    # the last 10% validates (point the config at minival when present)
    cut = max(len(db.records) * 9 // 10, 1)
    return (dataclasses.replace(db, records=db.records[:cut]),
            dataclasses.replace(db, records=db.records[cut:]))


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-c", "--config", default=None)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--pool-impl", default=None)
    p.add_argument("--grid", action="store_true",
                   help="full cartesian product over the 4 ambiguity "
                        "knobs instead of the one-at-a-time sweep")
    p.add_argument("--blocks-axis", type=int, nargs="*",
                   default=[8, 16, 24],
                   help="num_blocks options for the one-at-a-time sweep")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from gossipnet_tpu_torch.evaluate import evaluate_model, evaluate_raw_scores
    from gossipnet_tpu_torch.models.gossipnet import resolve_device
    from gossipnet_tpu_torch.train import train

    device = resolve_device(args.device)
    base = load_config(args.config)
    pool_impl = args.pool_impl or (
        "kernel" if device.type == "cuda" else "dense")
    train_db, val_db = datasets(base)
    raw = evaluate_raw_scores(val_db)
    print(json.dumps({"cell": "raw-scores-baseline", "AP": raw["AP"]}),
          flush=True)

    def run_cell(cell: dict) -> dict:
        tmp = tempfile.mkdtemp(prefix="gnet_cal_")
        cfg = cell_config(args.config, cell, args.steps, tmp)
        state = train(cfg, train_db, pool_impl=pool_impl, device=device,
                      metrics_path=f"{tmp}/m.jsonl")
        return evaluate_model(None, state.model, val_db,
                              batch_size=cfg.train.batch_size,
                              bucket_sizes=cfg.data.bucket_sizes)

    def show(cell):
        return {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in cell.items()}

    results = []
    for cell in cells(base, args.grid, args.blocks_axis):
        stats = run_cell(cell)
        line = {"cell": show(cell) if cell else "BASE", "AP": stats["AP"],
                "AP50": stats["AP50"]}
        if not args.grid:   # the base runs first
            if not cell:
                base_ap = stats["AP"]
            else:
                line["delta_vs_base"] = round(stats["AP"] - base_ap, 4)
        results.append((stats["AP"], show(cell) if cell else {"BASE": True},
                        stats))
        print(json.dumps(line), flush=True)

    results.sort(key=lambda r: -r[0])
    print("\n=== ranked (best first) ===")
    for ap, cell, _ in results:
        print(f"AP {ap:.4f}  {cell}")
    best_ap, best_cell, _ = results[0]
    print(f"\nbest cell: {best_cell} (AP {best_ap:.4f}, "
          f"raw baseline {raw['AP']:.4f})")
    return results


if __name__ == "__main__":
    main()
