"""The pair kernels' skip-tile sweep (port of ``scripts/tile_sweep.py``).

    python -m gossipnet_tpu_torch.tools.tile_sweep [--device cpu]

Sweeps the skip tile FI x TJ of K1 (and K2, K5, K6, which take the same
tile) over every shape the kernels take (``ops/cuda/launch.py`` TILES:
FI in {32, 64} rows, TJ in {16, 32, 64, 128} columns), in the reference's
two regimes, on its data: the flagship model (16 blocks, 128/32/32,
``init_params(seed=0)``) on ``synthetic_arrays(2, 4096, seed=0)``.

- ``dense``: ``block_sparse=False, sort_detections=False``: every tile is
  computed, so only the shape of the loop changes;
- ``sparse``: the defaults (Morton-sorted detections, tiles skipped where
  their boxes do not meet).

A case is the marginal cost of one forward, timed as the reference times
it: a chain of forwards (``tools/bench.py::Chain``, one captured loop body
on the card) of 6 and of 24 iterations, their difference over 18, the best
of two (``marginal_seconds``); dets/s = B x N over that. Beside it, K1's
stage-A work for the tile on the launch's own geometry: the IoU tests
(valid pairs in the tiles the flags keep) against the neighbour pairs,
per launch (every block of a forward launches on the same geometry).

Prints one line per case, ``<regime> <FI>x<TJ> {...}``, then one JSON
line of every case, then ``DONE``. A case that fails to build or launch
prints ``FAILED`` with the reason and the script exits non-zero after
``DONE``: every tile of the set must run on the card.

The default device is the card; without one this raises. ``--device cpu``
runs the same forwards through the kernels' plain versions (a check of
the tool, not a measurement); ``--batch``, ``-n``, ``--blocks`` and
``--lengths`` shrink it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from gossipnet_tpu_torch.models.gossipnet import resolve_device
from gossipnet_tpu_torch.ops import order as ordering
from gossipnet_tpu_torch.ops import pair_features as pf
from gossipnet_tpu_torch.ops.cuda import pairwise2
from gossipnet_tpu_torch.ops.cuda.launch import TILES
from gossipnet_tpu_torch.params import as_state_dict, init_params
from gossipnet_tpu_torch.tools.bench import (
    Chain,
    card_line,
    forward_step,
    marginal_seconds,
)
from gossipnet_tpu_torch.tools.entry import (
    device_tensors,
    flagship_cfg,
    synthetic_arrays,
)

REGIMES = (("dense", dict(block_sparse=False, sort_detections=False)),
           ("sparse", {}))


def regime_config(extra: dict, blocks: int | None = None):
    """The flagship config with a regime's model fields (and ``blocks``
    blocks, where given)."""
    cfg = flagship_cfg()
    model = dict(extra, **({} if blocks is None else {"num_blocks": blocks}))
    return dataclasses.replace(cfg,
                               model=dataclasses.replace(cfg.model, **model))


def launch_geometry(model_cfg, boxes, scores, valid, tile):
    """The geometry every K1 launch of one forward receives: the columns
    of the (Morton-sorted, where the config sorts) detections at ``tile``,
    as ``GossipNet._pool_fn`` builds them."""
    if model_cfg.sort_detections:
        perm = torch.argsort(ordering.morton_sort_key(boxes, valid), dim=-1,
                             stable=True)
        boxes = torch.gather(boxes, -2, perm[..., None].expand_as(boxes))
        scores = torch.gather(scores, -1, perm)
        valid = torch.gather(valid, -1, perm)
    col = pf.stack_columns(pf.det_columns(boxes, scores, valid))
    return pairwise2.pair_geometry(col, col, model_cfg.neighbor_iou,
                                   block_sparse=model_cfg.block_sparse,
                                   tile=tile)


def stage_a_counts(geom) -> tuple[int, int]:
    """(neighbour pairs, IoU tests) of one K1 launch: the valid pairs with
    IoU >= the threshold, and the valid pairs in the cells the flags keep
    at the geometry's tile (what stage A computes an IoU for)."""
    fi, tj = geom.tile
    nr, nc = geom.row.shape[2], geom.col.shape[2]
    thr = torch.tensor(geom.neighbor_iou, device=geom.row.device)
    pairs = tests = 0
    for img in range(geom.row.shape[0]):   # one image's [NR, NC] at a time
        row, col = geom.row[img:img + 1], geom.col[img:img + 1]
        valid = (row[0, 7] > 0)[:, None] & (col[0, 7] > 0)[None, :]
        iou = pairwise2.fields_iou(row[..., None], col[:, :, None, :])[0]
        pairs += int(((iou >= thr) & valid).sum())
        kept = geom.flags[img].repeat_interleave(fi, 0)[:nr] \
            .repeat_interleave(tj, 1)[:, :nc] > 0
        tests += int((kept & valid).sum())
    return pairs, tests


def run_case(model_cfg, tile, weights, arrays, rng, lengths):
    """One case -> {ms_per_fwd, dets_per_sec, k1_iou_tests,
    k1_neighbour_pairs}."""
    from gossipnet_tpu_torch.train import build_model

    boxes, scores, valid = arrays
    device = boxes.device
    model = build_model(dataclasses.replace(flagship_cfg(), model=model_cfg),
                        "kernel", device, pair_tile=tile).eval()
    model.load_state_dict(weights)
    chain = Chain(forward_step(model, boxes, valid), scores)
    per = marginal_seconds(chain, rng, *lengths, reps=2)
    pairs, tests = stage_a_counts(
        launch_geometry(model_cfg, boxes, scores, valid.bool(), tile))
    return {"ms_per_fwd": round(per * 1e3, 3),
            "dets_per_sec": round(scores.numel() / per, 0),
            "k1_iou_tests": tests, "k1_neighbour_pairs": pairs}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("-n", type=int, default=4096, help="detections per image")
    p.add_argument("--blocks", type=int, default=None,
                   help="gossip blocks (default: the flagship's 16)")
    p.add_argument("--lengths", type=int, nargs=2, default=(6, 24),
                   metavar=("K_SMALL", "K_LARGE"),
                   help="the two chain lengths (the reference's 6 and 24)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    arrays = device_tensors(synthetic_arrays(args.batch, args.n, seed=0),
                            device)
    print(f"tile sweep on {card_line(device)}: B={args.batch} N={args.n}, "
          f"chains of {args.lengths[0]} and {args.lengths[1]}", flush=True)
    rng = np.random.default_rng(7)
    results, failed = {}, []
    for regime, extra in REGIMES:
        cfg = regime_config(extra, args.blocks)
        weights = as_state_dict(init_params(cfg.model, seed=0))
        for fi, tj in TILES:
            key = f"{regime} {fi}x{tj}"
            try:
                results[key] = run_case(cfg.model, (fi, tj), weights, arrays,
                                        rng, args.lengths)
            except Exception as e:   # reported, then the run fails
                failed.append(key)
                print(key, f"FAILED: {type(e).__name__}: {str(e)[:200]}",
                      flush=True)
                continue
            print(key, results[key], flush=True)
    print(json.dumps(results), flush=True)
    print("DONE", flush=True)
    if failed:
        raise SystemExit(f"tile sweep: {len(failed)} case(s) failed: "
                         f"{', '.join(failed)}")
    return results


if __name__ == "__main__":
    main()
