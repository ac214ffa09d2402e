"""End-to-end check of gossipnet_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
1. the card (nvidia-smi name and power limit) and the software versions;
2. builds the six kernel sources (ops/cuda/csrc/pairwise2_fwd.cu,
   pairwise2_bwd.cu, matching_scan.cu, pairwise_fwd.cu, pairwise_bwd.cu,
   pair_ablate.cu) from the sources here, one nvcc each, all at once, with
   each build's time and ptxas registers/spills;
3. K1 against its plain PyTorch version on the card: f32 and bf16, the
   clustered B=8 N=1024 batch, B=1 N=4096, an odd rectangular NR != NC,
   block-sparse on and off, multi-class, all-padding rows; a probe with
   identity weights that makes m bit-exact only if the neighbour masks
   match;
3b. K2 against its plain backward on the same cases, f32 and bf16; a tie
   probe (every column duplicated: each tie must get the full gradient);
   a column-permutation probe (m bit-equal, d_b' the permutation of the
   other bit for bit); a winner count (no winner of K1's max missed); two
   launches bit-identical;
3c. K3 and K4 against the plain scan, exactly: the training batch with
   T=1, T=10 and T=32, duplicated GT columns (first index wins), config
   4's batch (N=4096, G=400) with T=1 and T=10 and cut to N=4095, rows
   with more candidates than a list holds, G=1024, all-zero IoU, a tiny
   G=3, K4 at N=4096; two launches bit-identical; outputs exact in
   allocator blocks filled with a non-zero pattern first (the kernel
   writes every output; ``python3 chip_smoke.py --scan-times`` runs this
   phase and then times K3 and K4 alone, ``--scan-stages`` rebuilds K3
   with the chain's bit test a no-op);
4. the serving path: the 16-block serving_bucketed.yaml model with seeded
   numpy weights through the bridge serves images in all five buckets via
   Rescorer.rescore_batch and serve_stream, with K1's launch counter
   checked against 16 launches per batch; its f32 logits against the
   dense plain path; the serve CLI answering JSON lines;
5. times of the forward with CUDA events at the bench workload (B=8,
   N=1024, clustered);
6. the training path: config 2 (coco_persons_full.yaml, 16 blocks at full
   width, batch 8) on the synthetic data of the reference's step probe
   (B=8 N=1024 G=112) trains 20 steps through train(); launch counters
   must read 16 K1 + 16 K2 + 1 K3 per step; the loss must be finite and
   fall; a checkpoint is written; the labels of a batch image by image
   through K4 equal the batched K3 labels; 10 steps, a resume and 10 more
   must give the parameters of 20 straight, bit for bit;
7. f32 gradients of the 16-block model, kernel path against the dense
   plain path, at B=2 N=512, each leaf also against its own scale;
8. the train CLI runs 5 steps from a temporary YAML and writes metrics;
9. times of the training path with CUDA events: the step host to host and
   on the device, the device busy share and each kernel's share, K2, K3
   and K4 ms/launch beside their plain versions and bounds; from K3's own
   input, the rows with a candidate, the list entries walked, the largest
   connected component of the det-GT candidate graph and the chain figure
   (its rows times one dependent shared-memory round trip);
9b. K1 and K2 on the 16-block models' own launch arguments at the four
   shapes of the main paths (the serving bench batch, config 2's training
   batch, config 4's B=2 N=4096 through pair_kernel 2, an evaluation batch
   B=8 N=256): against their plain versions in bf16 and f32, the fill of
   stage B's groups and the length of the winner queue beside the old lane
   use, ms/launch of both in bf16 and f32 beside their bounds
   (``python3 chip_smoke.py --pair-times`` runs only these timings, and
   K5's and K6's at the serving bench batch and config 4 through
   ``pair_kernel: 1``;
   ``python3 chip_smoke.py --k1-stages`` rebuilds K1 with one stage taken
   out at a time and times what is left);
3d. (run after phase 3c) K5, the unfolded pair kernel of
   ``pair_kernel: 1`` (ops/cuda/csrc/pairwise_fwd.cu), against its plain
   version: f32 and bf16, 8 and 9 features, square and rectangular, a
   padded tail and an all-padding image, block-sparse on and off,
   pairwise_dim 16, 32 and 64, and the mask probe;
3e. K6, its backward (pairwise_bwd.cu), against the plain backward on the
   same cases (in bf16 with dm zero at the near-tied maxima, as for K2),
   with the winner count, the tie probe, the column-permutation probe (m
   bit-equal, d_b the permutation bit for bit) and two launches
   bit-identical;
10. config 4 (crowded_4096.yaml, N=4096, batch 2) with pair_kernel 1: the
   Rescorer serves a B=2 N=4096 batch with 16 K5 launches, padding inert;
   K5 against K1 on the same f32 parameters at the reference's 2-block
   N=4096 oracle shape and at 16 blocks; 5 training steps with 16 K5 +
   16 K6 + 1 K3 launches each and a falling loss; f32 gradients of the
   K5/K6 path against the K1/K2 path, leaf by leaf; K5 and K6 on the
   launch arguments of the model (config 4's B=2 N=4096 and the serving
   bench batch) against their plain versions, in bf16 and f32, with the
   fill of stage B's groups and the length of K6's winner queue; K5/K6
   ms/launch (CUDA events and the profiler) beside K1/K2's on the same
   batch; K3 on the scan input of config 4's training step (events, the
   profiler, the plain version, the input's statistics and both figures);
   the forward and the step, with CUDA events and the host clock, with
   K3's share of the step's kernel time;
11. config 3 (coco_multiclass.yaml, 80 classes) on 80-class synthetic
   data: 5 training steps through K1/K2 with the class-match feature and 5
   through K5/K6 with nine features, launches counted; one served batch
   with class ids, whose f32 logits agree between the two kernels;
3f. (run after phase 3e) K7, the per-tile ablation of the pair tile
   (pair_ablate.cu), against its plain version: six modes x column tiles
   of 32, 64 and 128 at a small ragged shape with invalid detections and
   at the probe's own B=8 N=1024 P=32: the five f32 modes at rtol = atol =
   1e-5 (nofc2, h1 as it is, bit-equal), bf3d within one bf16 step and
   bit-equal on 99%, rows without a neighbour (-1e30) at the same places,
   two launches bit-identical; W2 a permutation matrix and b2 = 0, so
   that any misplaced fragment shows: full and bf3d bit-equal; the build's
   18 instantiations without a spill (ptxas), with HMMA in every mode but
   nofc2 and none there (cuobjdump -sass);
12. the ablation tool (gossipnet_tpu_torch.tools.kernel_ablate) as a user
   runs it: ``all`` chains 40 K7 launches per mode, times them with CUDA
   events and prints ms/call, us/tile and full - mode; the launch counter
   must read 40 per timed chain and 41 per mode with its warm-up; then
   ``full`` at column tiles 32 and 128; the plain version's time, the
   bound and the CUDA-core figure (FC1, the elementwise work, IoU and
   features at the f32 rate: this design's floor) per mode, each with
   its share of the time;
13. the evaluation path: evaluate.main on the card evaluates 64 synthetic
   images with the 16-block config 2 model (seeded weights), 16 K1
   launches per batch and no other kernel; its scores equal
   Rescorer.rescore_batch's; K1 on the launch arguments of each evaluation
   batch (B=8 N=256) against its plain version, and the f32 scores of the
   K1 path against the dense plain path's; the COCO stats of the model, of the raw
   scores and of swept GreedyNMS; the warm wall time, forward and host
   matching apart; then train() with a validation set at N=1024 and
   eval_every=2 logs val_AP, keeps the best checkpoint, and the eval CLI
   reads it with --best;
14. serving trained weights, from phase 13's checkpoint: (a)
   Rescorer.from_checkpoint bit-equal to a Rescorer on the best state
   restored by hand, reload(checkpoint_dir, best=False) to the latest
   state, the npz round trip bit-equal; (b) the TcpServer in this process
   on the 16-block serving_bucketed model: 4 JSON clients and a binary one
   at once over the phase-4 images, JSON replies within 2e-6 and binary
   within 1e-6 of rescore_batch, a bad request and a stats request
   answered, 16 K1 launches per served batch, then a reload under service
   after which every reply is the old weights' or the new ones'; (c) the
   serve CLI in a subprocess (--checkpoint-dir, --tcp 0): SIGHUP reloads,
   SIGTERM drains with exit 0; (d) file mode (--input, --output) equal to
   rescore_batch to 6 decimals, with its launches; (e) an artifact
   exported from the checkpoint served in-process, by the serve CLI and
   by evaluate --artifact (the checkpoint's AP to 1e-6); (f) wait() of a
   dispatched batch returns while 0.5 s of work enqueued after it still
   runs (F2);
14g. for information: TCP request latency p50/p99, images/s and mean
   batch at 1 and 4 JSON clients and 1 binary client on the bench's
   images, and the JSON-lines stream through rescore_stream (``python3
   chip_smoke.py --serve-times`` runs only this);
15. the captured paths (utils/cuda_graphs.py) against the eager ones: the
   serving forward of the 16-block model at the bench batch through K1
   and K5, in bf16 and f32, and config 4's, bit-equal to the eager
   forward at the same padded batch, a replay launching what an eager
   forward launches; 20 config-2 steps, 5 config-4 steps through
   pair_kernel 1 and 4 micro-steps of grad_accum_steps 2, each against
   eager train_step on a twin state: every step's metrics, then the
   parameters and optimizer slots, bit for bit; then, eager against
   captured in turns (events, host, host, events): the forward at the
   bench batch and config 4 (dets/s, kernel time, busy share),
   rescore_batch host to host, the config-2 and config-4 steps, the
   evaluation of 64 images, the TCP table of phase 14g; the capture
   seconds per shape and the memory reserved after the warm-up
   (``python3 chip_smoke.py --graph-times`` runs only these timings).

Every path of phases 4-14 runs through captured graphs, as a user's call
does: a replay adds its graph's launches to each counter, and the eager
run before each capture launches them too, so the launch checks count
replays plus captures.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it prints no result
and exits 1.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import queue
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from gossipnet_tpu_torch import api
from gossipnet_tpu_torch import evaluate
from gossipnet_tpu_torch import native
from gossipnet_tpu_torch import serving
from gossipnet_tpu_torch import train as training
from gossipnet_tpu_torch.api import Rescorer
from gossipnet_tpu_torch.config import load_config, experiment_path
from gossipnet_tpu_torch.data.bucketing import (
    BatchIterator,
    bucket_for,
    eval_batches,
    make_batch,
)
from gossipnet_tpu_torch.data.roidb import _xywh_to_xyxy_np
from gossipnet_tpu_torch.data.synthetic import (
    layout_batch,
    layout_record,
    synthetic_roidb,
)
from gossipnet_tpu_torch.models.gossipnet import PAD_LOGIT, PairParams
from gossipnet_tpu_torch.ops import matching
from gossipnet_tpu_torch.ops import order
from gossipnet_tpu_torch.ops import pair_features as pf
from gossipnet_tpu_torch.ops.cuda import ablate as k7
from gossipnet_tpu_torch.ops.cuda import build
from gossipnet_tpu_torch.ops.cuda import matching_scan as k3
from gossipnet_tpu_torch.ops.cuda import pairwise as k5
from gossipnet_tpu_torch.ops.cuda import pairwise2 as k1
from gossipnet_tpu_torch.params import as_state_dict, init_params
from gossipnet_tpu_torch.serving import serve_stream
from gossipnet_tpu_torch.tools import kernel_ablate
from gossipnet_tpu_torch.utils import model_artifact
from gossipnet_tpu_torch.utils import profiling
from gossipnet_tpu_torch.utils.checkpoint import CheckpointManager
from gossipnet_tpu_torch.utils.cuda_graphs import StepGraphs, forward_graphs
from gossipnet_tpu_torch.utils.export import load_params_npz, save_params_npz

# Published H100 SXM peaks (dense): bf16 tensor cores, f32 on CUDA cores,
# HBM3 bandwidth. Bounds below are against these, at the card's power
# limit printed beside them.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
IOU_OPS = 13            # min/max/sub/max x2, mul, add, sub, max, div, cmp
FEATURE_OPS = 10        # K5's per-pair features: 5 sub, 2 div, class cmp...
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)   # one bf16 ulp of h1 may flip
LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)  # 16 blocks compound f32 order
GRAD_TOL = dict(rtol=1e-3, atol=1e-3)   # the same, through the backward
# and per leaf, of its own max |g|: a dropped row or a halved tie moves a
# leaf by O(1) of its scale, f32 order over 16 blocks by far less
LEAF_GRAD_REL = 1e-3
WEIGHT_GRAD_REL = 1e-4   # sums over ~1e5 pairs in another order, of max|x|
KERNELS = ("pairwise2_fwd", "pairwise2_bwd", "matching_scan",
           "pairwise_fwd", "pairwise_bwd", "pair_ablate")
PAIR_KERNELS = ("pairwise2_fwd", "pairwise2_bwd", "pairwise_fwd",
                "pairwise_bwd")
COCO_THRESHOLDS = tuple(np.round(np.arange(0.5, 0.951, 0.05), 2).tolist())
# The reference's step probe (scripts/probe.py:70): buckets to B=8 N=1024
# G=112 at config 2's batch size.
TRAIN_DATA = dict(num_images=32, seed=0, num_gt=100, dets_per_gt=8,
                  num_clutter=200)
TRAIN_STEPS = 20
# kernels line: name -> (source under ops/cuda/csrc/, the TPU kernel)
KERNEL_ROWS = {
    "pair_pool2_fwd": ("pairwise2_fwd.cu",
                       "gossipnet_tpu/ops/pallas/pairwise2.py:529"),
    "pair_pool2_bwd": ("pairwise2_bwd.cu",
                       "gossipnet_tpu/ops/pallas/pairwise2.py:657"),
    "greedy_scan_batched": ("matching_scan.cu",
                            "gossipnet_tpu/ops/pallas/matching_kernel.py:112"),
    "greedy_scan": ("matching_scan.cu",
                    "gossipnet_tpu/ops/pallas/matching_kernel.py:29"),
    "pair_pool_fwd": ("pairwise_fwd.cu",
                      "gossipnet_tpu/ops/pallas/pairwise.py:314"),
    "pair_pool_bwd": ("pairwise_bwd.cu",
                      "gossipnet_tpu/ops/pallas/pairwise.py:492"),
    "pair_ablate": ("pair_ablate.cu", "scripts/kernel_ablate.py:19"),
}
# the pair kernels' labels in the log: (forward, backward)
LABELS = {k1: ("K1", "K2"), k5: ("K5", "K6")}
# config 4's training data: ~3,800 detections and 400 GTs per image,
# bucketed to N=4096; two images, so every step sees the same batch
CROWD_DATA = dict(num_images=2, seed=0, num_gt=400, dets_per_gt=8,
                  num_clutter=600, num_classes=1)
CROWD_STEPS = 5
DEV = "cuda"


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def sorted_bench_batch(b: int, n: int, seed: int = 0):
    """bench.py's clustered batch, Morton-sorted as the kernel path sorts."""
    batch = layout_batch("clustered", b, n, seed=seed)
    dev = torch.device(DEV)
    boxes = torch.from_numpy(batch.boxes).to(dev)
    scores = torch.from_numpy(batch.scores).to(dev)
    valid = torch.from_numpy(batch.valid).to(dev)
    perm = torch.argsort(order.morton_sort_key(boxes, valid), dim=-1,
                         stable=True)
    boxes = torch.gather(boxes, 1, perm[..., None].expand_as(boxes))
    return boxes, torch.gather(scores, 1, perm), torch.gather(valid, 1, perm)


def random_pair_inputs(rng, b, nr, nc, p, g):
    dev = torch.device(DEV)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    prm = PairParams(t(p, p), t(p, p), t(g, p, scale=0.5), t(p),
                     t(p, p, scale=1 / math.sqrt(p)), t(p, scale=0.3))
    return t(b, nr, p), t(b, nc, p), prm


TOL_TEXT = {"float32": f"rtol=atol={F32_TOL['atol']}",
            "bfloat16": "rtol=atol=2e-2, 99% within 1e-4"}


def within(got, want, dtype) -> bool:
    """A pair kernel's m, d_a or d_b against its plain version's: f32
    elementwise at F32_TOL; bf16 at BF16_TOL with 99% within 1e-4."""
    if dtype == "float32":
        return torch.allclose(got, want, **F32_TOL)
    return (torch.allclose(got, want, **BF16_TOL)
            and ((got - want).abs() > 1e-4).float().mean().item() < 0.01)


def compare(name, dtype, cols, rows=None, classes=None, block_sparse=True,
            probe=False, seed=0, kern=k1, p=32):
    """A pair kernel (K1, or K5 with ``kern=k5``) vs its plain version on
    one input; returns the max abs error."""
    rng = np.random.default_rng(seed)
    b, _, nc = cols.shape
    row_cols = cols if rows is None else cols[:, :, rows].contiguous()
    nr = row_cols.shape[2]
    g = pf.NUM_PAIR_FEATURES_MC if classes is not None else \
        pf.NUM_PAIR_FEATURES
    a, bb, prm = random_pair_inputs(rng, b, nr, nc, p, g)
    if probe:
        # wg = 0, W2 = I, b2 = 0, a = 0, b > 0: m_i = max of b_j over the
        # neighbour set, exact in any order: equal only if the masks are.
        a = torch.zeros_like(a)
        bb = bb.abs() + 1.0
        prm = PairParams(prm.wa, prm.wb, torch.zeros_like(prm.wg), prm.b1,
                         torch.eye(p, device=a.device),
                         torch.zeros_like(prm.b2))
    kw = dict(classes=None if classes is None else
              (classes if rows is None else classes[:, rows].contiguous()),
              col_classes=classes, compute_dtype=dtype)
    got = kern.pair_pool(row_cols, cols, a, bb, prm, 0.2,
                         block_sparse=block_sparse, **kw)
    want = kern.pair_pool_reference(row_cols, cols, a, bb, prm, 0.2, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if probe:
        ok = torch.equal(got, want)
        tol = "bit-exact (neighbour masks equal)"
    else:
        ok, tol = within(got, want, dtype), TOL_TEXT[dtype]
    label = LABELS[kern][0]
    log(f"  {label} {name:<24} {dtype:<8} B={b} NR={nr} NC={nc} P={p} "
        f"max_abs_err={err:.3e} tol {tol} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version: "
                             f"{name} {dtype} max_abs_err={err}")
    return err


def pair_case_inputs():
    """The detections of the pair-kernel checks: the clustered bench batch,
    a batch with a padded tail and an all-padding image, a multi-class
    batch and its class ids."""
    dev = torch.device(DEV)
    cols_1024 = pf.stack_columns(pf.det_columns(*sorted_bench_batch(8, 1024)))
    boxes, scores, valid = sorted_bench_batch(3, 700, seed=5)
    valid[1] = False                      # an all-padding image
    valid[2, 300:] = False                # and padding tail rows
    cols_pad = pf.stack_columns(pf.det_columns(boxes, scores, valid))
    cols_mc = pf.stack_columns(pf.det_columns(*sorted_bench_batch(2, 512)))
    cls = torch.from_numpy(np.random.default_rng(1).integers(
        0, 4, (2, cols_mc.shape[2]))).to(dev)
    return cols_1024, cols_pad, cols_mc, cls


def phase_kernel_cases() -> float:
    log("phase 3: K1 against its plain version on the card")
    cols_1024, cols_pad, cols_mc, cls = pair_case_inputs()
    cols_4096 = pf.stack_columns(pf.det_columns(*sorted_bench_batch(1, 4096)))
    n = cols_1024.shape[2]
    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        worst = max(worst,
                    compare("clustered_b8_n1024", dtype, cols_1024),
                    compare("clustered_b1_n4096", dtype, cols_4096),
                    compare("rect_odd", dtype, cols_1024[:2, :, :n - 23],
                            rows=slice(n // 9, n * 7 // 8 - 5)),
                    compare("block_sparse_off", dtype, cols_1024[:2],
                            block_sparse=False),
                    compare("multiclass", dtype, cols_mc, classes=cls),
                    compare("all_padding_rows", dtype, cols_pad))
    compare("mask_probe_b8_n1024", "float32", cols_1024, probe=True)
    compare("mask_probe_b1_n4096", "float32", cols_4096, probe=True)
    for dtype in ("float32", "bfloat16"):
        permutation_probe(cols_1024, dtype, backward=False)
    # how many pairs sit at the threshold, where only exact IoU agrees
    geom = k1.pair_geometry(cols_1024, cols_1024, 0.2)
    iou = k1.fields_iou(geom.row[..., None], geom.col[:, :, None, :])
    near = ((iou - 0.2).abs() < 1e-4).sum().item()
    log(f"  pairs with |IoU - 0.2| < 1e-4 at B=8 N=1024: {near}")
    return worst


def serving_images(rng):
    """~6 clustered images over all five buckets (7n/8 dets each)."""
    sizes = (256, 512, 1024, 1100, 2048, 4560)
    return [layout_record(rng, i, "clustered", n_dets=n)
            for i, n in enumerate(sizes)]


def phase_serving(cfg):
    log("phase 4: main path — 16-block serving_bucketed model on the card")
    recs = serving_images(np.random.default_rng(0))
    images = [(r.det_boxes, r.det_scores, None) for r in recs]
    rescorer = Rescorer(cfg, init_params(cfg.model, seed=0), device=DEV)
    buckets = sorted({min(b for b in cfg.data.bucket_sizes
                          if b >= len(im[1])) for im in images})
    log(f"  images: {[len(im[1]) for im in images]} dets -> buckets "
        f"{buckets}")
    rescorer.warmup(batch_size=1)
    warmed = rescorer._graphs.shapes()

    k1.pair_pool.launches = 0
    t0 = time.perf_counter()
    out = rescorer.rescore_batch(images, batch_size=8)
    batch_s = time.perf_counter() - t0
    launches = k1.pair_pool.launches
    n_batches = len(buckets)       # every image group fits one batch
    # a shape warmup(batch_size=1) did not capture (the two-image group,
    # padded to 2) is captured at its first dispatch, after one eager run
    new = len(rescorer._graphs.shapes()) - len(warmed)
    log(f"  rescore_batch: {len(images)} images in {batch_s * 1e3:.1f} ms, "
        f"K1 launches {launches} (expected {16 * (n_batches + new)} = 16 x "
        f"({n_batches} replayed batches + {new} eager run before a "
        f"capture)); graphs captured: {rescorer._graphs.shapes()}")
    if launches != cfg.model.num_blocks * (n_batches + new):
        raise AssertionError(f"K1 launches {launches} != 16 x "
                             f"({n_batches} + {new})")
    for im, s in zip(images, out):
        if len(s) != len(im[1]) or not np.isfinite(s).all() \
                or s.min() < 0 or s.max() > 1:
            raise AssertionError("bad rescored output")
    log(f"  scores finite in [0,1], lengths match; kept>0.5: "
        f"{[int((s > 0.5).sum()) for s in out]}")

    lines = "".join(json.dumps({"id": i, "boxes": im[0].tolist(),
                                "scores": im[1].tolist()}) + "\n"
                    for i, im in enumerate(images))
    reply = io.StringIO()
    k1.pair_pool.launches = 0
    served = serve_stream(rescorer, 0.5, inp=io.StringIO(lines), out=reply)
    stream_launches = k1.pair_pool.launches
    replies = [json.loads(x) for x in reply.getvalue().splitlines()]
    if served != len(images) or len(replies) != len(images):
        raise AssertionError(f"serve_stream answered {served} of "
                             f"{len(images)}")
    for rep, s in zip(replies, out):
        if np.abs(np.asarray(rep["new_scores"]) - s).max() > 2e-6:
            raise AssertionError(f"serve_stream reply {rep['id']} differs")
    log(f"  serve_stream: {served} JSON replies equal rescore_batch, K1 "
        f"launches {stream_launches} (expected {16 * n_batches})")
    if stream_launches != cfg.model.num_blocks * n_batches:
        raise AssertionError("serve_stream did not run every block on K1")
    total_launches = launches + stream_launches

    # f32 mode: K1 path against the dense plain path, logits
    f32 = load_config(experiment_path("serving_bucketed"),
                      {"model": {"pair_matmul_dtype": "float32"}})
    params = init_params(f32.model, seed=0)
    kern = Rescorer(f32, params, pool_impl="kernel", device=DEV)
    dense = Rescorer(f32, params, pool_impl="dense", device=DEV)
    worst = 0.0
    for padded_n in buckets:
        group = [(i,) + tuple(im) for i, im in enumerate(images)
                 if min(b for b in f32.data.bucket_sizes
                        if b >= len(im[1])) == padded_n]
        arrays, _ = kern._pack(group, padded_n)
        t = [torch.from_numpy(x).to(DEV) for x in arrays[:3]]
        with torch.inference_mode():
            lk, ld = kern.model(*t), dense.model(*t)
        if not torch.allclose(lk, ld, **LOGIT_TOL):
            raise AssertionError(f"f32 logits differ at N={padded_n}")
        worst = max(worst, (lk - ld).abs().max().item())
    log(f"  f32 logits, K1 path vs dense plain path: max_abs_err "
        f"{worst:.3e} (tol rtol=atol=1e-3) -> ok")

    cli = subprocess.run(
        [sys.executable, "-m", "gossipnet_tpu_torch.serve", "-c",
         experiment_path("serving_bucketed"), "--random-init"],
        input=lines, capture_output=True, text=True, timeout=600, check=True,
        cwd=Path(__file__).resolve().parent)
    cli_replies = [json.loads(x) for x in cli.stdout.splitlines()]
    if [r["id"] for r in cli_replies] != list(range(len(images))):
        raise AssertionError(f"serve CLI answered {cli.stdout[:200]}")
    log(f"  serve CLI: {len(cli_replies)} JSON replies; "
        f"{cli.stderr.strip().splitlines()[-1]}")
    return rescorer, total_launches


def cuda_time(fn, iters, warmup=3) -> float:
    """ms per call from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, reps) -> float:
    """ms per call of ``fn`` on the host clock, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_times(rescorer, dtype):
    log(f"phase 5: times at the bench workload (B=8, N=1024, clustered), "
        f"K1 in {dtype}")
    model = rescorer.model
    boxes, scores, valid = sorted_bench_batch(8, 1024)
    with torch.inference_mode():
        geom, a2, b2, wg_k, w2, b2bias, _ = capture(
            k1, "launch_kernel", lambda: model(boxes, scores, valid))
        kernel_ms = cuda_time(lambda: k1.launch_kernel(
            geom, a2, b2, wg_k, w2, b2bias, dtype), iters=50)
        plain_ms = cuda_time(lambda: k1._reference_core(
            geom, a2, b2, wg_k, w2, b2bias, dtype), iters=5, warmup=1)
        f32_ms = cuda_time(lambda: k1.launch_kernel(
            geom, a2, b2, wg_k, w2, b2bias, "float32"), iters=50)
        fwd_ms = cuda_time(lambda: model(boxes, scores, valid), iters=10)

    # what this run's data needs (k1_bound): neighbour pairs through the
    # MLP, and the IoU test over the valid pairs of the active tiles
    nb_pairs, tested = pair_counts(geom)
    p, k = 32, 3
    nbytes = sum(t.numel() * t.element_size() for t in
                 (geom.row, geom.col, a2, b2, wg_k, w2, b2bias, geom.flags)) \
        + a2.numel() * 4                                    # the output m
    bound_ms, bound_by = k1_bound((geom, a2, b2, wg_k, w2, b2bias), dtype)
    skipped = 1.0 - geom.flags.float().mean().item()
    dets_s = 8 * 1024 / (fwd_ms / 1e3)

    with torch.inference_mode():
        busy_ms, by_name = profile_kernels(
            lambda: model(boxes, scores, valid), reps=3)
    log_kernels(by_name, busy_ms, "forward")

    images = [(r.det_boxes, r.det_scores, None) for r in
              (layout_record(np.random.default_rng(0), i, "clustered", 1024)
               for i in range(8))]
    rescorer.rescore_batch(images)
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        rescorer.rescore_batch(images)
    e2e_ms = (time.perf_counter() - t0) / reps * 1e3

    log(f"  K1 {dtype}: {kernel_ms:.4f} ms/launch; K1 float32: "
        f"{f32_ms:.4f} ms/launch; plain version {dtype}: {plain_ms:.3f} ms")
    log(f"  bound {bound_ms:.5f} ms ({bound_by}"
        f": {nb_pairs} neighbour pairs x {2 * p * p + (k + 6) * p} ops, "
        f"{tested} IoU tests, {nbytes / 1e6:.2f} MB); tiles skipped "
        f"{skipped:.4f}")
    busy = f"{busy_ms / fwd_ms:.3f}" if busy_ms else "not measured"
    log(f"  eager forward (16 blocks, 16 K1 launches; captured: phase "
        f"15): {fwd_ms:.3f} ms = "
        f"{dets_s:.0f} dets/s (B x N / forward time); device busy {busy} "
        f"of it, K1 {16 * kernel_ms / fwd_ms:.3f}; Rescorer.rescore_batch "
        f"of 8 images host-to-host: {e2e_ms:.3f} ms")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)

# ---------------------------------------------------------------------------
# K2: the pair-pool backward
# ---------------------------------------------------------------------------

GRAD_NAMES = ("d_a'", "d_b'", "dWg_k", "dW2", "db2")


def pair_args(cols, rows=None, classes=None, block_sparse=True, seed=0,
              kern=k1, p=32):
    """The launch arguments of one pair stage on random weights -- K1's
    (geom, a', b', Wg_k, W2, b2), or K5's (columns, a, b, Wg, W2, b2) with
    ``kern=k5`` -- and a random cotangent dm."""
    rng = np.random.default_rng(seed)
    b, _, nc = cols.shape
    row_cols = cols if rows is None else cols[:, :, rows].contiguous()
    nr = row_cols.shape[2]
    g = pf.NUM_PAIR_FEATURES_MC if classes is not None else \
        pf.NUM_PAIR_FEATURES
    a, bb, prm = random_pair_inputs(rng, b, nr, nc, p, g)
    rcls = None if classes is None else \
        (classes if rows is None else classes[:, rows].contiguous())
    dm = torch.from_numpy(rng.standard_normal((b, nr, p)).astype(
        np.float32)).to(a.device)
    if kern is k5:
        cols5 = k5.pair_columns(row_cols, cols, 0.2, rcls, classes,
                                block_sparse)
        return (cols5, a, bb, prm.wg, prm.w2.contiguous(),
                prm.b2.contiguous()), dm
    geom = k1.pair_geometry(row_cols, cols, 0.2, rcls, classes, block_sparse)
    a2, b2 = k1.fold_separable(prm.wg, a, bb, geom)
    return (geom, a2.contiguous(), b2.contiguous(),
            k1._kernel_wg(prm.wg, geom.multiclass), prm.w2.contiguous(),
            prm.b2.contiguous()), dm


def grad_errors(got, want, dtype):
    """Per-gradient max abs error and whether it is within tolerance:
    d_a'/d_b' elementwise (f32 rtol=atol=1e-5; bf16 as K1's bf16), the
    weight gradients at WEIGHT_GRAD_REL of their largest entry."""
    errs, ok = {}, True
    for name, x, y in zip(GRAD_NAMES, got, want):
        err = (x - y).abs().max().item() if x.numel() else 0.0
        errs[name] = err
        if name in ("d_a'", "d_b'"):
            good = within(x, y, dtype)
        else:
            good = err <= WEIGHT_GRAD_REL * max(y.abs().max().item(), 1e-30)
        ok = ok and good
    return errs, ok


def compare_k2(name, dtype, cols, kern=k1, **kw):
    """K2 on K1's m (or K6 on K5's, ``kern=k5``) against the plain
    backward on the plain forward's m, on random weights."""
    args, dm = pair_args(cols, kern=kern, **kw)
    return check_backward(name, dtype, args, dm, kern)


NEAR_TIE_REL = 1e-5


def near_ties(args, dtype, kern=k1) -> torch.Tensor:
    """[B, NR, P] bool: the maxima whose best two candidates lie within
    NEAR_TIE_REL of each other (relative), in the plain version. K1's and
    K5's bf16 FC2 sums on the tensor cores, in another order than the plain
    version's fmaf chain, so the two agree on m to ~1e-7 relative and no
    closer: where two candidates are nearer than that, each side may crown
    another column, and the whole dm of that (row, q) moves between two
    columns. That is a property of the max at such inputs, not an error of
    either side (measured: one such flip among config 2's 203,115
    maxima)."""
    ties = []
    for _, nb, _, _, pre2 in kern._pair_chunks(*args, dtype):
        v = torch.where(nb[..., None], pre2, torch.full_like(pre2, -1e30))
        if v.shape[2] < 2:
            ties.append(torch.zeros_like(v[:, :, 0], dtype=torch.bool))
            continue
        top = v.topk(2, dim=2).values                       # [B, rc, 2, P]
        best, second = top[:, :, 0], top[:, :, 1]
        ties.append((best > 0) & (best - second < NEAR_TIE_REL * best))
    return torch.cat(ties, dim=1)


def check_backward(name, dtype, args, dm, kern=k1):
    """The backward kernel on the forward kernel's m against the plain
    backward on the plain forward's m, on the launch arguments ``args``.
    In bf16 (K2 and K6): with dm zero at the near ties (:func:`near_ties`),
    where the two sides may rightly differ; the tolerances stay as they
    are."""
    masked = ""
    if dtype == "bfloat16":
        tie = near_ties(args, dtype, kern)
        dm = torch.where(tie, torch.zeros_like(dm), dm)
        masked = f" ({int(tie.sum().item())} near-tied maxima left out)"
    m_k = kern.launch_kernel(*args, dtype)
    m_p = kern._reference_core(*args, dtype)
    got = kern.launch_backward_kernel(*args, m_k, dm, dtype)
    want = kern.pair_pool_backward_reference(*args, m_p, dm, dtype)
    torch.cuda.synchronize()
    errs, ok = grad_errors(got, want, dtype)
    label = LABELS[kern][1]
    log(f"  {label} {name:<24} {dtype:<8} NR={args[1].shape[1]} "
        f"NC={args[2].shape[1]} P={args[1].shape[2]} m==plain m: "
        f"{torch.equal(m_k, m_p)}; "
        + " ".join(f"{n}={e:.2e}" for n, e in errs.items())
        + f"{masked} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version: "
                             f"{name} {dtype} {errs}")
    return max(errs.values())


def k2_winners(cols, dtype, kern=k1):
    """dm = 1: db2[q] counts the winners of q, at least one per row with
    m > 0 (more only at exact ties). A recompute that missed the forward
    kernel's bits would miss winners here."""
    args, dm = pair_args(cols, kern=kern)
    m = kern.launch_kernel(*args, dtype)
    db2 = kern.launch_backward_kernel(*args, m, torch.ones_like(dm),
                                      dtype)[4]
    rows = (m > 0).sum(dim=(0, 1)).float()
    label = LABELS[kern][1]
    log(f"  {label} winners {dtype:<8}: {int(db2.sum().item())} for "
        f"{int(rows.sum().item())} (row, q) maxima > 0")
    if not bool((db2 >= rows).all()):
        raise AssertionError(f"{label} missed winners in {dtype}")


def k2_tie_probe(cols, dtype, kern=k1, classes=None):
    """Every column duplicated: each max then ties exactly between j and
    its copy, and each tie must get the full dm (the TPU kernel's rule),
    so d_b' repeats d_b' of the single problem on both copies, and d_a',
    dWg_k, dW2 and db2 double. A rule that split ties would halve them."""
    args_s, dm = pair_args(cols, classes=classes, kern=kern)
    geom_s, a2, b2, wg_k, w2, b2bias = args_s
    dup = torch.repeat_interleave(cols, 2, dim=2)
    build_cols = k5.pair_columns if kern is k5 else k1.pair_geometry
    geom_d = build_cols(cols, dup, 0.2, classes, None if classes is None
                        else torch.repeat_interleave(classes, 2, dim=1))
    args_d = (geom_d, a2, torch.repeat_interleave(b2, 2, dim=1).contiguous(),
              wg_k, w2, b2bias)
    m_s = kern.launch_kernel(*args_s, dtype)
    m_d = kern.launch_kernel(*args_d, dtype)
    single = kern.launch_backward_kernel(*args_s, m_s, dm, dtype)
    got = kern.launch_backward_kernel(*args_d, m_d, dm, dtype)
    plain = kern.pair_pool_backward_reference(
        *args_d, kern._reference_core(*args_d, dtype), dm, dtype)
    torch.cuda.synchronize()
    db_d = got[1]
    want = (2 * single[0], single[1].repeat_interleave(2, dim=1),
            2 * single[2], 2 * single[3], 2 * single[4])
    errs, ok = grad_errors(got, want, dtype)
    errs_p, ok_p = grad_errors(got, plain, dtype)
    copies = torch.equal(db_d[:, 0::2], db_d[:, 1::2])
    ok = ok and ok_p and copies and torch.equal(m_s, m_d)
    label = LABELS[kern][1]
    log(f"  {label} tie probe {dtype:<8}: copies of d_b bit-equal {copies}; "
        f"vs full-gradient rule max {max(errs.values()):.2e}, vs plain "
        f"{max(errs_p.values()):.2e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} tie rule fails in {dtype}: {errs} "
                             f"{errs_p}")
    return max(max(errs.values()), max(errs_p.values()))


def permutation_probe(cols, dtype, backward=True, seed=7, kern=k1):
    """The same problem with its columns (and b') permuted. K1's (K5's)
    max is an order-free merge and a pair's pre2 depends on nothing but the
    pair, so m must be bit-equal. K2's (K6's) d_b'_j adds its rows in an
    order the row indices fix, so d_b' must be the permutation of the other
    bit for bit; d_a' and the weight gradients add the columns in another
    order and are held to the tolerances of the plain comparison. For K6
    the probe also catches a column pass that hands the features its own
    column as the row: they are not symmetric."""
    args, dm = pair_args(cols, kern=kern)
    geom, a2, b2, wg_k, w2, b2bias = args
    nc = cols.shape[2]
    perm = torch.randperm(nc, generator=torch.Generator().manual_seed(seed)
                          ).to(cols.device)
    build_cols = k5.pair_columns if kern is k5 else k1.pair_geometry
    geom_p = build_cols(cols, cols[:, :, perm].contiguous(), 0.2)
    args_p = (geom_p, a2, b2[:, perm].contiguous(), wg_k, w2, b2bias)
    m = kern.launch_kernel(*args, dtype)
    m_p = kern.launch_kernel(*args_p, dtype)
    torch.cuda.synchronize()
    same_m = torch.equal(m, m_p)
    text = f"m bit-equal {same_m}"
    ok, worst = same_m, 0.0
    if backward:
        got = kern.launch_backward_kernel(*args, m, dm, dtype)
        got_p = kern.launch_backward_kernel(*args_p, m_p, dm, dtype)
        torch.cuda.synchronize()
        same_db = torch.equal(got_p[1], got[1][:, perm])
        want = (got[0], got[1][:, perm], *got[2:])
        errs, close = grad_errors(got_p, want, dtype)
        worst = max(errs.values())
        ok = ok and same_db and close
        text += (f"; d_b' the permutation of the other bit for bit "
                 f"{same_db}; d_a' and weight gradients max {worst:.2e}")
    label = LABELS[kern][1 if backward else 0]
    log(f"  {label} column-permutation probe {dtype:<8} NC={nc}: {text} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} column-permutation probe fails in "
                             f"{dtype}: {text}")
    return worst


def phase_k2_cases() -> float:
    log("phase 3b: K2 (pair-pool backward) against its plain version")
    cols_1024, cols_pad, cols_mc, cls = pair_case_inputs()
    cols_4096 = pf.stack_columns(pf.det_columns(*sorted_bench_batch(1, 4096)))
    n = cols_1024.shape[2]
    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        worst = max(worst,
                    compare_k2("clustered_b8_n1024", dtype, cols_1024),
                    compare_k2("clustered_b1_n4096", dtype, cols_4096),
                    compare_k2("rect_odd", dtype, cols_1024[:2, :, :n - 23],
                               rows=slice(n // 9, n * 7 // 8 - 5)),
                    compare_k2("block_sparse_off", dtype, cols_1024[:2],
                               block_sparse=False),
                    compare_k2("multiclass", dtype, cols_mc, classes=cls),
                    compare_k2("all_padding_rows", dtype, cols_pad),
                    k2_tie_probe(cols_1024[:2, :, :512].contiguous(), dtype),
                    permutation_probe(cols_1024[:2].contiguous(), dtype))
        k2_winners(cols_1024, dtype)
    args, dm = pair_args(cols_1024)
    for dtype in ("float32", "bfloat16"):
        m = k1.launch_kernel(*args, dtype)
        one = k1.launch_backward_kernel(*args, m, dm, dtype)
        two = k1.launch_backward_kernel(*args, m, dm, dtype)
        same = all(torch.equal(x, y) for x, y in zip(one, two))
        log(f"  K2 determinism {dtype}: two launches bit-identical: {same}")
        if not same:
            raise AssertionError(f"K2 is not deterministic in {dtype}")
    return worst


# ---------------------------------------------------------------------------
# K3 / K4: the greedy matching scan
# ---------------------------------------------------------------------------


def training_batch(seed=0, **data):
    """The first batch of the training stream of ``synthetic_roidb``."""
    roidb = synthetic_roidb(**{**TRAIN_DATA, **data})
    batch = next(BatchIterator(roidb, 8, (256, 512, 1024), seed=seed))
    return training.batch_to_device(batch, torch.device(DEV))


def capture(module, name: str, run):
    """Runs ``run()`` with ``module.name`` recording its arguments ->
    the first call's arguments, tensors copied (an optimizer step updates
    the parameters a pair stage was given in place), and the call still
    happens."""
    calls = []
    fn = getattr(module, name)

    def record(*args, **kw):
        # a thresholds pair is recorded as its host tensor: the scan's
        # wrapper copies it to the card on each call, as it always did
        calls.append(tuple(
            x.detach().clone() if isinstance(x, torch.Tensor)
            else x.host.clone() if isinstance(x, k3.Thresholds) else x
            for x in args))
        return fn(*args, **kw)

    # a wrapper's launch count lives on it; carry it over and back
    counted = hasattr(fn, "launches")
    if counted:
        record.launches = fn.launches
    setattr(module, name, record)
    try:
        run()
    finally:
        setattr(module, name, fn)
        if counted:
            fn.launches = record.launches
    return calls[0]


def scan_input(arrays, thresholds, seed=0):
    """The pre-masked, score-sorted IoU that greedy_match_batch hands K3,
    for random scores."""
    rng = np.random.default_rng(seed)
    scores = torch.from_numpy(rng.uniform(
        -3, 3, arrays["scores"].shape).astype(np.float32)).to(DEV)
    return capture(k3, "greedy_scan_batched", lambda: matching.greedy_match_batch(
        arrays["boxes"], scores, arrays["valid"], arrays["gt_boxes"],
        arrays["gt_valid"], arrays["gt_crowd"], thresholds, impl="kernel"))


def crowd_training_batch():
    """Config 4's training batch (B=2 N=4096 G=400), the first of its
    stream as phase 10 trains on it, on the card."""
    roidb = synthetic_roidb(**CROWD_DATA)
    batch = next(BatchIterator(roidb, 2, crowd_config().data.bucket_sizes))
    return training.batch_to_device(batch, torch.device(DEV))


def sparse_iou(rng, b, n, g, per_row, dense_rows=()):
    """Pre-masked IoU in sixteenths (exact ties) with about ``per_row``
    candidates a row above 0.3, every fifth row masked, and ``dense_rows``
    with a candidate in every column (more than a list holds)."""
    iou = np.round(rng.uniform(0.3, 1.0, (b, n, g)) * 16) / 16
    iou *= rng.uniform(size=(b, n, g)) < per_row / g
    iou[:, ::5] = 0.0
    rows = list(dense_rows)
    iou[:, rows] = np.round(rng.uniform(0.5, 1.0, (b, len(rows), g)) * 16) / 16
    return torch.from_numpy(iou.astype(np.float32)).to(DEV)


def compare_scan(name, iou, thresholds, single=False, twice=False,
                 dirty=False):
    """K3 (K4 with ``single``: one image, a grid of one) against the plain
    scan, exactly. ``twice``: a second launch must give the same bits.
    ``dirty``: the caching allocator's free blocks of the outputs' sizes
    are filled with a non-zero pattern first, and the outputs must land in
    them, which shows that the kernel writes every output."""
    thr = torch.tensor(thresholds, dtype=torch.float32)
    x = iou[None].contiguous() if single else iou
    reused = ""
    if dirty:
        shape = x.shape[:2] + (len(thresholds),)
        junk = [t for _ in range(4) for t in (
            torch.ones(shape, dtype=torch.bool, device=DEV),
            torch.full(shape, 0x5A5A5A5A, dtype=torch.int32, device=DEV))]
        ptrs = {t.data_ptr() for t in junk}
        del junk
    got = k3.launch_kernel(x, thr)
    if dirty:
        hit = all(t.data_ptr() in ptrs for t in got)
        reused = f", outputs in the filled blocks: {hit}"
        if not hit:
            raise AssertionError(f"{name}: the outputs did not land in the "
                                 f"filled blocks; the check proves nothing")
    want = k3.greedy_scan_reference(x, thr)
    again = k3.launch_kernel(x, thr) if twice else got
    torch.cuda.synchronize()
    ok = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    over = int(((x >= min(thresholds)).sum(dim=2) > 32).sum().item())
    log(f"  {'K4' if single else 'K3'} {name:<26} shape "
        f"{tuple(iou.shape)} T={len(thresholds)}: matched "
        f"{int(want[0].sum().item())}, rows past a list {over}, exact: {ok}"
        + (f", two launches bit-identical: {same}" if twice else "")
        + reused)
    if not ok or not same:
        raise AssertionError(f"scan kernel differs from its plain version: "
                             f"{name}")


def phase_scan_cases():
    log("phase 3c: K3/K4 (greedy matching scan) against the plain scan")
    arrays = training_batch()
    iou1, _ = scan_input(arrays, (0.5,))
    compare_scan("probe_batch_t1", iou1, (0.5,), dirty=True)
    iou10, _ = scan_input(arrays, COCO_THRESHOLDS, seed=1)
    compare_scan("probe_batch_t10", iou10, COCO_THRESHOLDS, dirty=True)
    g = iou1.shape[2]
    ties = iou1.repeat_interleave(2, dim=2)[:, :, :g].contiguous()
    compare_scan("duplicated_gt_columns", ties, COCO_THRESHOLDS)
    t32 = tuple(np.round(np.linspace(0.05, 0.95, 32), 3).tolist())
    compare_scan("probe_batch_t32", iou1, t32, twice=True)
    compare_scan("probe_image_k4", iou10[3], COCO_THRESHOLDS, single=True)
    crowd = crowd_training_batch()
    iou4k, _ = scan_input(crowd, (0.5,))
    compare_scan("config4_t1", iou4k, (0.5,), dirty=True)
    iou4k10, _ = scan_input(crowd, COCO_THRESHOLDS, seed=1)
    compare_scan("config4_t10", iou4k10, COCO_THRESHOLDS, twice=True)
    compare_scan("config4_n4095", iou4k10[:, :4095].contiguous(),
                  COCO_THRESHOLDS)
    rng = np.random.default_rng(11)
    over = sparse_iou(rng, 2, 300, 112, 4, dense_rows=(3, 50, 51, 200))
    compare_scan("overflow_rows", over, COCO_THRESHOLDS, twice=True)
    compare_scan("overflow_rows_k4", over[1], (0.5,), single=True)
    wide = sparse_iou(rng, 2, 1000, 1024, 6, dense_rows=(7, 998))
    compare_scan("g1024_n1000", wide, COCO_THRESHOLDS, twice=True)
    compare_scan("g1024_n1000_t32", wide, t32)
    compare_scan("all_zero", torch.zeros((2, 257, 112), device=DEV),
                 COCO_THRESHOLDS, dirty=True)
    compare_scan("tiny_n5_g3", sparse_iou(rng, 3, 5, 3, 2), (0.5, 0.75))
    rec = layout_record(np.random.default_rng(3), 0, "clustered", 4096)
    big = training.batch_to_device(make_batch([rec], padded_n=4096),
                                   torch.device(DEV))
    iou_one, _ = capture(k3, "greedy_scan", lambda: matching.greedy_match(
        big["boxes"][0], big["scores"][0], big["valid"][0],
        big["gt_boxes"][0], big["gt_valid"][0], big["gt_crowd"][0], (0.5,),
        impl="kernel"))
    compare_scan("clustered_n4096", iou_one, (0.5,), single=True)


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------


def train_config(tmp: Path, name: str, **train_kw):
    """Config 2 (coco_persons_full.yaml) at full width on the synthetic
    data, checkpointing under ``tmp/name``."""
    return load_config(experiment_path("coco_persons_full"), {
        "data": {"dataset": "synthetic"},
        "train": {"checkpoint_dir": str(tmp / name), "log_every": 1,
                  "snapshot_every": 10, "eval_every": 0, **train_kw}})


COUNTERS = {"pair_pool2_fwd": (k1, "pair_pool"),
            "pair_pool2_bwd": (k1, "pair_pool_backward"),
            "greedy_scan_batched": (k3, "greedy_scan_batched"),
            "greedy_scan": (k3, "greedy_scan"),
            "pair_pool_fwd": (k5, "pair_pool"),
            "pair_pool_bwd": (k5, "pair_pool_backward"),
            "pair_ablate": (k7, "pair_ablate")}


def reset_counts():
    for module, fn in COUNTERS.values():
        getattr(module, fn).launches = 0


def counts() -> dict:
    return {name: getattr(module, fn).launches
            for name, (module, fn) in COUNTERS.items()}


def want_counts(**nonzero) -> dict:
    """Every kernel's expected launches: ``nonzero``, the rest 0."""
    return {name: nonzero.get(name, 0) for name in COUNTERS}


def state_params(state) -> dict:
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def phase_training(tmp: Path):
    """The main path of this slice: config 2 trains on the card through K1,
    K2 and K3; then the labels of its last batch, image by image through
    K4, must equal the batched K3 labels."""
    log(f"phase 6: main path — config 2 (16 blocks, 128/32/32, batch 8) "
        f"trains {TRAIN_STEPS} steps on the card")
    cfg = train_config(tmp, "straight")
    roidb = synthetic_roidb(**TRAIN_DATA)
    first = next(BatchIterator(roidb, 8, cfg.data.bucket_sizes))
    log(f"  data: synthetic_roidb({TRAIN_DATA}) -> batches of B, N, G = "
        f"{first.batch_size}, {first.padded_n}, {first.padded_g}")
    metrics_path = tmp / "straight_metrics.jsonl"

    reset_counts()
    t0 = time.perf_counter()
    state = training.train(cfg, roidb, pool_impl="kernel",
                           metrics_path=str(metrics_path),
                           max_steps=TRAIN_STEPS, device=DEV)
    arrays = training.batch_to_device(first, torch.device(DEV))
    with torch.no_grad():
        logits = state.model(arrays["boxes"], arrays["scores"],
                             arrays["valid"])
    batched = matching.greedy_match_batch(
        arrays["boxes"], logits, arrays["valid"], arrays["gt_boxes"],
        arrays["gt_valid"], arrays["gt_crowd"], cfg.matching.thresholds)
    for b in range(first.batch_size):
        one = matching.greedy_match(
            arrays["boxes"][b], logits[b], arrays["valid"][b],
            arrays["gt_boxes"][b], arrays["gt_valid"][b],
            arrays["gt_crowd"][b], cfg.matching.thresholds, impl="kernel")
        if not all(torch.equal(x, y[b]) for x, y in zip(one, batched)):
            raise AssertionError(f"K4 labels of image {b} differ from K3's")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts()
    steps = state.step
    log(f"  {steps} steps in {run_s:.1f} s (first steps include warm-up); "
        f"launches {launches}")
    blocks = cfg.model.num_blocks
    runs = steps + state.graphs.captures
    # Each step replays its shape's graph; each capture followed one eager
    # step. The label check adds one forward (16 K1) and one K3 launch; K4
    # runs once per image of it.
    want = want_counts(pair_pool2_fwd=blocks * runs + blocks,
                       pair_pool2_bwd=blocks * runs,
                       greedy_scan_batched=runs + 1,
                       greedy_scan=first.batch_size)
    if launches != want:
        raise AssertionError(f"launches {launches} != {want} (16 K1 + 16 K2 "
                             f"+ 1 K3 per step)")
    log(f"  = {blocks} K1 + {blocks} K2 + 1 K3 per step over {steps} "
        f"replayed steps and {state.graphs.captures} eager step(s) before "
        f"a capture (+ one checking forward, and K4 on its "
        f"{first.batch_size} images, whose labels equal the batched K3 "
        f"labels)")

    losses = [json.loads(x)["loss"] for x in
              metrics_path.read_text().splitlines()]
    head, tail = np.mean(losses[:5]), np.mean(losses[-5:])
    log(f"  loss per step: {' '.join(f'{x:.4f}' for x in losses)}")
    if len(losses) != steps or not np.isfinite(losses).all() or tail >= head:
        raise AssertionError(f"loss not finite and falling: {losses}")
    ckpts = sorted(p.name for p in (tmp / "straight" / "steps").glob("*.pt"))
    log(f"  loss falls: mean of the first five {head:.4f}, of the last five "
        f"{tail:.4f}; checkpoints written: {ckpts}")
    if f"{steps}.pt" not in ckpts:
        raise AssertionError("no checkpoint of the last step")

    # Resume: 10 steps, stop, 10 more from the checkpoint, against straight.
    half = train_config(tmp, "resumed")
    training.train(half, roidb, pool_impl="kernel", max_steps=TRAIN_STEPS // 2,
                   device=DEV)
    resumed = training.train(half, roidb, pool_impl="kernel",
                             max_steps=TRAIN_STEPS, device=DEV)
    a, b = state_params(state), state_params(resumed)
    exact = all(torch.equal(a[k], b[k]) for k in a)
    worst = max((a[k] - b[k]).abs().max().item() for k in a)
    log(f"  resume: {TRAIN_STEPS // 2} steps + resume + {TRAIN_STEPS // 2} "
        f"against {TRAIN_STEPS} straight: parameters bit-identical: {exact} "
        f"(max |diff| {worst:.3e}); step {resumed.step}")
    if not exact or resumed.step != state.step:
        raise AssertionError("resume is not bit-exact")
    return state, launches


def phase_train_gradients():
    """f32 gradients of the 16-block model: the kernel path (K1 + K2)
    against the dense plain path, at B=2 N=512."""
    log("phase 7: f32 gradients, kernel path against the dense plain path")
    cfg = load_config(experiment_path("coco_persons_full"),
                      {"model": {"pair_matmul_dtype": "float32"}})
    arrays = training_batch(num_images=2, num_gt=50, dets_per_gt=8,
                            num_clutter=50)
    arrays = {k: v[:2] for k, v in arrays.items()}
    grads = {}
    for impl in ("kernel", "dense"):
        model = training.build_model(cfg, impl, DEV)
        model.load_state_dict(as_state_dict(init_params(cfg.model)))
        loss, _ = training.loss_and_metrics(model, arrays, cfg)
        loss.backward()
        grads[impl] = {k: p.grad for k, p in model.named_parameters()}
    compare_grads(f"kernel path vs dense plain path at B=2 "
                  f"N={arrays['boxes'].shape[1]}", grads["kernel"],
                  grads["dense"])


def compare_grads(label, got: dict, want: dict):
    """Two paths' parameter gradients, leaf by leaf: elementwise at
    GRAD_TOL, and each leaf's max |diff| at most LEAF_GRAD_REL of its own
    max |g|, so that a leaf of small entries is held to its own scale.
    Logs the leaves nearest their limit, each with its max |g|."""
    rows, bad = [], []
    for k, g in got.items():
        d = want[k]
        diff = (g - d).abs().max().item()
        scale = d.abs().max().item()
        ratio = diff / max(scale, 1e-30)
        rows.append((ratio, k, diff, scale))
        if not torch.allclose(g, d, **GRAD_TOL) or ratio > LEAF_GRAD_REL:
            bad.append(k)
    rows.sort(reverse=True)
    log(f"  f32 gradients, {label}: {len(rows)} parameter gradients, max "
        f"|diff| {max(r[2] for r in rows):.3e}, smallest leaf max |g| "
        f"{min(r[3] for r in rows):.3e} (tol rtol=atol=1e-3 and max |diff| "
        f"<= {LEAF_GRAD_REL} of the leaf's max |g|) -> "
        f"{'ok' if not bad else 'FAIL ' + str(bad[:4])}; nearest their "
        f"limit:")
    for ratio, k, diff, scale in rows[:6]:
        log(f"    {k:<40} max |g| {scale:.3e}  max |diff| {diff:.3e}  "
            f"ratio {ratio:.2e}")
    if bad:
        raise AssertionError(f"gradients differ ({label}): {bad}")


def phase_train_cli(tmp: Path):
    log("phase 8: the train CLI, 5 steps from a temporary YAML")
    import yaml

    with open(experiment_path("coco_persons_full")) as f:
        raw = yaml.safe_load(f)
    raw["data"]["dataset"] = "synthetic"
    raw["train"].update(max_steps=5, log_every=1,
                        checkpoint_dir=str(tmp / "cli_ckpt"))
    path = tmp / "cli.yaml"
    path.write_text(yaml.safe_dump(raw))
    metrics = tmp / "train_metrics.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "gossipnet_tpu_torch.train", "-c", str(path),
         "--metrics", str(metrics)], capture_output=True, text=True,
        timeout=600, cwd=Path(__file__).resolve().parent)
    if out.returncode != 0:
        raise AssertionError(f"train CLI failed:\n{out.stderr[-2000:]}")
    recs = [json.loads(x) for x in metrics.read_text().splitlines()]
    if [r["step"] for r in recs] != [1, 2, 3, 4, 5] or not all(
            np.isfinite(r["loss"]) for r in recs):
        raise AssertionError(f"train CLI metrics: {recs}")
    log(f"  train_metrics.jsonl: {len(recs)} records, loss "
        f"{recs[0]['loss']:.4f} -> {recs[-1]['loss']:.4f}; "
        f"{out.stdout.strip().splitlines()[-1]}")


def profile_kernels(fn, reps: int) -> tuple[float, dict]:
    """Device time of ``reps`` calls of ``fn`` from torch.profiler's CUDA
    trace, kernel events only (``profiling.kernel_ms``) -> (busy ms per
    call, {kernel name: ms per call}); (0.0, {}) when the trace holds no
    device time."""
    fn()
    torch.cuda.synchronize()
    with profiling.profile_trace(None) as prof:
        for _ in range(reps):
            fn()
    by_name = {k: v / reps for k, v in profiling.kernel_ms(prof).items()}
    return sum(by_name.values()), by_name


def log_kernels(by_name: dict, busy_ms: float, per: str):
    """The eight largest kernels of a profile, by share of kernel time."""
    if not busy_ms:
        log("  profile: the trace holds no device time (not measured)")
        return
    log(f"  kernels {busy_ms:.4f} ms per {per}; largest:")
    for key, ms in sorted(by_name.items(), key=lambda x: -x[1])[:8]:
        log(f"    {ms / busy_ms:6.3f}  {ms:8.4f} ms/{per}  {key[:70]}")


def k1_geometry(geom):
    """K1's geometry, or K5's columns read through a K1 geometry of the
    same detections with K5's own flags (the counters below read K1's
    fields)."""
    if isinstance(geom, k5.PairColumns):
        n = pf.NUM_COLUMNS
        return k1.pair_geometry(geom.row[:, :n], geom.col[:, :n],
                                geom.neighbor_iou)._replace(flags=geom.flags)
    return geom


def pair_counts(geom) -> tuple[int, int]:
    """(neighbour pairs, IoU tests) of one pair stage on this run's data:
    the valid pairs with IoU >= the threshold, and the valid pairs of the
    active tiles. ``geom`` is K1's geometry or K5's columns."""
    geom = k1_geometry(geom)
    rv, cv = geom.row[:, 7] > 0, geom.col[:, 7] > 0
    pair_valid = rv[:, :, None] & cv[:, None, :]
    nb = neighbour_mask(geom).sum().item()
    nr, nc = geom.row.shape[2], geom.col.shape[2]
    active = geom.flags.repeat_interleave(k1.TILE_I, 1)[:, :nr] \
        .repeat_interleave(k1.TILE_J, 2)[:, :, :nc] > 0
    return nb, (active & pair_valid).sum().item()


def lane_use(geom) -> tuple[int, int]:
    """(neighbour pairs, warp steps) of a pair-kernel loop without the
    neighbour queue (K7's layout): a warp holds 32 consecutive rows and
    runs the products for a column when any of them has it as neighbour,
    so the share of lanes that do useful work there is pairs / (32 x
    steps). Counted from the masks, not timed; the yardstick of the group
    fill. ``geom`` as for :func:`pair_counts`."""
    nb = neighbour_mask(k1_geometry(geom))
    bsz, nr, nc = nb.shape
    pad = -nr % k1.TILE_I
    rows = torch.nn.functional.pad(nb, (0, 0, 0, pad))
    steps = rows.view(bsz, -1, k1.TILE_I, nc).any(dim=2).sum().item()
    return nb.sum().item(), steps


def log_lane_use(label: str, geom) -> None:
    pairs, steps = lane_use(geom)
    log(f"  lane use of the pair products, {label}: {pairs} neighbour pairs "
        f"in {steps} warp steps of 32 rows = "
        f"{pairs / max(32 * steps, 1):.4f} of the lanes (counted from the "
        f"masks)")


def neighbour_mask(geom):
    """[B, NR, NC] bool: the pairs K1's geometry makes neighbours."""
    rv, cv = geom.row[:, 7] > 0, geom.col[:, 7] > 0
    iou = k1.fields_iou(geom.row[..., None], geom.col[:, :, None, :])
    return (iou >= torch.tensor(geom.neighbor_iou, device=iou.device)) \
        & rv[:, :, None] & cv[:, None, :]


def group_fill(geom, group: int, side: str = "rows", splits: int = 1):
    """(neighbour pairs, group slots) of stage B of K1 and K2 (or K5 and
    K6: ``geom`` as for :func:`pair_counts`) on this run's data, counted
    from the masks as the kernels queue them: a block owns 32 rows
    (``side="rows"``; the backward's column pass owns 32 columns), warp
    w of its four takes 16 of each 64 detections of the other side in steps
    of two, the ``splits`` blocks that share the own detections take the
    steps round robin, and a warp pops groups of ``group`` pairs; only its
    last group can be short.
    pairs / slots is the share of stage B's lanes on a real pair."""
    nb = neighbour_mask(k1_geometry(geom))
    if side == "cols":
        nb = nb.transpose(1, 2)
    bsz, nown, noth = nb.shape
    per_tile = torch.nn.functional.pad(nb, (0, 0, 0, -nown % k1.TILE_I)) \
        .view(bsz, -1, k1.TILE_I, noth).sum(dim=2)           # [B, NT, NOTH]
    j = torch.arange(noth, device=nb.device)
    item = j // k1.TILE_J * 8 + j % 16 // 2    # a step of two tests
    key = item % splits * 4 + j % k1.TILE_J // 16
    counts = torch.zeros(bsz, per_tile.shape[1], splits * 4,
                         dtype=per_tile.dtype, device=nb.device)
    counts.index_add_(2, key, per_tile)
    slots = ((counts + group - 1) // group).sum().item() * group
    return int(nb.sum().item()), int(slots)


def log_queues(label, args, m, dtype, kern=k1) -> None:
    """The fill of stage B's groups (bf16: groups of 16, f32: 32) with the
    kernels' splits, in the forward or the backward's row pass and in its
    column pass, and unsplit; and the length of the backward's winner
    queue. ``args``: the launch arguments, ``m`` the forward's output."""
    from gossipnet_tpu_torch.ops.cuda.launch import col_splits

    geom = args[0]
    fwd, bwd = LABELS[kern]
    splits = col_splits(
        geom.flags.shape[0] * geom.flags.shape[1], geom.flags.shape[2],
        torch.cuda.get_device_properties(0).multi_processor_count)
    for dt, group in (("bfloat16", 16), ("float32", 32)):
        fills = [group_fill(geom, group, "rows", splits),
                 group_fill(geom, group, "cols", splits),
                 group_fill(geom, group, "rows")]
        log(f"  group fill of stage B, {label}, {dt} (groups of {group}): "
            f"{fills[0][0]} neighbour pairs; with {splits} splits, {fwd} and "
            f"{bwd}'s row pass {fills[0][0] / max(fills[0][1], 1):.4f}, "
            f"{bwd}'s column pass {fills[1][0] / max(fills[1][1], 1):.4f} of "
            f"the group slots; unsplit {fills[2][0] / max(fills[2][1], 1):.4f}"
            f" (counted from the masks)")
    wp, wq = winner_pairs(args, dtype, kern)
    log(f"  {bwd} winner queue, {label}, {dtype}: {wp} pairs win {wq} "
        f"(pair, q) for {int((m > 0).sum().item())} (row, q) maxima > 0, of "
        f"{fills[0][0]} neighbour pairs (plain version), per pass")


def winner_pairs(args, dtype, kern=k1) -> tuple[int, int]:
    """(pairs that win at least one q, winning (pair, q)) of one pair
    stage, counted with the plain version on its own m: the length of K2's
    (K6's) winner queue over the whole launch, per pass."""
    m = kern._reference_core(*args, dtype)
    pairs = wins = 0
    for rows, nb, _, _, pre2 in kern._pair_chunks(*args, dtype):
        win = nb[..., None] & (pre2 == m[:, rows, None, :]) \
            & (m[:, rows, None, :] > 0)
        pairs += win.any(dim=-1).sum().item()
        wins += win.sum().item()
    return int(pairs), int(wins)


def k2_bound(args, m, dm, dtype, kern=k1) -> tuple[float, str, str]:
    """The least time for K2's (or K6's) work on these inputs: the
    recompute of every neighbour pair (the forward's count), the per-pair
    backward (dpre1 mask, d_a, d_b, dWg) and, per winning (pair, q), a
    column of W2 dpre2, of dW2 and db2; the IoU tests of the active tiles
    (and K6's per-pair features); each input read and each output written
    once: d_b' counts as its [B, NC, P] floats, which is what K2's column
    pass writes (K6 still sums a per-row-tile partial on top)."""
    geom, a2, b2, wg_k, w2, b2bias = args
    p, k = a2.shape[-1], wg_k.shape[0]
    nb, tested = pair_counts(geom)
    winners = kern.launch_backward_kernel(*args, m, torch.ones_like(dm),
                                          dtype)[4].sum().item()
    fc1 = (k + 6) * p if kern is k1 else 2 * k * p + 4 * p
    mlp = (nb * (2 * p * p + fc1 + 3 * p + 2 * k * p)
           + winners * (4 * p + 1))
    features = nb * FEATURE_OPS if kern is k5 else 0
    ops_s = mlp / (PEAK_BF16 if dtype == "bfloat16" else PEAK_F32) \
        + (tested * IOU_OPS + features) / PEAK_F32
    nbytes = sum(t.numel() * t.element_size() for t in
                 (geom.row, geom.col, a2, b2, wg_k, w2, b2bias, geom.flags,
                  m, dm)) + 4 * (a2.numel() + b2.numel() + wg_k.numel()
                                 + w2.numel() + b2bias.numel())
    bytes_s = nbytes / PEAK_BYTES
    how = (f"{nb} neighbour pairs, {int(winners)} winning (pair, q), "
           f"{tested} IoU tests, {nbytes / 1e6:.2f} MB")
    return max(ops_s, bytes_s) * 1e3, \
        "operations" if ops_s >= bytes_s else "bytes", how


def scan_bound(iou, t) -> tuple[float, str]:
    """The [B, N, G] IoU read once and the outputs written once, against
    two comparisons per (b, t, n, g). The chain is not in it: see
    scan_chain."""
    b, n, g = iou.shape
    bytes_s = (iou.numel() * 4 + t * 4 + b * n * t * 5) / PEAK_BYTES
    ops_s = 2 * b * t * n * g / PEAK_F32
    return max(bytes_s, ops_s) * 1e3, \
        "operations" if ops_s >= bytes_s else "bytes"


def scan_stats(iou, thresholds, best) -> list[tuple[int, int, int]]:
    """Per image, at the lowest threshold, from the scan's input and its
    result ``best`` [B, N, T]: (rows with a candidate, list entries walked
    until the first untaken GT, rows in the largest connected component of
    the det-GT candidate graph). Rows of different components never wait
    on each other, so the largest one is the chain no design can shorten."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    thr = np.asarray(thresholds, np.float32)
    x = iou.cpu().numpy()
    bst = best[..., int(thr.argmin())].cpu().numpy()
    _, n, g = x.shape
    gidx = np.arange(g)
    out = []
    for b in range(x.shape[0]):
        cand = x[b] >= thr.min()                      # [N, G]
        count = cand.sum(axis=1)
        v = x[b, np.arange(n), np.maximum(bst[b], 0)][:, None]
        ahead = (cand & ((x[b] > v) | ((x[b] == v)
                                       & (gidx < bst[b][:, None])))).sum(1)
        walked = int(np.where(bst[b] >= 0, ahead + 1, count).sum())
        r, c = np.nonzero(cand)
        graph = coo_matrix((np.ones(len(r)), (r, n + c)), shape=(n + g,) * 2)
        _, labels = connected_components(graph, directed=False)
        rows = labels[:n][count > 0]
        largest = int(np.bincount(rows).max()) if len(rows) else 0
        out.append((int((count > 0).sum()), walked, largest))
    return out


CHAIN_CYCLES = 32   # one dependent shared-memory round trip (load latency)


def sm_clock_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0])


def scan_chain(stats) -> tuple[float, str]:
    """The chain figure: the largest component's rows (images run side by
    side) x one dependent shared-memory round trip at the SM's top clock."""
    rows = max(s[2] for s in stats)
    mhz = sm_clock_mhz()
    ms = rows * CHAIN_CYCLES / (mhz * 1e3)
    return ms, (f"{rows} rows in the largest component x {CHAIN_CYCLES} "
                f"cycles at {mhz:.0f} MHz")


def log_scan_stats(label, iou, thresholds, best) -> float:
    """Logs the scan's input statistics and both figures; returns the
    chain figure in ms."""
    stats = scan_stats(iou, thresholds, best)
    n = iou.shape[1]
    bound_ms, by = scan_bound(iou, len(thresholds))
    chain_ms, how = scan_chain(stats)
    log(f"  {label}: per image, rows with a candidate "
        f"{'/'.join(str(s[0]) for s in stats)} of {n}; list entries walked "
        f"{'/'.join(str(s[1]) for s in stats)} ("
        f"{sum(s[1] for s in stats) / max(1, sum(s[0] for s in stats)):.2f} "
        f"a row); largest component {'/'.join(str(s[2]) for s in stats)} "
        f"rows")
    log(f"  {label}: bound {bound_ms:.6f} ms ({by}); chain figure "
        f"{chain_ms:.6f} ms ({how})")
    return chain_ms


def phase_train_times(state, tmp: Path) -> dict:
    """Times at the training shape B=8 N=1024 G=112 with CUDA events."""
    cfg = train_config(tmp, "times")
    dtype = cfg.model.pair_matmul_dtype
    log(f"phase 9: times of the training path at B=8 N=1024 G=112 (config 2,"
        f" pair products in {dtype})")
    dev = torch.device(DEV)
    it = BatchIterator(synthetic_roidb(**TRAIN_DATA), 8,
                       cfg.data.bucket_sizes)
    hosts = [training.host_arrays(next(it)) for _ in range(4)]
    batches = [dict(zip(h, device_arrays(h.values()))) for h in hosts]
    k2_args = capture(k1, "launch_backward_kernel",
                      lambda: training.train_step(state, batches[0], cfg))
    scan_args = capture(k3, "greedy_scan_batched",
                        lambda: training.train_step(state, batches[1], cfg))
    args, m, dm = k2_args[:6], k2_args[6], k2_args[7]
    k2_ms = cuda_time(lambda: k1.launch_backward_kernel(*k2_args), iters=20)
    m_plain = k1._reference_core(*args, dtype)
    k2_plain_ms = cuda_time(lambda: k1.pair_pool_backward_reference(
        *args, m_plain, dm, dtype), iters=2, warmup=1)
    k2_bound_ms, k2_by, k2_how = k2_bound(args, m, dm, dtype)

    iou, thr = scan_args
    one = iou[:1].contiguous()
    k3_ms = cuda_time(lambda: k3.launch_kernel(iou, thr), iters=50)
    k3_plain_ms = cuda_time(lambda: k3.greedy_scan_reference(iou, thr),
                            iters=2, warmup=1)
    k4_ms = cuda_time(lambda: k3.launch_kernel(one, thr), iters=50)
    k4_plain_ms = cuda_time(lambda: k3.greedy_scan_reference(one, thr),
                            iters=2, warmup=1)
    k3_bound_ms, k3_by = scan_bound(iou, len(thr))
    k4_bound_ms, k4_by = scan_bound(one, len(thr))

    # the step as train() runs it: a replay of phase 6's captured graphs
    def steps(n):
        for i in range(n):
            state.graphs(hosts[i % 4])

    steps(4)
    # in turns (events, host, host, events): the host clock spreads
    runs = [cuda_time(lambda: steps(1), iters=10, warmup=1),
            host_ms(lambda: steps(1), 10), host_ms(lambda: steps(1), 10),
            cuda_time(lambda: steps(1), iters=10, warmup=1)]
    step_ms = float(np.median(runs[0::3]))
    host_med = float(np.median(runs[1:3]))
    busy_ms, by_name = profile_kernels(lambda: steps(1), reps=3)

    def share(part):
        return sum(v for key, v in by_name.items() if part in key)

    log(f"  training step, captured, ms (events, host, host, events): "
        f"{', '.join(f'{x:.3f}' for x in runs)}; CUDA events {step_ms:.3f} "
        f"ms = {8 * 1024 / step_ms * 1e3:.0f} dets/s, host to host "
        f"{host_med:.3f} ms")
    if busy_ms:
        log(f"  device busy {busy_ms:.3f} ms per step = {busy_ms / step_ms:.3f}"
            f" of the step; kernel time shares: K1 "
            f"{share('pair_pool2_fwd') / busy_ms:.3f}, K2 "
            f"{share('pair_pool2_bwd') / busy_ms:.3f}, K3 "
            f"{share('greedy_scan') / busy_ms:.3f}")
    log_kernels(by_name, busy_ms, "step")
    log(f"  K2 {dtype}: {k2_ms:.4f} ms/launch; plain {k2_plain_ms:.3f} ms; "
        f"bound {k2_bound_ms:.5f} ms ({k2_by}: {k2_how})")
    _, best = k3.launch_kernel(iou, thr)
    log_scan_stats(f"K3's input T={len(thr)}", iou, thr.tolist(), best)
    log(f"  K3 T={len(thr)}: {k3_ms:.4f} ms/launch; plain {k3_plain_ms:.3f} "
        f"ms; bound {k3_bound_ms:.6f} ms ({k3_by}, {iou.numel() * 4 / 1e6:.2f}"
        f" MB of IoU)")
    log(f"  K4 (one image): {k4_ms:.4f} ms/launch; plain {k4_plain_ms:.3f} ms;"
        f" bound {k4_bound_ms:.6f} ms ({k4_by})")
    return {
        "pair_pool2_bwd": dict(ms=k2_ms, plain_ms=k2_plain_ms,
                               bound_ms=k2_bound_ms, bound_by=k2_by),
        "greedy_scan_batched": dict(ms=k3_ms, plain_ms=k3_plain_ms,
                                    bound_ms=k3_bound_ms, bound_by=k3_by),
        "greedy_scan": dict(ms=k4_ms, plain_ms=k4_plain_ms,
                            bound_ms=k4_bound_ms, bound_by=k4_by),
    }


# ---------------------------------------------------------------------------
# K5 / K6: the unfolded pair kernel (pair_kernel: 1) and its backward
# ---------------------------------------------------------------------------


def phase_k5_cases() -> float:
    log("phase 3d: K5 (the unfolded pair kernel, pair_kernel: 1) against "
        "its plain version on the card")
    cols_1024, cols_pad, cols_mc, cls = pair_case_inputs()
    cols_4096 = pf.stack_columns(pf.det_columns(*sorted_bench_batch(1, 4096)))
    small = cols_1024[:2, :, :512].contiguous()
    n = cols_1024.shape[2]
    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        worst = max(worst,
                    compare("clustered_b8_n1024", dtype, cols_1024, kern=k5),
                    compare("rect_odd", dtype, cols_1024[:2, :, :n - 23],
                            rows=slice(n // 9, n * 7 // 8 - 5), kern=k5),
                    compare("rect_multiclass", dtype,
                            cols_mc[:, :, :500].contiguous(),
                            rows=slice(37, 301),
                            classes=cls[:, :500].contiguous(), kern=k5),
                    compare("block_sparse_off", dtype, cols_1024[:2],
                            block_sparse=False, kern=k5),
                    compare("multiclass", dtype, cols_mc, classes=cls,
                            kern=k5),
                    compare("padded_all_padding", dtype, cols_pad, kern=k5),
                    compare("p16", dtype, small, p=16, kern=k5),
                    compare("p64_multiclass", dtype, cols_mc, classes=cls,
                            p=64, kern=k5))
    worst = max(worst, compare("clustered_b1_n4096", "float32", cols_4096,
                               kern=k5))
    compare("mask_probe_b8_n1024", "float32", cols_1024, probe=True, kern=k5)
    compare("mask_probe_b1_n4096", "float32", cols_4096, probe=True, kern=k5)
    compare("mask_probe_multiclass", "float32", cols_mc, classes=cls,
            probe=True, kern=k5)
    return worst


def phase_k6_cases() -> float:
    log("phase 3e: K6 (the unfolded pair-pool backward) against its plain "
        "version")
    cols_1024, cols_pad, cols_mc, cls = pair_case_inputs()
    small = cols_1024[:2, :, :512].contiguous()
    n = cols_1024.shape[2]
    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        worst = max(worst,
                    compare_k2("clustered_b8_n1024", dtype, cols_1024,
                               kern=k5),
                    compare_k2("rect_odd", dtype, cols_1024[:2, :, :n - 23],
                               rows=slice(n // 9, n * 7 // 8 - 5), kern=k5),
                    compare_k2("block_sparse_off", dtype, cols_1024[:2],
                               block_sparse=False, kern=k5),
                    compare_k2("multiclass", dtype, cols_mc, classes=cls,
                               kern=k5),
                    compare_k2("padded_all_padding", dtype, cols_pad,
                               kern=k5),
                    compare_k2("p16", dtype, small, p=16, kern=k5),
                    compare_k2("p64_multiclass", dtype, cols_mc, classes=cls,
                               p=64, kern=k5),
                    k2_tie_probe(small, dtype, kern=k5),
                    k2_tie_probe(cols_mc, dtype, kern=k5, classes=cls),
                    permutation_probe(cols_1024[:2].contiguous(), dtype,
                                      kern=k5))
        k2_winners(cols_1024, dtype, kern=k5)
    args, dm = pair_args(cols_1024, kern=k5)
    for dtype in ("float32", "bfloat16"):
        m = k5.launch_kernel(*args, dtype)
        one = k5.launch_backward_kernel(*args, m, dm, dtype)
        two = k5.launch_backward_kernel(*args, m, dm, dtype)
        same = all(torch.equal(x, y) for x, y in zip(one, two))
        log(f"  K6 determinism {dtype}: two launches bit-identical: {same}")
        if not same:
            raise AssertionError(f"K6 is not deterministic in {dtype}")
    return worst

# ---------------------------------------------------------------------------
# K7: the per-tile ablation of the pair tile
# ---------------------------------------------------------------------------

K7_ARGS = ("cols", "a", "b", "wg", "w2", "b2")
BF16_STEP = 2.0 ** -7    # one bf16 step, relative


def k7_inputs(small: bool) -> dict:
    """The probe's own inputs (B=8, N=1024, 600-pixel canvas, all valid),
    or a small ragged case: B=2, N=200 (no multiple of any tile) in a
    200-pixel canvas with 20 invalid detections, so that neighbours,
    non-neighbours and rows without a neighbour mix."""
    if not small:
        return kernel_ablate.probe_inputs(device=DEV)
    inputs = kernel_ablate.probe_inputs(2, 200, canvas=200.0, seed=1,
                                        device=DEV)
    inputs["cols"][:, pf.DetColumns._fields.index("valid"), 150:170] = 0.0
    return inputs


def permuted_w2(inputs: dict, seed: int = 3) -> dict:
    """The inputs with W2 a permutation matrix and b2 = 0: each pre2[q] is
    then one exact product h1[p] * 1, whatever order FC2 sums in, so the
    kernel must equal the plain version bit for bit unless a fragment puts
    a (slot, p, q) in the wrong place."""
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(k7.P))
    w2 = torch.zeros_like(inputs["w2"])
    w2[torch.arange(k7.P), perm.to(w2.device)] = 1.0
    return {**inputs, "w2": w2, "b2": torch.zeros_like(inputs["b2"])}


def k7_check(label, inputs, mode, tile_j, want, exact=False) -> float:
    """One K7 case against ``want``, the plain version's output: the five
    f32 modes at rtol = atol = 1e-5, bf3d within one bf16 step and
    bit-equal on 99%, ``exact``: bit-equal everywhere; rows without a
    neighbour (-1e30) at the same places, two launches bit-identical."""
    args = [inputs[k] for k in K7_ARGS]
    empty = want < -1e29                 # the mask value, f32 or bf16
    got = k7.pair_ablate(*args, mode, tile_j)
    again = k7.pair_ablate(*args, mode, tile_j)
    torch.cuda.synchronize()
    same_rows = torch.equal(got < -1e29, empty)
    err = ((got - want).abs()[~empty].max().item()
           if (~empty).any() else 0.0)
    equal = (got == want).float().mean().item()
    if exact:
        ok, tol = torch.equal(got, want), "bit-equal"
    elif mode == "bf3d":
        ok = (torch.allclose(got, want, rtol=BF16_STEP, atol=0.0)
              and equal >= 0.99)
        tol = "one bf16 step, 99% bit-equal"
    else:
        ok, tol = torch.allclose(got, want, **F32_TOL), TOL_TEXT["float32"]
    ok = ok and same_rows and torch.equal(got, again)
    log(f"  K7 {label:<22} {mode:<7} TJ={tile_j:<4} max_abs_err="
        f"{err:.3e} bit-equal {equal:.4f} rows at -1e30 "
        f"{int(empty.all(-1).sum())} (same places: {same_rows}) "
        f"tol {tol}; two launches bit-identical -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(
            f"K7 disagrees with its plain version: {label} {mode} "
            f"TILE_J={tile_j} max_abs_err={err}")
    return err


def phase_k7_cases() -> float:
    log("phase 3f: K7 (the per-tile ablation of the pair tile) against its "
        "plain version: six modes x TILE_J 32, 64, 128; nofc2 (h1 as it is) "
        "bit-equal; W2 a permutation and b2 = 0 (full, bf3d) bit-equal")
    k7_sass_check()
    worst = 0.0
    for label, small in (("small_b2_n200_ragged", True),
                         ("probe_b8_n1024", False)):
        inputs = k7_inputs(small)
        args = [inputs[k] for k in K7_ARGS]
        for mode in k7.MODES:
            want = k7.pair_ablate_reference(*args, mode)
            for tile_j in k7.TILE_JS:
                worst = max(worst, k7_check(label, inputs, mode, tile_j, want,
                                            exact=mode == "nofc2"))
        perm = permuted_w2(inputs)
        for mode in ("full", "bf3d"):
            want = k7.pair_ablate_reference(*[perm[k] for k in K7_ARGS],
                                            mode)
            for tile_j in k7.TILE_JS:
                k7_check(f"{label}_permW2", perm, mode, tile_j, want,
                         exact=True)
    return worst


def k7_sass_check() -> None:
    """ptxas and cuobjdump on the built pair_ablate library: no spill in
    any of the 18 instantiations, HMMA (the tensor cores' mma.sync) in
    every mode that keeps FC2 and none in nofc2."""
    import re

    spills = [line.strip() for line in
              build.build_logs.get("pair_ablate", "").splitlines()
              if "spill" in line and not re.search(
                  r"0 bytes spill stores, 0 bytes spill loads", line)]
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(build.library_path("pair_ablate"))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    hmma, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*pair_ablate_kernelILi(\d+)ELi(\d+)E",
                      line)
        if m:
            name = (k7.MODES[int(m.group(1))], int(m.group(2)))
            hmma[name] = 0
        elif name and "HMMA" in line:
            hmma[name] += 1
    log("  K7 SASS (cuobjdump -sass): HMMA per instantiation "
        + ", ".join(f"{mode}/{tj} {n}" for (mode, tj), n in sorted(
            hmma.items(), key=lambda x: (k7.MODES.index(x[0][0]), x[0][1]))))
    want = {(mode, tj) for mode in k7.MODES for tj in k7.TILE_JS}
    wrong = [k for k, n in hmma.items() if (n == 0) != (k[0] == "nofc2")]
    if set(hmma) != want or wrong or spills:
        raise AssertionError(f"K7 build: instantiations {sorted(hmma)}, "
                             f"HMMA where not expected or missing {wrong}, "
                             f"spills {spills}")


def k7_bound(inputs: dict, mode: str) -> tuple[float, str, str, float]:
    """The least time for K7's work in ``mode`` on these inputs. K7 is
    dense, so nothing depends on the data: every pair goes through the IoU
    test (two operations for the stand-in), the features (not ``nofeat``;
    dead code in ``nogw``), the Wg product (not ``nogw``), the adds, FC2
    (not ``nofc2``) and the mask; each input is read and the output
    written once. Also the CUDA-core figure of this design, which runs
    FC2 alone on the tensor cores: the same work without FC2, all of it
    at the f32 rate (read the time against it, as K3's against its chain
    figure)."""
    cols, a = inputs["cols"], inputs["a"]
    bsz, _, n = cols.shape
    p, g = k7.P, k7.G
    pairs = bsz * n * n
    fc1 = 0 if mode == "nogw" else 2 * g * p
    per_pair = 4 * p + fc1 + (0 if mode == "nofc2" else 2 * p * p)
    feature_ops = 0 if mode in ("nofeat", "nogw") else FEATURE_OPS
    test_ops = (2 if mode == "nofeat" else IOU_OPS) + feature_ops
    ops_s = pairs * per_pair / PEAK_BF16 + pairs * test_ops / PEAK_F32
    nbytes = sum(inputs[k].numel() * 4 for k in K7_ARGS) + a.numel() * 4
    bytes_s = nbytes / PEAK_BYTES
    core_ms = pairs * (fc1 + 4 * p + test_ops) / PEAK_F32 * 1e3
    how = (f"{pairs} pairs x {per_pair} product and {test_ops} f32 ops, "
           f"{nbytes / 1e6:.2f} MB")
    return max(ops_s, bytes_s) * 1e3, \
        "operations" if ops_s >= bytes_s else "bytes", how, core_ms


def phase_ablate() -> tuple[dict, int]:
    """The ablation tool on the card, as a user runs it: ``all`` at TILE_J
    64, then ``full`` at 32 and 128 -> (K7's times in mode ``full`` at
    TILE_J 64, the launches of the ``all`` run)."""
    log("phase 12: the ablation tool (python -m gossipnet_tpu_torch.tools."
        "kernel_ablate all): 40 chained K7 launches per mode at B=8 N=1024 "
        "P=32 G=8")
    reset_counts()
    results = kernel_ablate.main(["all"])
    launches = counts()
    per_mode = kernel_ablate.CALLS + 1       # the chain and its warm-up
    want = want_counts(pair_ablate=per_mode * len(k7.MODES))
    chained = [r["launches"] for r in results]
    log(f"  launches {launches['pair_ablate']} = {len(k7.MODES)} modes x "
        f"({kernel_ablate.CALLS} chained + 1 warm-up); in the timed chains "
        f"{chained}")
    if launches != want or chained != [kernel_ablate.CALLS] * len(k7.MODES):
        raise AssertionError(f"ablation launches {launches} != {want}, or "
                             f"a chain did not launch {kernel_ablate.CALLS}")
    for tile_j in ("32", "128"):
        kernel_ablate.main(["full", tile_j])
    inputs = k7_inputs(small=False)
    args = [inputs[k] for k in K7_ARGS]
    log_lane_use("one row per lane without the queue, on the probe's "
                 "unsorted boxes (K7 itself runs every lane)",
                 k1.pair_geometry(inputs["cols"], inputs["cols"], 0.2))
    out = {}
    for r in results:
        mode = r["mode"]
        if not math.isfinite(r["sum"]):
            raise AssertionError(f"ablation chain of {mode} is not finite")
        plain_ms, _ = cuda_once(
            lambda: k7.pair_ablate_reference(*args, mode))
        bound_ms, by, how, core_ms = k7_bound(inputs, mode)
        out[mode] = dict(ms=r["ms"], plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=by)
        log(f"  K7 {mode:<7} TJ=64: {r['ms']:.4f} ms/call, "
            f"{r['us_per_tile']:.4f} us/tile; full - mode "
            f"{r.get('full_minus_ms', 0.0):+.4f} ms; plain {plain_ms:.3f} "
            f"ms; bound {bound_ms:.5f} ms ({by}: {how}), "
            f"{bound_ms / r['ms']:.4f} of it; CUDA-core figure "
            f"{core_ms:.5f} ms (FC1, elementwise, IoU and features at 67 "
            f"TFLOP/s: read the time against this), {core_ms / r['ms']:.4f} "
            f"of it")
    return out["full"], launches["pair_ablate"]


# ---------------------------------------------------------------------------
# the evaluation path
# ---------------------------------------------------------------------------

EVAL_IMAGES = 64          # evaluate.load_roidb's synthetic set (seed 123)
EVAL_TRAIN_STEPS = 4
# the validation set of the short training run: the step probe's layout,
# so the periodic evaluation runs at N=1024
VAL_DATA = dict(TRAIN_DATA, num_images=8, seed=1)


def write_eval_yaml(tmp: Path, ckpt: Path) -> Path:
    """Config 2 with ``data.dataset: synthetic``, as a file the CLI reads."""
    import yaml

    with open(experiment_path("coco_persons_full")) as f:
        raw = yaml.safe_load(f)
    raw["data"]["dataset"] = "synthetic"
    raw["train"]["checkpoint_dir"] = str(ckpt)
    path = tmp / "eval.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path


def phase_evaluate(tmp: Path) -> tuple[dict, float]:
    """This slice's main path: the evaluation CLI's ``main`` on the card at
    config 2's full width and depth, then a training run that evaluates as
    it goes and the CLI reading its best checkpoint -> the launches of the
    counted evaluation, K1's worst error on its launch arguments."""
    log(f"phase 13: main path - the evaluation of the 16-block config 2 "
        f"model on the card (evaluate.main, {EVAL_IMAGES} synthetic images)")
    ckpt = tmp / "eval_ckpt"
    path = write_eval_yaml(tmp, ckpt)
    cfg = load_config(str(path))
    blocks = cfg.model.num_blocks
    roidb = evaluate.load_roidb(cfg)
    batches = list(eval_batches(roidb, cfg.train.batch_size,
                                cfg.data.bucket_sizes))
    log(f"  data: {len(roidb)} images of "
        f"{sorted({r.num_dets for r in roidb})} detections -> "
        f"{len(batches)} batches of B, N = "
        f"{sorted({(b.batch_size, b.padded_n) for b in batches})}; COCO "
        f"matching route: {'native C++' if native.available() else 'numpy'}")

    reset_counts()
    t0 = time.perf_counter()
    out = evaluate.main(["-c", str(path), "--random-init", "--nms-sweep"])
    wall = time.perf_counter() - t0
    launches = counts()
    # every batch replays its shape's graph; each shape's capture followed
    # one eager forward
    shapes = len({(b.batch_size, b.padded_n) for b in batches})
    want = want_counts(pair_pool2_fwd=blocks * (len(batches) + shapes))
    log(f"  evaluate.main: {wall:.2f} s wall (model build and captures "
        f"included); launches {launches}: {blocks} K1 x ({len(batches)} "
        f"replayed batches + {shapes} eager forward before a capture)")
    if launches != want:
        raise AssertionError(f"evaluation launches {launches} != {want} "
                             f"({blocks} K1 per batch, nothing else)")
    for name in ("gossipnet", "raw_scores", "greedy_nms"):
        stats = out[name]        # printed above by evaluate.main itself
        if not all(math.isfinite(v) for v in stats.values()) \
                or not 0.0 <= stats["AP"] <= 1.0:
            raise AssertionError(f"bad stats for {name}: {stats}")
    if out["raw_scores"]["AP"] <= 0.0 or out["greedy_nms"]["AP"] <= 0.0 \
            or not 0.3 <= out["greedy_nms"]["iou_threshold"] <= 0.7:
        raise AssertionError(f"baselines: {out}")

    # the scores behind that AP, against the serving entry point (both go
    # through K1: this holds the two entry points together, not the kernel)
    params = init_params(cfg.model, seed=0)
    model = training.build_model(cfg, "kernel", DEV)
    model.load_state_dict(as_state_dict(params))
    rescored = evaluate.rescore_roidb(None, model, roidb,
                                      cfg.train.batch_size,
                                      cfg.data.bucket_sizes)
    served = Rescorer(cfg, params, device=DEV).rescore_batch(
        [(r.det_boxes, r.det_scores, None) for r in roidb],
        batch_size=cfg.train.batch_size)
    worst = max(float(np.abs(rescored[r.image_id] - s).max())
                for r, s in zip(roidb, served))
    again = evaluate._evaluator_for(roidb, scores_by_image=rescored) \
        .summarize()
    log(f"  rescore_roidb vs Rescorer.rescore_batch on the same "
        f"{len(roidb)} images: max |diff| {worst:.3e} (tol 1e-5); the AP of "
        f"those scores equals evaluate.main's: {again == out['gossipnet']}")
    if worst > 1e-5 or again != out["gossipnet"]:
        raise AssertionError("evaluation scores differ from the Rescorer's")

    # K1 against its plain version at the shape this path gives it: the
    # first block's launch arguments of every evaluation batch, in the
    # model's own dtype
    dtype = cfg.model.pair_matmul_dtype
    k1_err = 0.0
    for i, batch in enumerate(batches):
        arrays = [torch.from_numpy(np.ascontiguousarray(x)).to(DEV)
                  for x in (batch.boxes, batch.scores, batch.valid,
                            batch.classes)]
        with torch.inference_mode():
            args = capture(k1, "launch_kernel", lambda: model(*arrays))
        got = k1.launch_kernel(*args)
        want = k1._reference_core(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        k1_err = max(k1_err, err)
        if args[-1] != dtype or not within(got, want, dtype):
            raise AssertionError(
                f"K1 disagrees with its plain version on evaluation batch "
                f"{i} ({args[-1]}): max_abs_err={err}")
    log(f"  K1 on the launch arguments of the {len(batches)} evaluation "
        f"batches (B={batches[0].batch_size} NR=NC={batches[0].padded_n} "
        f"P={args[1].shape[-1]}, {int(batches[0].valid[0].sum())} valid "
        f"detections per image, first block, {dtype}) against its plain "
        f"version: max_abs_err={k1_err:.3e} tol {TOL_TEXT[dtype]} -> ok")

    # and the whole evaluation forward against the dense plain path, f32
    f32 = load_config(str(path), {"model": {"pair_matmul_dtype": "float32"}})
    both = {}
    for impl in ("kernel", "dense"):
        net = training.build_model(f32, impl, DEV)
        net.load_state_dict(as_state_dict(params))
        reset_counts()
        both[impl] = evaluate.rescore_roidb(None, net, roidb,
                                            f32.train.batch_size,
                                            f32.data.bucket_sizes)
        got_counts = counts()
        want_n = blocks * (len(batches) + shapes) if impl == "kernel" else 0
        if got_counts != want_counts(pair_pool2_fwd=want_n):
            raise AssertionError(f"f32 {impl} evaluation launched "
                                 f"{got_counts}")
    # logits agree at LOGIT_TOL; the sigmoid's slope is at most 1/4
    score_tol = LOGIT_TOL["atol"] / 4
    dense_err = max(float(np.abs(both["kernel"][r.image_id]
                                 - both["dense"][r.image_id]).max())
                    for r in roidb)
    aps = {impl: evaluate._evaluator_for(
        roidb, scores_by_image=both[impl]).summarize()["AP"]
        for impl in both}
    log(f"  f32 scores of rescore_roidb, K1 path ({want_n} "
        f"launches) vs dense plain path (0 launches) on the same "
        f"{len(roidb)} images: max |diff| {dense_err:.3e} (tol "
        f"{score_tol:.1e}: the logit tolerance through the sigmoid); AP "
        f"{aps['kernel']:.6f} vs {aps['dense']:.6f}")
    if not dense_err <= score_tol or abs(aps["kernel"] - aps["dense"]) > 1e-3:
        raise AssertionError("the evaluation's K1 path differs from the "
                             "dense plain path")

    # where the wall time goes, warm
    t0 = time.perf_counter()
    evaluate.rescore_roidb(None, model, roidb, cfg.train.batch_size,
                           cfg.data.bucket_sizes)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    evaluate._evaluator_for(roidb, scores_by_image=rescored).summarize()
    coco_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    evaluate.evaluate_greedy_nms_sweep(roidb, [0.5])
    nms_s = time.perf_counter() - t0
    log(f"  evaluation wall time per {len(roidb)} images, warm: "
        f"{(fwd_s + coco_s) * 1e3:.1f} ms = forward {fwd_s * 1e3:.1f} ms "
        f"({len(batches)} batches x {blocks} K1) + COCO matching and AP "
        f"{coco_s * 1e3:.1f} ms on the host; the GreedyNMS baseline at one "
        f"threshold {nms_s * 1e3:.1f} ms")

    # a training run that evaluates as it goes, and --best reads its best
    tcfg = train_config(tmp, "eval_ckpt", eval_every=2, snapshot_every=0)
    train_db = synthetic_roidb(**TRAIN_DATA)
    val_db = synthetic_roidb(**VAL_DATA)
    val_batches = len(list(eval_batches(val_db, tcfg.train.batch_size,
                                        tcfg.data.bucket_sizes)))
    metrics = tmp / "eval_metrics.jsonl"
    reset_counts()
    t0 = time.perf_counter()
    tstate = training.train(tcfg, train_db, val_roidb=val_db,
                            pool_impl="kernel", metrics_path=str(metrics),
                            max_steps=EVAL_TRAIN_STEPS, device=DEV)
    run_s = time.perf_counter() - t0
    got = counts()
    evals = EVAL_TRAIN_STEPS // 2
    runs = EVAL_TRAIN_STEPS + tstate.graphs.captures
    eval_shapes = len(forward_graphs(tstate.model).shapes())
    want = want_counts(
        pair_pool2_fwd=blocks * (runs + evals * val_batches + eval_shapes),
        pair_pool2_bwd=blocks * runs, greedy_scan_batched=runs)
    recs = [json.loads(x) for x in metrics.read_text().splitlines()]
    aps = {r["step"]: r["val_AP"] for r in recs if "val_AP" in r}
    log(f"  train() with a validation set of {len(val_db)} images at "
        f"N=1024 and eval_every=2: {EVAL_TRAIN_STEPS} steps in {run_s:.1f} "
        f"s, val_AP by step {aps}; launches {got}")
    if got != want:
        raise AssertionError(f"launches {got} != {want}")
    if sorted(aps) != [2, 4] or not all(0.0 <= v <= 1.0
                                        for v in aps.values()):
        raise AssertionError(f"val_AP records: {aps}")
    best = json.loads((ckpt / "best.json").read_text())["metric"]
    if best != max(aps.values()) or not (ckpt / "best" / "state.pt").exists():
        raise AssertionError(f"best checkpoint {best} != max of {aps}")
    cli = subprocess.run(
        [sys.executable, "-m", "gossipnet_tpu_torch.evaluate", "-c",
         str(path), "--best"], capture_output=True, text=True, timeout=600,
        cwd=Path(__file__).resolve().parent)
    if cli.returncode != 0:
        raise AssertionError(f"eval CLI failed:\n{cli.stderr[-2000:]}")
    head = cli.stdout[:cli.stdout.index("{")].strip()
    stats = json.loads(cli.stdout[cli.stdout.index("{"):])
    log(f"  eval CLI --best: {head}; gossipnet AP "
        f"{stats['gossipnet']['AP']:.4f}, raw_scores AP "
        f"{stats['raw_scores']['AP']:.4f}, greedy_nms AP "
        f"{stats['greedy_nms']['AP']:.4f}")
    if "restored best-AP checkpoint" not in head or \
            stats["raw_scores"] != out["raw_scores"]:
        raise AssertionError(f"eval CLI --best: {cli.stdout[:400]}")
    return launches, k1_err


def k5_bound(args, dtype) -> tuple[float, str, str]:
    """The least time for K5's work on these inputs: every neighbour pair
    through the features and the MLP (FC1 over G features, FC2), the IoU
    tests of the active tiles, each input read and the output written
    once."""
    cols, a, b, wg, w2, b2bias = args
    p, g = a.shape[-1], wg.shape[0]
    nb, tested = pair_counts(cols)
    mlp = nb * (2 * p * p + 2 * g * p + 4 * p)
    ops_s = mlp / (PEAK_BF16 if dtype == "bfloat16" else PEAK_F32) \
        + (tested * IOU_OPS + nb * FEATURE_OPS) / PEAK_F32
    nbytes = sum(t.numel() * t.element_size() for t in
                 (cols.row, cols.col, a, b, wg, w2, b2bias, cols.flags)) \
        + a.numel() * 4                                     # the output m
    bytes_s = nbytes / PEAK_BYTES
    how = (f"{nb} neighbour pairs x {2 * p * p + 2 * g * p + 4 * p} ops, "
           f"{tested} IoU tests, {nbytes / 1e6:.2f} MB")
    return max(ops_s, bytes_s) * 1e3, \
        "operations" if ops_s >= bytes_s else "bytes", how


def cuda_once(fn):
    """One call of ``fn`` between CUDA events -> (ms, its result)."""
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def check_forward(name, dtype, got, want) -> float:
    """A K5 output against the plain version's on the same launch
    arguments, at phase 3d's tolerance."""
    err = (got - want).abs().max().item()
    ok = within(got, want, dtype)
    log(f"  K5 {name:<36} {dtype:<8} B={got.shape[0]} NR={got.shape[1]} "
        f"P={got.shape[2]} bit-equal {torch.equal(got, want)}, max_abs_err="
        f"{err:.3e} tol {TOL_TEXT[dtype]} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K5 disagrees with its plain version: {name} "
                             f"{dtype} max_abs_err={err}")
    return err


def k5_k6_times(label, fwd_args, bwd_args) -> tuple[dict, dict]:
    """K5 and K6 ms/launch on launch arguments captured from the model,
    beside their plain versions and bounds; the same plain runs hold K5
    and K6 to them at this shape (phase 3d/3e tolerances), in the
    captured dtype and again in f32 -> (times, worst errors)."""
    dtype = fwd_args[-1]
    args, m, dm = bwd_args[:6], bwd_args[6], bwd_args[7]
    k5_ms = cuda_time(lambda: k5.launch_kernel(*fwd_args), iters=20)
    k6_ms = cuda_time(lambda: k5.launch_backward_kernel(*bwd_args), iters=10)
    k5_dev = device_ms(lambda: k5.launch_kernel(*fwd_args))
    k6_dev = device_ms(lambda: k5.launch_backward_kernel(*bwd_args))
    k5_plain, m_first = cuda_once(lambda: k5._reference_core(*fwd_args))
    m_plain = k5._reference_core(*args, dtype)
    k6_plain, want = cuda_once(lambda: k5.pair_pool_backward_reference(
        *args, m_plain, dm, dtype))
    fwd_err = max(
        check_forward(f"{label}, first block", dtype,
                      k5.launch_kernel(*fwd_args), m_first),
        check_forward(f"{label}, last block", dtype, m, m_plain))
    got = k5.launch_backward_kernel(*bwd_args)
    torch.cuda.synchronize()
    errs, ok = grad_errors(got, want, dtype)
    log(f"  K6 {label + ', last block':<36} {dtype:<8} "
        + " ".join(f"{n}={e:.2e}" for n, e in errs.items())
        + f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K6 disagrees with its plain version: {label} "
                             f"{dtype} {errs}")
    bwd_err = max(max(errs.values()),
                  check_backward(f"{label}, last block", "float32", args, dm,
                                 k5))
    log_queues(label, args, m, dtype, kern=k5)
    k5_b, k5_by, k5_how = k5_bound(fwd_args[:6], dtype)
    k6_b, k6_by, k6_how = k2_bound(args, m, dm, dtype, kern=k5)
    log(f"  {label}: K5 {dtype} {k5_ms:.4f} ms/launch (events), "
        f"{k5_dev:.4f} ms on the device (profiler; 0: not measured), plain "
        f"{k5_plain:.3f} ms, bound {k5_b:.5f} ms ({k5_by}: {k5_how})")
    log(f"  {label}: K6 {dtype} {k6_ms:.4f} ms/launch (events), "
        f"{k6_dev:.4f} ms on the device (profiler; 0: not measured), plain "
        f"{k6_plain:.3f} ms, bound {k6_b:.5f} ms ({k6_by}: {k6_how})")
    times = {"pair_pool_fwd": dict(ms=k5_ms, plain_ms=k5_plain,
                                   bound_ms=k5_b, bound_by=k5_by),
             "pair_pool_bwd": dict(ms=k6_ms, plain_ms=k6_plain,
                                   bound_ms=k6_b, bound_by=k6_by)}
    return times, {"pair_pool_fwd": fwd_err, "pair_pool_bwd": bwd_err}


def capture_pair(kern, model, boxes, scores, valid, classes=None):
    """The forward and backward kernel's launch arguments (K5/K6, or K1/K2
    with ``kern=k1``) of one forward and backward of ``model``: the first
    block's forward, the last block's backward."""
    with torch.inference_mode():
        fwd = capture(kern, "launch_kernel",
                      lambda: model(boxes, scores, valid, classes))
    cot = torch.randn(scores.shape, generator=torch.Generator(
        device=scores.device).manual_seed(0), device=scores.device)
    bwd = capture(kern, "launch_backward_kernel", lambda: (
        model(boxes, scores, valid, classes) * cot).sum().backward())
    model.zero_grad(set_to_none=True)
    return fwd, bwd


def bench_k5_k6_times() -> dict:
    """K5/K6 at the serving bench batch (B=8, N=1024, clustered) of the
    serving_bucketed model with pair_kernel 1, timed and held against
    their plain versions -> the worst errors."""
    cfg = load_config(experiment_path("serving_bucketed"),
                      {"model": {"pair_kernel": 1}})
    model = training.build_model(cfg, "kernel", DEV)
    model.load_state_dict(as_state_dict(init_params(cfg.model, seed=0)))
    fwd, bwd = capture_pair(k5, model, *sorted_bench_batch(8, 1024))
    return k5_k6_times("serving bench B=8 N=1024", fwd, bwd)[1]


# ---------------------------------------------------------------------------
# config 4 (N=4096) and config 3 (80 classes)
# ---------------------------------------------------------------------------


def crowd_config(tmp: Path | None = None, **model):
    """Config 4 (crowded_4096.yaml) at full width, pair_kernel 1 unless
    ``model`` says otherwise, checkpointing under ``tmp``."""
    train = {} if tmp is None else {
        "checkpoint_dir": str(tmp / "crowd"), "log_every": 1,
        "snapshot_every": 0, "eval_every": 0}
    return load_config(experiment_path("crowded_4096"), {
        "model": {"pair_kernel": 1, **model}, "train": train})


def crowd_batch(b: int):
    """The reference's N=4096 oracle batch: layout_batch("clustered", b,
    4096) with every detection from 3900 on padding."""
    batch = layout_batch("clustered", b, 4096, seed=0)
    valid = batch.valid.copy()
    valid[:, 3900:] = False
    return batch.boxes, batch.scores, valid


def model_logits(cfg, arrays, params=None):
    model = training.build_model(cfg, "kernel", DEV)
    model.load_state_dict(as_state_dict(params or init_params(cfg.model)))
    with torch.inference_mode():
        return model(*[torch.from_numpy(np.ascontiguousarray(x)).to(DEV)
                       for x in arrays])


def phase_crowd_serving():
    log("phase 10: main path of this slice -- config 4 (crowded_4096.yaml: "
        "16 blocks, 128/32/32, N=4096, batch 2) with pair_kernel 1 (K5/K6)")
    cfg = crowd_config()
    boxes, scores, valid = crowd_batch(2)
    images = [(boxes[b][valid[b]], scores[b][valid[b]], None)
              for b in range(2)]
    rescorer = Rescorer(cfg, init_params(cfg.model, seed=0), device=DEV)
    rescorer.warmup(batch_size=2)
    reset_counts()
    out = rescorer.rescore_batch(images)
    torch.cuda.synchronize()
    launches = counts()
    if launches != want_counts(pair_pool_fwd=cfg.model.num_blocks):
        raise AssertionError(f"config 4 serving launches {launches}")
    for im, sc in zip(images, out):
        if len(sc) != len(im[1]) or not np.isfinite(sc).all() \
                or sc.min() < 0 or sc.max() > 1:
            raise AssertionError("bad rescored output at N=4096")
    # padding inert: moving the padded detections changes no valid logit
    model = rescorer.model
    t = [torch.from_numpy(x).to(DEV) for x in (boxes, scores, valid)]
    moved = [x.clone() for x in t[:2]]
    pad = ~t[2]
    moved[0][pad] = torch.rand_like(moved[0][pad]) * 640.0
    moved[1][pad] = torch.rand_like(moved[1][pad])
    with torch.inference_mode():
        logits = model(*t)
        logits_moved = model(moved[0], moved[1], t[2])
    inert = (torch.equal(logits[t[2]], logits_moved[t[2]])
             and bool((logits[pad] == PAD_LOGIT).all()))
    log(f"  Rescorer.rescore_batch of 2 images x {len(images[0][1])} "
        f"detections (bucket 4096), a replay of the graph warmup captured: "
        f"launches {launches['pair_pool_fwd']} K5, "
        f"0 K1; scores finite in [0, 1]; padding inert (valid logits "
        f"bit-equal when the padded boxes move, PAD_LOGIT on padding): "
        f"{inert}")
    if not inert:
        raise AssertionError("padding is not inert at N=4096")
    return rescorer


def phase_crowd_oracle():
    """K5 against K1 on the same f32 parameters: the reference's oracle
    shape (tests/test_tpu_hw.py:366: 2 blocks, width 64/32/32, B=1
    N=4096) within 2e-4, and config 4's 16 blocks within LOGIT_TOL."""
    two = dict(num_blocks=2, feature_dim=64, reduced_dim=32, pairwise_dim=32,
               pair_matmul_dtype="float32")
    for label, b, model_kw, tol in (
            ("2 blocks, 64/32/32, B=1", 1, two, dict(rtol=2e-4, atol=2e-4)),
            ("16 blocks, 128/32/32, B=2", 2,
             dict(pair_matmul_dtype="float32"), LOGIT_TOL)):
        arrays = crowd_batch(b)
        cfgs = {pk: crowd_config(**model_kw, pair_kernel=pk) for pk in (1, 2)}
        reset_counts()
        out = {pk: model_logits(cfg, arrays) for pk, cfg in cfgs.items()}
        torch.cuda.synchronize()
        launches = counts()
        blocks = cfgs[1].model.num_blocks
        valid = torch.from_numpy(arrays[2]).to(DEV)
        err = (out[1] - out[2]).abs().max().item()
        ok = (torch.allclose(out[1], out[2], **tol)
              and bool(torch.isfinite(out[1][valid]).all())
              and launches == want_counts(pair_pool_fwd=blocks,
                                          pair_pool2_fwd=blocks))
        log(f"  K5 vs K1, f32 logits at N=4096, {label}: max |diff| "
            f"{err:.3e} (tol rtol=atol={tol['atol']}); {blocks} K5 + "
            f"{blocks} K1 launches -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K5 and K1 disagree at N=4096 ({label}): "
                                 f"{err}, launches {launches}")


def phase_crowd_training(tmp: Path):
    log(f"  training: config 4, {CROWD_STEPS} steps through K5/K6 on "
        f"synthetic_roidb({CROWD_DATA})")
    cfg = crowd_config(tmp)
    roidb = synthetic_roidb(**CROWD_DATA)
    first = next(BatchIterator(roidb, 2, cfg.data.bucket_sizes))
    log(f"  data: {int(first.valid.sum(1).min())}-"
        f"{int(first.valid.sum(1).max())} detections per image -> B, N, G "
        f"= {first.batch_size}, {first.padded_n}, {first.padded_g}")
    metrics_path = tmp / "crowd_metrics.jsonl"
    reset_counts()
    t0 = time.perf_counter()
    state = training.train(cfg, roidb, pool_impl="kernel",
                           metrics_path=str(metrics_path),
                           max_steps=CROWD_STEPS, device=DEV)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts()
    steps, blocks = state.step, cfg.model.num_blocks
    runs = steps + state.graphs.captures
    want = want_counts(pair_pool_fwd=blocks * runs,
                       pair_pool_bwd=blocks * runs,
                       greedy_scan_batched=runs)
    log(f"  {steps} steps in {run_s:.1f} s, replayed ({state.graphs.captures}"
        f" eager steps before captures); launches {launches}")
    if launches != want:
        raise AssertionError(f"launches {launches} != {want} (16 K5 + 16 K6 "
                             f"+ 1 K3 per step)")
    losses = [json.loads(x)["loss"] for x in
              metrics_path.read_text().splitlines()]
    log(f"  = {blocks} K5 + {blocks} K6 + 1 K3 per step; loss per step: "
        f"{' '.join(f'{x:.4f}' for x in losses)}")
    if len(losses) != steps or not np.isfinite(losses).all() \
            or losses[-1] >= losses[0]:
        raise AssertionError(f"loss not finite and falling: {losses}")
    return state, launches, cfg, first


def phase_crowd_gradients(batch):
    """f32 gradients of config 4's 16 blocks at N=4096: the K5/K6 path
    against the K1/K2 path on the same parameters and batch."""
    arrays = training.batch_to_device(batch, torch.device(DEV))
    grads = {}
    for pk in (1, 2):
        cfg = crowd_config(pair_kernel=pk, pair_matmul_dtype="float32")
        model = training.build_model(cfg, "kernel", DEV)
        model.load_state_dict(as_state_dict(init_params(cfg.model)))
        loss, _ = training.loss_and_metrics(model, arrays, cfg)
        loss.backward()
        grads[pk] = {k: p.grad for k, p in model.named_parameters()}
    compare_grads("K5/K6 path vs K1/K2 path at B=2 N=4096", grads[1],
                  grads[2])


def phase_crowd_times(state, cfg, batch) -> tuple[dict, dict]:
    log("  times at config 4 (B=2, N=4096), pair products in "
        f"{cfg.model.pair_matmul_dtype}")
    dev = torch.device(DEV)
    arrays = training.batch_to_device(batch, dev)
    model = state.model
    det = (arrays["boxes"], arrays["scores"], arrays["valid"])
    fwd, bwd = capture_pair(k5, model, *det)
    times, worst = k5_k6_times("config 4 B=2 N=4096", fwd, bwd)
    # K1/K2 on the same batch and weights, to say where each pair kernel
    # is faster (pair_kernel 1 is the reference's default)
    other = training.build_model(
        crowd_config(pair_kernel=2), "kernel", DEV)
    other.load_state_dict(model.state_dict())
    fwd2, bwd2 = capture_pair(k1, other, *det)
    k1_ms = cuda_time(lambda: k1.launch_kernel(*fwd2), iters=20)
    k2_ms = cuda_time(lambda: k1.launch_backward_kernel(*bwd2), iters=10)
    log(f"  config 4 B=2 N=4096, same batch and weights: K1 {fwd2[-1]} "
        f"{k1_ms:.4f} ms/launch, K2 {k2_ms:.4f} ms/launch (K5 "
        f"{times['pair_pool_fwd']['ms']:.4f}, K6 "
        f"{times['pair_pool_bwd']['ms']:.4f})")
    # K3 on the scan input of config 4's training step
    iou, thr = capture(k3, "greedy_scan_batched",
                       lambda: training.train_step(state, arrays, cfg))
    k3_ms = cuda_time(lambda: k3.launch_kernel(iou, thr), iters=50)
    k3_dev, _ = scan_device_ms(lambda: k3.launch_kernel(iou, thr))
    k3_plain_ms = cuda_time(lambda: k3.greedy_scan_reference(iou, thr),
                            iters=1, warmup=1)
    _, best = k3.launch_kernel(iou, thr)
    log_scan_stats(f"config 4 K3's input T={len(thr)}", iou, thr.tolist(),
                   best)
    log(f"  config 4 B=2 N=4096 G={iou.shape[2]}: K3 {k3_ms:.4f} ms/launch "
        f"by events, {k3_dev:.4f} on the device; plain {k3_plain_ms:.3f} ms")

    # the same model through the default pair_kernel 2, a state of its own
    cfg2 = crowd_config(pair_kernel=2)
    state2 = training.create_train_state(cfg2, other)
    dets = 2 * 4096
    for pk, net, st, c, names in (
            (1, model, state, cfg, ("pair_pool_fwd", "pair_pool_bwd")),
            (2, other, state2, cfg2, ("pair_pool2_fwd", "pair_pool2_bwd"))):
        graphs = forward_graphs(net)
        steps = st.graphs or StepGraphs(st, c, training.step_body)
        host = training.host_arrays(batch)
        packed = [host[k] for k in ("boxes", "scores", "valid", "classes")]

        def forward():
            graphs(*packed)

        def step():
            steps(host)

        for name, fn in (("forward", forward), ("training step", step)):
            fn()
            runs = [cuda_time(fn, iters=10, warmup=1), host_ms(fn, 10),
                    host_ms(fn, 10), cuda_time(fn, iters=10, warmup=1)]
            events = float(np.median(runs[0::3]))
            busy_ms, by_name = profile_kernels(fn, reps=2)
            share = sum(v for key, v in by_name.items()
                        if any(n in key for n in names))
            scan = sum(v for key, v in by_name.items()
                       if "greedy_scan" in key)
            busy = (f"device busy {busy_ms / events:.3f}, kernels "
                    f"{busy_ms:.3f} ms, the pair kernels "
                    f"{share / busy_ms:.3f} of kernel time, K3 "
                    f"{scan / busy_ms:.4f} ({scan:.4f} ms)" if busy_ms
                    else "profile: not measured")
            log(f"  config 4 {name}, pair_kernel {pk}, captured, ms "
                f"(events, host, "
                f"host, events): {', '.join(f'{x:.3f}' for x in runs)}; CUDA "
                f"events {events:.3f} ms = {dets / events * 1e3:.0f} dets/s, "
                f"host {float(np.median(runs[1:3])):.3f} ms; {busy}")
    return times, worst


def phase_multiclass(tmp: Path):
    log("phase 11: config 3 (coco_multiclass.yaml: 80 classes, class "
        "embedding 32, 16 blocks, batch 8, class-aware matching) on 80-class "
        "synthetic data, through K1/K2 and through K5/K6")
    roidb = synthetic_roidb(**{**TRAIN_DATA, "num_classes": 80})
    first = next(BatchIterator(roidb, 8, (256, 512, 1024)))
    log(f"  data: B, N, G = {first.batch_size}, {first.padded_n}, "
        f"{first.padded_g}; {len(np.unique(first.classes[first.valid]))} "
        f"classes in the first batch")

    def config(pk, **model):
        return load_config(experiment_path("coco_multiclass"), {
            "data": {"dataset": "synthetic"},
            "model": {"pair_kernel": pk, **model},
            "train": {"checkpoint_dir": str(tmp / f"mc{pk}"), "log_every": 1,
                      "snapshot_every": 0, "eval_every": 0}})

    steps = 5
    for pk, fwd, bwd in ((2, "pair_pool2_fwd", "pair_pool2_bwd"),
                         (1, "pair_pool_fwd", "pair_pool_bwd")):
        cfg = config(pk)
        metrics_path = tmp / f"mc{pk}.jsonl"
        reset_counts()
        state = training.train(cfg, roidb, pool_impl="kernel",
                               metrics_path=str(metrics_path),
                               max_steps=steps, device=DEV)
        torch.cuda.synchronize()
        launches = counts()
        blocks = cfg.model.num_blocks
        runs = steps + state.graphs.captures
        want = want_counts(**{fwd: blocks * runs, bwd: blocks * runs,
                              "greedy_scan_batched": runs})
        losses = [json.loads(x)["loss"] for x in
                  metrics_path.read_text().splitlines()]
        ok = launches == want and state.step == steps \
            and np.isfinite(losses).all() and len(losses) == steps
        log(f"  pair_kernel {pk}: {steps} steps, launches {launches} "
            f"({blocks} {LABELS[k1 if pk == 2 else k5][0]} + {blocks} "
            f"{LABELS[k1 if pk == 2 else k5][1]} + 1 K3 per step); loss "
            f"{' '.join(f'{x:.4f}' for x in losses)} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"config 3 with pair_kernel {pk}: launches "
                                 f"{launches} != {want} or losses {losses}")

    # one served batch with class ids, f32, through both kernels
    images = [(first.boxes[b][first.valid[b]], first.scores[b][first.valid[b]],
               first.classes[b][first.valid[b]]) for b in range(8)]
    params = init_params(config(1).model, seed=0)
    logits, served = {}, {}
    for pk in (1, 2):
        cfg = config(pk, pair_matmul_dtype="float32")
        rescorer = Rescorer(cfg, params, device=DEV)
        rescorer.rescore_batch(images)      # captures the (8, n) graph
        reset_counts()
        served[pk] = rescorer.rescore_batch(images)
        launches = counts()
        name = "pair_pool_fwd" if pk == 1 else "pair_pool2_fwd"
        if launches != want_counts(**{name: cfg.model.num_blocks}):
            raise AssertionError(f"served batch launches {launches}")
        arrays, _ = rescorer._pack([(i,) + im for i, im in enumerate(images)],
                                   first.padded_n)
        logits[pk] = model_logits(cfg, arrays, params)
    err = (logits[1] - logits[2]).abs().max().item()
    moved = max(np.abs(a - b).max() for a, b in zip(served[1], served[2]))
    ok = torch.allclose(logits[1], logits[2], **LOGIT_TOL)
    log(f"  served batch of 8 images with class ids: {cfg.model.num_blocks} "
        f"K5 / {cfg.model.num_blocks} K1 launches;"
        f" f32 logits K5 vs K1 max |diff| {err:.3e} (tol rtol=atol=1e-3), "
        f"served scores max |diff| {moved:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"config 3 logits differ between K5 and K1: "
                             f"{err}")


# ---------------------------------------------------------------------------
# K1 / K2 at the four shapes the main paths give them
# ---------------------------------------------------------------------------

PAIR_SHAPES = ("bench B=8 N=1024", "config 2 B=8 N=1024", "config 4 B=2 N=4096",
               "evaluation B=8 N=256")


def seeded_model(cfg):
    model = training.build_model(cfg, "kernel", DEV)
    model.load_state_dict(as_state_dict(init_params(cfg.model, seed=0)))
    return model


def pair_shape_args() -> dict:
    """K1's and K2's launch arguments as the 16-block models give them
    (first block's forward, last block's backward; seeded weights; the
    model's own dtype, bf16) at the serving bench batch, config 2's training
    batch, config 4's batch through ``pair_kernel: 2`` and an evaluation
    batch of config 2."""
    dev = torch.device(DEV)
    out = {}
    bench = seeded_model(load_config(experiment_path("serving_bucketed")))
    out[PAIR_SHAPES[0]] = capture_pair(k1, bench, *sorted_bench_batch(8, 1024))
    cfg2 = load_config(experiment_path("coco_persons_full"),
                       {"data": {"dataset": "synthetic"}})
    model2 = seeded_model(cfg2)
    arrays = training_batch()
    out[PAIR_SHAPES[1]] = capture_pair(k1, model2, arrays["boxes"],
                                       arrays["scores"], arrays["valid"])
    cfg4 = crowd_config(pair_kernel=2)
    crowd = training.batch_to_device(next(BatchIterator(
        synthetic_roidb(**CROWD_DATA), 2, cfg4.data.bucket_sizes)), dev)
    out[PAIR_SHAPES[2]] = capture_pair(k1, seeded_model(cfg4), crowd["boxes"],
                                       crowd["scores"], crowd["valid"])
    batch = next(iter(eval_batches(evaluate.load_roidb(cfg2),
                                   cfg2.train.batch_size,
                                   cfg2.data.bucket_sizes)))
    ev = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
          for x in (batch.boxes, batch.scores, batch.valid)]
    out[PAIR_SHAPES[3]] = capture_pair(k1, model2, *ev)
    return out


def phase_pair_shapes(check: bool = True) -> tuple[dict, float, float]:
    """K1 and K2 on the models' own launch arguments at the four shapes of
    the main paths: against their plain versions in the model's dtype and
    in f32 (``check``), the fill of stage B's groups and the length of the
    winner queue beside the old lane use, and ms/launch of both in bf16 and
    f32 -> ({shape: times}, K1's and K2's worst error)."""
    log("phase 9b: K1 and K2 on the models' launch arguments at "
        + "; ".join(PAIR_SHAPES))
    times, k1_err, k2_err = {}, 0.0, 0.0
    for label, (fwd, bwd) in pair_shape_args().items():
        dtype = fwd[-1]
        args, m, dm = bwd[:6], bwd[6], bwd[7]
        geom = args[0]
        bsz, nr, p = args[1].shape
        if check:
            for name, a6 in (("first block", fwd[:6]), ("last block", args)):
                for dt in (dtype, "float32"):
                    got = k1.launch_kernel(*a6, dt)
                    want = k1._reference_core(*a6, dt)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    ok = within(got, want, dt)
                    log(f"  K1 {label + ', ' + name:<36} {dt:<8} bit-equal "
                        f"{torch.equal(got, want)}, max_abs_err={err:.3e} "
                        f"tol {TOL_TEXT[dt]} -> {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"K1 disagrees with its plain version: {label} "
                            f"{name} {dt} max_abs_err={err}")
                    k1_err = max(k1_err, err)
            for dt in (dtype, "float32"):
                k2_err = max(k2_err, check_backward(f"{label}, last block",
                                                    dt, args, dm))
            log_lane_use(f"a warp of 32 rows against one column, {label}",
                         geom)
            log_queues(label, args, m, dtype)
        row = {}
        for dt in (dtype, "float32"):
            m_dt = k1.launch_kernel(*args, dt)

            def fwd_call():
                return k1.launch_kernel(*fwd[:6], dt)

            def bwd_call():
                return k1.launch_backward_kernel(*args, m_dt, dm, dt)

            # CUDA events around a chain of launches (the host's launch
            # rate where that is the slower), and the device time of one
            # launch's kernels from the profiler (fill and slice sums too)
            row[dt] = (cuda_time(fwd_call, iters=30),
                       cuda_time(bwd_call, iters=20),
                       device_ms(fwd_call), device_ms(bwd_call))
        bound1 = k1_bound(fwd[:6], dtype)
        bound2 = k2_bound(args, m, dm, dtype)
        times[label] = dict(ms=row, bound_k1=bound1[0], bound_k2=bound2[0])
        for dt in (dtype, "float32"):
            e1, e2, d1, d2 = row[dt]
            d1, d2 = (f"{d:.4f} ms" if d else "not measured" for d in (d1, d2))
            log(f"  {label} (B={bsz} NR={nr} P={p}) {dt}: K1 {e1:.4f} "
                f"ms/launch (events), {d1} on the device (profiler); "
                f"K2 {e2:.4f} ms/launch (events), {d2} on the device")
        log(f"  {label} bounds, {dtype}: K1 {bound1[0]:.5f} ms ({bound1[1]}); "
            f"K2 {bound2[0]:.5f} ms ({bound2[1]}: {bound2[2]})")
    return times, k1_err, k2_err


K5_SHAPES = ("bench B=8 N=1024", "config 4 B=2 N=4096")


def k5_shape_args() -> dict:
    """K5's and K6's launch arguments as the 16-block models give them
    through ``pair_kernel: 1`` (first block's forward, last block's
    backward; seeded weights; the models' dtype, bf16): the serving bench
    batch and config 4's training batch. It calls nothing the package has
    not had since K5/K6 exist, so a copy of this script beside an earlier
    tree builds that tree's arguments."""
    dev = torch.device(DEV)
    bench = seeded_model(load_config(experiment_path("serving_bucketed"),
                                     {"model": {"pair_kernel": 1}}))
    cfg4 = crowd_config()
    crowd = training.batch_to_device(next(BatchIterator(
        synthetic_roidb(**CROWD_DATA), 2, cfg4.data.bucket_sizes)), dev)
    return {K5_SHAPES[0]: capture_pair(k5, bench,
                                       *sorted_bench_batch(8, 1024)),
            K5_SHAPES[1]: capture_pair(k5, seeded_model(cfg4),
                                       crowd["boxes"], crowd["scores"],
                                       crowd["valid"])}


def phase_k5_k6_shapes() -> None:
    """K5 and K6 ms/launch on the models' launch arguments, in the models'
    dtype and in f32: CUDA events around a chain of launches, and the
    device time of one launch's kernels from the profiler, beside the
    bounds. Only ``launch_kernel`` and ``launch_backward_kernel`` of the
    package are called."""
    log("K5 and K6 on the models' launch arguments at "
        + "; ".join(K5_SHAPES))
    for label, (fwd, bwd) in k5_shape_args().items():
        dtype = fwd[-1]
        args, m, dm = bwd[:6], bwd[6], bwd[7]
        bsz, nr, p = args[1].shape
        for dt in (dtype, "float32"):
            m_dt = k5.launch_kernel(*args, dt)

            def fwd_call():
                return k5.launch_kernel(*fwd[:6], dt)

            def bwd_call():
                return k5.launch_backward_kernel(*args, m_dt, dm, dt)

            e5, e6 = cuda_time(fwd_call, iters=20), cuda_time(bwd_call,
                                                              iters=10)
            d5, d6 = (f"{d:.4f} ms" if d else "not measured"
                      for d in (device_ms(fwd_call), device_ms(bwd_call)))
            log(f"  {label} (B={bsz} NR={nr} P={p}) {dt}: K5 {e5:.4f} "
                f"ms/launch (events), {d5} on the device (profiler); K6 "
                f"{e6:.4f} ms/launch (events), {d6} on the device")
        b5 = k5_bound(fwd[:6], dtype)
        b6 = k2_bound(args, m, dm, dtype, kern=k5)
        log(f"  {label} bounds, {dtype}: K5 {b5[0]:.5f} ms ({b5[1]}); K6 "
            f"{b6[0]:.5f} ms ({b6[1]}: {b6[2]})")


# K1 with one stage taken out by a build switch (csrc/pairwise2_fwd.cu), or
# with one block per row tile: (label, nvcc flags, splits or None)
K1_STAGES = (
    ("full", (), None),
    ("one block per row tile (no splits)", (), 1),
    ("stage A only (stage B does nothing)", ("-DGNET_ABLATE_STAGE_B",), None),
    ("no merge into the running max", ("-DGNET_ABLATE_MERGE",), None),
    ("a', b' of detection 0 (loads hit L1)", ("-DGNET_ABLATE_LOADS",), None),
    ("no merge, a', b' of detection 0",
     ("-DGNET_ABLATE_MERGE", "-DGNET_ABLATE_LOADS"), None),
)


def phase_k1_stages():
    """What each stage of K1 costs: the kernel rebuilt with a stage taken
    out (the outputs are wrong and are not read) and timed on the device
    at the four shapes, bf16 and f32. The differences are no sum of parts:
    the stages are chains of latencies that overlap."""
    from gossipnet_tpu_torch.ops.cuda import launch

    log("K1 by stage: device ms per launch (profiler) at "
        + "; ".join(PAIR_SHAPES))
    shapes = pair_shape_args()
    flags, splits_fn = build.NVCC_FLAGS, launch.col_splits
    try:
        for label, extra, splits in K1_STAGES:
            build.NVCC_FLAGS = flags + extra
            build._loaded.pop("pairwise2_fwd", None)
            if splits is not None:
                launch.col_splits = lambda blocks, nj, sms: splits
            cells = []
            for fwd, _ in shapes.values():
                cells.append("/".join(
                    f"{device_ms(lambda: k1.launch_kernel(*fwd[:6], dt)):.4f}"
                    for dt in ("bfloat16", "float32")))
            launch.col_splits = splits_fn
            log(f"  {label:<40} bf16/f32: " + "  ".join(cells))
    finally:
        build.NVCC_FLAGS, launch.col_splits = flags, splits_fn
        build._loaded.pop("pairwise2_fwd", None)


def scan_time_inputs() -> dict:
    """The scan inputs of ``--scan-times``, made as scan_input makes them:
    K3 at config 2's and config 4's training batches, T=1 and T=10, and
    K4 on one config-2 image -> {label: (iou, thresholds)}."""
    inputs = {}
    for label, arrays in (("K3 config 2 B=8 N=1024 G=112", training_batch()),
                          ("K3 config 4 B=2 N=4096 G=400",
                           crowd_training_batch())):
        for thr in ((0.5,), COCO_THRESHOLDS):
            inputs[f"{label} T={len(thr)}"] = scan_input(arrays, thr)
    iou, thr = inputs["K3 config 2 B=8 N=1024 G=112 T=1"]
    inputs["K4 one config-2 image T=1"] = (iou[:1].contiguous(), thr)
    return inputs


def phase_scan_times():
    """K3 and K4 timed: CUDA events around 50 launches (twice), then the
    device time from the profiler, beside the bound and the chain figure.
    Only ``greedy_match_batch(impl="kernel")`` and ``launch_kernel`` of the
    package are used, so a copy of this script beside an older tree times
    that tree's kernel on the same card."""
    log("K3/K4 times: ms/launch by CUDA events (two chains of 50), then on "
        "the device (profiler)")
    for label, (iou, thr) in scan_time_inputs().items():
        def fn():
            k3.launch_kernel(iou, thr)

        events = [cuda_time(fn, iters=50) for _ in range(2)]
        kernel, call = scan_device_ms(fn)
        _, best = k3.launch_kernel(iou, thr)
        log_scan_stats(label, iou, thr.tolist(), best)
        log(f"  {label}: events {events[0]:.4f}, {events[1]:.4f}; device "
            f"{kernel:.4f} ms/launch (the whole call, copies and fills "
            f"included: {call:.4f})")


def scan_device_ms(fn, reps: int = 20) -> tuple[float, float]:
    """(the scan kernel's device ms, all device ms of the call) per call
    from the profiler; zeros when the trace holds no device time."""
    for _ in range(2):
        busy, by_name = profile_kernels(fn, reps)
        if busy:
            return sum(v for key, v in by_name.items()
                       if "greedy_scan" in key), busy
    return 0.0, 0.0


# -D flags of a scratch build of matching_scan.cu: (label, flags)
SCAN_BUILDS = (
    ("as built", ()),
    ("the chain's bit test a no-op", ("-DGNET_ABLATE_CHAIN",)),
)


def phase_scan_stages():
    """Who sets K3's pace: the kernel as built (outputs checked) and
    rebuilt with the chain's bit test a no-op (the producers' pace; outputs
    wrong, not read), timed on the device."""
    inputs = scan_time_inputs()
    label, (iou, thr) = next(iter(inputs.items()))
    want = k3.greedy_scan_reference(iou, thr)
    flags = build.NVCC_FLAGS
    log("K3/K4 by build: device ms per launch (profiler) at "
        + "; ".join(inputs))
    try:
        for name, extra in SCAN_BUILDS:
            build.NVCC_FLAGS = flags + extra
            build._loaded.pop("matching_scan", None)
            build.build(["matching_scan"])
            exact = "not read"
            if "ABLATE" not in " ".join(extra):
                got = k3.launch_kernel(iou, thr)
                exact = all(torch.equal(a, b) for a, b in zip(got, want))
                if not exact:
                    raise AssertionError(f"K3 built with {extra} differs "
                                         f"from its plain version")
            cells = [f"{scan_device_ms(lambda: k3.launch_kernel(x, t))[0]:.4f}"
                     for x, t in inputs.values()]
            log(f"  {name:<30} {' '.join(cells)} (exact at {label}: "
                f"{exact})")
    finally:
        build.NVCC_FLAGS = flags
        build._loaded.pop("matching_scan", None)


def device_ms(fn, reps: int = 10) -> float:
    """Device time of one call's kernels from the profiler; a second try
    if the first trace came back empty, then 0.0 (not measured)."""
    for _ in range(2):
        busy, _ = profile_kernels(fn, reps)
        if busy:
            return busy
    return 0.0


def k1_bound(args, dtype) -> tuple[float, str]:
    """The least time for K1's work on these inputs: the neighbour pairs
    through the MLP, the IoU tests of the active tiles' valid pairs, each
    input read and the output written once."""
    geom, a2, b2, wg_k, w2, b2bias = args
    p, k = a2.shape[-1], wg_k.shape[0]
    nb_pairs, tested = pair_counts(geom)
    ops_s = nb_pairs * (2 * p * p + (k + 6) * p) / (
        PEAK_BF16 if dtype == "bfloat16" else PEAK_F32) \
        + tested * IOU_OPS / PEAK_F32
    nbytes = sum(t.numel() * t.element_size() for t in
                 (geom.row, geom.col, a2, b2, wg_k, w2, b2bias, geom.flags)) \
        + a2.numel() * 4
    bytes_s = nbytes / PEAK_BYTES
    return max(ops_s, bytes_s) * 1e3, \
        "operations" if ops_s >= bytes_s else "bytes"


# ---------------------------------------------------------------------------
# Phase 14: serving trained weights
# ---------------------------------------------------------------------------

SERVE_WAIT_S = 300          # every socket read, join and CLI line waits this
F2_SLEEP_S = 0.5            # the work enqueued behind a dispatched batch
SERVE_REQUESTS = 40         # closed-loop requests per client in phase 14g


def checkpoint_states(cfg, ckpt: Path) -> tuple[dict, dict]:
    """Phase 13's best and latest states, restored by hand (not through
    the Rescorer) -> two state_dicts on the CPU."""
    mgr = CheckpointManager(ckpt)
    state = training.create_train_state(
        cfg, training.build_model(cfg, "dense", "cpu"))
    best = {k: v.clone() for k, v in
            mgr.restore_best(state).model.state_dict().items()}
    state, _ = mgr.restore(state)
    return best, {k: v.clone() for k, v in state.model.state_dict().items()}


def bit_equal(got, want) -> bool:
    return all(np.array_equal(g, w) for g, w in zip(got, want))


def json_line(rid, image) -> bytes:
    return (json.dumps({"id": rid, "boxes": image[0].tolist(),
                        "scores": image[1].tolist()}) + "\n").encode()


def bin_frame(rid, image) -> bytes:
    boxes, scores = image[0], image[1]
    return (struct.pack("<IQII", serving.BIN_MAGIC, rid, len(scores), 0)
            + np.ascontiguousarray(boxes, "<f4").tobytes()
            + np.ascontiguousarray(scores, "<f4").tobytes())


def read_frame(sock):
    """One binary reply -> (id, error or None, scores or None)."""
    magic, status, rid = struct.unpack("<IBQ",
                                       serving._recv_exact(sock, 13))
    (ln,) = struct.unpack("<I", serving._recv_exact(sock, 4))
    if status:
        return rid, serving._recv_exact(sock, ln).decode(), None
    scores = np.frombuffer(serving._recv_exact(sock, 4 * ln), "<f4")
    (k,) = struct.unpack("<I", serving._recv_exact(sock, 4))
    serving._recv_exact(sock, 4 * k)
    return rid, None, scores


def tcp_client(port, requests, binary=False, latencies=None) -> list:
    """Sends ``requests`` ((id, image) or raw JSON text) one at a time on
    one connection -> the replies (dicts, or read_frame tuples)."""
    out = []
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=SERVE_WAIT_S) as s:
        f = s.makefile("r")
        for req in requests:
            t0 = time.perf_counter()
            if binary:
                s.sendall(bin_frame(*req))
                out.append(read_frame(s))
            else:
                s.sendall(req.encode() if isinstance(req, str)
                          else json_line(*req))
                out.append(json.loads(f.readline()))
            if latencies is not None:
                latencies.append(time.perf_counter() - t0)
    return out


def run_clients(jobs) -> list:
    """Runs each (fn, args) in its own thread -> results in order; raises
    what a client raised."""
    results, errors = [None] * len(jobs), []

    def run(i, fn, args):
        try:
            results[i] = fn(*args)
        except Exception as e:   # noqa: BLE001 -- raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, fn, args))
               for i, (fn, args) in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SERVE_WAIT_S)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"TCP clients failed: {errors}")
    return results


class CliLines:
    """A CLI subprocess's stderr, line by line, read by a thread, so that
    every wait has a timeout."""

    def __init__(self, proc):
        self.lines = queue.Queue()
        self.seen: list[str] = []

        def read():
            for line in proc.stderr:
                self.lines.put(line.rstrip("\n"))

        threading.Thread(target=read, daemon=True).start()

    def until(self, prefix: str) -> str:
        deadline = time.monotonic() + SERVE_WAIT_S
        while True:
            line = self.lines.get(timeout=max(deadline - time.monotonic(),
                                              0.001))
            self.seen.append(line)
            if line.startswith(prefix):
                return line


def serve_and_check(rescorer, images, n_json, buckets) -> int:
    """Serves ``images`` to ``n_json`` JSON clients and one binary client
    at once, then a bad request and a stats request -> the K1 launches.

    A score moves with its batch's composition (the dense layers' GEMMs
    sum in another order at another batch size; bf16 rounding of the pair
    inputs magnifies an f32 ulp), so each reply is held to the Rescorer's
    result for the very batch the server dispatched, recomputed through
    ``rescore_async``: JSON within 2e-6 (6 decimals), binary within 1e-6;
    the distance to ``rescore_batch``'s grouping is logged beside."""
    blocks = rescorer.cfg.model.num_blocks
    server = serving.TcpServer(rescorer, port=0, threshold=0.5)
    groups, dispatch = [], server._dispatch_group

    def recording(bucket, group):
        groups.append((bucket, [g[2]["id"] for g in group],
                       [g[3] for g in group]))
        dispatch(bucket, group)

    server._dispatch_group = recording
    server.start()
    reset_counts()
    try:
        jobs = [(tcp_client, (server.port,
                              [(f"c{c}-{i}", images[i]) for i in
                               np.roll(np.arange(len(images)), c)]))
                for c in range(n_json)]
        jobs.append((tcp_client, (server.port,
                                  [(100 + i, im) for i, im in
                                   enumerate(images)], True)))
        replies = run_clients(jobs)
        bad, stats = tcp_client(server.port,
                                ["{not json\n", '{"stats": true}\n'])
    finally:
        server.stop()
    launches = counts()
    want = {}
    for bucket, ids, group in groups:
        want.update(zip(ids, rescorer.rescore_async(
            group, padded_n=bucket).wait()))
    grouped = rescorer.rescore_batch(images)
    json_err, bin_err, exact, n_rep, spread = 0.0, 0.0, 0, 0, 0.0
    for client in replies[:n_json]:
        for rep in client:
            got = np.asarray(rep["new_scores"])
            json_err = max(json_err,
                           float(np.abs(got - want[rep["id"]]).max()))
            spread = max(spread, float(np.abs(
                got - grouped[int(rep["id"].split("-")[1])]).max()))
            n_rep += 1
    for rid, err, scores in replies[n_json]:
        if err is not None:
            raise AssertionError(f"binary request {rid}: {err}")
        diff = np.abs(scores - want[rid])
        bin_err = max(bin_err, float(diff.max()))
        exact += int(diff.max() == 0.0)
        spread = max(spread, float(np.abs(scores - grouped[rid - 100])
                                   .max()))
    log(f"  (b) TcpServer: {n_rep} JSON replies from {n_json} clients and "
        f"{len(replies[n_json])} binary frames at once over buckets "
        f"{buckets}, in {len(groups)} batches of "
        f"{sorted(len(ids) for _, ids, _ in groups)} images; against the "
        f"Rescorer on the same batches: max |diff| JSON {json_err:.2e} "
        f"(tol 2e-6, 6 decimals), binary {bin_err:.2e} (tol 1e-6), {exact} "
        f"of {len(replies[n_json])} binary replies bit-equal; against "
        f"rescore_batch's grouping: {spread:.2e}")
    log(f"  (b) bad request -> {bad}; stats images {stats['images']}, "
        f"batches {stats['batches']}, mean batch {stats['mean_batch']}, "
        f"errors {stats['errors']}; launches {launches} (expected "
        f"{blocks} K1 x {server.stats['batches']} batches)")
    if json_err > 2e-6 or bin_err > 1e-6 or "error" not in bad \
            or stats["images"] != (n_json + 1) * len(images) \
            or stats["errors"] != 1 or len(want) != stats["images"]:
        raise AssertionError("the TCP server's replies are wrong")
    if launches != want_counts(
            pair_pool2_fwd=blocks * server.stats["batches"]):
        raise AssertionError("the TCP server did not run every block on K1")
    return launches["pair_pool2_fwd"]


def phase_serve_trained(tmp: Path) -> int:
    """Phase 14: phase 13's trained checkpoint served through every entry
    point that reads weights -> the K1 launches of the in-process TCP
    server and file mode."""
    log("phase 14: serving trained weights - phase 13's checkpoint through "
        "from_checkpoint, the TCP server, the serve CLI, file mode and an "
        "artifact, on the 16-block serving_bucketed model")
    ckpt, cfg2_path = tmp / "eval_ckpt", tmp / "eval.yaml"
    root = Path(__file__).resolve().parent
    cfg = load_config(experiment_path("serving_bucketed"))
    blocks = cfg.model.num_blocks
    images = [(r.det_boxes, r.det_scores, None)
              for r in serving_images(np.random.default_rng(0))]

    # (a) checkpoints into the Rescorer, and the npz round trip
    best, latest = checkpoint_states(cfg, ckpt)
    served = Rescorer.from_checkpoint(cfg, str(ckpt), device=DEV)
    want = Rescorer(cfg, best, device=DEV).rescore_batch(images)
    got = served.rescore_batch(images)
    served.reload(checkpoint_dir=str(ckpt), best=False)
    got_latest = served.rescore_batch(images)
    want_latest = Rescorer(cfg, latest, device=DEV).rescore_batch(images)
    served.reload(checkpoint_dir=str(ckpt))
    save_params_npz(tmp / "best.npz", best)
    got_npz = Rescorer(cfg, load_params_npz(tmp / "best.npz"),
                       device=DEV).rescore_batch(images)
    same_weights = all(torch.equal(best[k], latest[k]) for k in best)
    log(f"  (a) from_checkpoint (best) vs a Rescorer on the best state "
        f"restored by hand: bit-equal {bit_equal(got, want)}; "
        f"reload(best=False) vs the latest state: bit-equal "
        f"{bit_equal(got_latest, want_latest)} (best and latest weights "
        f"equal: {same_weights}); save_params_npz -> load_params_npz -> "
        f"Rescorer: bit-equal {bit_equal(got_npz, want)}")
    if not (bit_equal(got, want) and bit_equal(got_latest, want_latest)
            and bit_equal(got_npz, want)):
        raise AssertionError("checkpoint-backed scores differ")

    # (b) the TCP server in this process: 4 JSON clients and a binary one
    # at once, a bad request and a stats request
    buckets = sorted({bucket_for(len(im[1]), cfg.data.bucket_sizes)
                      for im in images})
    tcp_launches = serve_and_check(served, images, 4, buckets)

    # (b) a reload while a client is served: every reply is the old
    # weights' or the new ones', and the new ones once it returned
    # (one client, so every request is dispatched alone: batch 1)
    new_params = init_params(cfg.model, seed=1)
    new = Rescorer(cfg, new_params, device=DEV).rescore_batch(
        images, batch_size=1)
    old = served.rescore_batch(images, batch_size=1)
    server = serving.TcpServer(served, port=0, threshold=0.5).start()
    progress = queue.Queue()

    def streaming(port):
        out = []
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=SERVE_WAIT_S) as s:
            f = s.makefile("r")
            for k in range(4 * len(images)):
                done = reloaded.is_set()
                s.sendall(json_line(k, images[k % len(images)]))
                out.append((done, json.loads(f.readline())))
                progress.put(k)
        return out

    reloaded, results = threading.Event(), []
    try:
        t = threading.Thread(target=lambda: results.append(
            streaming(server.port)))
        t.start()
        while progress.get(timeout=SERVE_WAIT_S) < len(images):
            pass
        served.reload(params=new_params)
        reloaded.set()
        t.join(timeout=SERVE_WAIT_S)
    finally:
        server.stop()
    kinds = []
    for done, rep in results[0]:
        i, s = rep["id"] % len(images), np.asarray(rep["new_scores"])
        kind = ("old" if np.abs(s - old[i]).max() <= 2e-6 else
                "new" if np.abs(s - new[i]).max() <= 2e-6 else "neither")
        if kind == "neither" or (done and kind == "old"):
            raise AssertionError(f"reply {rep['id']} after the reload "
                                 f"({done}) is {kind}")
        kinds.append(kind)
    log(f"  (b) reload under service: {kinds.count('old')} replies on the "
        f"old weights, then {kinds.count('new')} on the new ones, none "
        f"mixed")
    served.reload(checkpoint_dir=str(ckpt))

    # (c) the CLI in a subprocess: SIGHUP reloads, SIGTERM drains
    cfg2 = load_config(str(cfg2_path))
    fit = [im for im in images if len(im[1]) <= max(cfg2.data.bucket_sizes)]
    # one client: every request alone, as rescore_batch at batch 1
    want2 = Rescorer(cfg2, best, device=DEV).rescore_batch(fit,
                                                           batch_size=1)
    proc = subprocess.Popen(
        [sys.executable, "-m", "gossipnet_tpu_torch.serve", "-c",
         str(cfg2_path), "--checkpoint-dir", str(ckpt), "--tcp", "0",
         "--device", DEV], cwd=root, stderr=subprocess.PIPE, text=True)
    lines = CliLines(proc)
    try:
        port = int(lines.until("serving on ").rsplit(":", 1)[1])
        first = tcp_client(port, [(i, im) for i, im in enumerate(fit)])
        proc.send_signal(signal.SIGHUP)
        reload_line = lines.until("weights reloaded")
        second = tcp_client(port, [(i, im) for i, im in enumerate(fit)])
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=SERVE_WAIT_S)
        drained = lines.until("drained: ")
    finally:
        if proc.poll() is None:
            proc.kill()
    cli_err = max(float(np.abs(np.asarray(rep["new_scores"])
                               - want2[rep["id"]]).max())
                  for rep in first + second)
    log(f"  (c) serve CLI -c eval.yaml --checkpoint-dir --tcp 0: "
        f"{len(first) + len(second)} replies, max |diff| {cli_err:.2e} "
        f"against rescore_batch at batch 1 (tol 2e-6); SIGHUP -> "
        f"{reload_line!r}; "
        f"SIGTERM -> {drained!r}, exit {rc}")
    if cli_err > 2e-6 or rc != 0 or not drained.startswith(
            f"drained: {2 * len(fit)} images in") \
            or not drained.endswith(", 0 errors"):
        raise AssertionError(f"serve CLI: {lines.seen}")

    # (d) file mode on a COCO-results file of the phase-4 images
    dets = [{"image_id": i, "category_id": 1,
             "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
             "score": float(s)}
            for i, (bx, sc, _) in enumerate(images)
            for (x1, y1, x2, y2), s in zip(bx, sc)]
    (tmp / "dets.json").write_text(json.dumps(dets))
    from_file = [(_xywh_to_xyxy_np(np.asarray(
        [d["bbox"] for d in dets if d["image_id"] == i], np.float32)),
        np.asarray([d["score"] for d in dets if d["image_id"] == i],
                   np.float32), None) for i in range(len(images))]
    want_file = np.concatenate(served.rescore_batch(from_file))
    reset_counts()
    serving.main(["-c", experiment_path("serving_bucketed"),
                  "--checkpoint-dir", str(ckpt), "--input",
                  str(tmp / "dets.json"), "--output", str(tmp / "out.json"),
                  "--device", DEV])
    launches = counts()
    got_file = np.asarray([d["score"] for d in json.loads(
        (tmp / "out.json").read_text())])
    file_err = float(np.abs(got_file - want_file).max())
    rounded = int((got_file == np.round(want_file.astype(np.float64), 6))
                  .sum())
    log(f"  (d) file mode --input --output: {len(got_file)} detections of "
        f"{len(images)} images, max |diff| {file_err:.2e} against "
        f"rescore_batch (tol 1e-6: 6 decimals), {rounded} equal to its "
        f"6-decimal rounding; launches {launches}")
    # file mode's Rescorer is new: each batch's shape is captured after
    # one eager forward, then replayed
    if file_err > 1e-6 or launches != want_counts(
            pair_pool2_fwd=blocks * 2 * len(buckets)):
        raise AssertionError("file mode differs")
    file_launches = launches["pair_pool2_fwd"]

    # (e) an artifact: export, serve, evaluate
    art = tmp / "trained.gnetart"
    model_artifact.main(["-c", str(cfg2_path), "--checkpoint-dir", str(ckpt),
                         "--out", str(art), "--batches", "1,2,4,8",
                         "--device", DEV])
    artifact = model_artifact.ArtifactRescorer(art, device=DEV)
    art_err = max(float(np.abs(g - w).max()) for g, w in
                  zip(artifact.rescore_batch(fit, batch_size=1), want2))
    cli = subprocess.run(
        [sys.executable, "-m", "gossipnet_tpu_torch.serve", "--artifact",
         str(art), "--device", DEV], input=json_line(7, fit[0]).decode(),
        cwd=root,
        capture_output=True, text=True, timeout=SERVE_WAIT_S)
    reply = json.loads(cli.stdout.splitlines()[0]) if cli.stdout else {}
    reply_err = float(np.abs(np.asarray(reply.get("new_scores", [1e9]))
                             - want2[0]).max())
    with contextlib.redirect_stdout(io.StringIO()):   # phase 13 printed it
        ap_ckpt = evaluate.main(["-c", str(cfg2_path), "--best", "--device",
                                 DEV])
        ap_art = evaluate.main(["-c", str(cfg2_path), "--artifact",
                                str(art), "--device", DEV])
    ap_err = abs(ap_ckpt["gossipnet"]["AP"] - ap_art["gossipnet"]["AP"])
    log(f"  (e) artifact ({len(artifact.exported_shapes())} shapes, "
        f"{art.stat().st_size / 1e6:.2f} MB): vs the checkpoint Rescorer "
        f"max |diff| {art_err:.2e} (tol 1e-6); serve --artifact reply "
        f"{reply.get('id')} max |diff| {reply_err:.2e} (tol 2e-6); "
        f"evaluate --artifact AP {ap_art['gossipnet']['AP']:.6f} vs "
        f"--checkpoint-dir --best {ap_ckpt['gossipnet']['AP']:.6f} "
        f"(tol 1e-6)")
    if art_err > 1e-6 or cli.returncode != 0 or reply.get("id") != 7 \
            or reply_err > 2e-6 or ap_err > 1e-6:
        raise AssertionError(f"artifact: {cli.stderr[-2000:]}")

    # (f) F2: wait() does not wait for work enqueued after its batch
    waited, slept = f2_wait(served, api._HostCopy)
    old_waited, _ = f2_wait(served, DeviceCopy)
    log(f"  (f) rescore_async of the bench batch, then torch.cuda._sleep "
        f"of {F2_SLEEP_S} s ({sleep_cycles()} cycles at "
        f"{sm_clock_mhz():.0f} MHz) enqueued behind it: wait() returned "
        f"after {waited:.4f} s (limit 0.25), the stream after "
        f"{slept:.4f} s; the copy on wait() as before the repair: "
        f"{old_waited:.4f} s")
    if waited >= 0.25 or slept < 0.25:
        raise AssertionError("wait() waits for work enqueued after its "
                             "batch")
    return tcp_launches + file_launches


def bench_images():
    """The bench's images: 8 clustered layouts of 896 detections."""
    rng = np.random.default_rng(0)
    return [(r.det_boxes, r.det_scores, None) for r in
            (layout_record(rng, i, "clustered", 1024) for i in range(8))]


def sleep_cycles() -> int:
    return int(F2_SLEEP_S * sm_clock_mhz() * 1e6)


class DeviceCopy:
    """The read-back as it was before F2's repair: the device tensor,
    copied to the host when it is read, behind everything enqueued since
    on the stream."""

    def __init__(self, probs):
        self._probs = probs

    def numpy(self):
        return self._probs.cpu().numpy()


def f2_wait(rescorer, copy) -> tuple[float, float]:
    """Dispatch the bench batch, enqueue F2_SLEEP_S of sleep behind it ->
    (seconds wait() took, seconds until the stream was idle), with the
    read-back ``copy`` in place of ``api._HostCopy``; its scores must
    equal ``rescore_batch``'s."""
    images = bench_images()
    want = rescorer.rescore_batch(images)
    saved = api._HostCopy
    api._HostCopy = copy
    try:
        torch.cuda.synchronize()
        handle = rescorer.rescore_async(images)
        torch.cuda._sleep(sleep_cycles())
        t0 = time.perf_counter()
        got = handle.wait()
        waited = time.perf_counter() - t0
        torch.cuda.synchronize()
        slept = time.perf_counter() - t0
    finally:
        api._HostCopy = saved
    if not bit_equal(got, want):
        raise AssertionError("rescore_async differs from rescore_batch")
    return waited, slept


def phase_serve_times(card: str) -> None:
    """Phase 14g, for information: TCP request latency at 1 and 4 JSON
    clients and 1 binary client, closed loop, on the bench's images, with
    the 16-block serving_bucketed model (seeded weights); then
    serve_stream's JSON-lines stream through rescore_stream."""
    cfg = load_config(experiment_path("serving_bucketed"))
    rescorer = Rescorer(cfg, init_params(cfg.model, seed=0), device=DEV)
    log(f"phase 14g: serving times on the bench's images (8 x 896 "
        f"detections, bucket 1024), {SERVE_REQUESTS} requests per client "
        f"[{card}]")
    tcp_times(rescorer, card)


def tcp_times(rescorer, tag: str) -> None:
    """The TCP server on ``rescorer`` (its start() warms every padded
    shape of every bucket) at 1 and 4 JSON clients and 1 binary client,
    then two JSON-lines streams through serve_stream; logs each with
    ``tag``."""
    images = bench_images()
    server = serving.TcpServer(rescorer, port=0, threshold=0.5).start()
    try:
        for label, n_clients, binary in (("1 JSON client", 1, False),
                                         ("4 JSON clients", 4, False),
                                         ("4 JSON clients again", 4, False),
                                         ("1 binary client", 1, True)):
            before = server.stats_snapshot()
            lat: list[float] = []
            t0 = time.perf_counter()
            run_clients([(tcp_client, (
                server.port, [(c * 1000 + k, images[k % len(images)])
                              for k in range(SERVE_REQUESTS)], binary, lat))
                for c in range(n_clients)])
            wall = time.perf_counter() - t0
            after = server.stats_snapshot()
            n = after["images"] - before["images"]
            batches = after["batches"] - before["batches"]
            ms = np.asarray(lat) * 1e3
            log(f"  TCP {label}: request latency p50 "
                f"{np.percentile(ms, 50):.3f} ms, p99 "
                f"{np.percentile(ms, 99):.3f} ms; {n / wall:.1f} images/s; "
                f"mean batch {n / batches:.3f} ({n} images in {batches} "
                f"batches) [{tag}]")
    finally:
        server.stop()
    lines = "".join(json_line(k, images[k % len(images)]).decode()
                    for k in range(8 * len(images)))
    for _ in range(2):
        t0 = time.perf_counter()
        n = serve_stream(rescorer, 0.5, inp=io.StringIO(lines),
                         out=io.StringIO())
        s = time.perf_counter() - t0
        log(f"  serve_stream (rescore_stream, batches of 8) of {n} JSON "
            f"lines: {s * 1e3:.1f} ms, {n / s:.1f} images/s [{tag}]")


# ---------------------------------------------------------------------------
# phase 15: the captured paths against the eager ones
# ---------------------------------------------------------------------------

GATE_STEPS = 20          # config 2's run, as phase 6 trains it
GATE_CROWD_STEPS = 5     # config 4's, as phase 10 trains it
GATE_ACCUM_STEPS = 4     # micro-steps of grad_accum_steps: 2
TIME_ITERS = 20


class EagerGraphs:
    """Stands in for a Rescorer's ForwardGraphs: the forward runs eagerly
    on every dispatch, its inputs copied to the card as the Rescorer
    copied them before its graphs. The before-state of phase 15."""

    def __init__(self, graphs):
        self.graphs = graphs

    def __call__(self, *arrays):
        return self.graphs.forward(*(torch.from_numpy(
            np.ascontiguousarray(x)).to(DEV) for x in arrays))


def eager_rescorer(cfg, params):
    rescorer = Rescorer(cfg, params, device=DEV)
    rescorer._graphs = EagerGraphs(rescorer._graphs)
    return rescorer


def device_arrays(arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(DEV)
            for x in arrays]


def packed_layout(b: int, n: int, pad_from: int | None = None):
    """bench.py's clustered layout as the packed arrays a Rescorer
    dispatches; detections from ``pad_from`` on are padding."""
    batch = layout_batch("clustered", b, n, seed=0)
    valid = batch.valid.copy()
    if pad_from is not None:
        valid[:, pad_from:] = False
    return (batch.boxes, batch.scores, valid, np.zeros((b, n), np.int32))


def gate_forward(label: str, cfg, arrays) -> None:
    """The replayed forward against the eager one at the same padded
    batch: bit-equal probabilities, and a replay launches what an eager
    forward launches."""
    graphs = Rescorer(cfg, init_params(cfg.model, seed=0),
                      device=DEV)._graphs
    first = graphs(*arrays).clone()            # captured, then replayed
    reset_counts()
    again = graphs(*arrays).clone()
    torch.cuda.synchronize()
    replayed = counts()
    reset_counts()
    want = graphs.forward(*device_arrays(arrays))
    torch.cuda.synchronize()
    eager = counts()
    equal = torch.equal(first, want) and torch.equal(again, want)
    log(f"  forward, {label} {tuple(arrays[1].shape)}: captured vs eager "
        f"bit-equal {equal} (max |diff| "
        f"{(first - want).abs().max().item():.2e}); launches per replay "
        f"{ {k: v for k, v in replayed.items() if v} } = eager's "
        f"{replayed == eager}; capture {graphs.capture_seconds()}")
    if not equal or replayed != eager or not sum(eager.values()):
        raise AssertionError(f"captured forward differs from eager: {label}")


def train_batches(data: dict, b: int, cfg, count: int) -> list[dict]:
    it = BatchIterator(synthetic_roidb(**data), b, cfg.data.bucket_sizes)
    return [training.host_arrays(next(it)) for _ in range(count)]


def twin_states(cfg):
    """Two training states on the same seeded weights."""
    return [training.create_train_state(
        cfg, training.build_model(cfg, "kernel", DEV)) for _ in range(2)]


def gate_steps(label: str, cfg, batches: list[dict]) -> StepGraphs:
    """Captured micro-steps against eager train_step on twin states: the
    metrics of every step, then the parameters and optimizer slots, bit
    for bit; each replay launches what an eager step launches."""
    eager, stepped = twin_states(cfg)
    graphs = StepGraphs(stepped, cfg, training.step_body)
    worst, per_step = 0.0, None
    for host in batches:
        reset_counts()
        _, want = training.train_step(eager, dict(zip(
            host, device_arrays(host.values()))), cfg)
        torch.cuda.synchronize()
        eager_counts = counts()
        captures = graphs.captures
        reset_counts()
        got = graphs(host)
        torch.cuda.synchronize()
        if graphs.captures == captures:     # a replay, no capture
            if counts() != eager_counts:
                raise AssertionError(f"{label}: a replay launched "
                                     f"{counts()}, an eager step "
                                     f"{eager_counts}")
            per_step = eager_counts
        for k in want:
            worst = max(worst, (got[k] - want[k]).abs().item())
            if not torch.equal(got[k], want[k]):
                raise AssertionError(f"{label}: step {stepped.step} {k} "
                                     f"{got[k].item()} != {want[k].item()}")
    params = all(torch.equal(a, b) for a, b in zip(
        stepped.model.parameters(), eager.model.parameters()))
    slots = all(torch.equal(a, b) for a, b in zip(
        stepped.optimizer.make_slots(), eager.optimizer.make_slots()))
    log(f"  {label}: {len(batches)} captured micro-steps vs eager "
        f"train_step: loss, pos_frac, num_pos and grad_norm bit-equal at "
        f"every step (last loss {want['loss'].item():.6f}); parameters "
        f"{params}, optimizer slots {slots}; {graphs.captures} graphs; "
        f"launches per replay {({k: v for k, v in per_step.items() if v})} "
        f"= an eager step's")
    if not (params and slots and per_step):
        raise AssertionError(f"{label}: captured steps differ from eager")
    return graphs


def in_turns(fns: dict, iters: int = TIME_ITERS) -> dict:
    """Each of ``fns`` timed by CUDA events, the host clock, the host clock
    and CUDA events, the paths in turns (their order reversed at each
    round) -> {label: [events, host, host, events] ms per call}."""
    out = {k: [0.0] * 4 for k in fns}
    order = list(fns)
    for i, kind in enumerate(("events", "host", "host", "events")):
        for k in order:
            out[k][i] = (cuda_time(fns[k], iters, warmup=1)
                         if kind == "events" else host_ms(fns[k], iters))
        order.reverse()
    return out


def log_turns(label: str, fns: dict, per_call=None, card: str = "") -> dict:
    """Times ``fns`` in turns and logs each path's times, busy share and,
    with ``per_call`` (detections a call), its rate."""
    runs = in_turns(fns)
    for k, ms in runs.items():
        events = float(np.median([ms[0], ms[3]]))
        busy, _ = profile_kernels(fns[k], reps=3)
        rate = (f" = {per_call / events * 1e3:.0f} dets/s"
                if per_call else "")
        log(f"  {label}, {k}: ms (events, host, host, events) "
            f"{', '.join(f'{x:.3f}' for x in ms)}{rate}; kernels "
            f"{busy:.3f} ms, busy {busy / events:.3f} [{card}]")
    return runs


def phase_graph_times(card: str) -> None:
    """Phase 15's timings: eager against captured, in turns, at the bench
    batch, config 4, the config-2 and config-4 steps, the evaluation of
    64 images and the TCP server; capture seconds per shape and the memory
    reserved after the warm-up."""
    log(f"phase 15 timings: eager vs captured, in turns [{card}]")
    cfg = load_config(experiment_path("serving_bucketed"))
    params = init_params(cfg.model, seed=0)
    served, eager = Rescorer(cfg, params, device=DEV), \
        eager_rescorer(cfg, params)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()       # what earlier phases left cached
    base = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    served.warmup(batch_size=8)
    warm_s = time.perf_counter() - t0
    secs = served._graphs.capture_seconds()
    mem = profiling.device_memory_stats()["cuda:0"]
    log(f"  warmup(batch_size=8): {len(secs)} graphs in {warm_s:.2f} s; "
        f"seconds per shape (eager run + capture): "
        f"{ {k: round(v, 4) for k, v in secs.items()} }; memory reserved "
        f"{base / 2**20:.1f} MiB before, "
        f"{mem['bytes_reserved'] / 2**20:.1f} MiB after (in use "
        f"{mem['bytes_in_use'] / 2**20:.1f} MiB) [{card}]")
    for label, c, arrays in (
            ("bench forward B=8 N=1024 (K1, bf16)", cfg,
             packed_layout(8, 1024)),
            ("config 4 forward B=2 N=4096 (K5, bf16)", crowd_config(),
             packed_layout(2, 4096, pad_from=3900))):
        graphs = (served._graphs if c is cfg else Rescorer(
            c, init_params(c.model, seed=0), device=DEV)._graphs)
        dev = device_arrays(arrays)
        b, n = arrays[1].shape
        log_turns(label, {"eager": lambda: graphs.forward(*dev),
                          "captured": lambda: graphs(*arrays)},
                  per_call=b * n, card=card)
    images = bench_images()
    log_turns("Rescorer.rescore_batch of the bench's 8 images, host to host",
              {"eager": lambda: eager.rescore_batch(images),
               "captured": lambda: served.rescore_batch(images)}, card=card)

    for label, c, data, b in (
            ("config-2 step B=8 N=1024 G=112 (K1, K2, K3)",
             train_config(Path(tempfile.gettempdir()), "graph_times"),
             TRAIN_DATA, 8),
            ("config-4 step B=2 N=4096 G=400 (K5, K6, K3)", crowd_config(),
             CROWD_DATA, 2)):
        batches = train_batches(data, b, c, 4)
        st_eager, st_graph = twin_states(c)
        graphs = StepGraphs(st_graph, c, training.step_body)
        k = iter(range(10 ** 9))

        def eager_step():
            host = batches[next(k) % 4]
            training.train_step(st_eager, dict(zip(
                host, device_arrays(host.values()))), c)

        def captured_step():
            graphs(batches[next(k) % 4])

        for _ in range(4):
            captured_step()       # every shape of the four captured
        log_turns(label, {"eager": eager_step, "captured": captured_step},
                  per_call=b * batches[0]["scores"].shape[1], card=card)
        log(f"  {label}: seconds per captured step (eager step + capture):"
            f" {[round(v, 4) for v in graphs.capture_seconds().values()]}")

    ecfg = load_config(experiment_path("coco_persons_full"),
                       {"data": {"dataset": "synthetic"}})
    roidb = evaluate.load_roidb(ecfg)
    model = training.build_model(ecfg, "kernel", DEV)
    model.load_state_dict(as_state_dict(init_params(ecfg.model, seed=0)))
    graphs = forward_graphs(model)

    def eager_forward(*arrays):
        return graphs.forward(*device_arrays(arrays)).cpu().numpy()

    def rescore(fn=None):
        return lambda: evaluate.rescore_roidb(
            None, model, roidb, ecfg.train.batch_size,
            ecfg.data.bucket_sizes, forward_fn=fn)

    rescore()()
    runs = in_turns({"eager": rescore(eager_forward),
                     "captured": rescore()}, iters=3)
    for k, ms in runs.items():
        log(f"  evaluation forward of {len(roidb)} images (rescore_roidb, "
            f"B=8 N=256), {k}: ms (events, host, host, events) "
            f"{', '.join(f'{x:.3f}' for x in ms)} [{card}]")
    for label, rescorer in (("eager", eager), ("captured", served),
                            ("captured", served), ("eager", eager)):
        tcp_times(rescorer, f"{label}, {card}")


def phase_captured(card: str) -> None:
    """Phase 15: the captured paths (utils/cuda_graphs.py) against the
    eager ones, bit for bit at the same padded shapes, then timed."""
    log("phase 15: captured graphs against the eager paths")
    serve = load_config(experiment_path("serving_bucketed"))
    bench = packed_layout(8, 1024)
    for label, model in (("K1 bf16", {}),
                         ("K1 f32", {"pair_matmul_dtype": "float32"}),
                         ("K5 bf16", {"pair_kernel": 1}),
                         ("K5 f32", {"pair_kernel": 1,
                                     "pair_matmul_dtype": "float32"})):
        cfg = load_config(experiment_path("serving_bucketed"),
                          {"model": model}) if model else serve
        gate_forward(f"serving_bucketed {label}", cfg, bench)
    gate_forward("config 4 K5 bf16", crowd_config(),
                 packed_layout(2, 4096, pad_from=3900))
    tmp = Path(tempfile.gettempdir())
    cfg2 = train_config(tmp, "gate")
    gate_steps(f"config 2, {GATE_STEPS} steps", cfg2,
               train_batches(TRAIN_DATA, 8, cfg2, GATE_STEPS))
    crowd = crowd_config()
    gate_steps(f"config 4 pair_kernel 1, {GATE_CROWD_STEPS} steps", crowd,
               train_batches(CROWD_DATA, 2, crowd, GATE_CROWD_STEPS))
    accum = train_config(tmp, "gate_accum", grad_accum_steps=2)
    gate_steps(f"config 2 grad_accum_steps 2, {GATE_ACCUM_STEPS} "
               f"micro-steps", accum,
               train_batches(TRAIN_DATA, 8, accum, GATE_ACCUM_STEPS))
    phase_graph_times(card)


def phase_build(names=KERNELS):
    log(f"phase 2: build {', '.join(names)} from ops/cuda/csrc/, one nvcc "
        f"each, all at once")
    t0 = time.perf_counter()
    build.build(names)
    log(f"  built in {time.perf_counter() - t0:.1f} s wall")
    for name in names:
        log(f"  {name}.cu: {build.build_seconds.get(name, 0.0):.1f} s")
        entry, spills = "?", ""
        for line in build.build_logs.get(name, "").splitlines():
            if "Compiling entry function" in line:
                entry, spills = kernel_instance(line), ""
            elif "spill" in line:
                spills = line.strip()
            elif "Used" in line:
                log(f"    ptxas: {entry}: {line.split(':', 1)[1].strip()}; "
                    f"{spills}")


def kernel_instance(line: str) -> str:
    """``name<args>`` of the kernel a ptxas "Compiling entry function"
    line names: its mangled name's ``<length><name>_kernel`` and the
    template ints and bools after it."""
    import re

    for m in re.finditer(r"\d+", line):
        digits = m.group()
        for i in range(len(digits)):   # "_N_1" + "20pair_pool_fwd_kernel"
            end = m.end() + int(digits[i:])
            name = line[m.end():end]
            if name.endswith("_kernel") and line[end:end + 1] == "I":
                args = re.match(r"I((?:L[ib]\d+E)+)E", line[end:])
                vals = re.findall(r"L[ib](\d+)E", args.group(1)) if args \
                    else []
                return f"{name}<{','.join(vals)}>"
    return line.split("'")[1] if "'" in line else line.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    card = card_line()
    log(f"phase 1: card {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    if sys.argv[1:] == ["--pair-times"]:
        # The pair kernels alone, timed: K1/K2 at the four shapes, K5/K6 at
        # two; no check, no result line. It uses only what the package has
        # had since K5/K6 exist, so a copy of this script beside an earlier
        # tree times that tree's kernels on the same card.
        phase_build(PAIR_KERNELS)
        phase_pair_shapes(check=False)
        phase_k5_k6_shapes()
        log(card)
        return 0
    if sys.argv[1:] == ["--scan-times"]:
        # K3/K4 alone: built, checked (phase 3c), timed; no result line.
        phase_build(("matching_scan",))
        phase_scan_cases()
        phase_scan_times()
        log(card)
        return 0
    if sys.argv[1:] == ["--scan-stages"]:
        phase_build(("matching_scan",))
        phase_scan_stages()
        log(card)
        return 0
    if sys.argv[1:] == ["--serve-times"]:
        # Phase 14g alone: the serving times, for information; no result.
        phase_build(KERNELS[:1])
        phase_serve_times(card)
        log(card)
        return 0
    if sys.argv[1:] == ["--graph-times"]:
        # Phase 15's timings alone: eager against captured; no result.
        phase_build(KERNELS[:5])
        phase_graph_times(card)
        log(card)
        return 0
    if sys.argv[1:] == ["--k1-stages"]:
        phase_build(KERNELS[:2])
        phase_k1_stages()
        log(card)
        return 0
    phase_build()

    worst = {"pair_pool2_fwd": phase_kernel_cases(),
             "pair_pool2_bwd": phase_k2_cases(),
             "greedy_scan_batched": 0.0, "greedy_scan": 0.0}   # exact
    phase_scan_cases()
    worst.update(pair_pool_fwd=phase_k5_cases(),
                 pair_pool_bwd=phase_k6_cases(),
                 pair_ablate=phase_k7_cases())
    cfg = load_config(experiment_path("serving_bucketed"))
    rescorer, serve_launches = phase_serving(cfg)
    times = {"pair_pool2_fwd": phase_times(rescorer,
                                           cfg.model.pair_matmul_dtype)}
    with tempfile.TemporaryDirectory() as tmp:
        state, launches = phase_training(Path(tmp))
        phase_train_gradients()
        phase_train_cli(Path(tmp))
        times.update(phase_train_times(state, Path(tmp)))
        _, k1_shape_err, k2_shape_err = phase_pair_shapes()
        worst["pair_pool2_fwd"] = max(worst["pair_pool2_fwd"], k1_shape_err)
        worst["pair_pool2_bwd"] = max(worst["pair_pool2_bwd"], k2_shape_err)
        phase_crowd_serving()
        phase_crowd_oracle()
        crowd_state, crowd_launches, crowd_cfg, crowd_first = \
            phase_crowd_training(Path(tmp))
        phase_crowd_gradients(crowd_first)
        bench_worst = bench_k5_k6_times()
        crowd_times, crowd_worst = phase_crowd_times(crowd_state, crowd_cfg,
                                                     crowd_first)
        times.update(crowd_times)
        for name in crowd_worst:
            worst[name] = max(worst[name], bench_worst[name],
                              crowd_worst[name])
        phase_multiclass(Path(tmp))
        times["pair_ablate"], ablate_launches = phase_ablate()
        eval_launches, eval_err = phase_evaluate(Path(tmp))
        worst["pair_pool2_fwd"] = max(worst["pair_pool2_fwd"], eval_err)
        serve_launches += phase_serve_trained(Path(tmp))
    phase_serve_times(card)
    phase_captured(card)
    log(f"launches on the main paths: serving K1 {serve_launches} "
        f"(phases 4 and 14); "
        f"training {launches}; config 4 training {crowd_launches}; the "
        f"ablation tool K7 {ablate_launches}; evaluation {eval_launches}")
    launches = {**launches, "pair_pool_fwd": crowd_launches["pair_pool_fwd"],
                "pair_pool_bwd": crowd_launches["pair_pool_bwd"],
                "pair_ablate": ablate_launches}

    log(card)
    log(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"gossipnet_tpu_torch/ops/cuda/csrc/{source}",
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": worst[name], **times[name], "library_ms": None}
        for name, (source, replaces) in KERNEL_ROWS.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
