"""End-to-end flows and timings of gossipnet_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

The kernels' correctness on the card -- each against its plain version
at every shape and case, the captured paths against the eager ones, the
kernel paths against the dense plain path -- is held by the card tests:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This script runs what those tests do not: the user's entry points end to
end at full width (each flow raises on failure; the script then exits
non-zero), and the timings PERF.md's kernel table is read from. Where it
times a kernel it also holds it once against its plain version, through
the tests' own checks (``check_launch_args``, ``check_scan``,
``check_k7``, ``check_stream_k1`` and ``check_stream_k2``), on the launch
arguments it times: K1/K2 and K3/K4 on the trained config 2 step's (phase
9), K5/K6 at the bench batch and on the trained config 4 step's and K3 on
its scan input (phase 10), K7 in each mode at the probe's shape (phase
12), the bf16 stream's K1/K2 at the bench batch and config 2's (17b).
Phases
keep the numbers earlier records cite:
1. the card (nvidia-smi name and power limit) and the software versions;
2. builds the six kernel sources (ops/cuda/csrc/pairwise2_fwd.cu,
   pairwise2_bwd.cu, matching_scan.cu, pairwise_fwd.cu, pairwise_bwd.cu,
   pair_ablate.cu) from the sources here, one nvcc each, all at once, with
   each build's time and ptxas registers/spills;
4. the serving path: the 16-block serving_bucketed.yaml model with seeded
   numpy weights through the bridge serves images in all five buckets via
   Rescorer.rescore_batch and serve_stream, with K1's launch counter
   checked against 16 launches per batch; the serve CLI answering JSON
   lines;
5. times of the forward with CUDA events at the bench workload (B=8,
   N=1024, clustered);
6. the training path: config 2 (coco_persons_full.yaml, 16 blocks at full
   width, batch 8) on the synthetic data of the reference's step probe
   (B=8 N=1024 G=112) trains 20 steps through train(); launch counters
   must read 16 K1 + 16 K2 + 1 K3 per step; the loss must be finite and
   fall; a checkpoint is written; 10 steps, a resume and 10 more must give
   the parameters of 20 straight, bit for bit;
8. the train CLI runs 5 steps from a temporary YAML and writes metrics;
9. times of the training path with CUDA events: the step host to host and
   on the device, the device busy share and each kernel's share, K2, K3
   and K4 ms/launch beside their plain versions and bounds, each of the
   four held against its plain version on these arguments; from K3's own
   input, the rows with a candidate, the list entries walked, the largest
   connected component of the det-GT candidate graph and the chain figure
   (its rows times one dependent shared-memory round trip);
9b. K1 and K2 on the 16-block models' own launch arguments at the six
   shapes of the main paths (the serving bench batch, config 2's training
   batch, config 4's B=2 N=4096 through pair_kernel 2, an evaluation batch
   B=8 N=256, the sparse training cell's fill: eight of the drill's
   ``full`` images at B=8 N=256, and the crowd training cell's: two of its
   ``dense_4k`` images at B=2 N=4096): the fill of stage B's groups and
   the length of the winner queue beside the old lane use, ms/launch of
   both in bf16 and f32 beside their bounds, and K2's device activities a
   call, its device time by launch (row grid, column grid, sum), its share
   of blocks with a step, its column blocks' share that summed the row
   pass's records and the records' fill of their room; K1's list kernel's
   device time, entries, dense row tiles and bytes
   (``python3 chip_smoke.py --pair-times`` runs only these timings, and
   K5's and K6's at the serving bench batch and config 4 through
   ``pair_kernel: 1``;
   ``python3 chip_smoke.py --k1-stages`` rebuilds K1 with one stage taken
   out at a time and times what is left; ``--scan-times`` times K3 at
   config 2's and config 4's scan inputs and K4 on one image,
   ``--scan-stages`` rebuilds K3 with the chain's bit test a no-op);
10. config 4 (crowded_4096.yaml, N=4096, batch 2) with pair_kernel 1: the
   Rescorer serves a B=2 N=4096 batch with 16 K5 launches, padding inert;
   5 training steps with 16 K5 + 16 K6 + 1 K3 launches each and a falling
   loss; K5 and K6 ms/launch (CUDA events and the profiler) on the model's
   launch arguments at config 4's batch and the serving bench batch,
   beside their plain versions and bounds, with the fill of stage B's
   groups and the length of K6's winner queue, and K1/K2's on the same
   batch; K3 on the scan input of config 4's training step (events, the
   profiler, the plain version, the input's statistics and both figures);
   the forward and the step, with CUDA events and the host clock, with
   K3's share of the step's kernel time;
11. config 3 (coco_multiclass.yaml, 80 classes) on 80-class synthetic
   data: 5 training steps through K1/K2 with the class-match feature and 5
   through K5/K6 with nine features, launches counted;
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
   Rescorer.rescore_batch's; the COCO stats of the model, of the raw
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
   by evaluate --artifact (the checkpoint's AP to 1e-6);
14g. for information: TCP request latency p50/p99, images/s and mean
   batch at 1, 4 and 16 JSON clients and 1 and 16 binary clients on the
   bench's images, the clients subprocesses (tools/tcp_bench_client.py),
   and at 4 and 16 JSON clients the same client in threads of this
   process; and the JSON-lines stream through rescore_stream (``python3
   chip_smoke.py --serve-times`` runs only this);
15. eager against captured (utils/cuda_graphs.py) in turns (events,
   host, host, events): the forward at the bench batch and config 4
   (dets/s, kernel time, busy share), rescore_batch host to host, the
   config-2 and config-4 steps, the evaluation of 64 images, the TCP
   table of phase 14g; the capture seconds per shape and the memory
   reserved after the warm-up (``python3 chip_smoke.py --graph-times``
   runs only these timings);
16. the measuring tools (``gossipnet_tpu_torch/tools/``) on the card, each
   tool's ``main()`` with its default arguments, as a user runs it:
   ``tools.entry``, ``tools.bench`` in the four layouts,
   ``tools.bench_suite`` (11 cases), ``tools.probe`` in its seven modes
   (``--iters 5``) and ``forward`` and ``step`` with ``--impl pallas1``,
   and ``tools.bench_serving`` (subprocess TCP clients); every line names
   the card, and the tools' launches join the kernels' record
   (``python3 chip_smoke.py --bench`` runs only this phase);
17. the reduced-precision knobs (``python3 chip_smoke.py --precision``
   runs only this phase): K1 and K2 with the bf16 stream
   (``pair_elementwise_dtype: bfloat16``, its own instantiation) timed
   against the f32 stream in turns at the bench batch and config 2's
   batch, beside the stream's plain versions and bounds; the captured
   forward and step with each knob (the stream, ``model.dtype:
   bfloat16``, both) against the defaults in turns; config 2 trained and
   the bench's images served with the stream through ``train`` and
   ``Rescorer``, 16 K1 a batch and 16 K1 + 16 K2 + 1 K3 a step, then
   ``tools.demo_config1`` and ``tools.quality_demo clustered --steps
   20``. The stream's launches are counted apart in the record
   (``pair_pool2_fwd_bf16_stream``, ``pair_pool2_bwd_bf16_stream``);
18. the device mesh (``python3 chip_smoke.py --mesh`` runs only this):
   (a) the det shards in one process, for information: for n_det 2 and 4,
   each shard's rows of the 16-block flagship's launch arguments at the
   bench batch (K1/K2, f32 and bf16) and of config 4's batch (K5/K6)
   against every column, each shard's neighbour pairs and ms at the split
   count of its own row tiles and of the whole matrix's, beside the
   square launch; (b) worlds of 2 and 4 gloo ranks all on cuda:0
   (``parallel/world.py run_world``, the rank programs of
   ``parallel/legs.py``): the 16-block serving_bucketed model through the
   Rescorer on (1x2), (2x1), (2x2) and (1x4) at the bench batch against
   one device at the same padded batch (f32 1e-5, bf16 2e-2), 16 K1 per
   rank and batch; config 2 on (2x1) and (2x2) and config 4 (pair_kernel
   1) on (1x2) through train() for 3 steps (16 K1 + 16 K2, or K5/K6, + 1
   K3 per rank and step, the replicas bit-identical) and step 0's raw
   closed f32 gradients against one device summing each data rank's
   images as a batch (rtol 5e-4, atol 5e-6); the evaluation of 64 images
   on (2x2) against the mesh Rescorer's scores; the TcpServer on a (2x2)
   f32 Rescorer, JSON and binary replies within 1e-5 of one device;
   dryrun_multichip(4); (c) for information, labelled as one card's
   time-sliced ranks and no multi-GPU figure: each rank's ms of the
   sharded forward beside one device's eager forward, and the phase's
   seconds. The mesh's launches, summed over the ranks, join the record;
19. the scale drill (``gossipnet_tpu_torch/tools/scale_drill.py``;
   ``python3 chip_smoke.py --drill`` runs only this): (a) the drill's
   generators at 50 images and 20 PETS frames write files whose sha256
   equal the reference generator's (constants pinned by
   tests/test_torch_scale_drill.py); (b) ``gen()`` at 5,000 images, timed,
   with its counts and file sizes; (c) from those files and the ``run``
   arm's own YAMLs, in this process: config 2 trained 20 steps through
   ``train()`` at 16 K1 + 16 K2 + 1 K3 a step, config 3 (80 classes, the
   non-contiguous category ids remapped by the loader) 5 steps through the
   class-aware K3, then ``evaluate.main`` on config 2's checkpoint over
   the 5,000 images at 16 K1 a batch, its AP beside the raw-score and
   GreedyNMS baselines; (d) ``eval5k()`` (the numpy evaluator under 60 s);
   (e) the ``run`` arm through its five CLI subprocesses (config-1
   evaluation, config-2 training of 300 steps and its evaluation, config-3
   training and its evaluation), each one's wall time and peak RSS, none
   building a kernel; in the full script on a 1,000-image set (the time
   limit), with ``--drill`` on the 5,000 images. The in-process launches
   join the record;
20. the pair kernels' skip tile (``ops/cuda/launch.py`` TILES: FI in {32,
   64} rows x TJ in {16, 32, 64, 128} columns of a flag; ``python3
   chip_smoke.py --tiles`` runs only this): K1/K2 and K5/K6 on the
   16-block models' launch arguments at the bench batch and config 4's,
   each tile's ms/launch (events and the profiler) with its IoU tests and
   bounds; then ``tools.tile_sweep`` (2 regimes x 8 tiles, the flagship at
   B=2 N=4096) and the phase's seconds. Phases 1-19 run at the default
   tile;
21. the paths of the drill's pets, dense80 and dense4k arms on
   real-format files (``python3 chip_smoke.py --drill-files`` runs only
   this): 16 PETS frames (CVML XML, MOT CSV realigned), 16 dense images of
   80 classes and 8 dense4k images from the drill's generators, each
   through ``train()`` with its arm's ``mt`` YAML for two steps at 16 K1 +
   16 K2 + 1 K3 a step. The training runs' launches join the record.

``python3 chip_smoke.py --drill-arm ARM [steps] [lr] [schedule] [mt]
[--train-seed N]`` runs one recipe of the drill's pets, dense, dense80 or
dense4k arms through ``tools/scale_drill.py`` (the train and evaluate
CLIs as subprocesses) and holds its evaluation to the reference's figures
(``DRILL_REFERENCE``, RESULTS.md): the raw and swept-GreedyNMS APs to
RESULTS.md's three printed digits at the same threshold, GossipNet's AP
within 0.02; it prints the table and the val-AP trajectory, exits 1 on a
miss and prints no result line.

Every path of phases 4-14 runs through captured graphs, as a user's call
does (phase 18's mesh paths step eagerly): a replay adds its graph's
launches to each counter, and the eager run before each capture launches
them too, so the launch checks count replays plus captures.

The line before the last is the kernels' JSON record (launches, times,
plain versions' times and bounds); the last line is {"ok": true,
"device": {...}}. Without a CUDA device it prints no result and exits 1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
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

from gossipnet_tpu_torch import evaluate
from gossipnet_tpu_torch import native
from gossipnet_tpu_torch import serving
from gossipnet_tpu_torch import train as training
from gossipnet_tpu_torch.api import Rescorer
from gossipnet_tpu_torch.config import (
    config_to_dict,
    experiment_path,
    load_config,
)
from gossipnet_tpu_torch.data.bucketing import (
    BatchIterator,
    bucket_for,
    eval_batches,
)
from gossipnet_tpu_torch.data.roidb import _xywh_to_xyxy_np
from gossipnet_tpu_torch.data.synthetic import (
    BENCH_LAYOUTS,
    layout_batch,
    layout_record,
    synthetic_roidb,
)
from gossipnet_tpu_torch.models.gossipnet import PAD_LOGIT
from gossipnet_tpu_torch.ops import matching
from gossipnet_tpu_torch.ops import order
from gossipnet_tpu_torch.ops import pair_features as pf
from gossipnet_tpu_torch.ops.cuda import ablate as k7
from gossipnet_tpu_torch.ops.cuda import build
from gossipnet_tpu_torch.ops.cuda import launch
from gossipnet_tpu_torch.ops.cuda import matching_scan as k3
from gossipnet_tpu_torch.ops.cuda import pairwise as k5
from gossipnet_tpu_torch.ops.cuda import pairwise2 as k1
from gossipnet_tpu_torch.params import (
    as_state_dict,
    flatten_paths,
    init_params,
)
from gossipnet_tpu_torch.serving import serve_stream
from gossipnet_tpu_torch.tools import kernel_ablate
from gossipnet_tpu_torch.tools import scale_drill
from gossipnet_tpu_torch.utils import model_artifact
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
LIST_ENTRY_BYTES = 20   # a list entry: (row << 16) | column, four features
FEATURE_OPS = 10        # K5's per-pair features: 5 sub, 2 div, class cmp...
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
    # K1 and K2 with the bf16 stream (pair_elementwise_dtype: bfloat16)
    "pair_pool2_fwd_bf16_stream": ("pairwise2_fwd.cu",
                                   "gossipnet_tpu/ops/pallas/pairwise2.py:529"),
    "pair_pool2_bwd_bf16_stream": ("pairwise2_bwd.cu",
                                   "gossipnet_tpu/ops/pallas/pairwise2.py:657"),
    # K1's list kernel: K1's and K2's stage A, once a forward
    "pair_pool2_fwd_list": ("pairwise2_fwd.cu",
                            "gossipnet_tpu/ops/pallas/pairwise2.py:529"),
}
# the pair kernels' labels in the log: (forward, backward)
LABELS = {k1: ("K1", "K2"), k5: ("K5", "K6")}
# config 4's training data: ~3,800 detections and 400 GTs per image,
# bucketed to N=4096; two images, so every step sees the same batch
CROWD_DATA = dict(num_images=2, seed=0, num_gt=400, dets_per_gt=8,
                  num_clutter=600, num_classes=1)
CROWD_STEPS = 5
DEV = "cuda"
# phase 19: the drill's files at this size, as the reference's generator
# writes them from its default seeds (tests/test_torch_scale_drill.py pins
# the digests against scripts/scale_drill.py)
DRILL_IMAGES = 50
DRILL_FRAMES = 20
DRILL_SHA256 = {
    "annotations.json":
        "af7bb40de756c3f2a273d1b05aa8acf09db223823928c41d148134b8b2c1d467",
    "detections.json":
        "f08f3d5a414b3085fa04669ffd0f707800981c522b55f3023e6fb6fa5a406c94",
    "pets_gt.xml":
        "84cb7ff8375fd4be3099d57e8ebb381e231a9454238bb787471f768eb8197c40",
    "pets_dets.csv":
        "31e3bce5f1ead74535034c29c24d7100067be5743359e93af3b90e320dbced34",
}


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


# K1/K2's bf16 stream: bf16 operands and pair_elementwise_dtype bfloat16.
# Where a helper takes a dtype, this token stands for both arguments.
STREAM = "bf16 stream"


def dt_args(dtype) -> tuple:
    """The dtype arguments of a pair-kernel call for ``dtype``."""
    return ("bfloat16", "bfloat16") if dtype == STREAM else (dtype,)


# ---------------------------------------------------------------------------
# each kernel against its plain version. The full run checks every kernel
# once, on the launch arguments its timing phase has already captured;
# tests/test_torch_cuda.py holds them at every shape and case through these
# same functions.
# ---------------------------------------------------------------------------


def bf16_ulp(x):
    mag = x.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def untied(args, dm, dts=("bfloat16", "bfloat16"), kern=k1):
    """dm zero at the maxima whose best two candidates nearly tie in the
    plain version, where kernel and plain version may rightly crown
    different columns. With bf16 operands (``dts`` one dtype) the kernels'
    FC2 sums on the tensor cores and the plain version in fmaf order agree
    on m to ~1e-7 relative: near is within 1e-5 relative. With the bf16
    stream pre2 is a bf16 value that two orders may round one ulp apart:
    near is within one bf16 ulp, exact ties included."""
    ties = []
    for _, nb, _, _, pre2 in kern._pair_chunks(*args, *dts):
        v = torch.where(nb[..., None], pre2, torch.full_like(pre2, -1e30))
        top = v.topk(2, dim=2).values
        best, second = top[:, :, 0], top[:, :, 1]
        near = (best - second <= bf16_ulp(best) if dts[1:] == ("bfloat16",)
                else best - second < 1e-5 * best)
        ties.append((best > 0) & near)
    return torch.where(torch.cat(ties, dim=1), torch.zeros_like(dm), dm)


def assert_m(x, y, dtype):
    """A forward's m against its plain version's: f32 rtol = atol = 1e-5;
    bf16 rtol = atol = 2e-2 and 1e-4 on 99% of the entries (one bf16 ulp
    of an h1 value may flip)."""
    x, y = x.cpu().numpy(), y.cpu().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(x, y, rtol=2e-2, atol=2e-2)
        assert np.mean(np.abs(x - y) > 1e-4) < 0.01


def assert_grads(got, want, dtype):
    """A backward's five gradients against the plain version's: d_a' and
    d_b' at :func:`assert_m`'s tolerances; the weight gradients, summed
    over every pair in another order, within 1e-4 of their largest
    entry."""
    for name, x, y in zip(("d_a'", "d_b'", "dWg", "dW2", "db2"), got, want):
        x, y = x.cpu().numpy(), y.cpu().numpy()
        if name in ("d_a'", "d_b'"):
            if dtype == "float32":
                np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5,
                                           err_msg=name)
            else:
                np.testing.assert_allclose(x, y, rtol=2e-2, atol=2e-2,
                                           err_msg=name)
                assert np.mean(np.abs(x - y) > 1e-4) < 0.01, name
        else:
            np.testing.assert_allclose(x, y, rtol=0,
                                       atol=1e-4 * np.abs(y).max(),
                                       err_msg=name)


def check_plain(kern, args, dm, dtype):
    """The forward and backward kernel (K1/K2, or K5/K6) against their
    plain versions on the launch arguments ``args``: m at
    :func:`assert_m`'s tolerances, the gradients at :func:`assert_grads`'
    (bf16: dm zero at the near-tied maxima)."""
    m = kern.launch_kernel(*args, dtype)
    m_plain = kern._reference_core(*args, dtype)
    if dtype != "float32":
        dm = untied(args, dm, (dtype,), kern)
    got = kern.launch_backward_kernel(*args, m, dm, dtype)
    want = kern.pair_pool_backward_reference(*args, m_plain, dm, dtype)
    torch.cuda.synchronize()
    assert_m(m, m_plain, dtype)
    assert_grads(got, want, dtype)


def check_launch_args(kern, fwd, args, dm, dtype):
    """The forward and backward kernel against their plain versions on a
    model's own launch arguments (``fwd`` a forward's, ``args`` and ``dm``
    a backward's): in f32 m bit-equal and the same winners (dm = 1: db2
    counts them, bit-equal); in bf16 m within :func:`assert_m`'s
    tolerances and the gradients with dm zero at the near-tied maxima; two
    backward launches bit-identical."""
    for a6 in (fwd, args):
        m = kern.launch_kernel(*a6, dtype)
        m_plain = kern._reference_core(*a6, dtype)
        torch.cuda.synchronize()
        assert (m > 0).any()
        if dtype == "float32":
            assert torch.equal(m, m_plain)
        else:
            assert_m(m, m_plain, dtype)
    if dtype == "float32":
        ones = torch.ones_like(dm)
        wins = kern.launch_backward_kernel(*args, m, ones, dtype)[4]
        plain_wins = kern.pair_pool_backward_reference(*args, m_plain, ones,
                                                       dtype)[4]
        assert torch.equal(wins, plain_wins)
    else:
        dm = untied(args, dm, (dtype,), kern)
    got = kern.launch_backward_kernel(*args, m, dm, dtype)
    again = kern.launch_backward_kernel(*args, m, dm, dtype)
    want = kern.pair_pool_backward_reference(*args, m_plain, dm, dtype)
    torch.cuda.synchronize()
    assert_grads(got, want, dtype)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def check_list(geom):
    """K1's list kernel on ``geom`` against its plain twin
    (``pairwise2.pair_list_reference``): every part's count, and the
    entries a part holds and their features bit for bit in the same order;
    the list the geometry was built with is the same list."""
    lst = k1.pair_list(geom)
    twin = k1.pair_list_reference(geom)
    torch.cuda.synchronize()
    cap = lst.ij.shape[-1]
    fits = torch.arange(cap, device=lst.ij.device) \
        < lst.count.clamp(max=cap)[..., None]
    for name, x, y in (("count", lst.count, twin.count),
                       ("entries", lst.ij[fits], twin.ij[fits]),
                       ("features", lst.g[fits], twin.g[fits]),
                       ("the geometry's count", geom.pairs.count, lst.count),
                       ("the geometry's entries", geom.pairs.ij[fits],
                        lst.ij[fits])):
        if not torch.equal(x, y):
            raise AssertionError(f"K1's list kernel: {name} differ")


def check_stream_k1(fwd, args):
    """K1's bf16 stream against its plain version on a forward's and a
    backward's launch arguments: every entry a bf16 value, at most one
    bf16 ulp apart (the tensor cores and the fmaf chain sum FC2 in
    different orders, ~1e-7 apart before the stream rounds), in at most 1%
    of the entries, and not the f32 stream's m."""
    for a6 in (fwd, args):
        m = k1.launch_kernel(*a6, *dt_args(STREAM))
        m_plain = k1._reference_core(*a6, *dt_args(STREAM))
        torch.cuda.synchronize()
        assert (m > 0).any()
        assert torch.equal(m.to(torch.bfloat16).float(), m)
        diff = (m - m_plain).abs()
        assert bool((diff <= bf16_ulp(m_plain)).all())
        assert (diff > 0).float().mean().item() <= 0.01
        assert not torch.equal(m, k1.launch_kernel(*a6, "bfloat16"))


def check_stream_k2(args, dm):
    """K2's bf16 stream against its plain backward at bf16's tolerances,
    with dm zero where the best two candidates lie within one bf16 ulp;
    two launches bit-identical; each winner found (dm = 1: db2 counts at
    least one per positive maximum)."""
    dts = dt_args(STREAM)
    m = k1.launch_kernel(*args, *dts)
    m_plain = k1._reference_core(*args, *dts)
    dm = untied(args, dm)
    got = k1.launch_backward_kernel(*args, m, dm, *dts)
    again = k1.launch_backward_kernel(*args, m, dm, *dts)
    want = k1.pair_pool_backward_reference(*args, m_plain, dm, *dts)
    torch.cuda.synchronize()
    assert_grads(got, want, "bfloat16")
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    db2 = k1.launch_backward_kernel(*args, m, torch.ones_like(dm), *dts)[4]
    assert bool((db2 >= (m > 0).sum(dim=(0, 1)).float()).all())


def check_scan(iou, thr):
    """K3 on the scan input ``iou`` [B, N, G] and K4 on each of its images,
    exactly as the plain scan; two K3 launches bit-identical."""
    got = k3.greedy_scan_batched(iou, thr)
    again = k3.launch_kernel(iou, thr)
    ones = [k3.greedy_scan(x, thr) for x in iou]
    want = k3.greedy_scan_reference(iou, thr)
    torch.cuda.synchronize()
    for x, y, z in zip(got, again, want):
        assert torch.equal(x, y)
        assert torch.equal(x.cpu(), z.cpu())
    for i, one in enumerate(ones):
        for x, z in zip(one, want):
            assert torch.equal(x.cpu(), z[i].cpu())


def check_k7(args, mode, tile_j):
    """K7 in ``mode`` at column tile ``tile_j`` against its plain version:
    the five f32 modes rtol = atol = 1e-5, ``bf3d`` within one bf16 step
    and bit-equal on 99%; rows without a neighbour at the same places; two
    launches bit-identical -> the plain version's output."""
    got = k7.pair_ablate(*args, mode, tile_j)
    again = k7.pair_ablate(*args, mode, tile_j)
    want = k7.pair_ablate_reference(*args, mode)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    x, y = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(x < -1e29, y < -1e29)
    if mode == "bf3d":
        np.testing.assert_allclose(x, y, rtol=2.0 ** -7, atol=0)
        assert np.mean(x == y) >= 0.99
    else:
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5)
    return want


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
# batches, captured launch arguments and the scan's input
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


# kernel -> (module, counted wrapper, counter); K1's and K2's bf16-stream
# instantiation (phase 17) is counted apart too, and its launches are also
# in K1's and K2's own counts; K1's list kernel runs once a forward of a
# pair_kernel 2 model
COUNTERS = {"pair_pool2_fwd": (k1, "pair_pool", "launches"),
            "pair_pool2_bwd": (k1, "pair_pool_backward", "launches"),
            "greedy_scan_batched": (k3, "greedy_scan_batched", "launches"),
            "greedy_scan": (k3, "greedy_scan", "launches"),
            "pair_pool_fwd": (k5, "pair_pool", "launches"),
            "pair_pool_bwd": (k5, "pair_pool_backward", "launches"),
            "pair_ablate": (k7, "pair_ablate", "launches"),
            "pair_pool2_fwd_bf16_stream": (k1, "pair_pool", "launches_ew"),
            "pair_pool2_bwd_bf16_stream": (k1, "pair_pool_backward",
                                           "launches_ew"),
            "pair_pool2_fwd_list": (k1, "pair_list", "launches")}


def reset_counts():
    for module, fn, attr in COUNTERS.values():
        setattr(getattr(module, fn), attr, 0)


def counts() -> dict:
    return {name: getattr(getattr(module, fn), attr)
            for name, (module, fn, attr) in COUNTERS.items()}


def want_counts(**nonzero) -> dict:
    """Every kernel's expected launches: ``nonzero``, the rest 0."""
    return {name: nonzero.get(name, 0) for name in COUNTERS}


def state_params(state) -> dict:
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def phase_training(tmp: Path):
    """The main path of this slice: config 2 trains on the card through K1,
    K2 and K3, writes its checkpoints, and resumes from one bit for
    bit."""
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
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts()
    steps = state.step
    log(f"  {steps} steps in {run_s:.1f} s (first steps include warm-up); "
        f"launches {launches}")
    blocks = cfg.model.num_blocks
    runs = steps + state.graphs.captures
    # Each step replays its shape's graph; each capture followed one eager
    # step.
    want = want_counts(pair_pool2_fwd=blocks * runs,
                       pair_pool2_bwd=blocks * runs,
                       greedy_scan_batched=runs, pair_pool2_fwd_list=runs)
    if launches != want:
        raise AssertionError(f"launches {launches} != {want} (16 K1 + 16 K2 "
                             f"+ 1 K3 + 1 list per step)")
    log(f"  = {blocks} K1 + {blocks} K2 + 1 K3 + 1 list kernel per step "
        f"over {steps} "
        f"replayed steps and {state.graphs.captures} eager step(s) before "
        f"a capture")

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
    trace, kernel events only -> (busy ms per call, {kernel name: ms per
    call}); (0.0, {}) when the trace holds no device time. A user
    annotation (an optimizer's step range) also carries device time,
    spanning the kernels inside it, and is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {e.key: e.device_time_total / 1e3 / reps
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0
               and not getattr(e, "is_user_annotation", False)
               and "#" not in e.key}
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
                                geom.neighbor_iou)._replace(
                                    flags=geom.flags, tile=geom.tile,
                                    pairs=None)
    return geom


def pair_counts(geom) -> tuple[int, int]:
    """(neighbour pairs, IoU tests) of one pair stage on this run's data:
    the valid pairs with IoU >= the threshold, and the valid pairs of the
    active tiles at the geometry's skip tile. ``geom`` is K1's geometry or
    K5's columns."""
    geom = k1_geometry(geom)
    rv, cv = geom.row[:, 7] > 0, geom.col[:, 7] > 0
    pair_valid = rv[:, :, None] & cv[:, None, :]
    nb = neighbour_mask(geom).sum().item()
    nr, nc = geom.row.shape[2], geom.col.shape[2]
    fi, tj = geom.tile
    active = geom.flags.repeat_interleave(fi, 1)[:, :nr] \
        .repeat_interleave(tj, 2)[:, :, :nc] > 0
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
    w of its four takes a quarter of each TJ detections of the other side
    (the geometry's skip tile) in steps of two, the ``splits`` blocks that
    share the own detections take the steps round robin, and a warp pops
    groups of ``group`` pairs; only its last group can be short.
    pairs / slots is the share of stage B's lanes on a real pair."""
    nb = neighbour_mask(k1_geometry(geom))
    tj = geom.tile[1]
    if side == "cols":
        nb = nb.transpose(1, 2)
    bsz, nown, noth = nb.shape
    per_tile = torch.nn.functional.pad(nb, (0, 0, 0, -nown % k1.TILE_I)) \
        .view(bsz, -1, k1.TILE_I, noth).sum(dim=2)           # [B, NT, NOTH]
    j = torch.arange(noth, device=nb.device)
    item = j // tj * (tj // 8) + j % (tj // 4) // 2   # a step of two tests
    key = item % splits * 4 + j % tj // (tj // 4)
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
        geom.flags.shape[0] * -(-geom.row.shape[2] // k1.TILE_I),
        geom.flags.shape[2],
        torch.cuda.get_device_properties(0).multi_processor_count,
        geom.tile[1])
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
    m = kern._reference_core(*args, *dt_args(dtype))
    pairs = wins = 0
    for rows, nb, _, _, pre2 in kern._pair_chunks(*args, *dt_args(dtype)):
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
    (and K6's per-pair features), or, where K2 reads the geometry's
    neighbour list, its entries read once instead (the tests are the list
    kernel's, :func:`list_bound`); each input read and each output written
    once: d_b' counts as its [B, NC, P] floats, which is what K2's column
    pass writes (K6 still sums a per-row-tile partial on top)."""
    geom, a2, b2, wg_k, w2, b2bias = args
    p, k = a2.shape[-1], wg_k.shape[0]
    nb, tested = pair_counts(geom)
    listed = getattr(geom, "pairs", None) is not None
    tested = 0 if listed else tested
    winners = kern.launch_backward_kernel(*args, m, torch.ones_like(dm),
                                          *dt_args(dtype))[4].sum().item()
    fc1 = (k + 6) * p if kern is k1 else 2 * k * p + 4 * p
    mlp = (nb * (2 * p * p + fc1 + 3 * p + 2 * k * p)
           + winners * (4 * p + 1))
    features = nb * FEATURE_OPS if kern is k5 else 0
    ops_s = mlp / (PEAK_F32 if dtype == "float32" else PEAK_BF16) \
        + (tested * IOU_OPS + features) / PEAK_F32
    nbytes = sum(t.numel() * t.element_size() for t in
                 (geom.row, geom.col, a2, b2, wg_k, w2, b2bias, geom.flags,
                  m, dm)) + 4 * (a2.numel() + b2.numel() + wg_k.numel()
                                 + w2.numel() + b2bias.numel()) \
        + (list_entries(geom.pairs) * LIST_ENTRY_BYTES if listed else 0)
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
    geom = args[0]
    list_ms = cuda_time(lambda: k1.pair_list(geom), iters=50)
    list_dev = device_ms(lambda: k1.pair_list(geom))
    list_plain_ms = cuda_time(lambda: k1.pair_list_reference(geom), iters=2,
                              warmup=1)
    list_bound_ms, list_by, list_how = list_bound(geom)
    # each kernel against its plain version on the trained step's arguments
    for dt in (dtype, "float32"):
        check_launch_args(k1, args, args, dm, dt)
    check_list(geom)
    check_scan(iou, thr)
    log(f"  K1/K2 ({dtype} and float32) on the trained step's last block, "
        f"K1's list kernel on its geometry, and K3/K4 on its scan input "
        f"T={len(thr)} (K4 on each of its {iou.shape[0]} images): as their "
        f"plain versions")

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
    took = f"{list_dev:.4f} ms on the device" if list_dev else "not measured"
    log(f"  K1's list kernel: {list_ms:.4f} ms/launch (events), {took}; "
        f"plain {list_plain_ms:.3f} ms; bound {list_bound_ms:.5f} ms "
        f"({list_by}: {list_how})")
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
        "pair_pool2_fwd_list": dict(ms=list_ms, plain_ms=list_plain_ms,
                                    bound_ms=list_bound_ms,
                                    bound_by=list_by),
    }


# ---------------------------------------------------------------------------
# K7: the per-tile ablation of the pair tile
# ---------------------------------------------------------------------------

K7_ARGS = ("cols", "a", "b", "wg", "w2", "b2")


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
    inputs = kernel_ablate.probe_inputs(device=DEV)
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
        check_k7(args, mode, 64)
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


def phase_evaluate(tmp: Path) -> dict:
    """This slice's main path: the evaluation CLI's ``main`` on the card at
    config 2's full width and depth, then a training run that evaluates as
    it goes and the CLI reading its best checkpoint -> the launches of the
    counted evaluation."""
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
    want = want_counts(pair_pool2_fwd=blocks * (len(batches) + shapes),
                       pair_pool2_fwd_list=len(batches) + shapes)
    log(f"  evaluate.main: {wall:.2f} s wall (model build and captures "
        f"included); launches {launches}: {blocks} K1 x ({len(batches)} "
        f"replayed batches + {shapes} eager forward before a capture)")
    if launches != want:
        raise AssertionError(f"evaluation launches {launches} != {want} "
                             f"({blocks} K1 and 1 list per batch, nothing "
                             f"else)")
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
        pair_pool2_bwd=blocks * runs, greedy_scan_batched=runs,
        pair_pool2_fwd_list=runs + evals * val_batches + eval_shapes)
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
    return launches


def k5_bound(args, dtype) -> tuple[float, str, str]:
    """The least time for K5's work on these inputs: every neighbour pair
    through the features and the MLP (FC1 over G features, FC2), the IoU
    tests of the active tiles, each input read and the output written
    once."""
    cols, a, b, wg, w2, b2bias = args
    p, g = a.shape[-1], wg.shape[0]
    nb, tested = pair_counts(cols)
    mlp = nb * (2 * p * p + 2 * g * p + 4 * p)
    ops_s = mlp / (PEAK_F32 if dtype == "float32" else PEAK_BF16) \
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


def k5_k6_times(label, fwd_args, bwd_args) -> dict:
    """K5 and K6 ms/launch on launch arguments captured from the model,
    beside their plain versions and bounds, and held against them
    (:func:`check_launch_args`) -> the times."""
    dtype = fwd_args[-1]
    args, m, dm = bwd_args[:6], bwd_args[6], bwd_args[7]
    k5_ms = cuda_time(lambda: k5.launch_kernel(*fwd_args), iters=20)
    k6_ms = cuda_time(lambda: k5.launch_backward_kernel(*bwd_args), iters=10)
    k5_dev = device_ms(lambda: k5.launch_kernel(*fwd_args))
    k6_dev = device_ms(lambda: k5.launch_backward_kernel(*bwd_args))
    k5_plain, _ = cuda_once(lambda: k5._reference_core(*fwd_args))
    m_plain = k5._reference_core(*args, dtype)
    k6_plain, _ = cuda_once(lambda: k5.pair_pool_backward_reference(
        *args, m_plain, dm, dtype))
    check_launch_args(k5, fwd_args[:6], args, dm, dtype)
    log(f"  {label}: K5/K6 {dtype} on these arguments as their plain "
        f"versions")
    log_queues(label, args, m, dtype, kern=k5)
    k5_b, k5_by, k5_how = k5_bound(fwd_args[:6], dtype)
    k6_b, k6_by, k6_how = k2_bound(args, m, dm, dtype, kern=k5)
    log(f"  {label}: K5 {dtype} {k5_ms:.4f} ms/launch (events), "
        f"{k5_dev:.4f} ms on the device (profiler; 0: not measured), plain "
        f"{k5_plain:.3f} ms, bound {k5_b:.5f} ms ({k5_by}: {k5_how})")
    log(f"  {label}: K6 {dtype} {k6_ms:.4f} ms/launch (events), "
        f"{k6_dev:.4f} ms on the device (profiler; 0: not measured), plain "
        f"{k6_plain:.3f} ms, bound {k6_b:.5f} ms ({k6_by}: {k6_how})")
    return {"pair_pool_fwd": dict(ms=k5_ms, plain_ms=k5_plain,
                                  bound_ms=k5_b, bound_by=k5_by),
            "pair_pool_bwd": dict(ms=k6_ms, plain_ms=k6_plain,
                                  bound_ms=k6_b, bound_by=k6_by)}


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


def bench_k5_k6_times() -> None:
    """K5/K6 at the serving bench batch (B=8, N=1024, clustered) of the
    serving_bucketed model with pair_kernel 1, timed."""
    cfg = load_config(experiment_path("serving_bucketed"),
                      {"model": {"pair_kernel": 1}})
    model = training.build_model(cfg, "kernel", DEV)
    model.load_state_dict(as_state_dict(init_params(cfg.model, seed=0)))
    fwd, bwd = capture_pair(k5, model, *sorted_bench_batch(8, 1024))
    k5_k6_times("serving bench B=8 N=1024", fwd, bwd)


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


def phase_crowd_times(state, cfg, batch) -> dict:
    log("  times at config 4 (B=2, N=4096), pair products in "
        f"{cfg.model.pair_matmul_dtype}")
    dev = torch.device(DEV)
    arrays = training.batch_to_device(batch, dev)
    model = state.model
    det = (arrays["boxes"], arrays["scores"], arrays["valid"])
    fwd, bwd = capture_pair(k5, model, *det)
    times = k5_k6_times("config 4 B=2 N=4096", fwd, bwd)
    # K1/K2 on the same batch and weights, to say where each pair kernel
    # is faster (pair_kernel 1 is the reference's default)
    other = training.build_model(
        crowd_config(pair_kernel=2), "kernel", DEV)
    other.load_state_dict(model.state_dict())
    fwd2, bwd2 = capture_pair(k1, other, *det)
    k1_ms = cuda_time(lambda: k1.launch_kernel(*fwd2), iters=20)
    k2_ms = cuda_time(lambda: k1.launch_backward_kernel(*bwd2), iters=10)
    list_ms = cuda_time(lambda: k1.pair_list(bwd2[0]), iters=20)
    check_list(bwd2[0])
    log(f"  config 4 B=2 N=4096, same batch and weights: K1 {fwd2[-1]} "
        f"{k1_ms:.4f} ms/launch, K2 {k2_ms:.4f} ms/launch, K1's list "
        f"kernel {list_ms:.4f} ms a forward, as its plain twin (K5 "
        f"{times['pair_pool_fwd']['ms']:.4f}, K6 "
        f"{times['pair_pool_bwd']['ms']:.4f})")
    # K3 on the scan input of config 4's training step
    iou, thr = capture(k3, "greedy_scan_batched",
                       lambda: training.train_step(state, arrays, cfg))
    k3_ms = cuda_time(lambda: k3.launch_kernel(iou, thr), iters=50)
    k3_dev, _ = scan_device_ms(lambda: k3.launch_kernel(iou, thr))
    k3_plain_ms = cuda_time(lambda: k3.greedy_scan_reference(iou, thr),
                            iters=1, warmup=1)
    check_scan(iou, thr)
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
    return times


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
                              "greedy_scan_batched": runs,
                              "pair_pool2_fwd_list": runs if pk == 2 else 0})
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


# ---------------------------------------------------------------------------
# K1 / K2 at the shapes the main paths give them, and the sparse training fill
# ---------------------------------------------------------------------------

PAIR_SHAPES = ("bench B=8 N=1024", "config 2 B=8 N=1024", "config 4 B=2 N=4096",
               "evaluation B=8 N=256", "sparse fill B=8 N=256",
               "crowd fill B=2 N=4096")
# the sparse and crowd training cells' pools: the scale drill's `full` and
# `dense_4k` persons (portbench/traffic/mixes/sparse_persons_roidb.json,
# crowd_4096_roidb.json)
SPARSE_POOL_SEED = 20170721


def drill_fill_batch(dev, preset: str, b: int, n: int):
    """The first ``b`` images of a training cell's pool (the scale drill's
    ``preset`` draw, persons), padded to N=``n`` -> boxes, scores, valid
    on ``dev``."""
    from portbench.traffic import drill

    images = drill.draw(SPARSE_POOL_SEED, f"pool.{preset}", preset, b, n)
    boxes = np.zeros((b, n, 4), np.float32)
    scores = np.zeros((b, n), np.float32)
    valid = np.zeros((b, n), bool)
    for i, im in enumerate(images):
        k = len(im.scores)
        boxes[i, :k], scores[i, :k], valid[i, :k] = im.boxes, im.scores, True
    return [torch.from_numpy(x).to(dev) for x in (boxes, scores, valid)]


def sparse_fill_batch(dev):
    """Eight images of the sparse training cell's pool (``full``, 3-60
    detections an image) at N=256."""
    return drill_fill_batch(dev, "full", 8, 256)


def crowd_fill_batch(dev):
    """Two images of the crowd training cell's pool (``dense_4k``, config
    4's published batch: 1,600-2,900 detections an image) at N=4096."""
    return drill_fill_batch(dev, "dense_4k", 2, 4096)


def seeded_model(cfg):
    model = training.build_model(cfg, "kernel", DEV)
    model.load_state_dict(as_state_dict(init_params(cfg.model, seed=0)))
    return model


def pair_shape_args() -> dict:
    """K1's and K2's launch arguments as the 16-block models give them
    (first block's forward, last block's backward; seeded weights; the
    model's own dtype, bf16) at the serving bench batch, config 2's training
    batch, config 4's batch through ``pair_kernel: 2`` and an evaluation
    batch of config 2, and a batch of the sparse and of the crowd training
    cells' fills (the crowd's through config 4's model)."""
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
    out[PAIR_SHAPES[4]] = capture_pair(k1, model2, *sparse_fill_batch(dev))
    out[PAIR_SHAPES[5]] = capture_pair(k1, seeded_model(cfg4),
                                       *crowd_fill_batch(dev))
    return out


def k2_launches(by_name: dict) -> str:
    """A K2 call's device time by launch, from ``profile_kernels``' names:
    its row grid, its column grid (a tree older than the records runs both
    passes as one grid in bf16 mode), its ordered sum and its sets."""
    parts = {}
    for key, ms in by_name.items():
        if "pair_pool2_bwd_kernel_sum" in key:
            part = "sum"
        elif "pair_pool2_bwd_pass_kernel" in key:
            # the last template argument is ROWSIDE
            rowside = key[key.index("<") + 1:key.index(">")].split(",")[-1]
            part = "row grid" if rowside.strip() == "true" else "column grid"
        elif "pair_pool2_bwd_kernel" in key:
            part = "one grid of both passes"
        elif "memset" in key.lower():
            part = "sets"
        else:
            part = key[:40]
        parts[part] = parts.get(part, 0.0) + ms
    return ", ".join(f"{part} {ms:.4f}" for part, ms in parts.items())


def k2_blocks(args, m, dm, dtype) -> str:
    """Device activities (kernels, sets) of one K2 call (profiler), its
    device ms by launch, the share of its grids' blocks that had a step and
    the share of its column blocks with a step that summed the row pass's
    records (the kernel's own counts; a tree that has no such count says
    so)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    m_dt = k1.launch_kernel(*args, dtype)

    def call():
        return k1.launch_backward_kernel(*args, m_dt, dm, dtype)

    call()
    torch.cuda.synchronize()
    reps = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    # the trace's device activities (kernels, sets, copies) over the calls
    kernels = sum(e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  for e in prof.events()) / reps
    out = (f"{kernels:.2f} device activities a call (profiler)" if kernels
           else "launches not measured")
    busy, by_name = profile_kernels(call, reps)
    if busy:
        out += f"; device ms a call by launch: {k2_launches(by_name)}"
    bwd = k1.pair_pool_backward
    if not hasattr(bwd, "blocks_with_work"):
        return out + "; no count of blocks with a step in this tree"
    launched, worked = bwd.blocks_launched, bwd.blocks_with_work()
    columns = bwd.column_blocks() if hasattr(bwd, "column_blocks") else None
    call()
    launched, worked = (bwd.blocks_launched - launched,
                        bwd.blocks_with_work() - worked)
    out += (f"; blocks with a step {worked} of {launched} "
            f"({100.0 * worked / launched:.2f}%)")
    if columns is None:
        return out + "; no records in this tree"
    records, recomputed = (x - y for x, y in zip(bwd.column_blocks(),
                                                 columns))
    share = 100.0 * records / max(records + recomputed, 1)
    return (out + f"; column blocks with a step that summed records "
            f"{records} of {records + recomputed} ({share:.2f}%)")


def record_fill(args, dm, dtype) -> str:
    """K2's records against their room, counted with the plain version on
    its own m: the pairs that win some q (m > 0, dm != 0) over the 32 x P
    slots of every image's row tiles of 32, and the fullest tile's."""
    geom, a2 = args[0], args[1]
    bsz, nr, p = a2.shape
    cap = 32 * p
    m = k1._reference_core(*args, *dt_args(dtype))
    per_tile = torch.zeros((bsz, -(-nr // 32)), dtype=torch.int64,
                           device=a2.device)
    for rows, nb, _, _, pre2 in k1._pair_chunks(*args, *dt_args(dtype)):
        mr, dr = m[:, rows, None, :], dm[:, rows, None, :]
        wins = (nb[..., None] & (pre2 == mr) & (mr > 0) & (dr != 0))
        per_row = wins.any(dim=-1).sum(dim=-1)              # [B, rows]
        tiles = torch.arange(rows.start, rows.stop, device=a2.device) // 32
        per_tile.index_add_(1, tiles, per_row)
    total = int(per_tile.sum().item())
    return (f"records {total} of {per_tile.numel() * cap} slots "
            f"({100.0 * total / (per_tile.numel() * cap):.2f}%), the "
            f"fullest row tile {int(per_tile.max().item())} of {cap} "
            f"(plain version, {dtype})")


def list_entries(lst) -> int:
    """The entries a neighbour list holds (a part's first ``cap``)."""
    return int(lst.count.clamp(max=lst.ij.shape[-1]).sum())


def list_bound(geom) -> tuple[float, str, str]:
    """The least time for the list kernel's work on ``geom``: the IoU tests
    of the active tiles' valid pairs; the fields and flags read once, and
    each entry (20 bytes: its pair and four features) and the counts
    written once."""
    lst = geom.pairs
    _, tested = pair_counts(geom)
    entries = list_entries(lst)
    ops_s = tested * IOU_OPS / PEAK_F32
    nbytes = sum(t.numel() * t.element_size()
                 for t in (geom.row, geom.col, geom.flags, lst.count)) \
        + entries * LIST_ENTRY_BYTES
    bytes_s = nbytes / PEAK_BYTES
    how = f"{tested} IoU tests, {entries} entries, {nbytes / 1e6:.2f} MB"
    return max(ops_s, bytes_s) * 1e3, \
        "operations" if ops_s >= bytes_s else "bytes", how


def list_line(geom) -> str:
    """K1's list kernel on this geometry: its device ms and bound, the
    entries it writes, the row tiles whose list overflowed among those
    with a neighbour, and the list's bytes (a tree without the kernel says
    so)."""
    if not hasattr(k1, "pair_list"):
        return "no list kernel in this tree"
    ms = device_ms(lambda: k1.pair_list(geom))
    lst = geom.pairs
    working = int((lst.count.sum(-1) > 0).sum())
    dense = int((k1.list_groups(lst, 16) < 0).sum())
    mb = sum(t.numel() * t.element_size() for t in lst) / 1e6
    bound = list_bound(geom)
    took = f"{ms:.4f} ms on the device (profiler)" if ms else "not measured"
    return (f"list kernel {took}, bound {bound[0]:.5f} ms ({bound[1]}: "
            f"{bound[2]}); {list_entries(lst)} entries, dense row tiles "
            f"{dense} of {working} with a neighbour, {mb:.1f} MB")


def phase_pair_shapes(queues: bool = True) -> dict:
    """K1 and K2 on the models' own launch arguments at the six shapes of
    the main paths: with ``queues`` the fill of stage B's groups and the
    length of the winner queue beside the old lane use, then ms/launch of
    both in bf16 and f32 -> {shape: times}. Their correctness on these
    arguments: ``tests/test_torch_cuda.py -k main_path``."""
    log("phase 9b: K1 and K2 on the models' launch arguments at "
        + "; ".join(PAIR_SHAPES))
    times = {}
    for label, (fwd, bwd) in pair_shape_args().items():
        dtype = fwd[-1]
        args, m, dm = bwd[:6], bwd[6], bwd[7]
        geom = args[0]
        bsz, nr, p = args[1].shape
        if queues:
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
            log(f"  {label} {dt}: K2 {k2_blocks(args, m, dm, dt)}")
        log(f"  {label}: K2 {record_fill(args, dm, dtype)}")
        log(f"  {label}: {list_line(fwd[0])}")
        log(f"  {label} bounds, {dtype}: K1 {bound1[0]:.5f} ms ({bound1[1]}); "
            f"K2 {bound2[0]:.5f} ms ({bound2[1]}: {bound2[2]})")
    return times


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
    at the six shapes, bf16 and f32. The differences are no sum of parts:
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
                launch.col_splits = lambda blocks, nj, sms, tj=64: splits
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
    """Who sets K3's pace: the kernel as built and rebuilt with the chain's
    bit test a no-op (the producers' pace; outputs wrong, not read), timed
    on the device."""
    inputs = scan_time_inputs()
    flags = build.NVCC_FLAGS
    log("K3/K4 by build: device ms per launch (profiler) at "
        + "; ".join(inputs))
    try:
        for name, extra in SCAN_BUILDS:
            build.NVCC_FLAGS = flags + extra
            build._loaded.pop("matching_scan", None)
            build.build(["matching_scan"])
            cells = [f"{scan_device_ms(lambda: k3.launch_kernel(x, t))[0]:.4f}"
                     for x, t in inputs.values()]
            log(f"  {name:<30} {' '.join(cells)}")
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
    through the MLP, each input read and the output written once. K1 reads
    its pairs from the geometry's neighbour list (its entries read once;
    the list kernel's IoU tests are that kernel's, :func:`list_bound`); a
    tree without the list tests the active tiles' valid pairs itself."""
    geom, a2, b2, wg_k, w2, b2bias = args
    p, k = a2.shape[-1], wg_k.shape[0]
    nb_pairs, tested = pair_counts(geom)
    listed = getattr(geom, "pairs", None) is not None
    ops_s = nb_pairs * (2 * p * p + (k + 6) * p) / (
        PEAK_F32 if dtype == "float32" else PEAK_BF16) \
        + (0 if listed else tested * IOU_OPS / PEAK_F32)
    nbytes = sum(t.numel() * t.element_size() for t in
                 (geom.row, geom.col, a2, b2, wg_k, w2, b2bias, geom.flags)) \
        + a2.numel() * 4 \
        + (list_entries(geom.pairs) * LIST_ENTRY_BYTES if listed else 0)
    bytes_s = nbytes / PEAK_BYTES
    return max(ops_s, bytes_s) * 1e3, \
        "operations" if ops_s >= bytes_s else "bytes"


# ---------------------------------------------------------------------------
# Phase 14: serving trained weights
# ---------------------------------------------------------------------------

SERVE_WAIT_S = 300          # every socket read, join and CLI line waits this
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


def tcp_client(port, requests, binary=False) -> list:
    """Sends ``requests`` ((id, image) or raw JSON text) one at a time on
    one connection -> the replies (dicts, or read_frame tuples)."""
    out = []
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=SERVE_WAIT_S) as s:
        f = s.makefile("r")
        for req in requests:
            if binary:
                s.sendall(bin_frame(*req))
                out.append(read_frame(s))
            else:
                s.sendall(req.encode() if isinstance(req, str)
                          else json_line(*req))
                out.append(json.loads(f.readline()))
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
            pair_pool2_fwd=blocks * server.stats["batches"],
            pair_pool2_fwd_list=server.stats["batches"]):
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
            pair_pool2_fwd=blocks * 2 * len(buckets),
            pair_pool2_fwd_list=2 * len(buckets)):
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

    return tcp_launches + file_launches


def bench_images():
    """The bench's images: 8 clustered layouts of 896 detections."""
    rng = np.random.default_rng(0)
    return [(r.det_boxes, r.det_scores, None) for r in
            (layout_record(rng, i, "clustered", 1024) for i in range(8))]


def phase_serve_times(card: str) -> None:
    """Phase 14g, for information: TCP request latency of closed-loop
    clients on the bench's images, with the 16-block serving_bucketed
    model (seeded weights), the clients as subprocesses and, for the same
    requests, as threads of this process; then serve_stream's JSON-lines
    stream through rescore_stream."""
    cfg = load_config(experiment_path("serving_bucketed"))
    rescorer = Rescorer(cfg, init_params(cfg.model, seed=0), device=DEV)
    log(f"phase 14g: serving times on the bench's images (8 x 896 "
        f"detections, bucket 1024), {SERVE_REQUESTS} requests per client "
        f"[{card}]")
    tcp_times(rescorer, card, threads=True)


# (label, clients, protocol, clients as threads of this process) of the
# TCP rows; the thread rows (phase 14g only) repeat the row before them
TCP_ROWS = (("1 JSON client", 1, "", False),
            ("4 JSON clients", 4, "", False),
            ("4 JSON clients, threads", 4, "", True),
            ("16 JSON clients", 16, "", False),
            ("16 JSON clients, threads", 16, "", True),
            ("1 binary client", 1, "bin", False),
            ("16 binary clients", 16, "bin", False))


def tcp_times(rescorer, tag: str, threads: bool = False) -> None:
    """The TCP server on ``rescorer`` (its start() warms every padded
    shape of every bucket, default batching) under the TCP_ROWS' closed-
    loop clients, each sending the bench's images SERVE_REQUESTS times:
    ``tools/tcp_bench_client.py`` as subprocesses and, with ``threads``,
    the same client's ``run`` in threads of this process, so that two
    rows differ by the clients' host alone. Then two JSON-lines streams
    through serve_stream; logs each with ``tag``."""
    from gossipnet_tpu_torch.tools import bench_serving, tcp_bench_client

    images = bench_images()
    rows = [r for r in TCP_ROWS if threads or not r[3]]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "images.npz"
        tcp_bench_client.save_images(path, images)
        server = serving.TcpServer(rescorer, port=0, threshold=0.5).start()
        try:
            for label, n_clients, proto, in_threads in rows:
                before = server.stats_snapshot()
                if in_threads:
                    reports = run_clients([(tcp_bench_client.run, (
                        server.port, c, SERVE_REQUESTS, proto, path))
                        for c in range(n_clients)])
                else:
                    reports = bench_serving.run_clients(
                        server.port, n_clients, SERVE_REQUESTS, proto, path)
                after = server.stats_snapshot()
                lat = [x for r in reports for x in r["lats"]]
                if len(lat) != n_clients * SERVE_REQUESTS:
                    raise AssertionError(f"TCP {label}: {len(lat)} replies "
                                         f"of {n_clients * SERVE_REQUESTS}")
                # the overlap of the clients' run windows
                wall = (max(r["t1"] for r in reports)
                        - min(r["t0"] for r in reports))
                n = after["images"] - before["images"]
                batches = after["batches"] - before["batches"]
                ms = np.asarray(lat) * 1e3
                log(f"  TCP {label}: request latency p50 "
                    f"{np.percentile(ms, 50):.3f} ms, p99 "
                    f"{np.percentile(ms, 99):.3f} ms; {n / wall:.1f} "
                    f"images/s; mean batch {n / batches:.3f} ({n} images in "
                    f"{batches} batches) [{tag}]")
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
# phase 15: the captured paths against the eager ones, timed
# ---------------------------------------------------------------------------

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


def train_batches(data: dict, b: int, cfg, count: int) -> list[dict]:
    it = BatchIterator(synthetic_roidb(**data), b, cfg.data.bucket_sizes)
    return [training.host_arrays(next(it)) for _ in range(count)]


def twin_states(cfg):
    """Two training states on the same seeded weights."""
    return [training.create_train_state(
        cfg, training.build_model(cfg, "kernel", DEV)) for _ in range(2)]


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
    log(f"  warmup(batch_size=8): {len(secs)} graphs in {warm_s:.2f} s; "
        f"seconds per shape (eager run + capture): "
        f"{ {k: round(v, 4) for k, v in secs.items()} }; memory reserved "
        f"{base / 2**20:.1f} MiB before, "
        f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB after (in use "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB) [{card}]")
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


# ---------------------------------------------------------------------------
# phase 16: the measuring tools on the card
# ---------------------------------------------------------------------------

# Phase 16 imports the tools where it uses them: the timing modes
# (--pair-times, --scan-times) stay runnable beside a tree older than them.
PROBE_ITERS = "5"


def phase_tools(card: str) -> dict:
    """Phase 16: each measuring tool's ``main()`` as a user runs it, at full
    width with its default arguments -> the launches of the tools' runs.
    The pair kernels on the tools' blob batches and the bench's captured
    loop body are checked by ``tests/test_torch_cuda.py -k "blob or
    bench_loop"``."""
    from gossipnet_tpu_torch.tools import bench as bench_tool
    from gossipnet_tpu_torch.tools import bench_serving, bench_suite, probe
    from gossipnet_tpu_torch.tools import entry as entry_tool

    log("phase 16: the measuring tools on the card")
    t0 = time.perf_counter()
    reset_counts()
    steps = [("tools.entry", lambda: entry_tool.main([]))]
    for layout in BENCH_LAYOUTS:
        steps.append((f"tools.bench --layout {layout}",
                      lambda layout=layout: bench_tool.main(
                          ["--layout", layout])))
    steps.append(("tools.bench_suite", lambda: bench_suite.main([])))
    for mode in probe.MODES:
        steps.append((f"tools.probe {mode}", lambda mode=mode: probe.main(
            [mode, "--iters", PROBE_ITERS])))
    for mode in ("forward", "step"):
        steps.append((f"tools.probe {mode} --impl pallas1",
                      lambda mode=mode: probe.main(
                          [mode, "--impl", "pallas1", "--iters",
                           PROBE_ITERS])))
    steps.append(("tools.bench_serving", lambda: bench_serving.main([])))
    for name, run in steps:
        t1 = time.perf_counter()
        log(f"  $ python -m gossipnet_tpu_torch.{name}")
        run()
        log(f"  {name}: {time.perf_counter() - t1:.1f} s [{card}]")
    launches = counts()
    log(f"  phase 16: {time.perf_counter() - t0:.1f} s; launches of the "
        f"tools' runs {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 17: the reduced-precision knobs
# ---------------------------------------------------------------------------

# model overrides of each knob (pair_elementwise_dtype streams K1/K2 in bf16)
KNOBS = {"bf16 stream": {"pair_elementwise_dtype": "bfloat16"},
         "model.dtype bf16": {"dtype": "bfloat16"},
         "both": {"dtype": "bfloat16", "pair_elementwise_dtype": "bfloat16"}}
PRECISION_STEPS = 5      # captured steps of each knob's run
STREAM_SHAPES = ("bench B=8 N=1024", "config 2 B=8 N=1024")


def stream_shape_args() -> dict:
    """K1's and K2's launch arguments with the bf16 stream as the 16-block
    models give them (first block's forward, last block's backward,
    seeded weights): the serving bench batch and config 2's training
    batch."""
    knob = KNOBS["bf16 stream"]
    bench = seeded_model(load_config(experiment_path("serving_bucketed"),
                                     {"model": knob}))
    cfg2 = seeded_model(load_config(experiment_path("coco_persons_full"), {
        "data": {"dataset": "synthetic"}, "model": knob}))
    arrays = training_batch()
    return {
        STREAM_SHAPES[0]: capture_pair(k1, bench, *sorted_bench_batch(8, 1024)),
        STREAM_SHAPES[1]: capture_pair(k1, cfg2, arrays["boxes"],
                                       arrays["scores"], arrays["valid"])}


def phase_stream_times(shapes: dict, card: str) -> dict:
    """17b: K1 and K2 with the bf16 stream against their f32-stream
    instantiations (both bf16 operands), in turns in one call, at the
    bench batch and config 2's batch; the stream's plain versions and
    bounds -> the record's times (K1 at the bench batch, K2 at config
    2's)."""
    log(f"phase 17b: K1 and K2, bf16 stream against f32 stream, in turns "
        f"(ms/launch: events, host, host, events; device by the profiler) "
        f"[{card}]")
    out = {}
    for label in STREAM_SHAPES:
        fwd, bwd = shapes[label]
        a6, args, dm = fwd[:6], bwd[:6], bwd[7]
        m_s = k1.launch_kernel(*args, *dt_args(STREAM))
        m_b = k1.launch_kernel(*args, "bfloat16")
        fns = {"K1 bf16 stream": lambda: k1.launch_kernel(
                   *a6, *dt_args(STREAM)),
               "K1 f32 stream": lambda: k1.launch_kernel(*a6, "bfloat16"),
               "K2 bf16 stream": lambda: k1.launch_backward_kernel(
                   *args, m_s, dm, *dt_args(STREAM)),
               "K2 f32 stream": lambda: k1.launch_backward_kernel(
                   *args, m_b, dm, "bfloat16")}
        runs = in_turns(fns, iters=20)
        for name, ms in runs.items():
            dev = device_ms(fns[name])
            log(f"  {label}, {name}: {', '.join(f'{x:.4f}' for x in ms)} "
                f"ms; device {f'{dev:.4f} ms' if dev else 'not measured'}")
        plain1 = cuda_time(lambda: k1._reference_core(*a6, *dt_args(STREAM)),
                           iters=2, warmup=1)
        plain2 = cuda_time(lambda: k1.pair_pool_backward_reference(
            *args, m_s, dm, *dt_args(STREAM)), iters=1, warmup=1)
        check_stream_k1(a6, args)
        check_stream_k2(args, dm)
        b1, b2 = k1_bound(a6, STREAM), k2_bound(args, m_s, dm, STREAM)
        log(f"  {label}: plain K1 {plain1:.3f} ms, plain K2 {plain2:.3f} ms;"
            f" bounds K1 {b1[0]:.5f} ms ({b1[1]}), K2 {b2[0]:.5f} ms "
            f"({b2[1]}: {b2[2]})")
        out[label] = (
            dict(ms=float(np.median(runs["K1 bf16 stream"][0::3])),
                 plain_ms=plain1, bound_ms=b1[0], bound_by=b1[1]),
            dict(ms=float(np.median(runs["K2 bf16 stream"][0::3])),
                 plain_ms=plain2, bound_ms=b2[0], bound_by=b2[1]))
    return {"pair_pool2_fwd_bf16_stream": out[STREAM_SHAPES[0]][0],
            "pair_pool2_bwd_bf16_stream": out[STREAM_SHAPES[1]][1]}


def knob_config(name: str, knob: dict, tmp: Path):
    """Config ``name`` on synthetic data with a knob's overrides."""
    return load_config(experiment_path(name), {
        "data": {"dataset": "synthetic"}, "model": knob,
        "train": {"checkpoint_dir": str(tmp / f"prec_{len(knob)}"),
                  "log_every": 1, "snapshot_every": 0, "eval_every": 0}})


def step_launches(cfg) -> dict:
    """What one step of ``cfg`` launches: a K1 and a K2 per block (16), one
    K3, one list kernel, and the bf16 stream's K1 and K2 apart."""
    blocks = cfg.model.num_blocks
    stream = blocks if cfg.model.pair_elementwise_dtype == "bfloat16" else 0
    return want_counts(pair_pool2_fwd=blocks, pair_pool2_bwd=blocks,
                       greedy_scan_batched=1, pair_pool2_fwd_list=1,
                       pair_pool2_fwd_bf16_stream=stream,
                       pair_pool2_bwd_bf16_stream=stream)


def phase_precision_times(tmp: Path, card: str) -> None:
    """17d: the captured bench forward and config-2 step with each knob
    against the defaults, in turns in one call."""
    log(f"phase 17d: captured forward and step, each knob against the "
        f"defaults, in turns [{card}]")
    bench = packed_layout(8, 1024)
    fwds = {}
    for name, knob in {"defaults": {}, **KNOBS}.items():
        cfg = load_config(experiment_path("serving_bucketed"),
                          {"model": knob})
        graphs = Rescorer(cfg, init_params(cfg.model, seed=0),
                          device=DEV)._graphs
        graphs(*bench)
        fwds[name] = lambda graphs=graphs: graphs(*bench)
    log_turns("bench forward B=8 N=1024, captured", fwds, per_call=8 * 1024,
              card=card)
    steps = {}
    for name, knob in {"defaults": {}, **KNOBS}.items():
        cfg = knob_config("coco_persons_full", knob, tmp)
        batches = train_batches(TRAIN_DATA, 8, cfg, 4)
        state = training.create_train_state(
            cfg, training.build_model(cfg, "kernel", DEV))
        graphs = StepGraphs(state, cfg, training.step_body)
        for host in batches:
            graphs(host)            # every shape captured
        k = iter(range(10 ** 9))
        steps[name] = (lambda graphs=graphs, batches=batches, k=k:
                       graphs(batches[next(k) % 4]))
    log_turns("config-2 step B=8 N=1024 G=112, captured", steps,
              per_call=8 * 1024, card=card)


def phase_precision_main(tmp: Path, card: str) -> dict:
    """17e: the main path with the bf16 stream through the user's entry
    points (``train`` of config 2, ``Rescorer.rescore_batch`` of the
    bench's images), then ``tools.demo_config1`` and ``tools.quality_demo
    clustered --steps 20`` as a user runs them -> the launches of these
    runs."""
    from gossipnet_tpu_torch.tools import demo_config1, quality_demo

    log("phase 17e: config 2 trained and the bench's images served with the "
        "bf16 stream; then the reference's user scripts")
    knob = KNOBS["bf16 stream"]
    reset_counts()
    cfg = knob_config("coco_persons_full", knob, tmp)
    state = training.train(cfg, synthetic_roidb(**TRAIN_DATA),
                           pool_impl="kernel", max_steps=PRECISION_STEPS,
                           device=DEV)
    torch.cuda.synchronize()
    runs = state.step + state.graphs.captures
    got = counts()
    want = {name: n * runs for name, n in step_launches(cfg).items()}
    log(f"  train, {PRECISION_STEPS} steps with the bf16 stream: launches "
        f"{ {k: v for k, v in got.items() if v} } ({runs} step runs)")
    if got != want:
        raise AssertionError(f"training with the bf16 stream: {got} != "
                             f"{want}")
    serve = load_config(experiment_path("serving_bucketed"), {"model": knob})
    rescorer = Rescorer(serve, init_params(serve.model, seed=0), device=DEV)
    before = counts()
    images = bench_images()
    for _ in range(3):
        out = rescorer.rescore_batch(images)
    torch.cuda.synchronize()
    served = {k: v - before[k] for k, v in counts().items()}
    ok = (served["pair_pool2_fwd"] == served["pair_pool2_fwd_bf16_stream"]
          and served["pair_pool2_fwd"] % serve.model.num_blocks == 0
          and served["pair_pool2_fwd"] > 0
          and all(np.isfinite(s).all() for s in out))
    log(f"  Rescorer.rescore_batch of the bench's 8 images x 3 with the bf16 "
        f"stream: K1 {served['pair_pool2_fwd']} launches, all of the stream "
        f"({served['pair_pool2_fwd_bf16_stream']}); scores finite -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"serving with the bf16 stream: {served}")
    for label, run in (
            ("tools.demo_config1", lambda: demo_config1.main(
                ["--out", str(tmp / "demo_results.json")])),
            ("tools.quality_demo clustered --steps 20",
             lambda: quality_demo.main(["clustered", "--steps", "20",
                                        "--out-prefix", str(tmp / "demo")]))):
        t0 = time.perf_counter()
        log(f"  $ python -m gossipnet_tpu_torch.{label}")
        with contextlib.redirect_stdout(io.StringIO()) as text:
            result = run()
        ap = result["gossipnet"]["AP"]
        log(f"  {label}: {time.perf_counter() - t0:.1f} s; gossipnet AP "
            f"{ap:.4f}, " + (f"raw {result['raw_scores']['AP']:.4f}, "
                             f"exported {result['exported']}"
                             if "raw_scores" in result else
                             f"raw {result['raw']['AP']:.4f}, GreedyNMS "
                             f"{result['greedy_nms']['AP']:.4f} at "
                             f"{result['greedy_nms']['thr']}")
            + f" [{card}]")
        if not np.isfinite(ap):
            raise AssertionError(f"{label}: {text.getvalue()[-400:]}")
    return counts()


def phase_precision(card: str) -> tuple[dict, dict]:
    """Phase 17, the reduced-precision knobs -> (the main path's launches,
    the stream rows' times). 17b holds the stream's kernels against their
    plain versions on the arguments it times; the knobs' captured paths
    against eager: ``tests/test_torch_cuda.py -k model_bf16``."""
    t0 = time.perf_counter()
    times = phase_stream_times(stream_shape_args(), card)
    with tempfile.TemporaryDirectory() as tmp:
        phase_precision_times(Path(tmp), card)
        launches = phase_precision_main(Path(tmp), card)
    log(f"  phase 17: {time.perf_counter() - t0:.1f} s; main path launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return launches, times


# ---------------------------------------------------------------------------
# phase 18: the device mesh
# ---------------------------------------------------------------------------

MESH_DETS = (2, 4)
# scores of a mesh against one device at the same padded batch: f32 at the
# pair kernels' f32 gate, 1e-5; bf16 at their bf16 gate, 2e-2 (ROADMAP §3
# (d) measured 7.9e-3 between two batch compositions in bf16)
MESH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MESH_CARD = "one card, time-sliced ranks: no multi-GPU figure"
MESH_DEV = f"{DEV}:0"   # every rank of a world on the one card


def shard_args(args, rows: slice, kern):
    """Launch arguments of rows ``rows`` of a square launch against all of
    its columns, as the det-sharded forward builds them: the rows' fields
    and a, the tile flags of those rows at the launch's skip tile, every
    column; K1's geometry with the list of its own rows."""
    geom = args[0]
    row = geom.row[:, :, rows].contiguous()
    if kern is k1:
        flags = k1.tile_activity(row, geom.col, *geom.tile)
        geom = geom._replace(row=row, flags=flags.contiguous(),
                             i_feats=geom.i_feats[:, rows].contiguous())
        geom = geom._replace(pairs=k1.pair_list(geom))
    else:
        flags = k1.tile_activity(row, geom.col, *geom.tile,
                                 valid_field=k5._VALID)
        geom = geom._replace(row=row, flags=flags.contiguous())
    return (geom, args[1][:, rows].contiguous(), *args[2:6])


def shard_timing(label: str, kern, args, dm, dtype, n_det: int) -> None:
    """Each of ``n_det`` row shards launched against every column, in one
    process, as the det-sharded forward launches them: each shard's
    neighbour pairs and ms/launch at the split count of its own row tiles
    and at the whole matrix's, beside its bounds and the square launch.
    The shards against the square launch and their plain versions:
    ``tests/test_torch_cuda.py -k det_shards``."""
    fname, bname = LABELS[kern]
    n = args[1].shape[1]
    rows_per = n // n_det
    m_sq = kern.launch_kernel(*args, dtype)
    pairs, shards = [], []
    for r in range(n_det):
        rows = slice(r * rows_per, (r + 1) * rows_per)
        sa = shard_args(args, rows, kern)
        pairs.append(pair_counts(sa[0])[0])
        shards.append((sa, m_sq[:, rows].contiguous(),
                       dm[:, rows].contiguous()))
    splits = launch._splits(sa[0], m_sq.device, whole_matrix=True)
    own = launch._splits(sa[0], m_sq.device)
    log(f"  (a) {label} {dtype} n_det={n_det} (NR={rows_per} NC={n}): "
        f"{bname} splits {splits}, the whole matrix's; {fname} {own}, a "
        f"shard's own row tiles'")
    times = shard_times(kern, [(args, m_sq, dm), *shards], (dtype,), splits)
    for r, (sa, m, dm_r) in enumerate(shards, start=1):
        fb = k1_bound(sa, dtype)[:2] if kern is k1 else k5_bound(sa, dtype)
        bb = k2_bound(sa, m, dm_r, dtype, kern=kern)
        log(f"      shard {r - 1}/{n_det}: {pairs[r - 1]} neighbour pairs; "
            f"ms/launch (events) {fname} {times[r, 'fwd', 'own']:.4f} at "
            f"{own} splits (its own row tiles', this rule) / "
            f"{times[r, 'fwd', 'whole']:.4f} at {splits} (the whole "
            f"matrix's), bound {fb[0]:.5f} ({fb[1]}); {bname} "
            f"{times[r, 'bwd', 'own']:.4f} at {own} / "
            f"{times[r, 'bwd', 'whole']:.4f} at {splits} (this rule), "
            f"bound {bb[0]:.5f} ({bb[1]})")
    fwd = [times[r, "fwd", "own"] for r in range(1, n_det + 1)]
    bwd = [times[r, "bwd", "whole"] for r in range(1, n_det + 1)]
    log(f"      square launch at {splits} splits: {fname} "
        f"{times[0, 'fwd', 'own']:.4f}, {bname} "
        f"{times[0, 'bwd', 'own']:.4f} ms/launch; largest / mean shard: "
        f"pairs {max(pairs) / (sum(pairs) / n_det):.3f}, {fname} "
        f"{max(fwd) / (sum(fwd) / n_det):.3f}, {bname} "
        f"{max(bwd) / (sum(bwd) / n_det):.3f}")


@contextlib.contextmanager
def forced_splits(n: int):
    """Every pair-kernel launch in the block splits its row tiles ``n``
    ways."""
    keep = launch._splits
    launch._splits = lambda geom, device, whole_matrix=False: n
    try:
        yield
    finally:
        launch._splits = keep


def shard_times(kern, launches: list, dt: tuple, whole: int,
                rounds: int = 4) -> dict:
    """ms/launch from CUDA events of each (args, m, dm) of ``launches``
    (the square launch first, then the shards): its forward and backward
    at the split count of its own row tiles and at ``whole``, the whole
    matrix's. Each is warmed before it is timed, in turns, their order
    reversed at each round -> {(index, "fwd" or "bwd", "own" or "whole"):
    the median over the rounds}."""
    fns = {}
    for i, (sa, m, dm) in enumerate(launches):
        own = launch._splits(sa[0], m.device)
        for rule, n in (("own", own), ("whole", whole)):
            fns[i, "fwd", rule] = (n, lambda sa=sa: kern.launch_kernel(
                *sa, *dt))
            fns[i, "bwd", rule] = (n, lambda sa=sa, m=m, dm=dm:
                                   kern.launch_backward_kernel(*sa, m, dm,
                                                               *dt))
    runs = {k: [] for k in fns}
    order = list(fns)
    for _ in range(rounds):
        for k in order:
            n, fn = fns[k]
            with forced_splits(n):
                runs[k].append(cuda_time(fn, 10, warmup=2))
        order.reverse()
    return {k: float(np.median(v)) for k, v in runs.items()}


def phase_shard_times() -> None:
    """Phase 18 (a): the det shards' launches in one process, no
    collectives, timed."""
    log("phase 18 (a): the det shards -- each shard's rows against every "
        "column, K1/K2 at the 16-block flagship's bench batch (B=8 "
        "N=1024), K5/K6 at config 4's batch (B=2 N=4096)")
    bench = seeded_model(load_config(experiment_path("serving_bucketed")))
    _, bwd1 = capture_pair(k1, bench, *sorted_bench_batch(8, 1024))
    _, bwd5 = k5_shape_args()[K5_SHAPES[1]]
    for kern, bwd, name in ((k1, bwd1, "bench"), (k5, bwd5, "config 4")):
        b, n, _ = bwd[1].shape
        for n_det in MESH_DETS:
            for dtype in ("float32", "bfloat16"):
                shard_timing(f"{name} B={b} N={n}", kern, bwd[:6], bwd[7],
                             dtype, n_det)


def mesh_ov(cfg, n_data: int, n_det: int, **train) -> dict:
    """``cfg`` as overrides, on an (n_data x n_det) mesh."""
    ov = config_to_dict(cfg)
    ov["parallel"] = {"enable": "on", "data_axis": n_data,
                      "det_axis": n_det}
    ov["train"] = {**ov["train"], **train}
    return ov


def rank_launches(world, legs_: tuple) -> dict:
    """The launches of ``legs_`` summed over the ranks, by record name."""
    names = {"K1": "pair_pool2_fwd", "K2": "pair_pool2_bwd",
             "K3": "greedy_scan_batched", "K5": "pair_pool_fwd",
             "K6": "pair_pool_bwd", "K1 list": "pair_pool2_fwd_list"}
    out = {n: 0 for n in names.values()}
    for rank in world:
        for leg in legs_:
            for k, v in rank[leg]["launches"].items():
                out[names[k]] += v
    return out


def check_rank_launches(world, leg: str, per_rank: dict) -> None:
    for r, rank in enumerate(world):
        got = {k: v for k, v in rank[leg]["launches"].items() if v}
        if got != per_rank:
            raise AssertionError(f"{leg}: rank {r} launched {got}, "
                                 f"expected {per_rank}")


def local_grads(cfg, arrays: dict, n_data: int = 1) -> dict:
    """One device's gradient of the loss on ``arrays`` (numpy by name):
    the mean of the gradients of its ``n_data`` equal parts, each a
    batch of its own, which is the batch's gradient (the loss is a mean
    over images) summed at the batch composition a data rank has."""
    model = training.build_model(cfg, "kernel", DEV)
    model.load_state_dict(as_state_dict(init_params(cfg.model, seed=0)))
    rows = len(arrays["boxes"]) // n_data
    for d in range(n_data):
        loss, _ = training.loss_and_metrics(model, {
            k: torch.from_numpy(np.ascontiguousarray(
                v[d * rows:(d + 1) * rows])).to(DEV)
            for k, v in arrays.items()}, cfg)
        loss.backward()
    return {k: p.grad.cpu().numpy() / n_data
            for k, p in model.named_parameters()}


def grad_ratio(got: dict, want: dict) -> float:
    """The worst |got - want| / (5e-6 + 5e-4 |want|): at most 1 is within
    rtol 5e-4, atol 5e-6."""
    return max(float(np.max(np.abs(got[k] - want[k])
                            / (5e-6 + 5e-4 * np.abs(want[k]))))
               for k in want)


def check_grads(label: str, cfg, arrays: dict, got: dict,
                n_data: int) -> None:
    """Step 0's raw closed grads of a mesh against one device's, rtol 5e-4
    and atol 5e-6, the one device summing each data rank's images as a
    batch of its own; against the whole batch at once for information
    (ROADMAP §3 (d): an f32 sum at another batch composition)."""
    want = local_grads(cfg, arrays, n_data)
    whole = grad_ratio(got, local_grads(cfg, arrays)) if n_data > 1 \
        else None
    log(f"  (b) {label}: raw closed grads against one device, {len(want)} "
        f"tensors: worst |diff| / (5e-6 + 5e-4 |want|) = "
        f"{grad_ratio(got, want):.3f} (<= 1 passes; the device summing "
        f"each data rank's {len(arrays['boxes']) // n_data} images as a "
        f"batch)" + ("" if whole is None else
                     f"; against the batch of {len(arrays['boxes'])} at "
                     f"once, for information: {whole:.3f}"))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=5e-4, atol=5e-6,
                                   err_msg=f"{label} {k}")


def check_replicated(label: str, world, leg: str) -> None:
    first = world[0][leg]["result"][0]
    same = all(np.array_equal(rank[leg]["result"][0][k], first[k])
               for rank in world[1:] for k in first)
    log(f"  (b) {label}: parameters bit-identical on every rank after the "
        f"steps: {same}; steps {[r[leg]['result'][1] for r in world]}")
    if not same:
        raise AssertionError(f"{label}: ranks disagree after the steps")


def phase_mesh_worlds(tmp: Path) -> dict:
    """Phase 18 (b): worlds of gloo ranks sharing the card, through the
    port's entry points at full width -> the main paths' launches summed
    over the ranks."""
    from gossipnet_tpu_torch.parallel import legs
    from gossipnet_tpu_torch.parallel.world import run_world

    log(f"phase 18 (b): worlds of gloo ranks, every rank on {MESH_DEV} (" +
        MESH_CARD + ")")
    images = bench_images()
    serve = {dt: load_config(experiment_path("serving_bucketed"),
                             {"model": {"pair_matmul_dtype": dt}})
             for dt in ("bfloat16", "float32")}
    params = flatten_paths(init_params(serve["float32"].model, seed=0))
    cfg2 = load_config(experiment_path("coco_persons_full"),
                       {"data": {"dataset": "synthetic"}})
    cfg2_f32 = dataclasses.replace(cfg2, model=dataclasses.replace(
        cfg2.model, pair_matmul_dtype="float32"))
    cfg4 = crowd_config()
    cfg4_f32 = dataclasses.replace(cfg4, model=dataclasses.replace(
        cfg4.model, pair_matmul_dtype="float32"))
    batch2 = train_batches(TRAIN_DATA, 8, cfg2, 1)[0]
    batch4 = train_batches(CROWD_DATA, 2, cfg4, 1)[0]
    eval_roidb = evaluate.load_roidb(cfg2)
    eval_images = [(r.det_boxes, r.det_scores, None) for r in eval_roidb]
    bench_arrays = dict(zip(("boxes", "scores", "valid", "classes"),
                            packed_layout(8, 1024)))

    # the TCP server warms up every (batch, bucket) it can reach: the
    # bench images' bucket alone
    tcp_ov = mesh_ov(serve["float32"], 2, 2)
    tcp_ov["data"]["bucket_sizes"] = [1024]

    def rescore_legs(shapes):
        return [(f"rescore_{dt}_{d}x{t}", legs.rescore, dict(
            overrides=mesh_ov(serve[dt], d, t), params=params,
            images=images)) for dt in serve for d, t in shapes]

    def train_leg(name, cfg, d, t, data):
        return (name, legs.train_run, dict(
            overrides=mesh_ov(cfg, d, t, max_steps=3, log_every=1,
                              snapshot_every=0, eval_every=0,
                              checkpoint_dir=str(tmp / name)),
            data=data, metrics=True))

    def grads_leg(name, cfg, d, t, arrays):
        return (name, legs.grads, dict(
            overrides=config_to_dict(cfg), params=flatten_paths(
                init_params(cfg.model, seed=0)), arrays=arrays,
            shape=(d, t)))

    def ms_leg(name, d, t):
        return (name, legs.forward_ms, dict(
            overrides=config_to_dict(serve["bfloat16"]), params=params,
            arrays=bench_arrays, shape=(d, t)))

    plans = {
        2: [*rescore_legs([(1, 2), (2, 1)]),
            train_leg("train2_2x1", cfg2, 2, 1, TRAIN_DATA),
            grads_leg("grads2_2x1", cfg2_f32, 2, 1, batch2),
            train_leg("train4_1x2", cfg4, 1, 2, CROWD_DATA),
            grads_leg("grads4_1x2", cfg4_f32, 1, 2, batch4),
            ms_leg("ms_1x2", 1, 2), ms_leg("ms_2x1", 2, 1)],
        4: [*rescore_legs([(2, 2), (1, 4)]),
            train_leg("train2_2x2", cfg2, 2, 2, TRAIN_DATA),
            grads_leg("grads2_2x2", cfg2_f32, 2, 2, batch2),
            ("eval_2x2", legs.evaluate, dict(
                overrides=config_to_dict(cfg2), params=flatten_paths(
                    init_params(cfg2.model, seed=0)),
                data=dict(num_images=64, seed=123), shape=(2, 2),
                batch_size=cfg2.train.batch_size)),
            ("rescore_eval_2x2", legs.rescore, dict(
                overrides=mesh_ov(cfg2, 2, 2), params=flatten_paths(
                    init_params(cfg2.model, seed=0)), images=eval_images,
                batch_size=cfg2.train.batch_size)),
            ("tcp_2x2", legs.tcp, dict(
                overrides=tcp_ov, params=params,
                images=[im[:2] for im in images])),
            ms_leg("ms_2x2", 2, 2), ms_leg("ms_1x4", 1, 4)],
    }
    worlds = {}
    for size, plan in plans.items():
        t0 = time.perf_counter()
        worlds[size] = run_world(legs.run_legs, size, "gloo", MESH_DEV,
                                 timeout_s=600, args=(plan,))
        log(f"  (b) a world of {size} ranks on {MESH_DEV}: {len(plan)} "
            f"legs in {time.perf_counter() - t0:.1f} s")

    # the Rescorer on each mesh shape against one device, same padded batch
    for dt, cfg in serve.items():
        want = Rescorer(cfg, params, device=DEV, mesh=None) \
            .rescore_batch(images)
        for size, shapes in ((2, [(1, 2), (2, 1)]), (4, [(2, 2), (1, 4)])):
            for d, t in shapes:
                leg = f"rescore_{dt}_{d}x{t}"
                (got,) = worlds[size][0][leg]["result"]
                err = max(float(np.abs(g - w).max())
                          for g, w in zip(got, want))
                check_rank_launches(worlds[size], leg,
                                    {"K1": cfg.model.num_blocks,
                                     "K1 list": 1})
                log(f"  (b) Rescorer on ({d}x{t}), {dt}, bench batch: max "
                    f"|diff| against one device {err:.2e} (tol "
                    f"{MESH_TOL[dt]}); {cfg.model.num_blocks} K1 launches "
                    f"per rank at NR={1024 // t}")
                if err > MESH_TOL[dt]:
                    raise AssertionError(f"mesh Rescorer ({d}x{t}) {dt}: "
                                         f"{err}")
    # training: launches per rank and step, replicas, step 0's gradients
    for size, leg, cfg, batch, fb, n_data in (
            (2, "train2_2x1", cfg2_f32, batch2, ("K1", "K2"), 2),
            (4, "train2_2x2", cfg2_f32, batch2, ("K1", "K2"), 2),
            (2, "train4_1x2", cfg4_f32, batch4, ("K5", "K6"), 1)):
        blocks = cfg.model.num_blocks
        check_rank_launches(worlds[size], leg, {
            fb[0]: 3 * blocks, fb[1]: 3 * blocks, "K3": 3,
            **({"K1 list": 3} if fb[0] == "K1" else {})})
        check_replicated(leg, worlds[size], leg)
        losses = worlds[size][0][leg]["result"][2]
        if len(losses) != 3 or not np.isfinite(losses).all():
            raise AssertionError(f"{leg}: losses {losses}")
        grads_name = leg.replace("train", "grads")
        check_grads(grads_name, cfg, batch,
                    worlds[size][0][grads_name]["result"][0], n_data)
        log(f"  (b) {leg}: 3 steps, losses "
            f"{' '.join(f'{x:.4f}' for x in losses)}, {blocks} {fb[0]} + "
            f"{blocks} {fb[1]} + 1 K3 per rank and step")
    # the evaluation's scores against the mesh Rescorer's
    ev = worlds[4][0]["eval_2x2"]["result"]
    (served,) = worlds[4][0]["rescore_eval_2x2"]["result"]
    err = max(float(np.abs(ev["scores"][r.image_id] - s).max())
              for r, s in zip(eval_roidb, served))
    log(f"  (b) evaluation on (2x2), {len(eval_roidb)} images: AP "
        f"{ev['stats']['AP']:.4f}; scores against the mesh Rescorer's: max "
        f"|diff| {err:.2e} (tol 1e-5)")
    if err > 1e-5 or not math.isfinite(ev["stats"]["AP"]):
        raise AssertionError("mesh evaluation differs from the mesh Rescorer")
    # the TCP server on the (2x2) Rescorer, against one device in f32
    want = Rescorer(serve["float32"], params, device=DEV, mesh=None) \
        .rescore_batch(images)
    tcp = worlds[4][0]["tcp_2x2"]["result"]
    errs = {kind: max(float(np.abs(tcp[kind][i] - want[i]).max())
                      for i in range(len(images))) for kind in tcp}
    log(f"  (b) TcpServer on the (2x2) Rescorer, f32: {len(images)} JSON "
        f"and {len(images)} binary replies; max |diff| against one device "
        f"{errs} (tol 1e-5)")
    if max(errs.values()) > 1e-5:
        raise AssertionError(f"TCP replies on the mesh: {errs}")
    # for information: the sharded forward per rank against one device
    model = Rescorer(serve["bfloat16"], params, device=DEV, mesh=None).model
    arrays = device_arrays(packed_layout(8, 1024))
    with torch.no_grad():   # as the sharded inference runs
        eager = host_ms(lambda: model(*arrays[:3]), 5)
    for size, shapes in ((2, ("1x2", "2x1")), (4, ("2x2", "1x4"))):
        for s in shapes:
            per_rank = [round(rank[f"ms_{s}"]["result"], 3)
                        for rank in worlds[size]]
            log(f"  (c) sharded forward on ({s}), bench batch, bf16: "
                f"{per_rank} ms per rank (host, synchronized; "
                f"{MESH_CARD}); one device, eager: {eager:.3f} ms")
    main_legs = {2: [leg for leg, _, _ in plans[2]
                     if leg.startswith(("rescore", "train"))],
                 4: [leg for leg, _, _ in plans[4]
                     if leg.startswith(("rescore", "train", "eval", "tcp"))]}
    total = {}
    for size, names in main_legs.items():
        for k, v in rank_launches(worlds[size], names).items():
            total[k] = total.get(k, 0) + v
    return total


def phase_mesh(card: str) -> dict:
    """Phase 18 -> the main paths' launches summed over the ranks."""
    from gossipnet_tpu_torch.tools import entry as entry_tool

    t0 = time.perf_counter()
    phase_shard_times()
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_mesh_worlds(Path(tmp))
    log("phase 18 (b): dryrun_multichip(4), every rank on cuda:0")
    entry_tool.dryrun_multichip(4, DEV)
    log(f"phase 18: {time.perf_counter() - t0:.1f} s ({MESH_CARD}); "
        f"main-path launches over the ranks {launches}; {card}")
    return launches


# ---------------------------------------------------------------------------
# Phase 19: the scale drill (tools/scale_drill.py) on the card
# ---------------------------------------------------------------------------

DRILL_TRAIN_STEPS = 20        # config 2 from the drill's files, as phase 6
DRILL_MC_STEPS = 5            # config 3, as phase 11
DRILL_RUN_IMAGES = 1000       # the `run` arm's set in the full script


def file_mb(path: Path) -> str:
    return f"{path.name} {path.stat().st_size / 1e6:.1f} MB"


def drill_train(label: str, path: str, steps: int, tmp: Path):
    """``train()`` on the files and YAML of the drill's ``run`` arm, with
    its launches counted -> (state, roidb, launches)."""
    cfg = load_config(path)
    t0 = time.perf_counter()
    roidb, _ = training._datasets(cfg)
    load_s = time.perf_counter() - t0
    dets = np.array([r.num_dets for r in roidb])
    det_cls = np.concatenate([r.det_classes for r in roidb])
    gt_cls = np.concatenate([r.gt_classes for r in roidb])
    crowd = np.concatenate([r.gt_crowd for r in roidb])
    log(f"  {label}: {path}; build_roidb {load_s:.1f} s: {len(roidb)} "
        f"images, detections an image mean {dets.mean():.1f} max "
        f"{dets.max()} (buckets {cfg.data.bucket_sizes}), "
        f"{crowd.mean():.3f} of the GT crowds, labels "
        f"[{min(det_cls.min(), gt_cls.min())}, "
        f"{max(det_cls.max(), gt_cls.max())}] of {roidb.num_classes} "
        f"classes (category ids {roidb.cat_ids[:4]}...{roidb.cat_ids[-2:]})")
    # the 80 non-contiguous ids reach a launch as contiguous labels only
    if not (0 <= min(det_cls.min(), gt_cls.min())
            and max(det_cls.max(), gt_cls.max()) < cfg.model.num_classes
            and roidb.num_classes == cfg.model.num_classes):
        raise AssertionError(f"{label}: class labels outside [0, "
                             f"{cfg.model.num_classes})")
    metrics = tmp / f"{Path(path).stem}_metrics.jsonl"
    reset_counts()
    t0 = time.perf_counter()
    state = training.train(cfg, roidb, pool_impl="kernel",
                           metrics_path=str(metrics), max_steps=steps,
                           device=DEV)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts()
    blocks = cfg.model.num_blocks
    runs = state.step + state.graphs.captures
    want = want_counts(pair_pool2_fwd=blocks * runs,
                       pair_pool2_bwd=blocks * runs, greedy_scan_batched=runs,
                       pair_pool2_fwd_list=runs)
    losses = [json.loads(x)["loss"] for x in metrics.read_text().splitlines()]
    log(f"  {label}: {state.step} steps in {run_s:.1f} s "
        f"({state.graphs.captures} captured shapes); launches {launches} "
        f"= {blocks} K1 + {blocks} K2 + 1 K3 x ({state.step} replays + "
        f"{state.graphs.captures} eager steps before a capture); loss logged "
        f"(log_every {cfg.train.log_every}) "
        f"{' '.join(f'{x:.4f}' for x in losses)}")
    if launches != want or state.step != steps or not losses \
            or not np.isfinite(losses).all():
        raise AssertionError(f"{label}: launches {launches} != {want} or "
                             f"losses {losses}")
    return state, roidb, launches


def drill_cli_stats(rec: dict) -> str:
    """The AP lines of an evaluate phase's printed record."""
    return "; ".join(f"{k} AP {v['AP']:.4f} AP50 {v['AP50']:.4f}"
                     for k, v in rec["result"].items())


def phase_drill(card: str, run_images: int) -> dict:
    """Phase 19 -> the launches of its in-process training and
    evaluation."""
    t_phase = time.perf_counter()
    log("phase 19: the scale drill (tools/scale_drill.py): configs 1-3 from "
        "real-format COCO files")
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        same = tmp / "same"
        scale_drill.gen(n_images=DRILL_IMAGES, data_dir=same)
        scale_drill.gen_pets(n_frames=DRILL_FRAMES, data_dir=same)
        digests = {name: hashlib.sha256((same / name).read_bytes())
                   .hexdigest() for name in DRILL_SHA256}
        log(f"  (a) gen({DRILL_IMAGES} images), gen_pets({DRILL_FRAMES} "
            f"frames), numpy {np.__version__}: sha256 equal to the "
            f"reference generator's: "
            f"{ {n: digests[n] == DRILL_SHA256[n] for n in digests} }")
        if digests != DRILL_SHA256:
            raise AssertionError(f"the drill's files differ from the "
                                 f"reference's bytes: {digests}")

        data = tmp / "5k"
        t0 = time.perf_counter()
        made = scale_drill.gen(data_dir=data)
        log(f"  (b) gen(): {time.perf_counter() - t0:.1f} s, {made}, "
            f"{file_mb(data / 'annotations.json')}, "
            f"{file_mb(data / 'detections.json')}")

        log(f"  (c) configs 2 and 3 in this process, from {data}")
        _, y2, y3 = scale_drill.run_yamls(data_dir=data)
        state2, roidb2, launches = drill_train(
            "config 2 (persons)", y2, DRILL_TRAIN_STEPS, tmp)
        _, _, mc_launches = drill_train(
            "config 3 (80 classes)", y3, DRILL_MC_STEPS, tmp)
        cfg2 = load_config(y2)
        batches = list(eval_batches(roidb2, cfg2.train.batch_size,
                                    cfg2.data.bucket_sizes))
        shapes = len({(b.batch_size, b.padded_n) for b in batches})
        reset_counts()
        t0 = time.perf_counter()
        out = evaluate.main(["-c", y2, "--device", DEV])
        eval_s = time.perf_counter() - t0
        ev_launches = counts()
        want = want_counts(pair_pool2_fwd=cfg2.model.num_blocks
                           * (len(batches) + shapes),
                           pair_pool2_fwd_list=len(batches) + shapes)
        log(f"  evaluate.main on config 2's checkpoint (step "
            f"{state2.step}) over {len(roidb2)} images: {eval_s:.1f} s "
            f"(COCO matching: "
            f"{'native C++' if native.available() else 'numpy'}); "
            f"launches {ev_launches} = {cfg2.model.num_blocks} K1 x "
            f"({len(batches)} batches + {shapes} eager forward before a "
            f"capture); GossipNet AP {out['gossipnet']['AP']:.4f} AP50 "
            f"{out['gossipnet']['AP50']:.4f}, raw scores AP "
            f"{out['raw_scores']['AP']:.4f} AP50 "
            f"{out['raw_scores']['AP50']:.4f}, GreedyNMS at "
            f"{out['greedy_nms']['iou_threshold']:.2f} AP "
            f"{out['greedy_nms']['AP']:.4f} AP50 "
            f"{out['greedy_nms']['AP50']:.4f}")
        if ev_launches != want or not all(
                0.0 <= s["AP"] <= 1.0 for s in out.values()) \
                or out["raw_scores"]["AP"] <= 0.0:
            raise AssertionError(f"drill evaluation: launches {ev_launches}"
                                 f" != {want} or stats {out}")
        for more in (mc_launches, ev_launches):
            for name, n in more.items():
                launches[name] += n

        t0 = time.perf_counter()
        five = scale_drill.eval5k(data)
        log(f"  (d) eval5k: {five} ({time.perf_counter() - t0:.1f} s with "
            f"build_roidb; the evaluations above match in "
            f"{'native C++' if native.available() else 'numpy'})")

        run_dir = tmp / "run"
        if run_images == scale_drill.N_IMAGES:
            run_dir.mkdir()
            for name in ("annotations.json", "detections.json"):
                (run_dir / name).symlink_to(data / name)
        else:
            log(f"  (e) cut: the run arm on gen(n_images={run_images}) "
                f"(the full script's time limit); steps and widths as the "
                f"arm sets them")
            scale_drill.gen(n_images=run_images, data_dir=run_dir)
        libraries = sorted(build.BUILD_DIR.glob("lib*.so"))
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            phases = scale_drill.run(device=DEV, data_dir=run_dir)
        (tmp / "run.log").write_text(printed.getvalue())
        log(f"  (e) the run arm, {run_images} images, five CLI "
            f"subprocesses: {time.perf_counter() - t0:.1f} s; {card}")
        for name, rec in phases.items():
            stats = (f"; {drill_cli_stats(rec)}" if name.endswith("eval")
                     else "")
            log(f"    {name}: wall {rec['wall_s']} s, peak RSS "
                f"{rec['peak_rss_gb']} GB, kernels built "
                f"{rec['built']}{stats}")
        if any(rec["built"] for rec in phases.values()) \
                or sorted(build.BUILD_DIR.glob("lib*.so")) != libraries:
            raise AssertionError("a CLI phase built a kernel library")
        if not all(0 < rec["peak_rss_gb"] for rec in phases.values()):
            raise AssertionError("a CLI phase's peak RSS was not read")
    log(f"phase 19: {time.perf_counter() - t_phase:.1f} s; launches of its "
        f"in-process paths {launches}; {card}")
    return launches


# ---------------------------------------------------------------------------
# Phase 20: the pair kernels' skip tile
# ---------------------------------------------------------------------------

TILE_SHAPES = ("bench B=8 N=1024", "config 4 B=2 N=4096")   # timed there


def at_tile(args, tile):
    """Launch arguments ``args`` with the geometry's flags rebuilt at skip
    tile ``tile``, by the model's rule (``tile_activity`` at that shape),
    and the tile the launches then take; K1's geometry with the list built
    at it."""
    geom = args[0]
    valid = k5._VALID if isinstance(geom, k5.PairColumns) else k1._VALID
    flags = k1.tile_activity(geom.row, geom.col, *tile, valid_field=valid)
    geom = geom._replace(flags=flags.contiguous(), tile=tuple(tile))
    if isinstance(geom, k1.PairGeometry):
        geom = geom._replace(pairs=k1.pair_list(geom))
    return (geom, *args[1:])


def tile_shape_args(kern) -> dict:
    """The last block's backward launch arguments (args, m, dm) of the
    16-block models through ``kern`` (K1/K2 with ``pair_kernel: 2``,
    K5/K6 with 1; seeded weights, bf16) at the serving bench batch and
    config 4's training batch."""
    pk = 2 if kern is k1 else 1
    serving = seeded_model(load_config(experiment_path("serving_bucketed"),
                                       {"model": {"pair_kernel": pk}}))
    cfg4 = crowd_config(pair_kernel=pk)
    crowd = training.batch_to_device(next(BatchIterator(
        synthetic_roidb(**CROWD_DATA), 2, cfg4.data.bucket_sizes)),
        torch.device(DEV))
    return {
        TILE_SHAPES[0]: capture_pair(kern, serving,
                                     *sorted_bench_batch(8, 1024))[1],
        TILE_SHAPES[1]: capture_pair(kern, seeded_model(cfg4), crowd["boxes"],
                                     crowd["scores"], crowd["valid"])[1]}


def tile_times(kern, label: str, args, dm, dtype: str) -> dict:
    """ms per launch of the forward and backward kernel at every skip tile
    (CUDA events around a chain, and the device time of one launch from
    the profiler) beside the stage-A tests and the bounds, and K1's list
    kernel, which runs those tests once a forward, on a row of its own ->
    {tile: (fwd events, bwd events, fwd device, bwd device)}."""
    fname, bname = LABELS[kern]
    out = {}
    for tile in launch.TILES:
        ta = at_tile(args, tile)
        m = kern.launch_kernel(*ta, dtype)

        def fwd_call():
            return kern.launch_kernel(*ta, dtype)

        def bwd_call():
            return kern.launch_backward_kernel(*ta, m, dm, dtype)

        row = (cuda_time(fwd_call, iters=20), cuda_time(bwd_call, iters=10),
               device_ms(fwd_call, reps=5), device_ms(bwd_call, reps=5))
        out[tile] = row
        nb, tests = pair_counts(ta[0])
        fb = (k1_bound(ta, dtype) if kern is k1 else k5_bound(ta, dtype))[:2]
        bb = k2_bound(ta, m, dm, dtype, kern=kern)[:2]
        d1, d2 = (f"{d:.4f}" if d else "not measured" for d in row[2:])
        log(f"  {label} {dtype} tile {tile[0]}x{tile[1]}: {tests} IoU tests "
            f"for {nb} neighbour pairs; {fname} {row[0]:.4f} ms/launch "
            f"(events), {d1} on the device, bound {fb[0]:.5f} ({fb[1]}); "
            f"{bname} {row[1]:.4f} (events), {d2} on the device, bound "
            f"{bb[0]:.5f} ({bb[1]})")
        if kern is k1:
            log(f"  {label} tile {tile[0]}x{tile[1]}: {list_line(ta[0])}")
    return out


def phase_tiles(card: str) -> None:
    """Phase 20: the pair kernels' skip tile (``launch.TILES``): K1/K2 and
    K5/K6 timed at every tile at the bench batch and config 4's; then
    ``tools.tile_sweep`` as a user runs it. Every tile against the plain
    versions and the det shards: ``tests/test_torch_cuda.py -k "every_tile
    or det_shards"``."""
    from gossipnet_tpu_torch.tools import tile_sweep

    t0 = time.perf_counter()
    log(f"phase 20: the skip tile (FI x TJ) of K1, K2, K5 and K6 at every "
        f"tile of {launch.TILES} (default {launch.DEFAULT_TILE}); "
        + "; ".join(TILE_SHAPES))
    for kern in (k1, k5):
        for label, bwd in tile_shape_args(kern).items():
            tile_times(kern, label, bwd[:6], bwd[7], bwd[-1])
    log(f"  times: {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    tile_sweep.main([])
    log(f"  tools.tile_sweep: {time.perf_counter() - t1:.1f} s; {card}")
    log(f"phase 20: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 21 and --drill-arm: the drill's pets, dense, dense80 and dense4k arms
# ---------------------------------------------------------------------------

DRILL_FILE_STEPS = 2          # train() steps on each of phase 21's sets
# The reference's printed figures for each recipe of the drill's remaining
# arms (RESULTS.md, the lines named; the JAX package on a TPU): (AP, AP50,
# AP75) of the raw detector scores, of GreedyNMS at the swept threshold
# ``thr`` and of GossipNet from the checkpoint named (None: not printed),
# and the val-AP points RESULTS.md recorded (information, no gate).
DRILL_REFERENCE = {
    ("pets", "cosine", False): dict(
        lines="121-123", checkpoint="best", raw=(0.392, 0.699, 0.399),
        nms=(0.489, 0.930, 0.423), thr=0.55, gossipnet=(0.600, 0.987, None),
        trajectory=""),
    ("pets", "cosine", True): dict(
        lines="121-122, 124", checkpoint="best", raw=(0.392, 0.699, 0.399),
        nms=(0.489, 0.930, 0.423), thr=0.55, gossipnet=(0.700, 0.988, 0.891),
        trajectory=""),
    ("dense", "constant", False): dict(
        lines="166-168", checkpoint="final", raw=(0.293, 0.646, 0.217),
        nms=(0.364, 0.837, 0.211), thr=0.55, gossipnet=(0.466, 0.965, 0.349),
        trajectory="peaked at 0.515 @500, then decayed"),
    ("dense", "cosine", False): dict(
        lines="166-167, 169", checkpoint="final", raw=(0.293, 0.646, 0.217),
        nms=(0.364, 0.837, 0.211), thr=0.55, gossipnet=(0.532, 0.982, 0.497),
        trajectory=""),
    ("dense", "cosine", True): dict(
        lines="166-167, 170", checkpoint="final", raw=(0.293, 0.646, 0.217),
        nms=(0.364, 0.837, 0.211), thr=0.55, gossipnet=(0.677, 0.980, 0.841),
        trajectory="0.606 @1000 -> 0.659 @2000 -> 0.673 @3000"),
    ("dense80", "cosine", False): dict(
        lines="181-183", checkpoint="final", raw=(0.328, 0.657, 0.288),
        nms=(0.363, 0.824, 0.214), thr=0.55, gossipnet=(0.556, 0.996, 0.545),
        trajectory=""),
    ("dense80", "cosine", True): dict(
        lines="181-182, 184", checkpoint="final", raw=(0.328, 0.657, 0.288),
        nms=(0.363, 0.824, 0.214), thr=0.55, gossipnet=(0.702, 0.996, 0.891),
        trajectory="0.690 @1000 -> 0.707 @2500 -> 0.708 @3000"),
    ("dense4k", "cosine", True): dict(
        lines="338-340", checkpoint="final", raw=(0.179, 0.436, 0.111),
        nms=(0.228, 0.561, 0.129), thr=0.35, gossipnet=(0.423, 0.633, 0.508),
        trajectory="0.394 @1500 -> 0.409 @2000 -> 0.421 @3000"),
}
DRILL_AP_BAND = 0.02     # GossipNet's AP against the reference's (PERF.md §2)
# each arm's schedule when its command line names none (scale_drill.main)
DRILL_DEFAULT_SCHEDULE = {"pets": "cosine", "dense": "constant",
                          "dense80": "constant", "dense4k": "cosine"}


def drill_recipe(argv: list[str]) -> tuple[str, str, bool]:
    """``ARM [steps] [lr] [schedule] [mt]`` -> the key of its reference
    figures; SystemExit for a recipe RESULTS.md printed no figures for."""
    arm = argv[0] if argv else ""
    if arm not in DRILL_DEFAULT_SCHEDULE:
        raise SystemExit(f"--drill-arm: no arm {arm!r}; one of "
                         f"{sorted(DRILL_DEFAULT_SCHEDULE)}")
    steps, lr, schedule, mt, alpha, extra = scale_drill._parse_arm_args(
        argv[1:], DRILL_DEFAULT_SCHEDULE[arm])
    key = (arm, schedule, mt)
    if (steps, lr, alpha, extra) != (3000, 1e-3, 0.0, []) \
            or key not in DRILL_REFERENCE:
        raise SystemExit(f"--drill-arm {' '.join(argv)}: RESULTS.md prints "
                         f"no figures for this recipe; the gated ones: "
                         f"{sorted(DRILL_REFERENCE)} at 3000 steps, lr 1e-3")
    return key


def drill_gate(ref: dict, stats: dict) -> tuple[list[str], bool]:
    """The evaluate CLI's record ``stats`` against the reference's figures
    ``ref``: each baseline's AP rounds to the reference's three printed
    digits, GreedyNMS at the same swept threshold, and GossipNet's AP
    lies within DRILL_AP_BAND of the reference's -> the table's lines and
    whether every gate held."""
    def three(x):
        return "-" if x is None else f"{x:.3f}"

    lines = ["  | Method | Port AP / AP50 / AP75 | Reference AP / AP50 / "
             "AP75 | Gate | Held |", "  |---|---|---|---|---|"]
    held = True
    for label, key in (("raw detector scores", "raw"),
                       ("GreedyNMS, swept", "nms"),
                       ("GossipNet", "gossipnet")):
        got = stats[{"raw": "raw_scores", "nms": "greedy_nms"}.get(key, key)]
        want = ref[key]
        if key == "gossipnet":
            off = abs(got["AP"] - want[0])
            ok = off <= DRILL_AP_BAND
            gate = f"|AP - {want[0]:.3f}| = {off:.4f} <= {DRILL_AP_BAND}"
        else:
            ok = three(got["AP"]) == three(want[0])
            gate = f"AP {three(got['AP'])} == {three(want[0])}"
            if key == "nms":
                label += f" (best {got['iou_threshold']:.2f})"
                ok = ok and abs(got["iou_threshold"] - ref["thr"]) < 1e-6
                gate += f", threshold {ref['thr']:.2f}"
        held = held and ok
        lines.append(f"  | {label} | {got['AP']:.7f} / {got['AP50']:.7f} / "
                     f"{got['AP75']:.7f} | {' / '.join(map(three, want))} | "
                     f"{gate} | {'yes' if ok else 'NO'} |")
    return lines, held


def val_trajectory(path: Path) -> list[tuple[int, float]]:
    """(step, val_AP) of a training run's metrics file."""
    if not path.exists():
        return []
    recs = [json.loads(x) for x in path.read_text().splitlines() if x]
    return [(r["step"], r["val_AP"]) for r in recs if "val_AP" in r]


def pop_option(argv: list[str], name: str):
    """The value after ``name`` in ``argv``, both taken out; None when
    ``name`` is not there."""
    if name not in argv:
        return None
    at = argv.index(name)
    value = argv[at + 1]
    del argv[at:at + 2]
    return value


@contextlib.contextmanager
def train_seed(seed: int | None):
    """While inside, the drill's YAMLs set ``train.seed`` to ``seed`` (its
    weights' initialisation and batch order); unchanged for None."""
    if seed is None:
        yield
        return
    write = scale_drill._yaml

    def seeded(data_dir, name, text):
        return write(data_dir, name, text.replace(
            "train: {", f"train: {{seed: {seed}, ", 1))

    scale_drill._yaml = seeded
    try:
        yield
    finally:
        scale_drill._yaml = write


def phase_drill_arm(card: str, argv: list[str]) -> bool:
    """One recipe of the drill's pets, dense, dense80 or dense4k arms
    through ``scale_drill.main`` (the train and evaluate CLIs as
    subprocesses) on the card, then its evaluation against the reference's
    figures (:func:`drill_gate`) -> whether the gate held. The files go
    to a temporary directory. ``--train-seed N`` among ``argv`` trains at
    another seed than the recipe's 0 (a result outside the gate is run
    again so, and both are recorded)."""
    argv = list(argv)
    seed = pop_option(argv, "--train-seed")
    seed = None if seed is None else int(seed)
    ref = DRILL_REFERENCE[drill_recipe(argv)]
    lib = native._find_lib() if native.available() else None
    log(f"--drill-arm {' '.join(argv)}: RESULTS.md lines {ref['lines']}, "
        f"{ref['checkpoint']} checkpoint; train.seed "
        f"{0 if seed is None else seed}; COCO matching and the NMS sweep "
        f"in {f'native C++ ({lib})' if lib else 'numpy'}; {card}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, train_seed(seed):
        data = Path(tmp)
        rec = scale_drill.main([*argv, "--data-dir", str(data)])
        tag = next(k for k in rec if k.endswith("_train"))[:-len("_train")]
        trajectory = val_trajectory(data / f"m_{tag}.jsonl")
    wall = time.perf_counter() - t0
    train, ev = rec[f"{tag}_train"], rec[f"{tag}_eval"]
    restored = [x for x in ev["tail"] if x.startswith("restored")]
    log(f"  {tag}: {wall:.1f} s in all; train wall {train['wall_s']} s, "
        f"peak RSS {train['peak_rss_gb']} GB; eval wall {ev['wall_s']} s, "
        f"peak RSS {ev['peak_rss_gb']} GB; kernels built by the phases "
        f"{train['built'] + ev['built']}; {restored}")
    log("  val AP: " + " -> ".join(f"{ap:.4f} @{step}"
                                   for step, ap in trajectory)
        + f" (RESULTS.md: {ref['trajectory'] or 'not recorded'})")
    lines, held = drill_gate(ref, ev["result"])
    for line in lines:
        log(line)
    if not restored:
        held = False
        log("  the evaluation restored no checkpoint")
    log(f"  {tag}: the gate {'held' if held else 'MISSED'}; {card}")
    return held


def drill_file_sets(data: Path) -> dict:
    """Phase 21's sets, written to ``data`` by the drill's generators at
    the arms' densities: 16 PETS frames, 16 dense images of 80 classes, 8
    dense4k images (and a few held-out ones each), with the ``mt``
    recipes' own YAMLs -> {label: YAML path}."""
    scale_drill.gen_pets(n_frames=16, data_dir=data)
    scale_drill.gen_pets(n_frames=4, seed=1, prefix="val_", data_dir=data)
    scale_drill.gen(n_images=16, prefix="dense_", data_dir=data,
                    **scale_drill.DENSE)
    scale_drill.gen(n_images=2, seed=1, prefix="dense_val_", data_dir=data,
                    **scale_drill.DENSE)
    scale_drill.gen(n_images=8, prefix="dense4k_", data_dir=data,
                    **scale_drill.DENSE_4K)
    scale_drill.gen(n_images=2, seed=1, prefix="dense4k_val_", data_dir=data,
                    **scale_drill.DENSE_4K)
    return {
        "pets (CVML + MOT CSV)": scale_drill.pets_yaml(
            tag="pets_mt", mt=True, data_dir=data),
        "dense80 (80 classes)": scale_drill.full_yaml(
            schedule="cosine", tag="dense80_cosine_mt", multiclass=True,
            prefix="dense_", mt=True, data_dir=data),
        "dense4k (N=4096)": scale_drill.full_yaml(
            schedule="cosine", tag="dense4k_mt", prefix="dense4k_", mt=True,
            **scale_drill.DENSE_4K_ARM, data_dir=data)}


def phase_drill_files(card: str) -> dict:
    """Phase 21: the paths of the drill's remaining arms on real-format
    files: each set through ``train()`` (the arms' YAMLs, two steps, at 16
    K1 + 16 K2 + 1 K3 a step) -> the launches of its training runs. The
    kernels on each set's widest batch: ``tests/test_torch_cuda.py -k
    "pets or dense80 or dense4k"``."""
    t0 = time.perf_counter()
    log("phase 21: the drill's pets, dense80 and dense4k paths on "
        "real-format files")
    launches = want_counts()
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        for label, path in drill_file_sets(tmp).items():
            _, _, ran = drill_train(label, path, DRILL_FILE_STEPS, tmp)
            for name, n in ran.items():
                launches[name] += n
    log(f"phase 21: {time.perf_counter() - t0:.1f} s; launches of its "
        f"training runs {launches}; {card}")
    return launches


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
        # The pair kernels alone, timed: K1/K2 at the six shapes, K5/K6 at
        # two; no check, no result line. It uses only what the package has
        # had since K5/K6 exist, so a copy of this script beside an earlier
        # tree times that tree's kernels on the same card.
        phase_build(PAIR_KERNELS)
        phase_pair_shapes(queues=False)
        phase_k5_k6_shapes()
        log(card)
        return 0
    if sys.argv[1:] == ["--scan-times"]:
        # K3/K4 alone: built and timed; no result line.
        phase_build(("matching_scan",))
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
    if sys.argv[1:] == ["--bench"]:
        # Phase 16 alone: the measuring tools; no result line.
        phase_build(KERNELS[:5])
        phase_tools(card)
        log(card)
        return 0
    if sys.argv[1:] == ["--precision"]:
        # Phase 17 alone: the reduced-precision knobs; no result line.
        phase_build(KERNELS[:3])
        phase_precision(card)
        log(card)
        return 0
    if sys.argv[1:] == ["--mesh"]:
        # Phase 18 alone: the device mesh; no result line.
        phase_build(KERNELS[:5])
        phase_mesh(card)
        log(card)
        return 0
    if sys.argv[1:] == ["--drill"]:
        # Phase 19 alone, the run arm at the drill's full 5,000 images
        phase_build(KERNELS[:3])
        phase_drill(card, scale_drill.N_IMAGES)
        log(card)
        return 0
    if sys.argv[1:2] == ["--drill-arm"]:
        # One recipe of the drill's remaining arms, gated against the
        # reference's figures; no result line.
        phase_build(KERNELS[:3])
        held = phase_drill_arm(card, sys.argv[2:])
        log(card)
        return 0 if held else 1
    if sys.argv[1:] == ["--drill-files"]:
        # Phase 21 alone.
        phase_build(KERNELS[:3])
        phase_drill_files(card)
        log(card)
        return 0
    if sys.argv[1:] == ["--tiles"]:
        # Phase 20 alone: every skip tile timed, then tools.tile_sweep.
        phase_build(PAIR_KERNELS)
        phase_tiles(card)
        log(card)
        return 0
    if sys.argv[1:] == ["--k1-stages"]:
        phase_build(KERNELS[:2])
        phase_k1_stages()
        log(card)
        return 0
    phase_build()

    cfg = load_config(experiment_path("serving_bucketed"))
    rescorer, serve_launches = phase_serving(cfg)
    times = {"pair_pool2_fwd": phase_times(rescorer,
                                           cfg.model.pair_matmul_dtype)}
    with tempfile.TemporaryDirectory() as tmp:
        state, launches = phase_training(Path(tmp))
        phase_train_cli(Path(tmp))
        times.update(phase_train_times(state, Path(tmp)))
        phase_pair_shapes()
        phase_crowd_serving()
        crowd_state, crowd_launches, crowd_cfg, crowd_first = \
            phase_crowd_training(Path(tmp))
        bench_k5_k6_times()
        times.update(phase_crowd_times(crowd_state, crowd_cfg, crowd_first))
        phase_multiclass(Path(tmp))
        times["pair_ablate"], ablate_launches = phase_ablate()
        eval_launches = phase_evaluate(Path(tmp))
        serve_launches += phase_serve_trained(Path(tmp))
    phase_serve_times(card)
    phase_graph_times(card)
    tool_launches = phase_tools(card)
    precision_launches, precision_times = phase_precision(card)
    times.update(precision_times)
    mesh_launches = phase_mesh(card)
    drill_launches = phase_drill(card, DRILL_RUN_IMAGES)
    phase_tiles(card)
    files_launches = phase_drill_files(card)
    log(f"launches on the main paths: serving K1 {serve_launches} "
        f"(phases 4 and 14); "
        f"training {launches}; config 4 training {crowd_launches}; the "
        f"ablation tool K7 {ablate_launches}; evaluation {eval_launches}")
    launches = {**launches, "pair_pool_fwd": crowd_launches["pair_pool_fwd"],
                "pair_pool_bwd": crowd_launches["pair_pool_bwd"],
                "pair_ablate": ablate_launches}
    log(f"launches of the measuring tools (phase 16): {tool_launches}")
    log(f"launches of phase 17's main paths: {precision_launches}")
    log(f"launches of phase 18's main paths, over the ranks: "
        f"{mesh_launches}")
    log(f"launches of phase 19's main paths: {drill_launches}")
    log(f"launches of phase 21's main paths: {files_launches}")
    launches = {name: n + tool_launches[name] + precision_launches[name]
                + mesh_launches.get(name, 0) + drill_launches[name]
                + files_launches[name] for name, n in launches.items()}

    log(card)
    log(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"gossipnet_tpu_torch/ops/cuda/csrc/{source}",
        "replaces": replaces, "launches": launches[name],
        **times[name], "library_ms": None}
        for name, (source, replaces) in KERNEL_ROWS.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
