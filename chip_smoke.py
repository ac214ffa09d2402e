"""End-to-end check of gossipnet_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
1. the card (nvidia-smi name and power limit) and the software versions;
2. builds K1, K2 and K3/K4 (ops/cuda/csrc/pairwise2_fwd.cu,
   pairwise2_bwd.cu, matching_scan.cu) from the sources here, one nvcc
   each, all at once, with each build's time and ptxas registers/spills;
3. K1 against its plain PyTorch version on the card: f32 and bf16, the
   clustered B=8 N=1024 batch, B=1 N=4096, an odd rectangular NR != NC,
   block-sparse on and off, multi-class, all-padding rows; a probe with
   identity weights that makes m bit-exact only if the neighbour masks
   match;
3b. K2 against its plain backward on the same cases, f32 and bf16; a tie
   probe (every column duplicated: each tie must get the full gradient);
   a winner count (no winner of K1's max missed); two launches
   bit-identical;
3c. K3 and K4 against the plain scan, exactly: the training batch with
   T=1 and T=10, duplicated GT columns (first index wins), N=4096;
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
   plain path, at B=2 N=512;
8. the train CLI runs 5 steps from a temporary YAML and writes metrics;
9. times of the training path with CUDA events: the step host to host and
   on the device, the device busy share and each kernel's share, K2, K3
   and K4 ms/launch beside their plain versions and bounds.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it prints no result
and exits 1.
"""

from __future__ import annotations

import io
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gossipnet_tpu_torch import train as training
from gossipnet_tpu_torch.api import Rescorer
from gossipnet_tpu_torch.config import load_config, experiment_path
from gossipnet_tpu_torch.data.bucketing import BatchIterator, make_batch
from gossipnet_tpu_torch.data.synthetic import (
    layout_batch,
    layout_record,
    synthetic_roidb,
)
from gossipnet_tpu_torch.models.gossipnet import PairParams
from gossipnet_tpu_torch.ops import matching
from gossipnet_tpu_torch.ops import order
from gossipnet_tpu_torch.ops import pair_features as pf
from gossipnet_tpu_torch.ops.cuda import build
from gossipnet_tpu_torch.ops.cuda import matching_scan as k3
from gossipnet_tpu_torch.ops.cuda import pairwise2 as k1
from gossipnet_tpu_torch.params import as_state_dict, init_params
from gossipnet_tpu_torch.serving import serve_stream

# Published H100 SXM peaks (dense): bf16 tensor cores, f32 on CUDA cores,
# HBM3 bandwidth. Bounds below are against these, at the card's power
# limit printed beside them.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
IOU_OPS = 13            # min/max/sub/max x2, mul, add, sub, max, div, cmp
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)   # one bf16 ulp of h1 may flip
LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)  # 16 blocks compound f32 order
GRAD_TOL = dict(rtol=1e-3, atol=1e-3)   # the same, through the backward
WEIGHT_GRAD_REL = 1e-4   # sums over ~1e5 pairs in another order, of max|x|
KERNELS = ("pairwise2_fwd", "pairwise2_bwd", "matching_scan")
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
}
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


def compare(name, dtype, cols, rows=None, classes=None, block_sparse=True,
            probe=False, seed=0):
    """K1 vs its plain version on one input; returns the max abs error."""
    rng = np.random.default_rng(seed)
    b, _, nc = cols.shape
    row_cols = cols if rows is None else cols[:, :, rows].contiguous()
    nr = row_cols.shape[2]
    g = pf.NUM_PAIR_FEATURES_MC if classes is not None else \
        pf.NUM_PAIR_FEATURES
    a, bb, prm = random_pair_inputs(rng, b, nr, nc, 32, g)
    if probe:
        # wg = 0, W2 = I, b2 = 0, a = 0, b > 0: m_i = max of b_j over the
        # neighbour set, exact in any order: equal only if the masks are.
        a = torch.zeros_like(a)
        bb = bb.abs() + 1.0
        prm = PairParams(prm.wa, prm.wb, torch.zeros_like(prm.wg), prm.b1,
                         torch.eye(32, device=a.device),
                         torch.zeros_like(prm.b2))
    kw = dict(classes=None if classes is None else
              (classes if rows is None else classes[:, rows].contiguous()),
              col_classes=classes, compute_dtype=dtype)
    got = k1.pair_pool(row_cols, cols, a, bb, prm, 0.2,
                       block_sparse=block_sparse, **kw)
    want = k1.pair_pool_reference(row_cols, cols, a, bb, prm, 0.2, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if probe:
        ok = torch.equal(got, want)
        tol = "bit-exact (neighbour masks equal)"
    elif dtype == "float32":
        ok = torch.allclose(got, want, **F32_TOL)
        tol = f"rtol=atol={F32_TOL['atol']}"
    else:
        ok = (torch.allclose(got, want, **BF16_TOL)
              and ((got - want).abs() > 1e-4).float().mean().item() < 0.01)
        tol = "rtol=atol=2e-2, 99% within 1e-4"
    log(f"  K1 {name:<24} {dtype:<8} B={b} NR={nr} NC={nc} "
        f"max_abs_err={err:.3e} tol {tol} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version: {name} "
                             f"{dtype} max_abs_err={err}")
    return err


def phase_kernel_cases() -> float:
    log("phase 3: K1 against its plain version on the card")
    dev = torch.device(DEV)
    cols_1024 = pf.stack_columns(pf.det_columns(*sorted_bench_batch(8, 1024)))
    cols_4096 = pf.stack_columns(pf.det_columns(*sorted_bench_batch(1, 4096)))
    boxes, scores, valid = sorted_bench_batch(3, 700, seed=5)
    valid[1] = False                      # an all-padding image
    valid[2, 300:] = False                # and padding tail rows
    cols_pad = pf.stack_columns(pf.det_columns(boxes, scores, valid))
    cols_mc = pf.stack_columns(pf.det_columns(*sorted_bench_batch(2, 512)))
    cls = torch.from_numpy(np.random.default_rng(1).integers(
        0, 4, (2, cols_mc.shape[2]))).to(dev)
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

    k1.pair_pool.launches = 0
    t0 = time.perf_counter()
    out = rescorer.rescore_batch(images, batch_size=8)
    batch_s = time.perf_counter() - t0
    launches = k1.pair_pool.launches
    n_batches = len(buckets)       # every image group fits one batch
    log(f"  rescore_batch: {len(images)} images in {batch_s * 1e3:.1f} ms, "
        f"K1 launches {launches} (expected {16 * n_batches} = 16 x "
        f"{n_batches} batches)")
    if launches != cfg.model.num_blocks * n_batches:
        raise AssertionError(f"K1 launches {launches} != 16 x {n_batches}")
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

    # what this run's data needs: neighbour pairs through the MLP, and the
    # IoU test over the valid pairs of the active tiles
    rv = geom.row[:, 7] > 0
    cv = geom.col[:, 7] > 0
    iou = k1.fields_iou(geom.row[..., None], geom.col[:, :, None, :])
    pair_valid = rv[:, :, None] & cv[:, None, :]
    nb_pairs = ((iou >= torch.tensor(0.2, device=iou.device))
                & pair_valid).sum().item()
    active = geom.flags.repeat_interleave(k1.TILE_I, 1)[:, :1024] \
        .repeat_interleave(k1.TILE_J, 2)[:, :, :1024] > 0
    tested = (active & pair_valid).sum().item()
    p, k = 32, 3
    mlp_ops = nb_pairs * (2 * p * p + (k + 6) * p)
    iou_ops = tested * IOU_OPS
    ops_s = mlp_ops / (PEAK_BF16 if dtype == "bfloat16" else PEAK_F32) \
        + iou_ops / PEAK_F32
    nbytes = sum(t.numel() * t.element_size() for t in
                 (geom.row, geom.col, a2, b2, wg_k, w2, b2bias, geom.flags)) \
        + a2.numel() * 4                                    # the output m
    bytes_s = nbytes / PEAK_BYTES
    bound_ms = max(ops_s, bytes_s) * 1e3
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
    log(f"  bound {bound_ms:.5f} ms ({'operations' if ops_s >= bytes_s else 'bytes'}"
        f": {nb_pairs} neighbour pairs x {2 * p * p + (k + 6) * p} ops, "
        f"{tested} IoU tests, {nbytes / 1e6:.2f} MB); tiles skipped "
        f"{skipped:.4f}")
    busy = f"{busy_ms / fwd_ms:.3f}" if busy_ms else "not measured"
    log(f"  forward (16 blocks, 16 K1 launches): {fwd_ms:.3f} ms = "
        f"{dets_s:.0f} dets/s (B x N / forward time); device busy {busy} "
        f"of it, K1 {16 * kernel_ms / fwd_ms:.3f}; Rescorer.rescore_batch "
        f"of 8 images host-to-host: {e2e_ms:.3f} ms")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if ops_s >= bytes_s else "bytes")

# ---------------------------------------------------------------------------
# K2: the pair-pool backward
# ---------------------------------------------------------------------------

GRAD_NAMES = ("d_a'", "d_b'", "dWg_k", "dW2", "db2")


def pair_args(cols, rows=None, classes=None, block_sparse=True, seed=0,
              b_cols=None):
    """(geom, a', b', Wg_k, W2, b2) of one pair stage on random weights, and
    a random cotangent dm; ``b_cols`` overrides the column detections'
    b' (the tie probe)."""
    rng = np.random.default_rng(seed)
    b, _, nc = cols.shape
    row_cols = cols if rows is None else cols[:, :, rows].contiguous()
    nr = row_cols.shape[2]
    g = pf.NUM_PAIR_FEATURES_MC if classes is not None else \
        pf.NUM_PAIR_FEATURES
    a, bb, prm = random_pair_inputs(rng, b, nr, nc, 32, g)
    rcls = None if classes is None else \
        (classes if rows is None else classes[:, rows].contiguous())
    geom = k1.pair_geometry(row_cols, cols, 0.2, rcls, classes, block_sparse)
    a2, b2 = k1.fold_separable(prm.wg, a, bb, geom)
    if b_cols is not None:
        b2 = b_cols
    dm = torch.from_numpy(rng.standard_normal((b, nr, 32)).astype(
        np.float32)).to(a.device)
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
            if dtype == "float32":
                good = torch.allclose(x, y, **F32_TOL)
            else:
                good = (torch.allclose(x, y, **BF16_TOL) and
                        ((x - y).abs() > 1e-4).float().mean().item() < 0.01)
        else:
            good = err <= WEIGHT_GRAD_REL * max(y.abs().max().item(), 1e-30)
        ok = ok and good
    return errs, ok


def compare_k2(name, dtype, cols, **kw):
    """K2 on K1's m against the plain backward on the plain forward's m."""
    args, dm = pair_args(cols, **kw)
    m_k = k1.launch_kernel(*args, dtype)
    m_p = k1._reference_core(*args, dtype)
    got = k1.launch_backward_kernel(*args, m_k, dm, dtype)
    want = k1.pair_pool_backward_reference(*args, m_p, dm, dtype)
    torch.cuda.synchronize()
    errs, ok = grad_errors(got, want, dtype)
    log(f"  K2 {name:<24} {dtype:<8} NR={args[1].shape[1]} "
        f"NC={args[2].shape[1]} m==plain m: {torch.equal(m_k, m_p)}; "
        + " ".join(f"{n}={e:.2e}" for n, e in errs.items())
        + f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K2 disagrees with its plain version: {name} "
                             f"{dtype} {errs}")
    return max(errs.values())


def k2_winners(cols, dtype):
    """dm = 1: db2[q] counts the winners of q, at least one per row with
    m > 0 (more only at exact ties). A recompute that missed K1's bits
    would miss winners here."""
    args, dm = pair_args(cols)
    m = k1.launch_kernel(*args, dtype)
    db2 = k1.launch_backward_kernel(*args, m, torch.ones_like(dm), dtype)[4]
    rows = (m > 0).sum(dim=(0, 1)).float()
    log(f"  K2 winners {dtype:<8}: {int(db2.sum().item())} for "
        f"{int(rows.sum().item())} (row, q) maxima > 0")
    if not bool((db2 >= rows).all()):
        raise AssertionError(f"K2 missed winners in {dtype}")


def k2_tie_probe(cols, dtype):
    """Every column duplicated: each max then ties exactly between j and
    its copy, and each tie must get the full dm (the TPU kernel's rule),
    so d_b' repeats d_b' of the single problem on both copies, and d_a',
    dWg_k, dW2 and db2 double. A rule that split ties would halve them."""
    args_s, dm = pair_args(cols)
    geom_s, a2, b2, wg_k, w2, b2bias = args_s
    dup = torch.repeat_interleave(cols, 2, dim=2)
    geom_d = k1.pair_geometry(cols, dup, 0.2)
    args_d = (geom_d, a2, torch.repeat_interleave(b2, 2, dim=1).contiguous(),
              wg_k, w2, b2bias)
    m_s = k1.launch_kernel(*args_s, dtype)
    m_d = k1.launch_kernel(*args_d, dtype)
    single = k1.launch_backward_kernel(*args_s, m_s, dm, dtype)
    got = k1.launch_backward_kernel(*args_d, m_d, dm, dtype)
    plain = k1.pair_pool_backward_reference(
        *args_d, k1._reference_core(*args_d, dtype), dm, dtype)
    torch.cuda.synchronize()
    db_d = got[1]
    want = (2 * single[0], single[1].repeat_interleave(2, dim=1),
            2 * single[2], 2 * single[3], 2 * single[4])
    errs, ok = grad_errors(got, want, dtype)
    errs_p, ok_p = grad_errors(got, plain, dtype)
    copies = torch.equal(db_d[:, 0::2], db_d[:, 1::2])
    ok = ok and ok_p and copies and torch.equal(m_s, m_d)
    log(f"  K2 tie probe {dtype:<8}: copies of d_b' bit-equal {copies}; vs "
        f"full-gradient rule max {max(errs.values()):.2e}, vs plain "
        f"{max(errs_p.values()):.2e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K2 tie rule fails in {dtype}: {errs} {errs_p}")
    return max(max(errs.values()), max(errs_p.values()))


def phase_k2_cases() -> float:
    log("phase 3b: K2 (pair-pool backward) against its plain version")
    dev = torch.device(DEV)
    cols_1024 = pf.stack_columns(pf.det_columns(*sorted_bench_batch(8, 1024)))
    cols_4096 = pf.stack_columns(pf.det_columns(*sorted_bench_batch(1, 4096)))
    boxes, scores, valid = sorted_bench_batch(3, 700, seed=5)
    valid[1] = False
    valid[2, 300:] = False
    cols_pad = pf.stack_columns(pf.det_columns(boxes, scores, valid))
    cols_mc = pf.stack_columns(pf.det_columns(*sorted_bench_batch(2, 512)))
    cls = torch.from_numpy(np.random.default_rng(1).integers(
        0, 4, (2, cols_mc.shape[2]))).to(dev)
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
                    k2_tie_probe(cols_1024[:2, :, :512].contiguous(), dtype))
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
        calls.append(tuple(x.detach().clone() if isinstance(x, torch.Tensor)
                           else x for x in args))
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


def compare_scan(name, iou, thresholds, single=False):
    thr = torch.tensor(thresholds, dtype=torch.float32)
    if single:
        got = k3.launch_kernel(iou[None].contiguous(), thr)
    else:
        got = k3.launch_kernel(iou, thr)
    want = k3.greedy_scan_reference(iou[None] if single else iou, thr)
    torch.cuda.synchronize()
    ok = all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(got, want))
    log(f"  {'K4' if single else 'K3'} {name:<28} shape "
        f"{tuple(iou.shape)} T={len(thresholds)}: matched "
        f"{int(want[0].sum().item())}, exact: {ok}")
    if not ok:
        raise AssertionError(f"scan kernel differs from its plain version: "
                             f"{name}")


def phase_scan_cases():
    log("phase 3c: K3/K4 (greedy matching scan) against the plain scan")
    arrays = training_batch()
    iou1, _ = scan_input(arrays, (0.5,))
    compare_scan("probe_batch_t1", iou1, (0.5,))
    iou10, _ = scan_input(arrays, COCO_THRESHOLDS, seed=1)
    compare_scan("probe_batch_t10", iou10, COCO_THRESHOLDS)
    g = iou1.shape[2]
    ties = iou1.repeat_interleave(2, dim=2)[:, :, :g].contiguous()
    compare_scan("duplicated_gt_columns", ties, COCO_THRESHOLDS)
    rec = layout_record(np.random.default_rng(3), 0, "clustered", 4096)
    big = training.batch_to_device(make_batch([rec], padded_n=4096),
                                   torch.device(DEV))
    iou4k, _ = capture(k3, "greedy_scan", lambda: matching.greedy_match(
        big["boxes"][0], big["scores"][0], big["valid"][0],
        big["gt_boxes"][0], big["gt_valid"][0], big["gt_crowd"][0], (0.5,),
        impl="kernel"))
    compare_scan("clustered_n4096", iou4k, (0.5,), single=True)
    return iou1, iou10


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


def reset_counts():
    k1.pair_pool.launches = 0
    k1.pair_pool_backward.launches = 0
    k3.greedy_scan_batched.launches = 0
    k3.greedy_scan.launches = 0


def counts() -> dict:
    return {"pair_pool2_fwd": k1.pair_pool.launches,
            "pair_pool2_bwd": k1.pair_pool_backward.launches,
            "greedy_scan_batched": k3.greedy_scan_batched.launches,
            "greedy_scan": k3.greedy_scan.launches}


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
    # The label check adds one forward (16 K1) and one K3 launch; K4 runs
    # once per image of it.
    want = {"pair_pool2_fwd": blocks * steps + blocks,
            "pair_pool2_bwd": blocks * steps,
            "greedy_scan_batched": steps + 1,
            "greedy_scan": first.batch_size}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want} (16 K1 + 16 K2 "
                             f"+ 1 K3 per step)")
    log(f"  = {blocks} K1 + {blocks} K2 + 1 K3 per step over {steps} steps "
        f"(+ one checking forward, and K4 on its {first.batch_size} images, "
        f"whose labels equal the batched K3 labels)")

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
    worst, bad = 0.0, []
    for k, g in grads["kernel"].items():
        d = grads["dense"][k]
        worst = max(worst, (g - d).abs().max().item())
        if not torch.allclose(g, d, **GRAD_TOL):
            bad.append(k)
    log(f"  B=2 N={arrays['boxes'].shape[1]}: {len(grads['kernel'])} "
        f"parameter gradients, max |diff| {worst:.3e} (tol rtol=atol=1e-3)"
        f" -> {'ok' if not bad else 'FAIL ' + str(bad[:4])}")
    if bad:
        raise AssertionError(f"gradients differ: {bad}")


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
    call}); (0.0, {}) when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # kernel events only: a user annotation (the optimizer's step range)
    # also carries device time, spanning the kernels inside it
    by_name = {e.key: e.device_time_total / reps / 1e3
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


def k2_bound(args, m, dm, dtype) -> tuple[float, str, str]:
    """The least time for K2's work on these inputs: the recompute of every
    neighbour pair (K1's count), the per-pair backward (dpre1 mask, d_a',
    d_b', dWg_k) and, per winning (pair, q), a column of W2 dpre2, of dW2
    and db2; the IoU tests of the active tiles; each input read and each
    output written once."""
    geom, a2, b2, wg_k, w2, b2bias = args
    p, k = a2.shape[-1], wg_k.shape[0]
    rv, cv = geom.row[:, 7] > 0, geom.col[:, 7] > 0
    iou = k1.fields_iou(geom.row[..., None], geom.col[:, :, None, :])
    pair_valid = rv[:, :, None] & cv[:, None, :]
    nb = ((iou >= torch.tensor(geom.neighbor_iou, device=iou.device))
          & pair_valid).sum().item()
    nr, nc = geom.row.shape[2], geom.col.shape[2]
    active = geom.flags.repeat_interleave(k1.TILE_I, 1)[:, :nr] \
        .repeat_interleave(k1.TILE_J, 2)[:, :, :nc] > 0
    tested = (active & pair_valid).sum().item()
    winners = k1.launch_backward_kernel(*args, m, torch.ones_like(dm),
                                        dtype)[4].sum().item()
    mlp = (nb * (2 * p * p + (k + 6) * p + 3 * p + 2 * k * p)
           + winners * (4 * p + 1))
    ops_s = mlp / (PEAK_BF16 if dtype == "bfloat16" else PEAK_F32) \
        + tested * IOU_OPS / PEAK_F32
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
    two comparisons per (b, t, n, g); the serial chain over N is what
    limits the kernel and no bound counts it."""
    b, n, g = iou.shape
    bytes_s = (iou.numel() * 4 + t * 4 + b * n * t * 5) / PEAK_BYTES
    ops_s = 2 * b * t * n * g / PEAK_F32
    return max(bytes_s, ops_s) * 1e3, \
        "operations" if ops_s >= bytes_s else "bytes"


def phase_train_times(state, tmp: Path) -> dict:
    """Times at the training shape B=8 N=1024 G=112 with CUDA events."""
    cfg = train_config(tmp, "times")
    dtype = cfg.model.pair_matmul_dtype
    log(f"phase 9: times of the training path at B=8 N=1024 G=112 (config 2,"
        f" pair products in {dtype})")
    dev = torch.device(DEV)
    it = BatchIterator(synthetic_roidb(**TRAIN_DATA), 8,
                       cfg.data.bucket_sizes)
    batches = [training.batch_to_device(next(it), dev) for _ in range(4)]
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

    def steps(n):
        for i in range(n):
            training.train_step(state, batches[i % 4], cfg)

    def host_ms(reps=10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(reps)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    steps(2)
    # in turns (events, host, host, events): the host clock spreads
    runs = [cuda_time(lambda: steps(1), iters=10, warmup=1), host_ms(),
            host_ms(), cuda_time(lambda: steps(1), iters=10, warmup=1)]
    step_ms = float(np.median(runs[0::3]))
    host_med = float(np.median(runs[1:3]))
    busy_ms, by_name = profile_kernels(lambda: steps(1), reps=3)

    def share(part):
        return sum(v for key, v in by_name.items() if part in key)

    log(f"  training step, ms (events, host, host, events): "
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
    log(f"  K3 T={len(thr)}: {k3_ms:.4f} ms/launch; plain {k3_plain_ms:.3f} "
        f"ms; bound {k3_bound_ms:.6f} ms ({k3_by}, {iou.numel() * 4 / 1e6:.2f}"
        f" MB of IoU; the serial chain of {iou.shape[1]} steps limits it)")
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


def phase_build():
    log(f"phase 2: build {', '.join(KERNELS)} from ops/cuda/csrc/, one nvcc "
        f"each, all at once")
    t0 = time.perf_counter()
    build.build(KERNELS)
    log(f"  built in {time.perf_counter() - t0:.1f} s wall")
    for name in KERNELS:
        log(f"  {name}.cu: {build.build_seconds.get(name, 0.0):.1f} s")
        for line in build.build_logs.get(name, "").splitlines():
            if "Used" in line or "spill" in line:
                log("    ptxas:", line.strip())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    card = card_line()
    log(f"phase 1: card {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    phase_build()

    worst = {"pair_pool2_fwd": phase_kernel_cases(),
             "pair_pool2_bwd": phase_k2_cases(),
             "greedy_scan_batched": 0.0, "greedy_scan": 0.0}   # exact
    phase_scan_cases()
    cfg = load_config(experiment_path("serving_bucketed"))
    rescorer, serve_launches = phase_serving(cfg)
    times = {"pair_pool2_fwd": phase_times(rescorer,
                                           cfg.model.pair_matmul_dtype)}
    with tempfile.TemporaryDirectory() as tmp:
        state, launches = phase_training(Path(tmp))
        phase_train_gradients()
        phase_train_cli(Path(tmp))
        times.update(phase_train_times(state, Path(tmp)))
    log(f"launches on the main paths: serving K1 {serve_launches}; "
        f"training {launches}")

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
