"""End-to-end check of gossipnet_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
1. the card (nvidia-smi name and power limit) and the software versions;
2. builds K1 (ops/cuda/csrc/pairwise2_fwd.cu) from the sources here;
3. K1 against its plain PyTorch version on the card: f32 and bf16, the
   clustered B=8 N=1024 batch, B=1 N=4096, an odd rectangular NR != NC,
   block-sparse on and off, multi-class, all-padding rows; a probe with
   identity weights that makes m bit-exact only if the neighbour masks
   match;
4. the main path: the 16-block serving_bucketed.yaml model with seeded
   numpy weights through the bridge serves images in all five buckets via
   Rescorer.rescore_batch and serve_stream, with K1's launch counter
   checked against 16 launches per batch; its f32 logits against the
   dense plain path; the serve CLI answering JSON lines;
5. times with CUDA events at the bench workload (B=8, N=1024, clustered).

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
import time
from pathlib import Path

import numpy as np
import torch

from gossipnet_tpu_torch.api import Rescorer
from gossipnet_tpu_torch.config import load_config, experiment_path
from gossipnet_tpu_torch.data.synthetic import layout_batch, layout_record
from gossipnet_tpu_torch.models.gossipnet import PairParams
from gossipnet_tpu_torch.ops import order
from gossipnet_tpu_torch.ops import pair_features as pf
from gossipnet_tpu_torch.ops.cuda import build
from gossipnet_tpu_torch.ops.cuda import pairwise2 as k1
from gossipnet_tpu_torch.params import init_params
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


def main_path_k1_inputs(model, boxes, scores, valid):
    """The arguments of block 0's K1 launch in one forward of ``model``."""
    captured = []
    launch = k1.launch_kernel

    def record(*args):
        captured.append(args)
        return launch(*args)

    k1.launch_kernel = record
    try:
        model(boxes, scores, valid)
    finally:
        k1.launch_kernel = launch
    return captured[0]


def profile_forward(model, boxes, scores, valid, reps=3) -> float:
    """Device time by kernel over ``reps`` forwards, from torch.profiler's
    CUDA trace (kernel events only, so no op is counted twice); returns
    the device busy ms per forward (0.0 when the trace has no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(boxes, scores, valid)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                model(boxes, scores, valid)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = sorted(((e.device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.device_time_total > 0), reverse=True)
    if not rows:
        log("  profile: the trace holds no device time (not measured)")
        return 0.0
    busy_ms = sum(us for us, _, _ in rows) / reps / 1e3
    log(f"  profile of {reps} forwards: kernels {busy_ms:.4f} ms per "
        f"forward ({wall_ms:.3f} ms wall under the profiler); by kernel:")
    for us, key, count in rows[:8]:
        log(f"    {us / reps / 1e3 / busy_ms:6.3f}  {us / reps / 1e3:8.4f} "
            f"ms/fwd  x{count // reps:<4} {key[:70]}")
    return busy_ms


def phase_times(rescorer, dtype):
    log(f"phase 5: times at the bench workload (B=8, N=1024, clustered), "
        f"K1 in {dtype}")
    model = rescorer.model
    boxes, scores, valid = sorted_bench_batch(8, 1024)
    with torch.inference_mode():
        geom, a2, b2, wg_k, w2, b2bias, _ = main_path_k1_inputs(
            model, boxes, scores, valid)
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

    busy_ms = profile_forward(model, boxes, scores, valid)

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    card = card_line()
    log(f"phase 1: card {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    log("phase 2: build K1 from ops/cuda/csrc/pairwise2_fwd.cu")
    t0 = time.perf_counter()
    build.build(["pairwise2_fwd"])
    log(f"  built in {time.perf_counter() - t0:.1f} s")
    for line in build.build_logs.get("pairwise2_fwd", "").splitlines():
        if "Used" in line or "spill" in line:
            log("  ptxas:", line.strip())

    worst = phase_kernel_cases()
    cfg = load_config(experiment_path("serving_bucketed"))
    rescorer, launches = phase_serving(cfg)
    times = phase_times(rescorer, cfg.model.pair_matmul_dtype)

    log(card)
    log(json.dumps({"kernels": [{
        "name": "pair_pool2_fwd", "route": "cuda",
        "source": "gossipnet_tpu_torch/ops/cuda/csrc/pairwise2_fwd.cu",
        "replaces": "gossipnet_tpu/ops/pallas/pairwise2.py:529",
        "launches": launches, "max_abs_err": worst,
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "library_ms": None}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
