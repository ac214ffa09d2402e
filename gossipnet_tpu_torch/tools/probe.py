"""Measurement and validation probe: the port's counterpart of
``scripts/probe.py``, with its seven modes and its arguments.

    python -m gossipnet_tpu_torch.tools.probe MODE [--batch 8] [--n 1024]
        [--blocks 16] [--iters 20] [--impl pallas|pallas1|pallas2|dense]
        [--layout bucketed|clustered|uniform|mixed|blob]
        [--dtype bfloat16|float32] [--ew-dtype float32] [--device cpu]

Modes:
  forward   chained forward ms/iter at --batch/--n (and dets/s)
  step      the training step taken apart: forward, forward+matching and
            forward+backward, each chained
  train     captured training steps (``train.train_steps_group``): the
            marginal ms/step between 5 and 25 steps, and a finite loss
  match     the plain scan against K3, both through ``greedy_match_batch``
  parity    the dense plain path against the kernel path: max |diff|
  loop      the captured chain against a host-level chain of eager
            forwards (bit-equal), and single-call times
  activity  the fraction of tile pairs the kernels run: at the reference's
            x-sort and 128 x 128 tile, and at the port's Morton sort and
            the kernels' TILE_I x TILE_J tile

``--impl``: ``pallas`` is the config's pair kernel (``pair_kernel: 2``,
K1/K2), ``pallas1`` selects K5/K6 and ``pallas2`` K1/K2, ``dense`` the
dense plain path; on CPU tensors each kernel is its plain version.
``--ew-dtype bfloat16`` raises, as the model does (ROADMAP item 16).

Data (``scripts/probe.py:43-76``): ``bucketed`` is the first training
batch of ``synthetic_roidb(32, num_gt=100, dets_per_gt=8,
num_clutter=200)`` at N < 4096 and of ``crowd_roidb(8, num_people=380,
dets_per_person=10)`` at N >= 4096; the other layouts are
``layout_batch``. Weights are ``init_params(seed=0)``. A chain runs as
``tools/bench.py``'s does: on the card one captured graph of the loop
body, replayed; on the CPU eagerly. Every timed line names the device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from gossipnet_tpu_torch import train as training
from gossipnet_tpu_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
)
from gossipnet_tpu_torch.data.bucketing import BatchIterator
from gossipnet_tpu_torch.data.synthetic import (
    crowd_roidb,
    layout_batch,
    synthetic_roidb,
)
from gossipnet_tpu_torch.models.gossipnet import GossipNet, resolve_device
from gossipnet_tpu_torch.ops import order
from gossipnet_tpu_torch.ops import pair_features as pf
from gossipnet_tpu_torch.ops.cuda.launch import TILE_I, TILE_J
from gossipnet_tpu_torch.ops.cuda.matching_scan import split_thresholds
from gossipnet_tpu_torch.ops.cuda.pairwise2 import tile_activity
from gossipnet_tpu_torch.ops.matching import greedy_match_batch
from gossipnet_tpu_torch.params import as_state_dict, init_params
from gossipnet_tpu_torch.tools.bench import (
    Chain,
    card_line,
    forward_step,
    host_chain,
)
from gossipnet_tpu_torch.utils.cuda_graphs import StepGraphs

MODES = ("forward", "step", "train", "match", "parity", "loop", "activity")
_VALID_COLUMN = pf.DetColumns._fields.index("valid")


def _impl(args) -> tuple[str, int | None]:
    """(pool_impl, pair kernel or None for the config's)."""
    if args.impl in ("pallas1", "pallas2"):
        return "kernel", int(args.impl[-1])
    if args.impl in ("pallas", "dense"):
        return ("kernel" if args.impl == "pallas" else "dense"), None
    raise ValueError(f"unknown --impl {args.impl!r}; options: pallas, "
                     "pallas1, pallas2, dense")


def _config(args) -> Config:
    _, kernel = _impl(args)
    kernel_kw = {} if kernel is None else {"pair_kernel": kernel}
    return Config(
        model=ModelConfig(num_blocks=args.blocks, feature_dim=128,
                          reduced_dim=32, pairwise_dim=32,
                          pair_matmul_dtype=args.dtype,
                          pair_elementwise_dtype=args.ew_dtype,
                          **kernel_kw),
        train=TrainConfig(batch_size=args.batch),
        data=DataConfig(bucket_sizes=(args.n,)),
    )


def _data(args, device):
    """(the Batch, its arrays by name on ``device``)."""
    if args.layout != "bucketed":
        batch = layout_batch(args.layout, batch=args.batch, n=args.n, seed=0)
    else:
        if args.n >= 4096:
            roidb = crowd_roidb(num_images=8, seed=0, num_people=380,
                                dets_per_person=10)
        else:
            roidb = synthetic_roidb(num_images=32, seed=0, num_gt=100,
                                    dets_per_gt=8, num_clutter=200)
        batch = next(BatchIterator(roidb, args.batch, (args.n,), seed=0))
    return batch, training.batch_to_device(batch, device)


def _model_and_data(args, device):
    """(cfg, model with seeded weights, Batch, arrays on ``device``)."""
    cfg = _config(args)
    pool_impl, _ = _impl(args)
    model = training.build_model(cfg, pool_impl, device)
    model.load_state_dict(as_state_dict(init_params(cfg.model, seed=0)))
    batch, arrays = _data(args, device)
    return cfg, model, batch, arrays


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _chain_time(name: str, chain: Chain, s0, iters: int) -> float:
    """ms per iteration of ``iters`` chained iterations after one warm
    iteration, ended by a read-back (``scripts/probe.py:79``)."""
    s = chain.run(s0, 1)
    float(s.sum())
    s = s.clone()
    t0 = time.perf_counter()
    s = chain.run(s, iters)
    float(s.sum())
    dt = (time.perf_counter() - t0) / iters * 1e3
    print(f"{name}: {dt:.2f} ms/iter", flush=True)
    return dt


def mode_forward(args, device) -> float:
    _, model, _, arrays = _model_and_data(args, device)
    boxes, valid = arrays["boxes"], arrays["valid"]

    def fwd(s, k):
        with torch.no_grad():
            return torch.sigmoid(model(boxes, s + k * 1e-7, valid))

    dt = _chain_time(
        f"forward B={args.batch} N={args.n} blocks={args.blocks} "
        f"layout={args.layout} impl={args.impl}",
        Chain(fwd, arrays["scores"]), arrays["scores"], args.iters)
    print(f"  -> {args.batch * args.n / (dt / 1e3):,.0f} dets/sec "
          f"({card_line(device)})", flush=True)
    return dt


def mode_step(args, device) -> dict:
    args.layout = "bucketed"
    cfg, model, _, arrays = _model_and_data(args, device)
    boxes, valid = arrays["boxes"], arrays["valid"]
    at_half = split_thresholds([0.5], device)
    thresholds = split_thresholds(cfg.matching.thresholds, device)
    params = list(model.parameters())
    head = next(i for i, p in enumerate(params) if p is model.head.weight)

    def fwd(s, k):
        with torch.no_grad():
            return torch.sigmoid(model(boxes, s + k * 1e-7, valid))

    def match(s, k):
        lab = greedy_match_batch(
            boxes, s + k * 1e-7, valid, arrays["gt_boxes"],
            arrays["gt_valid"], arrays["gt_crowd"], at_half).labels
        return s * 0.999 + 0.001 * lab[:, 0]

    def grad(s, k):
        # every parameter's gradient, as a training step takes it
        with torch.enable_grad():
            loss = training.loss_and_metrics(
                model, dict(arrays, scores=s), cfg, thresholds)[0]
            g = torch.autograd.grad(loss, params)
        return s + 1e-9 * g[head].sum()

    s0 = arrays["scores"]
    out = {"forward": _chain_time("forward", Chain(fwd, s0), s0,
                                  args.iters),
           "forward+matching": _chain_time("forward+matching",
                                           Chain(match, s0), s0, args.iters),
           "forward+backward (grad)": _chain_time(
               "forward+backward (grad)", Chain(grad, s0), s0,
               max(args.iters // 2, 3))}
    print(f"  ({card_line(device)})", flush=True)
    return out


def mode_train(args, device) -> float:
    args.layout = "bucketed"
    cfg, model, batch, _ = _model_and_data(args, device)
    state = training.create_train_state(cfg, model)
    steps = StepGraphs(state, cfg, training.step_body)
    totals = {}
    for k in (5, 25):
        float(training.train_steps_group(steps, [batch] * k)["loss"])
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            loss = float(training.train_steps_group(steps, [batch] * k)
                         ["loss"])
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        totals[k] = best
        print(f"K={k}: total {totals[k] * 1e3:.1f} ms  mean loss "
              f"{loss:.4f}", flush=True)
        if not np.isfinite(loss):
            raise AssertionError(f"non-finite loss {loss}")
    marginal = (totals[25] - totals[5]) / 20 * 1e3
    print(f"marginal train step: {marginal:.1f} ms "
          f"({args.batch * args.n / marginal * 1e3:,.0f} dets/s trained; "
          f"{card_line(device)})", flush=True)
    return marginal


def mode_match(args, device) -> dict:
    args.layout = "bucketed"
    _, arrays = _data(args, device)
    at_half = split_thresholds([0.5], device)
    shape = tuple(arrays["scores"].shape)
    out = {}
    for impl in ("scan", "kernel"):
        def step(s, k, impl=impl):
            lab = greedy_match_batch(
                arrays["boxes"], s + k * 1e-7, arrays["valid"],
                arrays["gt_boxes"], arrays["gt_valid"], arrays["gt_crowd"],
                at_half, impl=impl).labels
            return s * 0.999 + 0.001 * lab[:, 0]

        def uniform(seed):
            return torch.from_numpy(np.random.default_rng(seed).uniform(
                0, 1, shape).astype(np.float32)).to(device)

        chain = Chain(step, arrays["scores"])
        totals = {}
        for k in (5, 25):
            # warm, then the median of 3 chains from fresh scores each
            float(chain.run(uniform(999 + k), k).sum())
            ts = []
            for rep in range(3):
                s0 = uniform(10 * k + rep)
                _sync(device)
                t0 = time.perf_counter()
                v = float(chain.run(s0, k).sum())
                ts.append(time.perf_counter() - t0)
            totals[k] = sorted(ts)[1]
            print(f"{impl} K={k}: median {totals[k] * 1e3:.1f} ms of "
                  f"{[round(t * 1e3, 1) for t in ts]} (v={v:.4f})",
                  flush=True)
        out[impl] = (totals[25] - totals[5]) / 20 * 1e3
        print(f"{impl} marginal: {out[impl]:.2f} ms/step "
              f"({card_line(device)})", flush=True)
    return out


def mode_parity(args, device) -> float:
    layout = args.layout if args.layout != "bucketed" else "clustered"
    d = layout_batch(layout, batch=args.batch, n=args.n, seed=3)
    boxes, scores, valid = (torch.from_numpy(x).to(device)
                            for x in (d.boxes, d.scores, d.valid))
    pool_impl, kernel = _impl(args)
    kernel_kw = {} if kernel is None else {"pair_kernel": kernel}
    mc = ModelConfig(num_blocks=min(args.blocks, 2), feature_dim=64,
                     reduced_dim=32, pairwise_dim=32,
                     pair_matmul_dtype="float32", **kernel_kw)
    weights = as_state_dict(init_params(mc, seed=0))
    outs = []
    for impl in ("dense", pool_impl):
        model = GossipNet(mc, pool_impl=impl, device=device)
        model.load_state_dict(weights)
        with torch.inference_mode():
            outs.append(model(boxes, scores, valid))
    diff = float((outs[0] - outs[1]).abs().max())
    print(f"dense vs {args.impl}: max abs diff {diff:.3e}", flush=True)
    if not diff < 2e-2:
        raise AssertionError(f"parity failure: {diff}")
    return diff


def mode_loop(args, device) -> list[float]:
    _, model, _, arrays = _model_and_data(args, device)
    step = forward_step(model, arrays["boxes"], arrays["valid"])
    scores = arrays["scores"]
    k_iters = 10
    chain = Chain(step, scores)
    host_val = host_chain(step, scores, k_iters).cpu()
    dev_val = chain.run(scores, k_iters).cpu()
    diff = float((host_val - dev_val).abs().max())
    print("host vs device loop max diff:", diff, flush=True)
    if not torch.equal(host_val, dev_val):
        raise AssertionError("the chained loop differs from the host chain")
    rng = np.random.default_rng(7)
    times = []
    for _ in range(8):
        s0 = torch.from_numpy(rng.uniform(0, 1, tuple(scores.shape)).astype(
            np.float32)).to(device)
        _sync(device)
        t0 = time.perf_counter()
        float(chain.run(s0, 1).sum())
        times.append(time.perf_counter() - t0)
    print("single fwd+readback ms:", [round(t * 1e3, 1) for t in times],
          f"({card_line(device)})", flush=True)
    return times


def activity(boxes, scores, valid, key, ti: int, tj: int) -> float:
    """The fraction of tile pairs whose row and column boxes meet, after a
    stable sort of the detections by ``key``."""
    perm = torch.argsort(key, dim=-1, stable=True)
    boxes = torch.gather(boxes, -2, perm[..., None].expand_as(boxes))
    cs = pf.stack_columns(pf.det_columns(
        boxes, torch.gather(scores, -1, perm), torch.gather(valid, -1, perm)))
    flags = tile_activity(cs, cs, ti, tj, valid_field=_VALID_COLUMN)
    return float(flags.float().mean())


def mode_activity(args, device) -> dict:
    _, arrays = _data(args, device)
    boxes, scores, valid = arrays["boxes"], arrays["scores"], arrays["valid"]
    x_key = torch.where(valid, 0.5 * (boxes[..., 0] + boxes[..., 2]),
                        torch.full_like(boxes[..., 0], float("inf")))
    out = {"x-sorted 128x128": activity(boxes, scores, valid, x_key, 128,
                                        128),
           f"morton {TILE_I}x{TILE_J}": activity(
               boxes, scores, valid, order.morton_sort_key(boxes, valid),
               TILE_I, TILE_J)}
    print(f"tile activity ({args.layout}, x-sorted): "
          f"{out['x-sorted 128x128']:.3f}", flush=True)
    print(f"tile activity ({args.layout}, Morton-sorted, {TILE_I}x{TILE_J} "
          f"tiles): {out[f'morton {TILE_I}x{TILE_J}']:.3f}", flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("mode", choices=MODES)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--blocks", type=int, default=16)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--impl", default="pallas",
                   help="pool impl: pallas (config-default kernel) | "
                        "pallas1 | pallas2 | dense")
    p.add_argument("--layout", default="bucketed",
                   help="bucketed | clustered | uniform | mixed | blob")
    p.add_argument("--dtype", default="bfloat16",
                   help="pair_matmul_dtype: bfloat16 | float32")
    p.add_argument("--ew-dtype", default="float32",
                   help="pair_elementwise_dtype: float32 | bfloat16")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    result = globals()[f"mode_{args.mode}"](args, device)
    print("DONE", flush=True)
    return result


if __name__ == "__main__":
    main()
