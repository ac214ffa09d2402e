"""Training (port of ``gossipnet_tpu/train.py``): the matching-driven loss,
an optimizer with optax's semantics, checkpoint/resume and the CLI.

One step is the forward (16 K1 launches at config 2; K5 with
``pair_kernel: 1``), greedy det<->GT matching on the detached logits (one
K3 launch; within classes when ``matching.class_aware``), the balanced
logistic loss, the backward (16 K2 launches; K6) and the optimizer
update. Batches are padded to static buckets; a resumed run replays the
exact stream (model, optimizer, schedule, step, generator and iterator
cursor are all saved).

    python -m gossipnet_tpu_torch.train -c experiments/coco_persons_full.yaml

runs on the card and raises without one. Not ported yet, and raising
where a run reaches them: the default COCO evaluation when ``eval_every``
fires with a validation set (ROADMAP.md item 10; ``train(eval_fn=...)``
takes a custom one), the ``coco``/``pets`` loaders (item 10),
``parallel.enable: "on"`` (item 14) and ``--profile`` (item 13).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch
from torch import Tensor

from gossipnet_tpu_torch.config import Config
from gossipnet_tpu_torch.data.bucketing import Batch, BatchIterator
from gossipnet_tpu_torch.data.roidb import Roidb
from gossipnet_tpu_torch.losses import matching_loss
from gossipnet_tpu_torch.models.gossipnet import GossipNet, resolve_device
from gossipnet_tpu_torch.params import as_state_dict, init_params
from gossipnet_tpu_torch.utils.checkpoint import CheckpointManager
from gossipnet_tpu_torch.utils.metrics import MetricsLogger, StepTimer

BATCH_KEYS = ("boxes", "scores", "valid", "classes", "gt_boxes",
              "gt_classes", "gt_valid", "gt_crowd")


def make_lr_schedule(cfg: Config) -> Callable[[int], float]:
    """The learning rate of parameter update ``count`` (from 0), as
    ``gossipnet_tpu.train.make_lr_schedule`` builds it from optax schedules.

    Horizons are configured in micro-steps and the schedule advances once
    per update, so they scale by 1/``grad_accum_steps``; step boundaries
    that collide after the scaling compound their decay factors.
    """
    t = cfg.train
    k = max(t.grad_accum_steps, 1)
    lr = t.learning_rate
    if t.lr_schedule == "constant":
        def sched(count: int) -> float:
            return lr
    elif t.lr_schedule == "step":
        bounds: dict[int, float] = {}
        for s in t.lr_decay_steps:
            key = max(int(s) // k, 1)
            bounds[key] = bounds.get(key, 1.0) * t.lr_decay_rate

        def sched(count: int) -> float:   # optax.piecewise_constant_schedule
            v = lr
            for boundary, scale in sorted(bounds.items()):
                if count >= boundary:
                    v = v * scale
            return v
    elif t.lr_schedule == "cosine":
        decay_steps = max(t.max_steps // k, 1)

        def sched(count: int) -> float:   # optax.cosine_decay_schedule
            c = min(count, decay_steps)
            return lr * (0.5 * (1 + math.cos(math.pi * c / decay_steps)))
    else:
        raise ValueError(f"unknown lr_schedule {t.lr_schedule!r}")
    if t.warmup_steps > 0:
        warm, main = max(t.warmup_steps // k, 1), sched

        def sched(count: int) -> float:   # join(linear warmup, main)
            if count < warm:
                return (0.0 - lr) * (1 - max(count, 0) / warm) + lr
            return main(count - warm)
    return sched


def global_norm(tensors: Sequence[Tensor]) -> Tensor:
    """optax.global_norm: the L2 norm of all elements together (per-tensor
    norms in one fused launch, then their norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class OptaxOptimizer(torch.optim.Optimizer):
    """optax's chain, written out: ``clip_by_global_norm`` (when
    ``grad_clip_norm > 0``) then ``adam`` / ``adamw`` / ``sgd`` (momentum
    0.9), inside ``MultiSteps`` when ``grad_accum_steps > 1``.

    - clipping scales by ``max_norm / norm`` when ``norm >= max_norm``,
      with no epsilon (``clip_grad_norm_`` adds 1e-6);
    - Adam keeps eps outside the square root, bias-corrects both moments;
    - accumulation keeps the running mean of the micro-step gradients and
      updates once every k micro-steps, clipping that mean.

    Every operation runs over all parameters at once (``torch._foreach_*``,
    the same elementwise arithmetic as one op per tensor), and nothing
    waits for the device. The learning rate of an update is
    ``param_groups[0]["lr"]``; a ``LambdaLR`` of :func:`make_lr_schedule`
    sets it (initial lr 1.0, so the rate is the schedule's value exactly).
    :meth:`step` returns True when it updated the parameters.
    """

    def __init__(self, params, cfg: Config):
        t = cfg.train
        if t.optimizer not in ("adam", "adamw", "sgd"):
            raise ValueError(f"unknown optimizer {t.optimizer!r}")
        super().__init__(params, dict(
            lr=1.0, kind=t.optimizer, max_norm=float(t.grad_clip_norm),
            weight_decay=float(t.weight_decay),
            accum=max(int(t.grad_accum_steps), 1), b1=0.9, b2=0.999,
            eps=1e-8, momentum=0.9, count=0, mini_step=0))

    def _slots(self, name: str) -> list[Tensor]:
        params = self.param_groups[0]["params"]
        return [self.state[p].setdefault(name, torch.zeros_like(p))
                for p in params]

    @torch.no_grad()
    def step(self, closure=None) -> bool:
        group = self.param_groups[0]
        params = group["params"]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        k = group["accum"]
        if k > 1:
            n, accs = group["mini_step"], self._slots("acc")
            delta = torch._foreach_sub(grads, accs)     # acc += (g - acc)/(n+1)
            torch._foreach_div_(delta, n + 1)
            torch._foreach_add_(accs, delta)
            if n + 1 < k:
                group["mini_step"] = n + 1
                return False
            group["mini_step"] = 0
            grads = [a.clone() for a in accs]
            torch._foreach_zero_(accs)
        if group["max_norm"] > 0:
            # where(norm < max, g, g / norm * max), as an exact 0/1 blend
            norm, max_norm = global_norm(grads), group["max_norm"]
            keep = (norm < max_norm).float()
            clipped = torch._foreach_div(grads, norm)
            torch._foreach_mul_(clipped, max_norm)
            torch._foreach_mul_(clipped, 1.0 - keep)
            grads = torch._foreach_mul(grads, keep)
            torch._foreach_add_(grads, clipped)
        group["count"] += 1
        c, lr = group["count"], group["lr"]
        if group["kind"] == "sgd":
            traces = self._slots("trace")               # g + momentum * trace
            torch._foreach_mul_(traces, group["momentum"])
            torch._foreach_add_(traces, grads)
            update = torch._foreach_mul(traces, -lr)
        else:
            b1, b2 = group["b1"], group["b2"]
            mus, nus = self._slots("mu"), self._slots("nu")
            torch._foreach_mul_(mus, b1)                # (1-b1) g + b1 mu
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
            sq = torch._foreach_mul(grads, grads)       # (1-b2) g^2 + b2 nu
            torch._foreach_mul_(sq, 1 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, sq)
            denom = torch._foreach_div(nus, 1 - b2 ** c)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(mus, 1 - b1 ** c)
            torch._foreach_div_(update, denom)
            if group["kind"] == "adamw":
                torch._foreach_add_(update, torch._foreach_mul(
                    params, group["weight_decay"]))
            torch._foreach_mul_(update, -lr)
        torch._foreach_add_(params, update)
        return True


def make_optimizer(cfg: Config, params) -> tuple[OptaxOptimizer,
                                                 torch.optim.lr_scheduler.LambdaLR]:
    """The optimizer and the LambdaLR that drives its learning rate."""
    opt = OptaxOptimizer(params, cfg)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, make_lr_schedule(cfg))


def build_model(cfg: Config, pool_impl: str = "dense",
                device="cuda") -> GossipNet:
    """An uninitialised GossipNet for ``cfg.model`` on ``device``, with
    ``train.remat_blocks``."""
    return GossipNet(cfg.model, pool_impl=pool_impl, device=device,
                     remat=cfg.train.remat_blocks)


@dataclasses.dataclass
class TrainState:
    """Everything a resumed run needs: the model (parameters), the
    optimizer and its schedule, the step count and a generator (seeded for
    stochastic extensions; the JAX state's PRNG key)."""

    model: GossipNet
    optimizer: OptaxOptimizer
    schedule: torch.optim.lr_scheduler.LambdaLR
    step: int
    generator: torch.Generator

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "schedule": self.schedule.state_dict(),
                "step": self.step,
                "generator": self.generator.get_state()}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.schedule.load_state_dict(sd["schedule"])
        self.step = int(sd["step"])
        self.generator.set_state(sd["generator"])


def create_train_state(cfg: Config, model: GossipNet, seed: int | None = None,
                       params=None) -> TrainState:
    """Loads ``params`` (a state_dict, or a JAX tree through the bridge;
    default ``init_params(cfg.model, seed)``) into ``model`` and builds the
    optimizer around it."""
    seed = cfg.train.seed if seed is None else seed
    params = init_params(cfg.model, seed) if params is None else params
    model.load_state_dict(as_state_dict(params))
    opt, schedule = make_optimizer(cfg, list(model.parameters()))
    return TrainState(model, opt, schedule, 0,
                      torch.Generator().manual_seed(seed))


def loss_and_metrics(model: GossipNet, batch_arrays: dict,
                     cfg: Config) -> tuple[Tensor, dict]:
    """Forward + matching + weighted logistic loss, all on the device (a
    class-agnostic model ignores the batch's class ids)."""
    logits = model(batch_arrays["boxes"], batch_arrays["scores"],
                   batch_arrays["valid"], batch_arrays["classes"])
    return matching_loss(logits, batch_arrays, cfg)


def train_step(state: TrainState, batch_arrays: dict, cfg: Config):
    """One micro-step -> (state, metrics): loss, pos_frac, num_pos and
    grad_norm (of the step's gradient, before clipping), as 0-d tensors
    left on the device."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_and_metrics(state.model, batch_arrays, cfg)
    loss.backward()
    params = state.optimizer.param_groups[0]["params"]
    metrics["grad_norm"] = global_norm(
        [p.grad for p in params if p.grad is not None]).detach()
    if state.optimizer.step():
        state.schedule.step()
    state.step += 1
    return state, metrics


def train_steps_group(state: TrainState, group: list[dict], cfg: Config):
    """``steps_per_call`` steps (the JAX package scans them in one device
    call): metrics are the group's means, grad_norm the last step's."""
    mlist = []
    for arrays in group:
        state, m = train_step(state, arrays, cfg)
        mlist.append(m)
    out = {k: torch.stack([m[k] for m in mlist]).mean() for k in mlist[0]}
    out["grad_norm"] = mlist[-1]["grad_norm"]
    return state, out


def batch_to_device(batch: Batch, device) -> dict:
    """The batch's arrays as tensors on ``device`` (copies queued without
    waiting for the device)."""
    return {k: torch.from_numpy(np.ascontiguousarray(getattr(batch, k)))
            .to(device, non_blocking=True) for k in BATCH_KEYS}


def train(
    cfg: Config,
    roidb: Roidb,
    val_roidb: Roidb | None = None,
    pool_impl: str = "kernel",
    metrics_path: str | None = None,
    max_steps: int | None = None,
    eval_fn=None,
    profile_dir: str | None = None,
    tb_dir: str | None = None,
    stop=None,
    device="cuda",
    params=None,
) -> TrainState:
    """Full training loop with checkpoint/resume and periodic eval.

    Resumes from ``cfg.train.checkpoint_dir`` when it holds a checkpoint.
    ``eval_fn(state) -> dict`` runs every ``eval_every`` steps (a ``"AP"``
    key keeps the best checkpoint); without one, a ``val_roidb`` would need
    the COCO evaluation, which is not ported (raises, ROADMAP.md item 10).
    ``stop``: a zero-arg callable polled once per drawn batch; when it
    returns True, queued batches flush as single steps, a checkpoint is
    written and the state returns, and a later ``train()`` on the same
    checkpoint dir resumes bit-exactly. ``params`` seeds the model (a
    state_dict or a JAX tree; default ``init_params``).
    """
    if profile_dir:
        raise NotImplementedError(
            "--profile (a trace of training steps) is not ported yet: "
            "ROADMAP.md item 13")
    if cfg.parallel.enable == "on":
        raise NotImplementedError(
            "parallel.enable='on' (a device mesh) is not ported yet: "
            "ROADMAP.md item 14")
    device = resolve_device(device)
    t = cfg.train
    max_steps = max_steps if max_steps is not None else t.max_steps
    model = build_model(cfg, pool_impl, device)
    it = BatchIterator(roidb, t.batch_size, cfg.data.bucket_sizes,
                       seed=t.seed, shuffle=cfg.data.shuffle)
    state = create_train_state(cfg, model, params=params)

    ckpt = CheckpointManager(t.checkpoint_dir, max_to_keep=t.keep_checkpoints)
    if ckpt.latest_step() is not None:
        state, host_state = ckpt.restore(state)
        if "iterator" in host_state:
            it.set_state(host_state["iterator"])
        print(f"resumed from step {state.step}", flush=True)

    logger = MetricsLogger(metrics_path, tb_dir=tb_dir)
    timer = StepTimer()

    def default_eval(st):
        if val_roidb is None:
            return {}
        raise NotImplementedError(
            "periodic COCO evaluation (eval_every with a validation set) is "
            "not ported yet: ROADMAP.md item 10; pass train(eval_fn=...)")

    eval_fn = eval_fn or default_eval
    spc = max(int(t.steps_per_call), 1)
    # Queues key on BOTH padded shapes, as the JAX loop stacks them.
    queues: dict[tuple[int, int], list[Batch]] = {}

    def run_group(state, group: list[Batch]):
        arrays = [batch_to_device(b, device) for b in group]
        if len(arrays) == 1:
            return train_step(state, arrays[0], cfg)
        return train_steps_group(state, arrays, cfg)

    def flush_queues(state):
        """Train every queued batch as single steps (deterministic order),
        so the iterator state always matches the trained stream."""
        nonlocal host_step
        for key in sorted(queues):
            for b in queues[key]:
                state, _ = train_step(state, batch_to_device(b, device), cfg)
                host_step += 1
            queues[key] = []
        return state

    host_step = state.step

    def planned_steps() -> int:
        return host_step + sum(len(v) for v in queues.values())

    preempted = False
    while planned_steps() < max_steps:
        if stop is not None and stop():
            preempted = True
            break
        batch = next(it)
        key = (batch.padded_n, batch.padded_g)
        queues.setdefault(key, []).append(batch)
        group = queues[key]
        if len(group) < spc:
            continue
        queues[key] = []
        state, metrics = run_group(state, group)
        host_step += len(group)
        step = host_step
        for b in group:
            timer.tick(int(np.sum(b.valid)))

        if step % t.log_every < spc or step >= max_steps:
            logger.log(step, steps_per_sec=timer.steps_per_sec,
                       dets_per_sec=timer.dets_per_sec,
                       **{k: float(v) for k, v in metrics.items()})
        if t.snapshot_every and step % t.snapshot_every < spc:
            state = flush_queues(state)
            step = state.step
            ckpt.save(step, state, {"iterator": it.get_state()})
        if t.eval_every and step % t.eval_every < spc:
            stats = eval_fn(state)
            if stats:
                logger.log(step, **{f"val_{k}": v for k, v in stats.items()})
                if "AP" in stats:
                    ckpt.maybe_save_best(stats["AP"], state)

    # Tail: batches drawn but still queued train as single steps before the
    # final save; the preemption path exits through the same code.
    state = flush_queues(state)
    ckpt.save(state.step, state, {"iterator": it.get_state()})
    if preempted:
        print(f"preempted: snapshot at step {state.step}; rerun to resume",
              flush=True)
    return state


def _datasets(cfg: Config) -> tuple[Roidb, Roidb | None]:
    if cfg.data.dataset != "synthetic":
        raise NotImplementedError(
            f"dataset {cfg.data.dataset!r} (the COCO/PETS loaders) is not "
            "ported yet: ROADMAP.md item 10; use data.dataset: synthetic")
    from gossipnet_tpu_torch.data.synthetic import synthetic_roidb

    nc = cfg.model.num_classes
    return (synthetic_roidb(num_images=256, seed=cfg.train.seed,
                            num_classes=nc),
            synthetic_roidb(num_images=32, seed=cfg.train.seed + 1,
                            num_classes=nc))


def main(argv: list[str] | None = None) -> None:
    """CLI: python -m gossipnet_tpu_torch.train -c experiments/foo.yaml"""
    import argparse
    import signal
    import threading

    from gossipnet_tpu_torch.config import load_config

    p = argparse.ArgumentParser(description="Train GossipNet (PyTorch/CUDA)")
    p.add_argument("-c", "--config", default=None, help="YAML config")
    p.add_argument("--metrics", default="train_metrics.jsonl")
    p.add_argument("--pool-impl", default="kernel",
                   choices=["dense", "kernel"],
                   help="pair stage: the CUDA pair kernels of "
                        "model.pair_kernel (default) or dense")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace of training steps (not ported: item 13)")
    p.add_argument("--tensorboard", default=None, metavar="DIR",
                   help="also mirror scalars to TensorBoard summaries")
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    device = resolve_device("cuda")
    roidb, val = _datasets(cfg)
    # Preemption: the first SIGTERM/SIGINT finishes the in-flight group,
    # flushes, checkpoints (iterator cursor included) and exits 0; rerunning
    # resumes bit-exactly. A second signal kills.
    stop_ev = threading.Event()

    def _preempt(signum, frame):
        del frame
        if stop_ev.is_set():
            signal.signal(signum, signal.SIG_DFL)
            signal.raise_signal(signum)
        print("signal received: checkpointing, then exiting "
              "(signal again to kill)", flush=True)
        stop_ev.set()

    signal.signal(signal.SIGTERM, _preempt)
    signal.signal(signal.SIGINT, _preempt)
    train(cfg, roidb, val_roidb=val, pool_impl=args.pool_impl,
          metrics_path=args.metrics, profile_dir=args.profile,
          tb_dir=args.tensorboard, stop=stop_ev.is_set, device=device)


if __name__ == "__main__":
    main()
