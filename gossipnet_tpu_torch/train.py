"""Training (port of ``gossipnet_tpu/train.py``): the matching-driven loss,
an optimizer with optax's semantics, checkpoint/resume and the CLI.

One step is the forward (16 K1 launches at config 2; K5 with
``pair_kernel: 1``), greedy det<->GT matching on the detached logits (one
K3 launch; within classes when ``matching.class_aware``), the balanced
logistic loss, the backward (16 K2 launches; K6) and the optimizer
update. Batches are padded to static buckets; a resumed run replays the
exact stream (model, optimizer, schedule, step, generator and iterator
cursor are all saved).

On the card ``train`` replays one captured graph of the step per padded
shape (``utils/cuda_graphs.py::StepGraphs``), as the reference jits its
step; :func:`train_step` is the same step run eagerly, its oracle. On the
CPU the same step function runs eagerly.

    python -m gossipnet_tpu_torch.train -c experiments/coco_persons_full.yaml

runs on the card and raises without one; ``--profile DIR`` writes a
``torch.profiler`` trace of steps 10-15. When ``eval_every`` fires with a
validation set, the COCO AP of the rescored detections
(``evaluate.evaluate_model``) is logged as ``val_*`` and the best
checkpoint follows ``val_AP``.

On a device mesh (``parallel.enable: "on"``, or ``auto`` in a world of
several CUDA ranks; ``parallel/sharding.py``) each batch is one SPMD step
of every rank, run eagerly, and ``steps_per_call`` falls back to single
steps. Every rank restores the checkpoint; rank 0 alone writes
checkpoints and metrics, and the ranks wait for each write. Under
``torchrun`` the CLI joins its world (NCCL, ``cuda:LOCAL_RANK``):

    torchrun --nproc-per-node 4 -m gossipnet_tpu_torch.train -c cfg.yaml
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch import Tensor

from gossipnet_tpu_torch.config import Config
from gossipnet_tpu_torch.data.bucketing import Batch, BatchIterator
from gossipnet_tpu_torch.data.roidb import Roidb
from gossipnet_tpu_torch.losses import matching_loss
from gossipnet_tpu_torch.models.gossipnet import GossipNet, resolve_device
from gossipnet_tpu_torch.ops.matching import Thresholds
from gossipnet_tpu_torch.params import as_state_dict, init_params
from gossipnet_tpu_torch.parallel.sharding import (
    make_sharded_train_step,
    mesh_from_config,
)
from gossipnet_tpu_torch.utils.checkpoint import CheckpointManager
from gossipnet_tpu_torch.utils.cuda_graphs import StepGraphs
from gossipnet_tpu_torch.utils.metrics import MetricsLogger, StepTimer
from gossipnet_tpu_torch.utils.profiling import StepProfiler

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


class Hyper(NamedTuple):
    """The scalars one update of :class:`OptaxOptimizer` reads, computed on
    the host by :meth:`OptaxOptimizer.plan`: Python numbers in an eager
    step, 0-d device tensors in a captured one (written before each
    replay, so no value freezes at its capture-time value).

    Each divisor comes as its reciprocal, which the update multiplies by:
    on the card ``torch._foreach_div`` by a Python number multiplies by its
    reciprocal while the 0-d tensor overload divides, so only a product
    gives an eager and a captured step the same bits."""

    acc_scale: float | Tensor  # 1 / (n + 1): the accumulation mean's step
    neg_lr: float | Tensor     # -learning rate
    inv_bc1: float | Tensor    # 1 / (1 - b1 ** count), Adam's first
    inv_bc2: float | Tensor    # and second bias correction


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
    A micro-step is host bookkeeping (:meth:`plan`) and device arithmetic
    (:meth:`update`), so that a captured step can run the second alone;
    :meth:`step` does both and returns True when it updated the
    parameters.
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

    def make_slots(self) -> list[Tensor]:
        """Every slot an update reads, made now if missing (zeros, as the
        first update would make them) -> the slot tensors. A step is
        captured only after this: a slot made inside a graph would be
        zeroed on every replay."""
        group = self.param_groups[0]
        names = ("trace",) if group["kind"] == "sgd" else ("mu", "nu")
        names += ("acc",) if group["accum"] > 1 else ()
        return [t for name in names for t in self._slots(name)]

    def plan(self) -> tuple[bool, Hyper]:
        """The host bookkeeping of one micro-step: advances ``mini_step``
        and ``count`` -> (whether it updates the parameters, its
        :class:`Hyper` scalars)."""
        group = self.param_groups[0]
        n, k = 0, group["accum"]
        if k > 1:
            n = group["mini_step"]
            if n + 1 < k:
                group["mini_step"] = n + 1
                return False, Hyper(1 / (n + 1), 0.0, 1.0, 1.0)
            group["mini_step"] = 0
        group["count"] += 1
        self._opt_called = True   # what LRScheduler checks: an update ran
        c, lr = group["count"], group["lr"]
        return True, Hyper(1 / (n + 1), -lr, 1 / (1 - group["b1"] ** c),
                           1 / (1 - group["b2"] ** c))

    @torch.no_grad()
    def update(self, apply: bool, hyper: Hyper) -> None:
        """The device arithmetic of one micro-step on the parameters'
        ``.grad``: accumulate (``grad_accum_steps > 1``) and, when
        ``apply``, clip and update."""
        group = self.param_groups[0]
        params = group["params"]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if group["accum"] > 1:
            accs = self._slots("acc")
            delta = torch._foreach_sub(grads, accs)     # acc += (g - acc)/(n+1)
            torch._foreach_mul_(delta, hyper.acc_scale)
            torch._foreach_add_(accs, delta)
            if not apply:
                return
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
        if group["kind"] == "sgd":
            traces = self._slots("trace")               # g + momentum * trace
            torch._foreach_mul_(traces, group["momentum"])
            torch._foreach_add_(traces, grads)
            update = torch._foreach_mul(traces, hyper.neg_lr)
        else:
            b1, b2 = group["b1"], group["b2"]
            mus, nus = self._slots("mu"), self._slots("nu")
            torch._foreach_mul_(mus, b1)                # (1-b1) g + b1 mu
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
            sq = torch._foreach_mul(grads, grads)       # (1-b2) g^2 + b2 nu
            torch._foreach_mul_(sq, 1 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, sq)
            denom = torch._foreach_mul(nus, hyper.inv_bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_mul(mus, hyper.inv_bc1)
            torch._foreach_div_(update, denom)
            if group["kind"] == "adamw":
                torch._foreach_add_(update, torch._foreach_mul(
                    params, group["weight_decay"]))
            torch._foreach_mul_(update, hyper.neg_lr)
        torch._foreach_add_(params, update)

    def step(self, closure=None) -> bool:
        apply, hyper = self.plan()
        self.update(apply, hyper)
        return apply

    def load_state_dict(self, state_dict: dict) -> None:
        """Loads as torch's Optimizer does, but into the slot tensors that
        exist already, in place (a slot the saved state lacks is zeroed):
        a captured step reads them at the addresses it was captured with."""
        params = self.param_groups[0]["params"]
        live = [dict(self.state[p]) for p in params]
        super().load_state_dict(state_dict)
        with torch.no_grad():
            for p, slots in zip(params, live):
                for name, tensor in slots.items():
                    loaded = self.state[p].get(name)
                    if loaded is None:
                        tensor.zero_()
                    else:
                        tensor.copy_(loaded)
                    self.state[p][name] = tensor


def make_optimizer(cfg: Config, params) -> tuple[OptaxOptimizer,
                                                 torch.optim.lr_scheduler.LambdaLR]:
    """The optimizer and the LambdaLR that drives its learning rate."""
    opt = OptaxOptimizer(params, cfg)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, make_lr_schedule(cfg))


def build_model(cfg: Config, pool_impl: str = "dense", device="cuda",
                pair_tile=None) -> GossipNet:
    """An uninitialised GossipNet for ``cfg.model`` on ``device``, with
    ``train.remat_blocks`` and the pair kernels' skip tile ``pair_tile``
    (``None``: the default; see :class:`GossipNet`)."""
    return GossipNet(cfg.model, pool_impl=pool_impl, device=device,
                     remat=cfg.train.remat_blocks, pair_tile=pair_tile)


@dataclasses.dataclass
class TrainState:
    """Everything a resumed run needs: the model (parameters), the
    optimizer and its schedule, the step count and a generator (seeded for
    stochastic extensions; the JAX state's PRNG key). ``graphs``: the
    captured steps that ``train`` runs on this state (not saved)."""

    model: GossipNet
    optimizer: OptaxOptimizer
    schedule: torch.optim.lr_scheduler.LambdaLR
    step: int
    generator: torch.Generator
    graphs: StepGraphs | None = dataclasses.field(default=None, repr=False)

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "schedule": self.schedule.state_dict(),
                "step": self.step,
                "generator": self.generator.get_state()}

    def load_state_dict(self, sd: dict) -> None:
        """Copies into the live parameters and optimizer slots in place,
        so captured steps stay valid."""
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


def loss_and_metrics(model: GossipNet, batch_arrays: dict, cfg: Config,
                     thresholds: Thresholds | None = None,
                     ) -> tuple[Tensor, dict]:
    """Forward + matching + weighted logistic loss, all on the device (a
    class-agnostic model ignores the batch's class ids)."""
    logits = model(batch_arrays["boxes"], batch_arrays["scores"],
                   batch_arrays["valid"], batch_arrays["classes"])
    return matching_loss(logits, batch_arrays, cfg, thresholds)


def step_body(state: TrainState, batch_arrays: dict, cfg: Config,
              apply: bool, hyper: Hyper,
              thresholds: Thresholds | None = None) -> dict:
    """The device work of one micro-step, which the card captures:
    forward, matching, loss, backward, the global norm and the optimizer's
    update (``apply`` and ``hyper`` from ``OptaxOptimizer.plan``) ->
    metrics: loss, pos_frac, num_pos and grad_norm (of the step's
    gradient, before clipping), 0-d tensors left on the device."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_and_metrics(state.model, batch_arrays, cfg,
                                     thresholds)
    loss.backward()
    params = state.optimizer.param_groups[0]["params"]
    metrics["grad_norm"] = global_norm(
        [p.grad for p in params if p.grad is not None]).detach()
    state.optimizer.update(apply, hyper)
    return metrics


def train_step(state: TrainState, batch_arrays: dict, cfg: Config):
    """One eager micro-step -> (state, metrics): the oracle of the captured
    step that ``train`` replays (the same :func:`step_body`, its scalars
    Python numbers)."""
    apply, hyper = state.optimizer.plan()
    metrics = step_body(state, batch_arrays, cfg, apply, hyper)
    if apply:
        state.schedule.step()
    state.step += 1
    return state, metrics


def train_steps_group(steps: StepGraphs, group: list[Batch]) -> dict:
    """``steps_per_call`` steps, one replay of the captured step each (the
    JAX package scans them in one device call): metrics are the group's
    means, grad_norm the last step's."""
    mlist = [steps(host_arrays(b)) for b in group]
    out = {k: torch.stack([m[k] for m in mlist]).mean() for k in mlist[0]}
    out["grad_norm"] = mlist[-1]["grad_norm"]
    return out


def host_arrays(batch: Batch) -> dict:
    """The batch's arrays by name, as numpy."""
    return {k: getattr(batch, k) for k in BATCH_KEYS}


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
    key keeps the best checkpoint); without one, a ``val_roidb`` gets the
    COCO evaluation of its rescored detections.
    ``stop``: a zero-arg callable polled once per drawn batch; when it
    returns True, queued batches flush as single steps, a checkpoint is
    written and the state returns, and a later ``train()`` on the same
    checkpoint dir resumes bit-exactly (on a mesh every rank passes one,
    and rank 0's answer counts). ``params`` seeds the model (a state_dict
    or a JAX tree; default ``init_params``).

    ``cfg.parallel`` puts the run on a mesh (``mesh_from_config``), whose
    steps run eagerly, not as captured graphs. ``enable: "on"`` at 1 x 1 in
    a process that belongs to no world makes one, a ``torch.distributed``
    default group of one rank that stays for the life of the process.
    """
    device = resolve_device(device)
    mesh = mesh_from_config(cfg, device)
    main = mesh is None or mesh.is_main
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

    if mesh is None:
        # captured after the restore above, so they read the restored
        # tensors
        steps = state.graphs = StepGraphs(state, cfg, step_body)
    else:
        sharded_step = make_sharded_train_step(cfg, mesh)
        if main:
            print(f"training on mesh {mesh.shape}", flush=True)

        def steps(arrays: dict) -> dict:
            return sharded_step(state, {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in arrays.items()})[1]

    def save(step: int) -> None:
        """Rank 0 writes; on a mesh every rank waits for the write."""
        if main:
            ckpt.save(step, state, {"iterator": it.get_state()})
        if mesh is not None:
            mesh.barrier()

    def should_stop() -> bool:
        if stop is None:
            return False
        flag = bool(stop())
        if mesh is not None:   # every rank stops at rank 0's batch
            flag = bool(mesh.broadcast_(torch.tensor(
                [int(flag)], device=device)).item())
        return flag

    logger = MetricsLogger(metrics_path if main else None, echo=main,
                           tb_dir=tb_dir if main else None)
    timer = StepTimer()
    profiler = StepProfiler(profile_dir or "profile",
                            enabled=bool(profile_dir) and main)

    def default_eval(st):
        if val_roidb is None:
            return {}
        from gossipnet_tpu_torch.evaluate import (
            evaluate_model,
            sharded_forward_fn,
        )

        # periodic evaluation runs on the training mesh
        fwd = None if mesh is None else sharded_forward_fn(mesh, st.model)
        return evaluate_model(
            None, st.model, val_roidb,
            batch_size=t.batch_size, bucket_sizes=cfg.data.bucket_sizes,
            forward_fn=fwd,
        )

    eval_fn = eval_fn or default_eval
    spc = max(int(t.steps_per_call), 1)
    # Queues key on BOTH padded shapes, as the JAX loop stacks them.
    queues: dict[tuple[int, int], list[Batch]] = {}

    def run_group(state, group: list[Batch]):
        if len(group) == 1:
            return state, steps(host_arrays(group[0]))
        return state, train_steps_group(steps, group)

    def flush_queues(state):
        """Train every queued batch as single steps (deterministic order),
        so the iterator state always matches the trained stream."""
        nonlocal host_step
        for key in sorted(queues):
            for b in queues[key]:
                steps(host_arrays(b))
                host_step += 1
            queues[key] = []
        return state

    host_step = state.step

    def planned_steps() -> int:
        return host_step + sum(len(v) for v in queues.values())

    preempted = False
    while planned_steps() < max_steps:
        if should_stop():
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
        profiler.step(step)

        if step % t.log_every < spc or step >= max_steps:
            logger.log(step, steps_per_sec=timer.steps_per_sec,
                       dets_per_sec=timer.dets_per_sec,
                       **{k: float(v) for k, v in metrics.items()})
        if t.snapshot_every and step % t.snapshot_every < spc:
            state = flush_queues(state)
            step = state.step
            save(step)
        if t.eval_every and step % t.eval_every < spc:
            stats = eval_fn(state)
            if stats:
                logger.log(step, **{f"val_{k}": v for k, v in stats.items()})
                if "AP" in stats and main:
                    ckpt.maybe_save_best(stats["AP"], state)
                if mesh is not None:
                    mesh.barrier()

    # Tail: batches drawn but still queued train as single steps before the
    # final save; the preemption path exits through the same code.
    state = flush_queues(state)
    profiler.close()
    save(state.step)
    if preempted:
        print(f"preempted: snapshot at step {state.step}; rerun to resume",
              flush=True)
    return state


def _datasets(cfg: Config) -> tuple[Roidb, Roidb | None]:
    """The training and validation sets ``cfg.data`` names."""
    d = cfg.data
    if d.dataset == "synthetic":
        from gossipnet_tpu_torch.data.synthetic import synthetic_roidb

        nc = cfg.model.num_classes
        return (synthetic_roidb(num_images=256, seed=cfg.train.seed,
                                num_classes=nc),
                synthetic_roidb(num_images=32, seed=cfg.train.seed + 1,
                                num_classes=nc))
    if d.dataset == "pets":
        from gossipnet_tpu_torch.data.pets import build_pets_roidb

        return (build_pets_roidb(d.ann_file, d.det_file,
                                 max_dets=d.max_detections),
                build_pets_roidb(d.val_ann_file, d.val_det_file,
                                 max_dets=d.max_detections)
                if d.val_ann_file else None)
    from gossipnet_tpu_torch.data.roidb import build_roidb

    return (build_roidb(d.ann_file, d.det_file, person_only=d.person_only,
                        max_dets=d.max_detections),
            build_roidb(d.val_ann_file, d.val_det_file,
                        person_only=d.person_only,
                        max_dets=d.max_detections)
            if d.val_ann_file else None)


def main(argv: list[str] | None = None) -> None:
    """CLI: python -m gossipnet_tpu_torch.train -c experiments/foo.yaml"""
    import argparse
    import signal
    import threading

    from gossipnet_tpu_torch.config import load_config
    from gossipnet_tpu_torch.parallel.world import world_from_env

    p = argparse.ArgumentParser(description="Train GossipNet (PyTorch/CUDA)")
    p.add_argument("-c", "--config", default=None, help="YAML config")
    p.add_argument("--metrics", default="train_metrics.jsonl")
    p.add_argument("--pool-impl", default="kernel",
                   choices=["dense", "kernel"],
                   help="pair stage: the CUDA pair kernels of "
                        "model.pair_kernel (default) or dense")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of steps 10-15 to "
                        "DIR/trace.json")
    p.add_argument("--tensorboard", default=None, metavar="DIR",
                   help="also mirror scalars to TensorBoard summaries")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card; under "
                        "torchrun cuda:LOCAL_RANK) or cpu")
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    device = resolve_device(world_from_env(args.device))
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
