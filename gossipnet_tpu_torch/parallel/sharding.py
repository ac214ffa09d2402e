"""Device-mesh execution: (data, det) sharded training and inference
(port of ``gossipnet_tpu/parallel/sharding.py``).

- ``data``: batch data parallelism. Every rank holds the same global
  batch and takes rows ``[d * B / n_data, (d + 1) * B / n_data)`` of it
  (JAX's ``P(DATA_AXIS)``, written out); gradients and metrics are meaned
  over the ranks.
- ``det``: detection-axis model parallelism: the rows of the O(N^2) pair
  matrix split over the ranks of a data shard (``spmd.py``).

JAX runs this as one program over the mesh (``shard_map``); here each rank
is a process and the collectives are explicit (``world.py``). A mesh step
runs eagerly: a gloo collective cannot be captured into a CUDA graph.
"""

from __future__ import annotations

import torch
from torch import Tensor

from gossipnet_tpu_torch.config import Config
from gossipnet_tpu_torch.losses import matching_loss
from gossipnet_tpu_torch.parallel import world
from gossipnet_tpu_torch.parallel.spmd import gossipnet_sharded_forward
from gossipnet_tpu_torch.parallel.world import (
    DATA_AXIS,
    DET_AXIS,
    Mesh,
    make_mesh,
)

__all__ = ["DATA_AXIS", "DET_AXIS", "make_mesh", "mesh_from_config",
           "make_sharded_inference", "make_sharded_grads",
           "make_sharded_train_step", "data_shard"]


def mesh_from_config(cfg: Config, device, for_training: bool = True
                     ) -> Mesh | None:
    """The ('data', 'det') mesh ``cfg.parallel`` describes over this
    process's world, or None for the single-device path: the one decision
    point of ``train()``, the evaluation and ``api.Rescorer``.

    ``off``: no mesh. ``auto``: a mesh only in a world of more than one
    rank on CUDA devices (a CPU world never engages by itself). ``on``:
    the configured shape; a process without a world makes a world of one
    for a 1 x 1 mesh. A mesh covers the whole world, one rank a device.
    """
    p = cfg.parallel
    enable = p.enable
    if isinstance(enable, bool):   # YAML 1.1 parses on/off as booleans
        enable = "on" if enable else "off"
    if enable not in ("auto", "on", "off"):
        raise ValueError(f"parallel.enable must be auto|on|off, "
                         f"got {p.enable!r}")
    device = torch.device(device)
    if enable == "off":
        return None
    size = world.world_size()
    if enable == "auto" and (size <= 1 or device.type != "cuda"):
        return None
    n_det = max(int(p.det_axis), 1)
    if p.data_axis:
        n_data = int(p.data_axis)
    else:
        # data_axis=0 = "use what fits": every rank left, but for training
        # never more than evenly divides the batch
        n_data = max(size // n_det, 1)
        if for_training:
            while cfg.train.batch_size % n_data != 0:
                n_data -= 1
    if n_data * n_det > size:
        raise ValueError(
            f"parallel config needs {n_data}x{n_det} devices, "
            f"only {size} visible (one per rank of the world)")
    if n_data * n_det == 1 and enable == "auto":
        return None
    if n_data * n_det < size:
        raise ValueError(
            f"parallel config needs {n_data}x{n_det} devices but the world "
            f"has {size} ranks: a mesh covers every rank")
    _validate_shapes(cfg, n_data, n_det, for_training)
    if size == 1 and not torch.distributed.is_initialized():
        world.init_world("nccl" if device.type == "cuda" else "gloo", device)
    return make_mesh(n_data, n_det, device=device)


def _validate_shapes(cfg: Config, n_data: int, n_det: int,
                     for_training: bool) -> None:
    # Serving (Rescorer) pads its own batch rows to a data-axis
    # multiple, so only training checks batch_size.
    if for_training and cfg.train.batch_size % n_data != 0:
        raise ValueError(
            f"batch_size {cfg.train.batch_size} not divisible by "
            f"data axis {n_data}"
        )
    bad = [b for b in cfg.data.bucket_sizes if b % n_det != 0]
    if bad:
        raise ValueError(
            f"bucket sizes {bad} not divisible by det axis {n_det}"
        )


def data_shard(arrays: dict, mesh: Mesh) -> dict:
    """This rank's rows of every [B, ...] array of the global batch."""
    n_data = mesh.shape[DATA_AXIS]
    out = {}
    for k, v in arrays.items():
        b = v.shape[0]
        if b % n_data:
            raise ValueError(f"batch {b} does not tile the mesh data axis "
                             f"({n_data})")
        rows = b // n_data
        out[k] = v[mesh.data_rank * rows:(mesh.data_rank + 1) * rows]
    return out


def _forward(model, arrays: dict, mesh: Mesh) -> Tensor:
    multiclass = model.cfg.num_classes > 1
    return gossipnet_sharded_forward(
        model, arrays["boxes"], arrays["scores"], arrays["valid"],
        arrays["classes"] if multiclass else None, mesh=mesh)


def make_sharded_inference(mesh: Mesh):
    """-> ``fn(model, arrays) -> sigmoid scores [B, N]`` of the whole
    global batch on every rank: batch rows over 'data', pair rows over
    'det', with ``model``'s parameters and config (the config-5 serving
    path)."""

    def fn(model, arrays: dict) -> Tensor:
        with torch.no_grad():
            probs = torch.sigmoid(_forward(model, data_shard(arrays, mesh),
                                           mesh))
            return mesh.gather_rows(probs, DATA_AXIS, dim=0)

    return fn


def _closed_grads(model, arrays: dict, cfg: Config, mesh: Mesh
                  ) -> tuple[list[Tensor], dict]:
    """Backward of this rank's loss, then the closure over the mesh ->
    (the parameters' gradients, written to ``.grad`` too, and the metrics
    meaned over 'data').

    Each det rank computes the full loss of its data shard from the
    gathered logits, and the gather's backward sums the cotangents of all
    n_det copies, so each rank's raw gradient is d(n_det L)/dtheta over
    its own rows: the mean over 'det' (not the sum) is the gradient, then
    the mean over 'data' (``sharding.py:136-158``). With equal groups both
    means are one sum over the world divided by its size."""
    params = list(model.parameters())
    for p in params:
        p.grad = None
    logits = _forward(model, data_shard(arrays, mesh), mesh)
    loss, metrics = matching_loss(logits, data_shard(arrays, mesh), cfg)
    loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    mesh.all_reduce_(flat)
    flat /= mesh.size
    out = []
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)
        out.append(p.grad)
    names = sorted(metrics)
    m = torch.stack([metrics[k].detach().float() for k in names])
    mesh.all_reduce_(m, DATA_AXIS)
    m /= mesh.shape[DATA_AXIS]
    return out, dict(zip(names, m.unbind()))


def make_sharded_grads(cfg: Config, mesh: Mesh):
    """-> ``fn(model, arrays) -> (grads, metrics)``: the exact gradients
    of the global batch-mean loss, by parameter name, the same on every
    rank, comparable with the single-device gradient of the same loss."""

    def fn(model, arrays: dict):
        grads, metrics = _closed_grads(model, arrays, cfg, mesh)
        names = [n for n, _ in model.named_parameters()]
        return dict(zip(names, grads)), metrics

    return fn


def make_sharded_train_step(cfg: Config, mesh: Mesh):
    """-> ``step(state, arrays) -> (state, metrics)``: one SPMD step of the
    train state's model and ``OptaxOptimizer`` over the mesh. Parameters
    and optimizer slots stay the same on every rank (replicated); batches
    shard over 'data', the pair stage over 'det'."""
    if cfg.loss.normalize == "per_batch" and mesh.shape[DATA_AXIS] > 1:
        # Each data rank's loss sees only its batch shard, so 'per_batch'
        # would pool its weighting per SHARD: gradients would change with
        # the mesh shape while claiming whole-batch semantics. Refuse;
        # 'per_image' is mesh-invariant (each image normalizes alone).
        raise ValueError(
            "loss.normalize='per_batch' pools the whole batch into one "
            "weighting problem, which a data-sharded mesh cannot honor "
            f"(data axis = {mesh.shape[DATA_AXIS]}); use "
            "loss.normalize='per_image' or parallel.det_axis-only "
            "sharding")
    from gossipnet_tpu_torch.train import global_norm   # train imports us

    def step(state, arrays: dict):
        apply, hyper = state.optimizer.plan()
        grads, metrics = _closed_grads(state.model, arrays, cfg, mesh)
        metrics["grad_norm"] = global_norm(grads).detach()
        state.optimizer.update(apply, hyper)
        if apply:
            state.schedule.step()
        state.step += 1
        return state, metrics

    return step

