"""The process world a device mesh lives in (no JAX counterpart: JAX runs
one controller that owns every device; the port runs one process per
rank, each with its own device).

- :func:`init_world` joins this process to a ``torch.distributed`` world
  with an explicit backend, device, rank and size; :func:`world_from_env`
  does it from the variables ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``: NCCL on ``cuda:LOCAL_RANK``).
- :func:`run_world` starts a world of ``spawn``-ed processes that each run
  one function and returns what each returned. It never forks, and a rank
  that raises, dies or outlives the timeout makes it raise after it has
  killed the rest.
- :class:`Mesh` is the ('data', 'det') grid over the world's ranks, laid
  out row-major as ``jax.sharding.Mesh(devices.reshape(n_data, n_det))``,
  with one process group per row, per column and for the whole grid, each
  with the world's timeout, and one more for the main rank's small
  messages to ranks that wait idle (:meth:`Mesh.announce`).
- :class:`AllGatherRows` gathers the row shards of a tensor with one
  ``all_reduce``: each rank writes its rows into zeros, so the sum is
  exact. Its backward sums the cotangent over the group and keeps this
  rank's rows: ``psum_scatter``, the transpose of ``all_gather``.

Only ``all_reduce`` and ``broadcast`` are used, the two collectives that
both NCCL and gloo take on CUDA tensors, so a world of gloo ranks sharing
one card runs every path that NCCL runs across cards.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
from torch import Tensor

DATA_AXIS = "data"
DET_AXIS = "det"
DEFAULT_TIMEOUT_S = 300.0
# the timeout of Mesh.announce's group: a rank waits there for the next
# request of a server, however long the server stays idle
IDLE_TIMEOUT = datetime.timedelta(days=3650)
# init_world's timeout, which the groups of a mesh take too (None: a world
# made elsewhere, whose groups take torch's default)
_world_timeout: datetime.timedelta | None = None


def init_world(backend: str = "gloo", device="cpu", rank: int = 0,
               world_size: int = 1, init_method: str | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join this process to the default ``torch.distributed`` group ->
    this rank's device (made current on CUDA).

    ``init_method`` names the rendezvous (``tcp://localhost:<port>``,
    ``env://``); a world of one needs none. ``timeout_s`` bounds every
    collective of the world and of its meshes (not :meth:`Mesh.announce`),
    so a dead peer fails the run instead of hanging it."""
    global _world_timeout
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a world")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} but no CUDA device is "
                               "visible")
        torch.cuda.set_device(device)
    timeout = _world_timeout = datetime.timedelta(seconds=timeout_s)
    if init_method is None:
        if world_size != 1:
            raise ValueError("a world of more than one rank needs an "
                             "init_method")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timeout)
    return device


def world_from_env(device) -> torch.device:
    """Under ``torchrun`` (``WORLD_SIZE`` set), join its world: NCCL on
    ``cuda:LOCAL_RANK`` for a CUDA ``device``, gloo on the CPU -> the
    rank's device. Otherwise, or when this process already belongs to a
    world, ``device`` as it is."""
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return init_world("nccl" if device.type == "cuda" else "gloo", device,
                      int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                      init_method="env://")


def world_size() -> int:
    """Ranks in this process's world (1 when it has none)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """Rank 0 of the world, or a process without one: the rank that writes
    checkpoints and metrics and answers clients."""
    return not dist.is_initialized() or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in an (n_data x n_det) grid over the world.

    ``shape`` is ``{"data": n_data, "det": n_det}``; world rank
    ``data_rank * n_det + det_rank``. ``det_group`` holds the ranks of
    this rank's data shard (they split its detections' rows),
    ``data_group`` the ranks that hold the same rows of other data shards,
    ``world_group`` all of them; ``idle_group`` all of them too, on the
    host, with no deadline an idle server reaches (:meth:`announce`)."""

    shape: dict
    data_rank: int
    det_rank: int
    det_group: object
    data_group: object
    world_group: object
    idle_group: object
    device: torch.device

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[DET_AXIS]

    @property
    def is_main(self) -> bool:
        return self.data_rank == 0 and self.det_rank == 0

    def barrier(self) -> None:
        dist.barrier(group=self.world_group)

    def all_reduce_(self, t: Tensor, group: str = "world") -> Tensor:
        """Sum ``t`` in place over the world (or the ``"data"`` or
        ``"det"`` group) -> ``t``."""
        dist.all_reduce(t, group=self._group(group))
        return t

    def announce(self, *values: int) -> tuple[int, ...]:
        """Small integers from the main rank to every rank -> the main
        rank's; each rank passes as many. They travel on ``idle_group``
        (gloo on host tensors, timeout :data:`IDLE_TIMEOUT`), so a rank may
        wait here for the main rank's next request as long as a server
        stays idle, while every other collective keeps the world's
        timeout."""
        t = torch.tensor(values, dtype=torch.int64)
        dist.broadcast(t, 0, group=self.idle_group)
        return tuple(int(v) for v in t.tolist())

    def broadcast_(self, t: Tensor) -> Tensor:
        """``t`` from the main rank to every rank, in place -> ``t``."""
        dist.broadcast(t, 0, group=self.world_group)
        return t

    def gather_rows(self, x: Tensor, axis: str = DET_AXIS,
                    dim: int = 1) -> Tensor:
        """:class:`AllGatherRows` of this rank's shard ``x`` over the
        ``axis`` group, along ``dim`` (x itself for a single shard)."""
        if self.shape[axis] == 1:
            return x
        index = self.det_rank if axis == DET_AXIS else self.data_rank
        return AllGatherRows.apply(x, self._group(axis), self.shape[axis],
                                   index, dim)

    def _group(self, name: str):
        return {"world": self.world_group, DATA_AXIS: self.data_group,
                DET_AXIS: self.det_group}[name]


def make_mesh(n_data: int | None = None, n_det: int = 1,
              device=None) -> Mesh:
    """The ('data', 'det') mesh over the whole world (``sharding.py:36``
    of the JAX package); ``n_data`` defaults to world size // n_det.

    Every rank calls it, in the same order as every other mesh it builds,
    because each group is made by all ranks together. ``device``: this
    rank's (default: the current CUDA device, else the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a world: init_world first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_det
    if n_data < 1 or n_det < 1 or n_data * n_det != world:
        raise ValueError(f"a ({n_data} x {n_det}) mesh needs "
                         f"{n_data * n_det} devices, the world has {world}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    rank = dist.get_rank()
    data_rank, det_rank = divmod(rank, n_det)
    det_group = data_group = None
    for d in range(n_data):
        g = dist.new_group([d * n_det + t for t in range(n_det)],
                           timeout=_world_timeout)
        if d == data_rank:
            det_group = g
    for t in range(n_det):
        g = dist.new_group([d * n_det + t for d in range(n_data)],
                           timeout=_world_timeout)
        if t == det_rank:
            data_group = g
    world_group = dist.new_group(list(range(world)), timeout=_world_timeout)
    idle_group = dist.new_group(list(range(world)), backend="gloo",
                                timeout=IDLE_TIMEOUT)
    return Mesh({DATA_AXIS: n_data, DET_AXIS: n_det}, data_rank, det_rank,
                det_group, data_group, world_group, idle_group,
                torch.device(device))


class AllGatherRows(torch.autograd.Function):
    """x [B, R, ...] of shard ``index`` of ``shards`` -> [B, shards * R,
    ...] along ``dim``, the shards in order, on every rank of ``group``.

    Forward: this rank's rows written into zeros, then ``all_reduce(SUM)``
    (adding zeros is exact, so the gather is bit-exact). Backward:
    ``all_reduce(SUM)`` of the cotangent, then this rank's rows: every
    rank's use of the gathered rows reaches the rank that owns them."""

    @staticmethod
    def forward(ctx, x: Tensor, group, shards: int, index: int,
                dim: int = 1) -> Tensor:
        rows = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = rows * shards
        full = x.new_zeros(shape)
        full.narrow(dim, index * rows, rows).copy_(x)
        dist.all_reduce(full, group=group)
        ctx.group, ctx.index, ctx.rows, ctx.dim = group, index, rows, dim
        return full

    @staticmethod
    def backward(ctx, grad: Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        own = grad.narrow(ctx.dim, ctx.index * ctx.rows, ctx.rows)
        return own.contiguous(), None, None, None, None


# ---------------------------------------------------------------------------
# the world runner
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(device, rank: int) -> torch.device:
    """A rank's device: ``"cuda"`` without an index is ``cuda:rank``; any
    other device (``cpu``, ``cuda:0``) is shared by every rank."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank)
    return device


def _rank_main(fn, rank, size, backend, device, port, timeout_s, args,
               results) -> None:
    """One rank of :func:`run_world`: join the world, run ``fn(device,
    *args)``, put (rank, ok, result or traceback) on ``results``."""
    try:
        torch.set_num_threads(1)
        dev = init_world(backend, rank_device(device, rank), rank, size,
                         f"tcp://localhost:{port}", timeout_s)
        out = fn(dev, *args)
        dist.barrier()
        results.put((rank, True, out))
    except Exception:   # noqa: BLE001 -- reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, world_size: int, backend: str = "gloo", device="cpu",
              timeout_s: float = DEFAULT_TIMEOUT_S, args: tuple = (),
              collective_timeout_s: float | None = None) -> list:
    """Run ``fn(device, *args)`` on each rank of a new world of
    ``world_size`` spawned processes -> the ranks' results, in rank order.

    ``fn`` and ``args`` are pickled, so ``fn`` lives at the top of a
    module that imports neither JAX nor a test. ``device``: see
    :func:`rank_device`. A rank that raises or dies, or a world still
    running after ``timeout_s``, makes this raise after every rank left is
    killed; the ranks' collectives time out after ``collective_timeout_s``
    (default ``timeout_s``)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, world_size, backend, str(device),
                               port, collective_timeout_s or timeout_s,
                               args, results))
             for rank in range(world_size)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world_size:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and not p.is_alive()]
                if dead:
                    try:   # its result may still be in the pipe
                        rank, ok, payload = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result"
                        ) from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"world of {world_size} still "
                                       f"running after {timeout_s} s")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{payload}")
            out[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=30 if len(out) == world_size else 0)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world_size)]
