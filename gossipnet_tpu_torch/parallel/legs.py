"""Rank programs for the worlds that :func:`~.world.run_world` starts.

Each leg drives one mesh path of the port through its entry points from
plain data (config overrides, a flat parameter dict and batches as numpy)
and returns numpy, so that the process that started the world (a test
holding the JAX package's references, ``tools.entry --dryrun-multichip``,
``chip_smoke.py --mesh``) checks what the ranks computed. Every rank runs
the same legs in the same order: a mesh is built by all ranks together.

    run_world(run_legs, 4, args=([("fwd", forward, {...}), ...],))
"""

from __future__ import annotations

import json
import socket
import struct
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from gossipnet_tpu_torch.config import load_config
from gossipnet_tpu_torch.ops.cuda import matching_scan as k3
from gossipnet_tpu_torch.ops.cuda import pairwise as k5
from gossipnet_tpu_torch.ops.cuda import pairwise2 as k1
from gossipnet_tpu_torch.params import as_state_dict
from gossipnet_tpu_torch.parallel.sharding import (
    make_sharded_grads,
    make_sharded_inference,
    make_sharded_train_step,
)
from gossipnet_tpu_torch.parallel.world import (
    DET_AXIS,
    AllGatherRows,
    make_mesh,
)

# kernel -> (wrapper, counter): the launches a leg made on its rank
COUNTERS = {"K1": (k1.pair_pool, "launches"),
            "K2": (k1.pair_pool_backward, "launches"),
            "K3": (k3.greedy_scan_batched, "launches"),
            "K5": (k5.pair_pool, "launches"),
            "K6": (k5.pair_pool_backward, "launches")}


def launch_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in COUNTERS.items()}


def run_legs(device, legs: list) -> dict:
    """Runs each (name, leg, kwargs) as ``leg(device, **kwargs)`` -> name
    -> {"result": what it returned, "launches": the kernels it launched on
    this rank}."""
    out = {}
    for name, leg, kw in legs:
        before = launch_counts()
        result = leg(device, **kw)
        out[name] = {"result": result, "launches": {
            k: v - before[k] for k, v in launch_counts().items()}}
    return out


def _model(cfg, params, device):
    from gossipnet_tpu_torch.train import build_model

    model = build_model(cfg, "kernel", device)
    model.load_state_dict(as_state_dict(params))
    return model


def _tensors(arrays: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def _numpy(tensors: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in tensors.items()}


def forward(device, overrides: dict, params: dict, arrays: dict,
            shape: tuple) -> np.ndarray:
    """Sigmoid scores [B, N] of ``make_sharded_inference`` on a
    ``shape`` = (n_data, n_det) mesh."""
    cfg = load_config(None, overrides)
    mesh = make_mesh(*shape, device=device)
    model = _model(cfg, params, device)
    return make_sharded_inference(mesh)(model, _tensors(arrays, device)
                                        ).cpu().numpy()


def forward_ms(device, overrides: dict, params: dict, arrays: dict,
               shape: tuple, reps: int = 5) -> float:
    """Host ms of one ``make_sharded_inference`` call on this rank,
    collectives included, each call ending in a synchronize: the mean of
    ``reps`` after one warm-up call."""
    cfg = load_config(None, overrides)
    mesh = make_mesh(*shape, device=device)
    model = _model(cfg, params, device)
    fn, t = make_sharded_inference(mesh), _tensors(arrays, device)

    def call():
        fn(model, t)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    call()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    return (time.perf_counter() - t0) * 1e3 / reps


def grads(device, overrides: dict, params: dict, arrays: dict,
          shape: tuple) -> tuple[dict, dict]:
    """(the closed raw gradients by parameter name, the metrics) of
    ``make_sharded_grads`` on a ``shape`` mesh."""
    cfg = load_config(None, overrides)
    mesh = make_mesh(*shape, device=device)
    model = _model(cfg, params, device)
    g, metrics = make_sharded_grads(cfg, mesh)(model,
                                                _tensors(arrays, device))
    return _numpy(g), _numpy(metrics)


def train_steps(device, overrides: dict, params: dict, batches: list,
                shape: tuple) -> tuple[dict, list]:
    """``make_sharded_train_step`` on each batch in turn -> (the
    parameters after the last, every step's metrics)."""
    from gossipnet_tpu_torch.train import build_model, create_train_state

    cfg = load_config(None, overrides)
    mesh = make_mesh(*shape, device=device)
    state = create_train_state(cfg, build_model(cfg, "kernel", device),
                               params=params)
    step = make_sharded_train_step(cfg, mesh)
    metrics = []
    for arrays in batches:
        state, m = step(state, _tensors(arrays, device))
        metrics.append(_numpy(m))
    return _numpy(state.model.state_dict()), metrics


def train_run(device, overrides: dict, data: dict, max_steps: int | None
              = None, params: dict | None = None, metrics: bool = False):
    """``train()`` on ``synthetic_roidb(**data)`` with the mesh its config
    asks for -> (its parameters, its step, the logged losses when
    ``metrics``)."""
    from gossipnet_tpu_torch.data.synthetic import synthetic_roidb
    from gossipnet_tpu_torch.train import train

    cfg = load_config(None, overrides)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "metrics.jsonl"
        state = train(cfg, synthetic_roidb(**data), max_steps=max_steps,
                      device=device, params=params,
                      metrics_path=str(path) if metrics else None)
        losses = ([json.loads(line).get("loss") for line in open(path)]
                  if metrics and path.exists() else [])
    return _numpy(state.model.state_dict()), state.step, losses


def evaluate(device, overrides: dict, params: dict, data: dict,
             shape: tuple, batch_size: int) -> dict:
    """``evaluate_model`` through ``sharded_forward_fn`` on a ``shape``
    mesh -> {"stats": the COCO stats, "scores": per image id}."""
    from gossipnet_tpu_torch.data.synthetic import synthetic_roidb
    from gossipnet_tpu_torch.evaluate import (
        _evaluator_for,
        rescore_roidb,
        sharded_forward_fn,
    )

    cfg = load_config(None, overrides)
    mesh = make_mesh(*shape, device=device)
    model = _model(cfg, params, device)
    roidb = synthetic_roidb(**data)
    scores = rescore_roidb(None, model, roidb, batch_size,
                           cfg.data.bucket_sizes,
                           forward_fn=sharded_forward_fn(mesh, model))
    return {"stats": _evaluator_for(roidb, scores).summarize(),
            "scores": scores}


def rescore(device, overrides: dict, params: dict, images: list,
            batch_size: int = 8, reload: dict | None = None,
            idle_s: float = 0.0):
    """The main rank: ``Rescorer(cfg, params)`` with the mesh of the
    config's ``parallel``, idle for ``idle_s`` seconds, rescores ``images``
    (and again after ``reload(reload)`` when given) -> the scores; the
    other ranks follow it and return None."""
    from gossipnet_tpu_torch.api import Rescorer

    r = Rescorer(load_config(None, overrides), params, device=device)
    if not r.mesh.is_main:
        r.follow()
        return None
    try:
        time.sleep(idle_s)
        out = [r.rescore_batch(images, batch_size)]
        if reload is not None:
            r.reload(reload)
            out.append(r.rescore_batch(images, batch_size))
    finally:
        r.close()
    return out


def tcp(device, overrides: dict, params: dict, images: list) -> dict | None:
    """The main rank: a ``TcpServer`` on the sharded Rescorer answers two
    JSON clients and one binary client over ``images`` ((boxes, scores))
    -> {"json": {id: scores}, "binary": {id: scores}}; the other ranks
    follow the Rescorer and return None."""
    from gossipnet_tpu_torch.api import Rescorer
    from gossipnet_tpu_torch.serving import BIN_MAGIC, TcpServer, _recv_exact

    r = Rescorer(load_config(None, overrides), params, device=device)
    if not r.mesh.is_main:
        r.follow()
        return None
    got = {"json": {}, "binary": {}}
    errors = []

    def client(ids, binary):
        try:
            with socket.create_connection(("127.0.0.1", server.port),
                                          timeout=120) as s:
                f = s.makefile("r")
                for k in ids:
                    bx, sc = images[k]
                    if binary:
                        s.sendall(struct.pack("<IQII", BIN_MAGIC, k, len(sc),
                                              0)
                                  + np.asarray(bx, "<f4").tobytes()
                                  + np.asarray(sc, "<f4").tobytes())
                        _, status, rid = struct.unpack("<IBQ",
                                                       _recv_exact(s, 13))
                        (n,) = struct.unpack("<I", _recv_exact(s, 4))
                        if status:
                            raise RuntimeError(_recv_exact(s, n).decode())
                        scores = np.frombuffer(_recv_exact(s, 4 * n), "<f4")
                        (kept,) = struct.unpack("<I", _recv_exact(s, 4))
                        _recv_exact(s, 4 * kept)
                        got["binary"][rid] = scores.copy()
                    else:
                        s.sendall((json.dumps({
                            "id": k, "boxes": np.asarray(bx).tolist(),
                            "scores": np.asarray(sc).tolist()})
                            + "\n").encode())
                        resp = json.loads(f.readline())
                        if "error" in resp:
                            raise RuntimeError(resp["error"])
                        got["json"][resp["id"]] = np.asarray(
                            resp["new_scores"], np.float32)
        except Exception as e:   # noqa: BLE001 -- raised below
            errors.append(e)

    server = None
    try:   # the followers are released whatever happens here
        server = TcpServer(r, port=0, threshold=0.0, batch_size=8,
                           window_ms=5.0).start()
        half = len(images) // 2
        threads = [threading.Thread(target=client, args=(ids, binary))
                   for ids, binary in ((range(half), False),
                                       (range(half, len(images)), False),
                                       (range(len(images)), True))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"TCP clients failed: {errors}")
    finally:
        if server is not None:
            server.stop()
        r.close()
    return got


def meshes_from_configs(device, configs: list) -> list:
    """``mesh_from_config`` on each config (overrides) in turn -> its
    mesh shape, None, or the ``ValueError`` it raised as text."""
    from gossipnet_tpu_torch.parallel.sharding import mesh_from_config

    out = []
    for ov in configs:
        try:
            mesh = mesh_from_config(load_config(None, ov), device)
        except ValueError as e:
            out.append(f"ValueError: {e}")
        else:
            out.append(None if mesh is None else mesh.shape)
    return out


def gather_exact(device, shape: tuple) -> bool:
    """The row gather and its backward on a ``shape`` mesh against
    slicing, bit for bit: the gathered tensor is every shard's rows in
    order, and the backward of sum(w * gathered) is this rank's rows of w
    times the det axis (each det rank's copy of the loss adds its own)."""
    mesh = make_mesh(*shape, device=device)
    n_det = mesh.shape[DET_AXIS]
    gen = torch.Generator().manual_seed(0)
    full = torch.randn(3, 8 * n_det, 5, generator=gen).to(device)
    # small integers: the backward's sum of n_det copies is exact
    w = torch.randint(-8, 8, full.shape, generator=gen).float().to(device)
    rows = slice(mesh.det_rank * 8, (mesh.det_rank + 1) * 8)
    x = full[:, rows].clone().requires_grad_(True)
    got = AllGatherRows.apply(x, mesh.det_group, n_det, mesh.det_rank, 1)
    (got * w).sum().backward()
    return (torch.equal(got, full)
            and torch.equal(x.grad, w[:, rows] * n_det))


def imported_modules(device, prefixes: tuple) -> list:
    """The modules this rank has imported whose top package is one of
    ``prefixes``."""
    del device
    return sorted(m for m in sys.modules if m.split(".")[0] in prefixes)


def fail(device, rank: int) -> None:
    """Raises on world rank ``rank``; the others wait in a collective."""
    if torch.distributed.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    torch.distributed.barrier()
