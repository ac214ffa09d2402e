"""Rescoring throughput at N=1024: the port's counterpart of ``bench.py``.

    python -m gossipnet_tpu_torch.tools.bench [--layout blob] [--device cpu]

Prints ONE JSON line ``{"metric", "value", "unit"}``: rescored detections
per second of the 16-block flagship model (``tools/entry.py``) with seeded
weights (``init_params(seed=0)``), B=8 images of N=1024 padded detections
on the card. The metric names N, the model, the layout and the card
(``nvidia-smi`` name and power limit). There is no ``vs_baseline``: the
reference divides by a target per TPU chip, and no TPU figure is a target
for the card.

The measurement is the reference's. K iterations of the forward are
chained, each iteration's sigmoid output plus ``k * 1e-7`` (k the
iteration's index) feeding the next one's scores, so no two iterations
see the same input, and the chain ends in one read-back to the host whose
checksum must be finite. The cost of one iteration is the difference of
two chain lengths (20 and 100) over their difference, best of three,
which removes the fixed cost of a call; dets/s = B * N / that cost.

On the card the chain replays one captured CUDA graph of the loop body
(:class:`Chain`, on ``utils/cuda_graphs.py::Captured``): forward, sigmoid,
perturbation, written back into the graph's own static score input, and
``k`` a device counter that the graph itself increments. That is the
counterpart of the reference's ``lax.fori_loop``: no host work between
iterations, and no constant baked in at capture that would make every
replay the same.

``--device cpu`` runs the reference's non-TPU leg when asked: B=1, N=256,
the dense plain path, chain lengths 2 and 6. It is not a fallback: the
default device is the card, and without one this raises.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np
import torch
from torch import Tensor

from gossipnet_tpu_torch.data.synthetic import BENCH_LAYOUTS, layout_batch
from gossipnet_tpu_torch.models.gossipnet import resolve_device
from gossipnet_tpu_torch.tools.entry import (
    device_tensors,
    flagship_cfg,
    seeded_model,
    synthetic_arrays,
)
from gossipnet_tpu_torch.utils.cuda_graphs import Captured


def card_line(device: torch.device) -> str:
    """The device a figure was taken on: on the card, ``nvidia-smi``'s
    name and power limit; on the CPU, that it is the CPU."""
    if device.type != "cuda":
        return "cpu, plain PyTorch"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


class Chain:
    """``step(s, k) -> s'`` chained on ``s0``'s device: iteration k reads
    the scores the previous one wrote and a 0-d float32 ``k``.

    On the card one graph of the loop body is captured: ``s`` and ``k`` are
    its static input and counter, the body writes ``step``'s result back
    into ``s`` and adds one to ``k``, so K replays are K iterations with
    no host work between them. On the CPU the same body runs eagerly.
    """

    def __init__(self, step, s0: Tensor):
        self.step = step
        self.s = s0.clone()
        self.k = torch.zeros((), dtype=torch.float32, device=s0.device)
        self.graph = None
        if s0.is_cuda:
            self.graph = Captured(self._body, torch.cuda.graph_pool_handle())

    def _body(self) -> Tensor:
        self.s.copy_(self.step(self.s, self.k))
        self.k.add_(1.0)
        return self.s

    def run(self, s0: Tensor, iters: int) -> Tensor:
        """``iters`` iterations from scores ``s0`` with k = 0, 1, ... ->
        the last scores (the chain's own tensor; read it before the next
        run)."""
        self.s.copy_(s0)
        self.k.zero_()
        for _ in range(iters):
            if self.graph is None:
                self._body()
            else:
                self.graph.replay()
        return self.s


def host_chain(step, s0: Tensor, iters: int) -> Tensor:
    """The same iterations as :meth:`Chain.run`, each an eager call from
    the host with its own ``k`` tensor: the oracle of the captured loop."""
    s = s0.clone()
    for k in range(iters):
        s = step(s, torch.tensor(float(k), device=s.device))
    return s


def forward_step(model, boxes: Tensor, valid: Tensor):
    """The bench's loop body: ``sigmoid(model(boxes, s, valid)) + k * 1e-7``
    (``bench.py:79-83``)."""
    def step(s: Tensor, k: Tensor) -> Tensor:
        with torch.no_grad():
            return torch.sigmoid(model(boxes, s, valid)) + k * 1e-7
    return step


def marginal_seconds(chain: Chain, rng: np.random.Generator, k_small: int,
                     k_large: int, reps: int = 3) -> float:
    """Seconds of one chained iteration: the difference of a ``k_large``
    and a ``k_small`` chain over ``k_large - k_small``, the best of
    ``reps`` (``bench.py:87-106``). Each chain is warmed once from fresh
    scores and timed from other fresh scores, up to the read-back of its
    checksum, which must be finite."""
    device = chain.s.device

    def fresh() -> Tensor:
        return torch.from_numpy(
            rng.uniform(0, 1, tuple(chain.s.shape)).astype(np.float32)
        ).to(device)

    def run(k: int) -> float:
        float(chain.run(fresh(), k).sum())           # warm, and drain
        s1 = fresh()
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        checksum = float(chain.run(s1, k).sum())
        dt = time.perf_counter() - t0
        if not math.isfinite(checksum):
            raise RuntimeError(f"chain of {k}: checksum {checksum}")
        return dt

    return min((run(k_large) - run(k_small)) / (k_large - k_small)
               for _ in range(reps))


def layout_arrays(layout: str, batch: int, n: int):
    """The bench's batch: ``clustered`` through ``synthetic_arrays`` (16 GT
    slots), any other layout through ``layout_batch`` (``bench.py:60-63``)."""
    if layout == "clustered":
        return synthetic_arrays(batch=batch, n=n, seed=0)
    return layout_batch(layout, batch=batch, n=n, seed=0)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--layout", default="clustered", choices=BENCH_LAYOUTS,
                   help="spatial detection layout (tools/bench_suite.py "
                        "reports all of them)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    n, batch = (1024, 8) if on_card else (256, 1)
    cfg = flagship_cfg()
    model = seeded_model(cfg, device)
    boxes, scores, valid = device_tensors(
        layout_arrays(args.layout, batch, n), device)
    chain = Chain(forward_step(model, boxes, valid), scores)
    k_small, k_large = (20, 100) if on_card else (2, 6)
    per_iter = marginal_seconds(chain, np.random.default_rng(7), k_small,
                                k_large)
    result = {
        "metric": f"rescored detections/sec @ N={n}, "
                  f"{cfg.model.num_blocks}-block GossipNet "
                  f"({card_line(device)}), "
                  f"layout={args.layout}, sustained on-device",
        "value": round(batch * n / per_iter, 1),
        "unit": "dets/sec",
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
