"""Captured forwards and training steps: the port's counterpart of the
reference's ``jax.jit`` per shape.

The JAX package compiles one executable per (padded batch, bucket)
(``gossipnet_tpu/api.py:114 _fn``, ``evaluate.py:83``) and one per training
shape (``train.py:136 train_step``, ``:149 train_steps_scanned``), and
replays it. Here the card replays one ``torch.cuda.CUDAGraph`` per padded
shape instead: a few host calls per forward or step in place of hundreds
of launches, which is what kept the eager paths host-bound.

- A graph is captured at the first call at its shape, after one eager run
  of the same function on a side stream: the kernels' libraries are built
  and bound, their shared-memory attributes set and cuBLAS's handle made
  before the capture, which cannot hold any of that.
- Each graph reads static input tensors, copied in before every replay,
  and writes static outputs. The work is enqueued on the caller's stream,
  so what the caller enqueues next (a copy of the outputs) runs after it.
  The graphs of one owner share one memory pool: an output is valid until
  the next replay of any graph of its owner.
- A capture that fails raises. Nothing runs eagerly in its place.
- On CPU tensors nothing is captured: the same function runs eagerly.

The kernels' launch counters (``pair_pool.launches`` and the others) count
Python calls of their wrappers, and a replay makes none. So each graph
records, per counter, the launches its capture made, restores the counters
(the capture ran nothing), and adds those launches again on every replay.
The eager run before a capture did launch its kernels and counts.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch import Tensor

from gossipnet_tpu_torch.ops.cuda import matching_scan, pairwise, pairwise2
from gossipnet_tpu_torch.ops.cuda.matching_scan import split_thresholds

# The counted wrappers of every kernel a forward or a training step runs.
COUNTED = (pairwise2.pair_pool, pairwise2.pair_pool_backward,
           pairwise.pair_pool, pairwise.pair_pool_backward,
           matching_scan.greedy_scan_batched, matching_scan.greedy_scan)
# Every counter a graph keeps: each wrapper's ``launches``, and K1's and
# K2's bf16-stream launches, which are also counted apart.
_COUNTERS = tuple((fn, "launches") for fn in COUNTED) + (
    (pairwise2.pair_pool, "launches_ew"),
    (pairwise2.pair_pool_backward, "launches_ew"))


def _counts() -> list[int]:
    return [getattr(fn, attr) for fn, attr in _COUNTERS]


def _add_counts(ns) -> None:
    for (fn, attr), n in zip(_COUNTERS, ns):
        setattr(fn, attr, getattr(fn, attr) + n)


class Captured:
    """One CUDA graph of ``fn()``, which reads static inputs and returns
    its static outputs.

    ``settle``, when given, runs between the eager run and the capture
    (the training step restores the state that the eager run advanced).
    ``seconds`` is the wall time of the eager run and the capture
    together: the cold-start cost of this shape.
    """

    def __init__(self, fn, pool, settle=None, error_mode: str = "global"):
        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        if settle is not None:
            settle()
        start = _counts()
        self.graph = torch.cuda.CUDAGraph()
        # A cyclic collection during the capture could free an old graph
        # (a Rescorer's model and its graphs form a cycle), and destroying
        # a graph is an operation a capture refuses: collect first, then
        # hold the collector off until the capture has ended.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool,
                                  capture_error_mode=error_mode):
                self.outputs = fn()
        finally:
            if collecting:
                gc.enable()
            made = _counts()
            _add_counts([a - b for a, b in zip(start, made)])
        self.launches = [b - a for a, b in zip(start, made)]
        self.seconds = time.perf_counter() - t0

    def replay(self):
        """Replays the graph on the current stream -> its static outputs."""
        self.graph.replay()
        _add_counts(self.launches)
        return self.outputs


def _host_tensors(arrays, device) -> list[Tensor]:
    """numpy arrays as CPU tensors; for the card in pinned memory, so that
    their copies to it are enqueued without waiting for the stream (the
    caching host allocator keeps each buffer until its copy has run)."""
    host = [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]
    return [h.pin_memory() for h in host] if device.type == "cuda" else host


def _static_copies(host: list[Tensor], device) -> list[Tensor]:
    out = [torch.empty(h.shape, dtype=h.dtype, device=device) for h in host]
    for s, h in zip(out, host):
        s.copy_(h)
    return out


class ForwardGraphs:
    """The rescoring forward of ``model`` (probabilities, sigmoid of the
    logits), one captured graph per (b, n) of the packed batch.

    Callers hold the graphs' outputs only until their next call (the
    Rescorer enqueues its read-back right behind the replay, under its
    lock); weights copied into the model in place are read by the next
    replay, with no new capture.
    """

    def __init__(self, model):
        self.model = model
        self.device = next(model.parameters()).device
        self._graphs: dict[tuple, tuple[list[Tensor], Captured]] = {}
        self._pool = None

    def forward(self, boxes, scores, valid, classes) -> Tensor:
        """The function that is captured: probabilities [b, n]."""
        with torch.inference_mode():
            return torch.sigmoid(self.model(boxes, scores, valid, classes))

    def __call__(self, boxes_a, scores_a, valid_a, classes_a) -> Tensor:
        """Probabilities [b, n] of one packed batch (numpy arrays). On the
        card the static output of the (b, n) graph, captured at the first
        call at that shape; on the CPU the eager forward."""
        host = _host_tensors((boxes_a, scores_a, valid_a, classes_a),
                             self.device)
        if self.device.type != "cuda":
            return self.forward(*host)
        key = tuple(scores_a.shape)
        if key not in self._graphs:
            inputs = _static_copies(host, self.device)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            # thread_local: a server's other threads may wait on events
            # while a shape it was not warmed at is captured
            self._graphs[key] = (inputs, Captured(
                lambda: self.forward(*inputs), self._pool,
                error_mode="thread_local"))
        inputs, graph = self._graphs[key]
        for s, h in zip(inputs, host):
            s.copy_(h, non_blocking=True)
        return graph.replay()

    def shapes(self) -> list[tuple[int, int]]:
        """The (b, n) shapes captured so far, sorted."""
        return sorted(self._graphs)

    def capture_seconds(self) -> dict[tuple[int, int], float]:
        """Per captured shape, the eager run and the capture, in seconds."""
        return {k: g.seconds for k, (_, g) in sorted(self._graphs.items())}


def forward_graphs(model) -> ForwardGraphs:
    """The captured forwards of ``model``, kept on the model: they live as
    long as its parameters, and their shape set is what its callers
    dispatch (the padded batches of each bucket)."""
    graphs = model.__dict__.get("_forward_graphs")
    if graphs is None:
        graphs = model._forward_graphs = ForwardGraphs(model)
    return graphs


class StepGraphs:
    """The training micro-step of ``state``, one captured graph per shape
    of the batch's arrays and per kind of update (``grad_accum_steps > 1``
    has two: accumulate only, and accumulate and apply; the host's
    ``mini_step`` picks).

    ``body(state, arrays, cfg, apply, hyper, thresholds) -> metrics`` is
    the step's device work (``train.step_body``): forward, matching, loss,
    backward, global norm, clipping and the optimizer's update. The host
    bookkeeping stays outside the graph: the optimizer's :meth:`plan`
    before each replay, whose scalars (the learning rate, Adam's bias
    corrections, the accumulation divisor) reach the graph through a small
    device tensor written from pinned memory, and the schedule and step
    counter after it.

    Before a capture every optimizer slot exists, and the eager run's
    effect on the parameters and slots is undone, so captured step 1
    equals eager step 1 bit for bit. Parameters and slots are updated in
    place, and loading a state copies into them
    (``OptaxOptimizer.load_state_dict``), so a graph never reads stale
    tensors.
    """

    def __init__(self, state, cfg, body):
        self.state, self.cfg, self._body = state, cfg, body
        self.device = next(state.model.parameters()).device
        self._hyper = torch.zeros(4, dtype=torch.float32, device=self.device)
        self._thresholds = split_thresholds(cfg.matching.thresholds,
                                            self.device)
        self._graphs: dict[tuple, tuple[dict, Captured]] = {}
        self._pool = None

    def _run(self, arrays: dict, apply: bool, hyper):
        return self._body(self.state, arrays, self.cfg, apply, hyper,
                          self._thresholds)

    def _capture(self, host: dict, apply: bool, hyper) -> tuple[dict,
                                                                Captured]:
        state = self.state
        inputs = dict(zip(host, _static_copies(list(host.values()),
                                               self.device)))
        live = (list(state.optimizer.param_groups[0]["params"])
                + state.optimizer.make_slots())
        saved = [t.detach().clone() for t in live]

        def restore():
            with torch.no_grad():
                for t, s in zip(live, saved):
                    t.copy_(s)

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return inputs, Captured(lambda: self._run(inputs, apply, hyper),
                                self._pool, settle=restore)

    def __call__(self, arrays: dict) -> dict:
        """One micro-step on ``arrays`` (numpy, by name) -> its metrics,
        0-d tensors of its own (cloned from the graph's outputs)."""
        state = self.state
        apply, values = state.optimizer.plan()
        staged = torch.tensor([float(v) for v in values], dtype=torch.float32)
        if self.device.type == "cuda":
            staged = staged.pin_memory()
        self._hyper.copy_(staged, non_blocking=True)
        hyper = type(values)(*self._hyper.unbind())
        host = dict(zip(arrays, _host_tensors(arrays.values(), self.device)))
        if self.device.type != "cuda":
            metrics = self._run(host, apply, hyper)
        else:
            key = (apply,) + tuple((k, tuple(v.shape))
                                   for k, v in host.items())
            if key not in self._graphs:
                self._graphs[key] = self._capture(host, apply, hyper)
            inputs, graph = self._graphs[key]
            for k, h in host.items():
                inputs[k].copy_(h, non_blocking=True)
            metrics = {k: v.clone() for k, v in graph.replay().items()}
        if apply:
            state.schedule.step()
        state.step += 1
        return metrics

    @property
    def captures(self) -> int:
        """Graphs captured so far (each after one eager step)."""
        return len(self._graphs)

    def capture_seconds(self) -> dict[tuple, float]:
        """Per captured graph (update kind and array shapes), the eager
        step and the capture, in seconds."""
        return {k: g.seconds for k, (_, g) in self._graphs.items()}
