"""The spans of the port's trainer and step graphs
(``utils/profiling.py::span``): the gate is the profiler's own flag, and a
training run under ``torch.profiler`` shows each step as
``gossipnet.train.step`` holding one ``draw``, one ``graphs.stage`` and
one ``graphs.launch``, a ``sync`` exactly on the log's steps, and the rare
``checkpoint`` and ``eval`` where they fire. On the card (marked ``cuda``)
the same run's launches hold the graph replays, and no span shows among
the device activities that ``portbench.trace.Profile`` keeps.

The file imports no JAX, so its card test runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gossipnet_tpu_torch import train as t_train
from gossipnet_tpu_torch.config import load_config
from gossipnet_tpu_torch.data.synthetic import synthetic_roidb
from gossipnet_tpu_torch.utils import profiling

MODEL = {"num_blocks": 2, "feature_dim": 16, "reduced_dim": 8,
         "pairwise_dim": 8, "pair_matmul_dtype": "float32"}
STEPS = 7


def _config(tmp_path, **train):
    return load_config(None, {
        "model": MODEL, "data": {"bucket_sizes": [32, 64, 128]},
        "parallel": {"enable": "off"},
        "train": {"batch_size": 2, "log_every": 3, "snapshot_every": 0,
                  "eval_every": 0, "checkpoint_dir": str(tmp_path / "c"),
                  **train}})


def _roidb():
    return synthetic_roidb(num_images=6, seed=0, num_gt=5, dets_per_gt=5,
                           num_clutter=6)


def _inside(outer, spans, name):
    a, b = outer[1], outer[2]
    return [s for s in spans if s[0] == name and a <= s[1] and s[2] <= b]


def _check_steps(spans, cfg) -> list:
    """Each step span holds one draw, one stage and one launch, in that
    order, and a sync exactly on the log's steps -> the step spans."""
    steps = sorted((s for s in spans if s[0] == "gossipnet.train.step"),
                   key=lambda s: s[1])
    assert len(steps) == STEPS
    for k, step in enumerate(steps, 1):
        parts = [_inside(step, spans, f"gossipnet.{n}")
                 for n in ("train.draw", "graphs.stage", "graphs.launch")]
        assert [len(p) for p in parts] == [1, 1, 1]
        (draw,), (stage,), (launch,) = parts
        assert draw[2] <= stage[1] and stage[2] <= launch[1]
        logged = k % cfg.train.log_every == 0 or k == STEPS
        assert len(_inside(step, spans, "gossipnet.train.sync")) == logged
    assert len([s for s in spans if s[0] == "gossipnet.train.sync"]) == len(
        [k for k in range(1, STEPS + 1)
         if k % cfg.train.log_every == 0 or k == STEPS])
    return steps


def test_span_gate_is_the_profilers_flag():
    """``span`` reads ``torch.autograd.profiler._is_profiler_enabled``,
    which ``torch.profiler.profile`` sets while it records, whether entered
    as a context or through start() and stop()."""
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("x") is profiling.OFF
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled
        assert isinstance(profiling.span("x"),
                          torch.profiler.record_function)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        assert isinstance(profiling.span("x"),
                          torch.profiler.record_function)
    finally:
        prof.stop()
    assert profiling.span("x") is profiling.OFF


def test_training_run_spans_nest_on_cpu(tmp_path):
    cfg = _config(tmp_path, snapshot_every=2, eval_every=3)
    evals = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state = t_train.train(cfg, _roidb(), max_steps=STEPS, device="cpu",
                              eval_fn=lambda st: evals.append(st.step) or {})
    assert state.step == STEPS and evals == [3, 6]
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("gossipnet.")]
    steps = _check_steps(spans, cfg)
    for k, step in enumerate(steps, 1):
        assert len(_inside(step, spans, "gossipnet.train.checkpoint")) == (
            k % 2 == 0)
        assert len(_inside(step, spans, "gossipnet.train.eval")) == (
            k % 3 == 0)
    # the final save follows the loop, outside every step
    assert len([s for s in spans if s[0] == "gossipnet.train.checkpoint"]
               ) == STEPS // 2 + 1
    assert not [s for s in spans if s[0] == "gossipnet.graphs.capture"]


@pytest.mark.cuda
def test_training_run_spans_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the captured step has no CPU mode")
    from portbench.trace import Profile

    cfg = _config(tmp_path)
    roidb = _roidb()
    prof = Profile(True).start()
    prof.open()
    t_train.train(cfg, roidb, pool_impl="kernel", max_steps=STEPS,
                  device="cuda")
    torch.cuda.synchronize()
    prof.close()
    prof.stop()
    spans = [s for s in prof.host if s[0].startswith("gossipnet.")]
    steps = _check_steps(spans, cfg)
    captures = [s for s in spans if s[0] == "gossipnet.graphs.capture"]
    assert captures
    for step in steps:
        (launch,) = _inside(step, spans, "gossipnet.graphs.launch")
        replays = _inside(launch, prof.host, "cudaGraphLaunch")
        assert len(replays) == 1
        assert not [c for c in captures if launch[1] <= c[1] < launch[2]]
    assert not [d for d in prof.device if d[0].startswith("gossipnet.")]
    assert prof.busy_s() > 0
