"""The port's compile model against the reference's, on the CPU: the
padded batch (``_pad_batch``), the shapes that ``warmup`` and
``TcpServer.start`` dispatch, a partial group scored at its padded batch,
and the step function that the card captures, run eagerly here, against
``train_step`` bit for bit. Also the pieces the capture needed: the
thresholds pair, row selection without an index tensor, an optimizer
state loaded into its live slots, and the profiler's trace of a training
run.

On CPU tensors nothing is captured (``utils/cuda_graphs.py``): the same
forward and step functions run eagerly, so these tests hold what the card
replays. The graphs themselves are held against the eager paths in
``tests/test_torch_cuda.py``. Tolerance against JAX: 1e-5 on the scores
(the same f32 model, another summation order); the eager step against the
step function: bit for bit (the same operations; the optimizer's scalars
reach it as 0-d float32 tensors instead of Python numbers).
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import json

import jax
import numpy as np
import pytest
import torch

from gossipnet_tpu import api as j_api
from gossipnet_tpu.config import load_config as j_load_config
from gossipnet_tpu.serving import TcpServer as JTcpServer
from gossipnet_tpu.train import build_model as j_build_model
from gossipnet_tpu_torch import train as t_train
from gossipnet_tpu_torch.api import Rescorer
from gossipnet_tpu_torch.config import load_config
from gossipnet_tpu_torch.data.bucketing import BatchIterator
from gossipnet_tpu_torch.data.synthetic import synthetic_roidb
from gossipnet_tpu_torch.ops import matching
from gossipnet_tpu_torch.ops.cuda import pairwise2
from gossipnet_tpu_torch.serving import TcpServer
from gossipnet_tpu_torch.utils import cuda_graphs, profiling

MODEL = {"num_blocks": 2, "feature_dim": 16, "reduced_dim": 8,
         "pairwise_dim": 8, "pair_matmul_dtype": "float32"}
BUCKETS = (32, 64, 128)


def _overrides(**train):
    return {"model": MODEL, "data": {"bucket_sizes": list(BUCKETS)},
            "parallel": {"enable": "off"},
            "train": {"batch_size": 2, "log_every": 1000,
                      "snapshot_every": 0, "eval_every": 0, **train}}


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port Rescorer on the same parameters."""
    jcfg = j_load_config(None, _overrides())
    params = j_build_model(jcfg, "dense").init(
        jax.random.key(0), np.zeros((1, 32, 4), np.float32),
        np.zeros((1, 32), np.float32), np.ones((1, 32), bool))["params"]
    params = jax.tree.map(np.asarray, params)
    jr = j_api.Rescorer(jcfg, params, pool_impl="dense", mesh=None)
    r = Rescorer(load_config(None, _overrides()), params,
                 pool_impl="kernel", device="cpu")
    return jr, r


def _image(rng, n):
    xy = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(5, 25, (n, 2))], 1)
    return (boxes.astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32), None)


@pytest.mark.parametrize("b", range(1, 10))
def test_pad_batch_matches_jax(pair, b):
    jr, r = pair
    assert r._pad_batch(b) == jr._pad_batch(b)


def _recorded_runs(rescorer, monkeypatch, act) -> list[tuple[int, int]]:
    """The (b, n) of every ``_run`` that ``act()`` makes, in order (the
    forward itself is skipped: only the shapes are compared)."""
    shapes = []

    def run(boxes_a, scores_a, valid_a, classes_a):
        shapes.append(tuple(scores_a.shape))
        return np.zeros(scores_a.shape, np.float32)

    monkeypatch.setattr(rescorer, "_run", run)
    act()
    monkeypatch.undo()
    return shapes


@pytest.mark.parametrize("k", [1, 3, 8])
def test_warmup_and_server_start_dispatch_jax_shapes(pair, monkeypatch, k):
    """``warmup(batch_size=k)`` and ``TcpServer.start`` (per-bucket caps:
    a detection budget of k x the largest bucket) run the reference's
    shapes in its order."""
    jr, r = pair
    want = _recorded_runs(jr, monkeypatch, lambda: jr.warmup(batch_size=k))
    got = _recorded_runs(r, monkeypatch, lambda: r.warmup(batch_size=k))
    assert got == want
    assert len(set(got)) == len(BUCKETS) * len(
        {1 << max(b - 1, 0).bit_length() for b in range(1, k + 1)})

    def started(server_cls, rescorer):
        server = server_cls(rescorer, port=0, batch_size=k)
        try:
            return _recorded_runs(rescorer, monkeypatch, server.start)
        finally:
            server.stop()

    want = started(JTcpServer, jr)
    assert started(TcpServer, r) == want
    caps = {n: max(shape[0] for shape in want if shape[1] == n)
            for n in BUCKETS}
    assert caps == {n: 1 << max(min(max(k, k * 128 // n), 64) - 1,
                                0).bit_length() for n in BUCKETS}


def test_three_image_group_scores_at_batch_four(pair):
    jr, r = pair
    rng = np.random.default_rng(3)
    images = [_image(rng, n) for n in (20, 30, 25)]
    seen = []
    hook = r.model.register_forward_pre_hook(
        lambda module, args: seen.append(tuple(args[1].shape)))
    try:
        got = r.rescore_batch(images)
    finally:
        hook.remove()
    assert seen == [(4, 32)]
    want = jr.rescore_batch(images)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_forward_graphs_live_on_the_model_and_run_eagerly_on_cpu(pair):
    _, r = pair
    graphs = cuda_graphs.forward_graphs(r.model)
    assert graphs is r._graphs is cuda_graphs.forward_graphs(r.model)
    rng = np.random.default_rng(4)
    arrays, _ = r._pack([(0,) + _image(rng, 30)], 32)
    got = graphs(*arrays)
    with torch.inference_mode():
        want = torch.sigmoid(r.model(*(torch.from_numpy(x)
                                       for x in arrays[:3])))
    assert torch.equal(got, want)
    assert graphs.shapes() == []          # nothing captured on the CPU


# ---------------------------------------------------------------------------
# the captured step function, run eagerly
# ---------------------------------------------------------------------------


def _state(cfg):
    model = t_train.build_model(cfg, "kernel", "cpu")
    return t_train.create_train_state(cfg, model)


def _slots(state):
    opt = state.optimizer
    return [t for p in opt.param_groups[0]["params"]
            for _, t in sorted(opt.state[p].items())]


@pytest.mark.parametrize("train", [
    dict(optimizer="adam", learning_rate=3e-3, lr_schedule="cosine",
         max_steps=10, warmup_steps=3, grad_clip_norm=1.0),
    dict(optimizer="adam", learning_rate=3e-3, lr_schedule="cosine",
         max_steps=10, warmup_steps=3, grad_accum_steps=2),
], ids=["adam_cosine_warmup", "accum2"])
def test_step_function_equals_train_step_bit_for_bit(train):
    """10 micro-steps of ``StepGraphs`` (the step function the card
    captures, with its scalars as 0-d tensors) and of ``train_step``."""
    cfg = load_config(None, _overrides(**train))
    eager, stepped = _state(cfg), _state(cfg)
    steps = cuda_graphs.StepGraphs(stepped, cfg, t_train.step_body)
    it = BatchIterator(synthetic_roidb(num_images=6, seed=0, num_gt=5,
                                       dets_per_gt=5, num_clutter=6),
                       2, BUCKETS, seed=0)
    for _ in range(10):
        batch = next(it)
        _, want = t_train.train_step(
            eager, t_train.batch_to_device(batch, "cpu"), cfg)
        got = steps(t_train.host_arrays(batch))
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert stepped.step == eager.step == 10
    ga, ge = (s.optimizer.param_groups[0] for s in (stepped, eager))
    assert (ga["count"], ga["mini_step"], ga["lr"]) == \
        (ge["count"], ge["mini_step"], ge["lr"])
    for a, b in zip(stepped.model.parameters(), eager.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(_slots(stepped), _slots(eager)):
        assert torch.equal(a, b)


def test_optimizer_state_loads_into_its_live_slots():
    """A captured step reads the slots at their addresses: loading a
    state copies into them (and zeroes a slot the saved state lacks)."""
    cfg = load_config(None, _overrides(optimizer="adam"))
    state = _state(cfg)
    saved = state.optimizer.state_dict()          # no slot made yet
    live = state.optimizer.make_slots()
    for t in live:
        t.fill_(3.0)
    ptrs = [t.data_ptr() for t in live]
    state.optimizer.load_state_dict(saved)
    assert [t.data_ptr() for t in state.optimizer.make_slots()] == ptrs
    assert all(bool((t == 0).all()) for t in state.optimizer.make_slots())
    other = _state(cfg)
    for t in other.optimizer.make_slots():
        t.fill_(0.5)
    state.optimizer.load_state_dict(other.optimizer.state_dict())
    assert [t.data_ptr() for t in state.optimizer.make_slots()] == ptrs
    assert all(bool((t == 0.5).all()) for t in state.optimizer.make_slots())


def test_thresholds_pair_gives_the_same_matching(rng):
    n, g = 30, 6
    xy = rng.uniform(0, 50, (2, n, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + 12.0], -1))
    gt = boxes[:, ::5][:, :g].clone()
    scores = torch.from_numpy(rng.uniform(-2, 2, (2, n)).astype(np.float32))
    valid = torch.ones((2, n), dtype=torch.bool)
    gt_valid = torch.ones((2, g), dtype=torch.bool)
    gt_crowd = torch.zeros((2, g), dtype=torch.bool)
    gt_crowd[:, -1] = True
    thr = (0.3, 0.5, 0.7)
    pair = matching.split_thresholds(thr, boxes.device)
    assert matching.split_thresholds(pair, boxes.device) is pair
    for impl in ("scan", "kernel"):
        want = matching.greedy_match_batch(boxes, scores, valid, gt,
                                           gt_valid, gt_crowd, thr,
                                           impl=impl)
        got = matching.greedy_match_batch(boxes, scores, valid, gt,
                                          gt_valid, gt_crowd, pair,
                                          impl=impl)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("rows", [(1, 2, 3, 4, 5, 6), (3, 4, 5, 7),
                                  (0, 1, 2), (0, 1, 2, 8)])
def test_rows_taken_by_slices_equal_list_indexing(rows):
    x = torch.randn(9, 5, requires_grad=True)
    got = pairwise2._take_rows(x, rows)
    want = x[list(rows)]
    assert torch.equal(got, want)
    w = torch.randn(want.shape)
    (ga,) = torch.autograd.grad((got * w).sum(), x)
    (gb,) = torch.autograd.grad((want * w).sum(), x)
    assert torch.equal(ga, gb)


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_profiled_training_run_writes_a_trace(tmp_path):
    """``--profile DIR`` traces steps 10-15 of a 16-step run."""
    cfg = load_config(None, _overrides(checkpoint_dir=str(tmp_path / "c"),
                                       learning_rate=3e-3))
    roidb = synthetic_roidb(num_images=6, seed=0, num_gt=5, dets_per_gt=5,
                            num_clutter=6)
    state = t_train.train(cfg, roidb, max_steps=16, device="cpu",
                          profile_dir=str(tmp_path / "prof"))
    assert state.step == 16
    trace = json.loads((tmp_path / "prof" / profiling.TRACE_FILE)
                       .read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("addmm" in str(n) or "matmul" in str(n) for n in names)
    assert {"gossipnet.train.step", "gossipnet.graphs.launch"} <= names


def test_profile_helpers_without_a_card(tmp_path, monkeypatch):
    """``span`` off is the shared no-op and builds no ``record_function``;
    on, it records a CPU range by name; ``StepProfiler`` writes its
    window's trace."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built while off")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        assert profiling.span("a") is profiling.span("b") is profiling.OFF
        with profiling.span("outer"), profiling.span("inner"):
            torch.ones(8).sum()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("gossipnet.region"):
            torch.ones(8).sum()
    region = [e for e in prof.events() if e.name == "gossipnet.region"]
    assert len(region) == 1
    assert any(e.name == "aten::sum" and e.cpu_parent is region[0]
               for e in prof.events())
    sp = profiling.StepProfiler(tmp_path / "s", start=2, stop=3,
                                enabled=True)
    for step in range(1, 5):
        sp.step(step)
    sp.close()
    assert (tmp_path / "s" / profiling.TRACE_FILE).exists()
    assert isinstance(sp.prof, torch.profiler.profile)
