"""Config 4, the N=4096 crowd, as the benchmark runs it.

- its configuration file loads to the ``Config`` of
  ``experiments/crowded_4096.yaml``, and its traffic puts every image in
  the single 4096 bucket, uncut;
- the port's plain CPU path agrees with the benchmark's reference
  (``portbench/reference``) on one step of the crowd cut to a size the CPU
  runs, and the port's bf16 pair stream (the check's control) does not;
- the cell's two new per-layer readers, K3's device time a step and K2's
  share of blocks with a step, read a hand-made trace and hand-set
  counters, and return None where they have nothing to read.

The file imports no JAX.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import json

import numpy as np
import pytest

from gossipnet_tpu_torch.config import experiment_path, load_config
from gossipnet_tpu_torch.data.bucketing import BatchIterator, make_batch
from gossipnet_tpu_torch.data.roidb import ImageRecord
from gossipnet_tpu_torch.ops.cuda import pairwise2
from gossipnet_tpu_torch.train import (batch_to_device, build_model,
                                       loss_and_metrics)
from portbench import bench, run, weights
from portbench.bench import ROOT, Bench
from portbench.drivers.train import _roidb
from portbench.metrics import layer
from portbench.reference import training as ref_train
from portbench.trace import Profile
from portbench.traffic import drill, generate

CELL = "train_crowd_4096"
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CROWD_METRICS = [m for m in BENCHMARK["per_layer"]
                 if CELL in m.get("workloads", ())]


def crowd_file() -> dict:
    return bench.config_file("crowded_4096")


def test_configuration_is_the_published_yaml():
    tree = crowd_file()
    assert tree["reduced"] == []
    got = load_config(None, overrides=tree["config"])
    assert got == load_config(experiment_path("crowded_4096"))
    # the defaults the file's `assumed` names
    assert (got.train.learning_rate, got.train.lr_schedule,
            got.train.grad_clip_norm, got.model.pair_kernel) == (
        1e-4, "constant", 0.0, 2)
    assert (tuple(got.matching.thresholds), got.matching.crowd_as_ignore,
            got.loss.pos_weight_mode) == ((0.5,), True, "balanced")


def test_traffic_fills_only_the_4096_bucket():
    cfg = load_config(None, overrides=crowd_file()["config"])
    wl = bench.workload_file(CELL)
    mix = bench.traffic_file(wl["traffic"])
    images = generate.roidb_images(2 ** 33 + 5, mix, cfg.data.max_detections)
    assert len(images) == 128
    dets = np.array([len(im.scores) for im in images])
    # every image is whole (no cap bit) and far from the next bucket down
    assert dets.max() < cfg.data.max_detections and dets.min() > 1024
    it = BatchIterator(_roidb(images), cfg.train.batch_size,
                       cfg.data.bucket_sizes, seed=cfg.train.seed)
    for _ in range(64):
        b = next(it)
        assert b.padded_n == 4096 and b.boxes.shape[0] == 2
        assert 128 <= b.padded_g <= 224


def _step(model: dict, images, **extra):
    """Step 1's loss and gradient of the crowd config at ``model``'s widths
    on the port's plain CPU path (padded to N=256)."""
    tree = crowd_file()["config"]
    cfg = load_config(None, overrides={
        **tree, "model": {**model, **extra},
        "data": {**tree["data"], "max_detections": 256,
                 "bucket_sizes": [256]}})
    net = build_model(cfg, "kernel", "cpu")
    w = weights.make(model, 2 ** 33 + 1, "cpu")
    net.load_state_dict(w)
    recs = [ImageRecord(i, im.boxes, im.scores,
                        np.zeros(len(im.scores), np.int32), im.gt_boxes,
                        np.zeros(len(im.gt_boxes), np.int32), im.gt_crowd)
            for i, im in enumerate(images)]
    batch = batch_to_device(make_batch(recs, 256), "cpu")
    loss, _ = loss_and_metrics(net, batch, cfg)
    loss.backward()
    return (float(loss.detach()),
            {k: p.grad for k, p in net.named_parameters()}, w)


def test_crowd_step_agrees_with_the_reference():
    """Two blocks at the published 128/32/32, B=2, two ``dense_4k`` images
    capped at 192 detections (163 and 139 GT, G padded to 176).

    Limits: the loss within 1e-5 of the reference's, relatively (the
    port's forward reads 8e-8 here; both sum in float32 in other orders);
    each gradient leaf within 2e-2 of the larger of its norm and the
    median leaf's (the port reads 1.1e-3: its backward rounds its pair
    dots' operands to bf16, the reference passes float32 straight
    through). Over six draws the port read at most 9e-8 and 7.3e-3; the
    bf16 stream at least 3.3e-5 and 4.3e-2, so it fails both."""
    model = {**crowd_file()["config"]["model"], "num_blocks": 2}
    images = drill.draw(20170721, "crowd", "dense_4k", 2, 192)
    assert [len(im.scores) for im in images] == [192, 192]
    loss, grads, w = _step(model, images)
    want, ref_grads = ref_train.loss_and_grads(
        w, [(im.boxes, im.scores, im.gt_boxes, im.gt_crowd)
            for im in images], 2, [0.5])
    norms = {k: float(g.norm()) for k, g in ref_grads.items()}
    med = float(np.median(list(norms.values())))

    def gaps(loss, grads):
        leaf = max(float((grads[k] - g).norm()) / max(norms[k], med)
                   for k, g in ref_grads.items())
        return abs(loss - want) / abs(want), leaf

    loss_gap, grad_gap = gaps(loss, grads)
    assert loss_gap <= 1e-5 and grad_gap <= 2e-2, (loss_gap, grad_gap)
    control = gaps(*_step(model, images,
                          pair_elementwise_dtype="bfloat16")[:2])
    assert control[0] > 1e-5 and control[1] > 2e-2, control


# -- the cell's readers ------------------------------------------------------

def _traced(device, steps=4, window=(0.0, 1e6)):
    b = Bench(CELL, 1, 1.0, True, device="cpu")
    prof = Profile(False)
    prof.window, prof.device = window, device
    b.profile, b.layer = prof, {"steps": steps}
    return b


K3 = "void (anonymous namespace)::greedy_scan_kernel<4>(float const*)"


def test_match_ms_reads_k3_a_step():
    match = run.reader("match_ms.train_crowd")
    b = _traced([(K3, 100.0, 300.0), (K3, 500.0, 700.0),
                 ("void (anonymous namespace)::pair_pool2_bwd_kernel<32>",
                  300.0, 500.0),
                 (K3, 1e6 - 50.0, 1e6 + 150.0)])    # clipped to the window
    # (200 + 200 + 50) us over 4 steps
    assert match.read(b) == pytest.approx(450e-3 / 4)
    assert match.patterns() == ["greedy_scan_kernel"]


@pytest.mark.parametrize("case", ["untraced", "no steps", "no K3"])
def test_match_ms_none_without_a_reading(case):
    match = run.reader("match_ms.train_crowd")
    b = _traced([] if case == "no K3" else [(K3, 0.0, 10.0)],
                steps=0 if case == "no steps" else 4)
    if case == "untraced":
        b.profile = None
    assert match.read(b) is None


def test_blocks_worked_reads_the_counts(monkeypatch):
    worked = run.reader("pair_bwd_blocks_worked.train_crowd")
    bwd = pairwise2.pair_pool_backward
    monkeypatch.setattr(bwd, "blocks_launched", 4000)
    monkeypatch.setattr(bwd, "blocks_with_work", lambda: 1100)
    assert worked.read(Bench(CELL, 1, 1.0, True)) == pytest.approx(27.5)


def test_blocks_worked_none_without_launches(monkeypatch):
    worked = run.reader("pair_bwd_blocks_worked.train_crowd")
    bwd = pairwise2.pair_pool_backward
    monkeypatch.setattr(bwd, "blocks_launched", 0)
    assert worked.read(Bench(CELL, 1, 1.0, True)) is None
    # a program without the kernel's own count
    monkeypatch.setattr(bwd, "blocks_launched", 4000)
    monkeypatch.delattr(bwd, "blocks_with_work")
    assert worked.read(Bench(CELL, 1, 1.0, True)) is None


@pytest.mark.parametrize("name", ["pair_bwd_from_records.train_crowd",
                                  "pair_bwd_from_records.train"])
def test_from_records_reads_the_column_counts(monkeypatch, name):
    records = run.reader(name)
    bwd = pairwise2.pair_pool_backward
    monkeypatch.setattr(bwd, "column_blocks", lambda: (990, 10))
    assert records.read(Bench(CELL, 1, 1.0, True)) == pytest.approx(99.0)
    # no column block with a step, or a program without the count
    monkeypatch.setattr(bwd, "column_blocks", lambda: (0, 0))
    assert records.read(Bench(CELL, 1, 1.0, True)) is None
    monkeypatch.delattr(bwd, "column_blocks")
    assert records.read(Bench(CELL, 1, 1.0, True)) is None


@pytest.mark.parametrize("metric", CROWD_METRICS, ids=lambda m: m["name"])
def test_crowd_metric_readers(metric):
    """Each of the cell's metrics has its reader, which says what the
    entry says and moves the cell's rate."""
    mod = run.reader(metric["name"])
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
        metric["layer"], metric["unit"], metric["source"], metric["moves"])
    assert metric["moves"] == "train_dets_per_s"
    assert metric["workloads"] == [CELL]


def test_crowd_readers_share_the_dense_cells_arithmetic():
    """The cell's idle, roofline and MFU readers are the dense cell's
    arithmetic under a new name: the same trace reads the same."""
    model = crowd_file()["config"]["model"]
    b = _traced([("void (anonymous namespace)::pair_pool2_fwd_kernel<32>",
                  0.0, 2e5),
                 ("void (anonymous namespace)::pair_pool2_bwd_kernel<32>",
                  3e5, 8e5)])
    b.layer = {"model": model, "pairs": 410_000 * 50, "dets": 4_480 * 50,
               "launches": 16 * 50, "steps": 50,
               "params": weights.parameter_count(model)}
    for name in ("device_idle", "pair_fwd_roofline", "pair_bwd_roofline",
                 "step_mfu"):
        crowd = run.reader(f"{name}.train_crowd").read(b)
        dense = run.reader(f"{name}.train").read(b)
        assert crowd == dense and crowd is not None and crowd > 0
    assert layer.device_idle(b) == pytest.approx(30.0)


def test_crowd_cell_entries():
    cell = {w["name"]: w for w in BENCHMARK["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "crowded_4096", "crowd_4096_roidb", 1)
    config = {c["name"]: c for c in BENCHMARK["configs"]}["crowded_4096"]
    assert config["reduced"] == [] and config["file"].endswith(
        "crowded_4096.json")
    rate = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    assert CELL in rate["train_dets_per_s"]["workloads"]
    assert {m["name"] for m in run.cell_metrics(BENCHMARK, CELL, False)} == {
        "train_dets_per_s", "setup_s"}
    assert len(CROWD_METRICS) == 7
    assert set(bench.workload_file(CELL)["limits"]) == {
        "loss_gap", "loss_gap_step1", "grad_gap", "update_gap"}


def test_pair_times_crowd_row_is_the_cells_pool():
    """``chip_smoke.py --pair-times``'s crowd row runs two images of the
    cell's own pool, padded to the cell's bucket."""
    import chip_smoke

    mix = bench.traffic_file("crowd_4096_roidb")
    (preset, _), = mix["pool"].items()
    assert chip_smoke.SPARSE_POOL_SEED == mix["pool_seed"]
    boxes, scores, valid = chip_smoke.crowd_fill_batch("cpu")
    assert boxes.shape == (2, 4096, 4)
    pool = generate.pools(1, mix, 4096)[preset][:2]
    for i, im in enumerate(pool):
        n = len(im.scores)
        assert int(valid[i].sum()) == n and bool(valid[i, :n].all())
        assert np.array_equal(boxes[i, :n].numpy(), im.boxes)
        assert np.array_equal(scores[i, :n].numpy(), im.scores)
