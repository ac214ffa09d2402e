"""Config 3, the 80-class GossipNet, as the benchmark runs it
(``train_dense80_mt``).

- its configuration file loads to the ``Config`` of
  ``experiments/coco_multiclass.yaml`` with only the keys its ``assumed``
  names changed (the matching thresholds, COCO's 0.5:0.95);
- its traffic (``portbench/traffic/drill80.py``) draws exactly what the
  scale drill's ``gen`` writes with the drill's ``DENSE`` preset, classes
  mapped as ``build_roidb`` maps them, and fills mostly the 1024 bucket;
- the port's plain CPU step agrees with the class-aware reference
  (``portbench/reference/multiclass.py``) on one T=10 step, and the bf16
  pair stream, a reference without the class match and one without the
  class embedding do not; the reference matches in the order it is given,
  and agrees with the step in the order of the port's first logits, which
  the driver reads (``first_logits``);
- ``portbench/weights_multiclass.py`` names and shapes the port's
  ``state_dict``;
- the cell's new readers read a hand-made trace and hand-set counters,
  and return None where they have nothing to read.

The file imports no JAX.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import dataclasses
import functools
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from gossipnet_tpu_torch.config import experiment_path, load_config
from gossipnet_tpu_torch.data.bucketing import BatchIterator, make_batch
from gossipnet_tpu_torch.data.roidb import ImageRecord
from gossipnet_tpu_torch.ops.cuda import matching_scan
from gossipnet_tpu_torch.train import (BATCH_KEYS, batch_to_device,
                                       build_model, loss_and_metrics)
from portbench import bench, counts, counts_multiclass, run
from portbench import weights_multiclass
from portbench.bench import ROOT, Bench
from portbench.drivers import train_multiclass
from portbench.metrics import layer
from portbench.reference import multiclass as ref_mc
from portbench.trace import Profile
from portbench.traffic import drill80

CELL = "train_dense80_mt"
CONFIG = "coco_multiclass_mt"
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL_METRICS = [m for m in BENCHMARK["per_layer"]
                if CELL in m.get("workloads", ())]
MT = [0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8, 0.85, 0.9, 0.95]


def config_file() -> dict:
    return bench.config_file(CONFIG)


def test_configuration_is_the_yaml_with_cocos_thresholds():
    from gossipnet_tpu_torch.tools import scale_drill

    tree = config_file()
    assert tree["reduced"] == []
    assert json.loads(scale_drill.MT_THRESHOLDS) == MT
    got = load_config(None, overrides=tree["config"])
    yaml = load_config(experiment_path("coco_multiclass"))
    assert got.matching.thresholds != yaml.matching.thresholds
    assert list(got.matching.thresholds) == MT
    # the one key the file changes is the one its `assumed` names first
    assert "matching.thresholds" in tree["assumed"]
    assert dataclasses.replace(
        got, matching=dataclasses.replace(
            got.matching, thresholds=yaml.matching.thresholds)) == yaml
    # the defaults the file's `assumed` names
    assert (got.matching.class_aware, got.matching.crowd_as_ignore,
            got.model.pair_kernel, got.train.seed) == (True, True, 2, 0)
    assert (got.model.num_classes, got.model.class_embed_dim,
            got.train.batch_size, got.train.grad_clip_norm) == (80, 32, 8,
                                                                10.0)


def test_dense80_is_the_drills_dense_preset_with_its_person_share():
    from gossipnet_tpu_torch.tools import scale_drill

    assert drill80.PRESETS["dense80"] == {**scale_drill.DENSE,
                                          "person_p": 0.3}
    assert drill80.NUM_CLASSES == 80


@pytest.mark.parametrize("max_dets", [1024, 512])
def test_drill80_draws_the_drills_files_with_every_class(tmp_path, max_dets):
    """The in-memory draw is ``gen(**DENSE)`` loaded by ``build_roidb`` with
    all 80 classes: the same images, boxes, scores and classes (at 512 the
    score-ranked cap cuts every image)."""
    from gossipnet_tpu_torch.data.roidb import build_roidb
    from gossipnet_tpu_torch.tools import scale_drill

    scale_drill.gen(n_images=3, seed=5, data_dir=tmp_path,
                    **scale_drill.DENSE)
    roidb = build_roidb(str(tmp_path / "annotations.json"),
                        str(tmp_path / "detections.json"), person_only=False,
                        max_dets=max_dets, skip_empty=False)
    assert roidb.cat_ids == sorted(drill80.LABEL)
    rng = np.random.default_rng(5)
    for rec in roidb.records:
        im = drill80.draw_image(rng, max_dets=max_dets,
                                **drill80.PRESETS["dense80"])
        np.testing.assert_array_equal(rec.det_boxes, im.boxes)
        np.testing.assert_array_equal(rec.det_scores, im.scores)
        np.testing.assert_array_equal(rec.det_classes, im.classes)
        np.testing.assert_array_equal(rec.gt_boxes, im.gt_boxes)
        np.testing.assert_array_equal(rec.gt_classes, im.gt_classes)
        np.testing.assert_array_equal(rec.gt_crowd, im.gt_crowd)
        assert len(im.scores) <= max_dets
        assert len(set(im.classes.tolist())) > 30


def test_traffic_fills_mostly_the_1024_bucket():
    cfg = load_config(None, overrides=config_file()["config"])
    mix = bench.traffic_file(bench.workload_file(CELL)["traffic"])
    images = drill80.roidb_images(2 ** 33 + 5, mix, cfg.data.max_detections)
    assert len(images) == 256
    dets = np.array([len(im.scores) for im in images])
    # no image reaches the cap; most lie in the 1024 bucket
    assert dets.max() < 1024 and dets.min() > 256
    assert 0.8 < np.mean(dets > 512) < 0.95
    assert 600 < dets.mean() < 760
    again = drill80.roidb_images(2 ** 33 + 6, mix, cfg.data.max_detections)
    assert sorted(dets) == sorted(len(im.scores) for im in again)
    it = BatchIterator(train_multiclass._roidb(images), cfg.train.batch_size,
                       cfg.data.bucket_sizes, seed=cfg.train.seed)
    for _ in range(32):
        b = next(it)
        assert b.padded_n in (512, 1024) and b.boxes.shape[0] == 8
        assert b.classes.max() < 80 and b.gt_classes.max() < 80


# -- one class-aware step against the reference ------------------------------

LOSS_LIMIT, GRAD_LIMIT = 1e-6, 3e-2


def _images():
    """The cell's own pool's first two images, capped at 192 detections."""
    mix = bench.traffic_file("dense80_roidb")
    return drill80.draw(mix["pool_seed"], "pool.dense80", "dense80", 2, 192)


def _as_reference(images):
    return [(im.boxes, im.scores, im.classes, im.gt_boxes, im.gt_classes,
             im.gt_crowd) for im in images]


def _model() -> dict:
    return {**config_file()["config"]["model"], "num_blocks": 2}


def _cfg(extra: tuple = ()):
    """Config 3 at two blocks of the published widths, padded to N=192."""
    tree = config_file()["config"]
    return load_config(None, overrides={
        **tree, "model": {**_model(), **dict(extra)},
        "data": {**tree["data"], "max_detections": 192,
                 "bucket_sizes": [192]}})


def _batch():
    recs = [ImageRecord(i, im.boxes, im.scores, im.classes, im.gt_boxes,
                        im.gt_classes, im.gt_crowd)
            for i, im in enumerate(_images())]
    return make_batch(recs, 192)


@functools.lru_cache(maxsize=None)
def _step(extra: tuple = ()):
    """Step 1's loss and gradient of config 3 at two blocks of the
    published widths on the port's plain CPU path (padded to N=192)."""
    cfg = _cfg(extra)
    net = build_model(cfg, "kernel", "cpu")
    net.load_state_dict(weights_multiclass.make(_model(), 2 ** 33 + 1,
                                                "cpu"))
    batch = batch_to_device(_batch(), "cpu")
    loss, _ = loss_and_metrics(net, batch, cfg)
    loss.backward()
    return (float(loss.detach()),
            {k: p.grad for k, p in net.named_parameters()},
            list(cfg.matching.thresholds))


def _reference(params=None):
    w = weights_multiclass.make(_model(), 2 ** 33 + 1, "cpu")
    return ref_mc.loss_and_grads(w if params is None else params(w),
                                 _as_reference(_images()), 2, MT)


def _gaps(port, reference):
    (loss, grads), (want, ref_grads) = port, reference
    norms = {k: float(g.norm()) for k, g in ref_grads.items()}
    med = float(np.median(list(norms.values())))
    leaf = max(float((grads[k] - g).norm()) / max(norms[k], med)
               for k, g in ref_grads.items())
    return abs(loss - want) / abs(want), leaf


def test_class_aware_step_agrees_with_the_reference():
    """Two blocks at the published 128/32/32 and 80 classes, B=2, the
    cell's first two images capped at 192 detections, T=10 within classes.

    Limits: the loss within 1e-6 of the reference's, relatively (the
    port's forward reads 1.7e-7 here; both sum in float32 in other
    orders); each gradient leaf within 3e-2 of the larger of its norm and
    the median leaf's (the port reads 9.9e-3, in ``pair_wg``'s geometric
    rows: its backward rounds its pair dots' operands to bf16, the
    reference passes float32 straight through). Over six draws the port
    read at most 1.7e-7 and 1.21e-2; the bf16 stream at least 1.2e-5 and
    5.9e-2, so it fails both."""
    loss, grads, thresholds = _step()
    assert thresholds == MT
    gaps = _gaps((loss, grads), _reference())
    assert gaps[0] <= LOSS_LIMIT and gaps[1] <= GRAD_LIMIT, gaps


def test_bf16_stream_fails_the_comparison():
    stream = _step((("pair_elementwise_dtype", "bfloat16"),))[:2]
    gaps = _gaps(stream, _reference())
    assert gaps[0] > LOSS_LIMIT and gaps[1] > GRAD_LIMIT, gaps


def _without_class_match(monkeypatch):
    init = ref_mc.Geometry.__init__

    def dropped(self, *args):
        init(self, *args)
        self.pair_feats = torch.cat([self.pair_feats[:, :3],
                                     torch.zeros_like(self.pair_feats[:, 3:])],
                                    dim=-1)

    monkeypatch.setattr(ref_mc.Geometry, "__init__", dropped)
    return None


def _without_embedding(monkeypatch):
    def zeroed(w):
        return {**w, "class_embed.weight":
                torch.zeros_like(w["class_embed.weight"])}
    return zeroed


@pytest.mark.parametrize("dropped", [_without_class_match,
                                     _without_embedding],
                         ids=["class_match", "class_embedding"])
def test_a_reference_without_a_class_part_fails_the_comparison(
        monkeypatch, dropped):
    """Over six draws a reference without the class match read at least
    5.4e-4 and 0.41, one without the embedding 6.6e-4 and 0.47: both fail
    both limits."""
    port = _step()[:2]
    params = dropped(monkeypatch)
    gaps = _gaps(port, _reference(params))
    assert gaps[0] > LOSS_LIMIT and gaps[1] > GRAD_LIMIT, gaps


def _own_logits(params, images) -> list:
    return [ref_mc.forward(params, ref_mc.Geometry(
        *(torch.as_tensor(x) for x in im[:3])), 2).detach().numpy()
        for im in images]


def test_reference_matches_in_the_order_it_is_given():
    """``order`` sets the matching's order: the reference's own logits give
    its own step bit for bit, the same logits negated other targets."""
    w = weights_multiclass.make(_model(), 2 ** 33 + 1, "cpu")
    images = _as_reference(_images())
    loss, grads = _reference()
    own = _own_logits(w, images)
    same = ref_mc.loss_and_grads(w, images, 2, MT, order=own)
    assert same[0] == loss
    assert all(torch.equal(same[1][k], g) for k, g in grads.items())
    other = ref_mc.loss_and_grads(w, images, 2, MT,
                                  order=[-x for x in own])
    assert other[0] != loss


def test_first_logits_are_the_ports_and_the_step_agrees_in_their_order():
    """The driver's ``first_logits`` reads the port's first-step logits of
    each image over its valid rows (the reference's within the forward's
    agreement), and the reference matching in their order agrees with the
    port's step within the comparison's limits."""
    w = weights_multiclass.make(_model(), 2 ** 33 + 1, "cpu")
    batch = _batch()
    arrays = {k: np.array(getattr(batch, k)) for k in BATCH_KEYS}
    order = train_multiclass.first_logits(_cfg(), w, arrays, "cpu")
    images = _as_reference(_images())
    assert [len(x) for x in order] == [len(im[0]) for im in images]
    for got, want in zip(order, _own_logits(w, images)):
        np.testing.assert_allclose(got, want, atol=1e-3)
    gaps = _gaps(_step()[:2], ref_mc.loss_and_grads(w, images, 2, MT,
                                                    order=order))
    assert gaps[0] <= LOSS_LIMIT and gaps[1] <= GRAD_LIMIT, gaps


def test_reference_imports_neither_jax_nor_the_port_and_turns_tf32_off():
    code = ("import json, sys\n"
            "import portbench.reference.multiclass, "
            "portbench.weights_multiclass, portbench.counts_multiclass, "
            "portbench.traffic.drill80\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    top = set(json.loads(out.splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "optax", "gossipnet_tpu",
                      "gossipnet_tpu_torch"}
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        im = _images()[0]
        ref_mc.loss_and_grads(
            weights_multiclass.make({**_model(), "num_blocks": 1}, 1, "cpu"),
            _as_reference([im])[:1], 1, [0.5])
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_reference_class_features():
    """The per-class rank counts only the detections of its own class, and
    the class match is the fourth per-pair feature."""
    boxes = torch.tensor([[0, 0, 10, 10], [1, 1, 11, 11], [0, 0, 10, 11],
                          [50, 50, 60, 60]], dtype=torch.float32)
    scores = torch.tensor([0.9, 0.8, 0.7, 0.6])
    classes = torch.tensor([3, 5, 3, 5])
    geom = ref_mc.Geometry(boxes, scores, classes)
    np.testing.assert_allclose(geom.phi[:, 1].numpy(), [0, 0, 0.5, 0.5])
    same = (classes[geom.I] == classes[geom.J]).float()
    assert torch.equal(geom.pair_feats[:, 3], same)
    assert ref_mc.IN_PAIR == (0, 1, 2, 8)


def test_weights_name_and_shape_the_ports_state_dict():
    model = config_file()["config"]["model"]
    cfg = load_config(None, overrides=config_file()["config"])
    net = build_model(cfg, "dense", "cpu")
    want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    got = weights_multiclass.make(model, 3, "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert weights_multiclass.parameter_count(model) == sum(
        v.numel() for v in net.state_dict().values())
    spec = {name: std for name, _, std in weights_multiclass.shapes(model)}
    assert spec["class_embed.weight"] == pytest.approx(32 ** -0.5)
    assert spec["init_fc.weight"] == pytest.approx(34 ** -0.5)
    assert spec["blocks.0.pair_wg"] == pytest.approx(9 ** -0.5)
    net.load_state_dict(got)


def test_class_aware_counts_by_hand():
    p = 32
    assert counts_multiclass.pair_flops(p) == 2 * p * p + 2 * 4 * p + 4 * p
    assert counts_multiclass.pair_flops(p) - counts.pair_flops(p) == 2 * p
    model = config_file()["config"]["model"]
    extra = 2 * 32 * 128     # init_fc's 32 more inputs a detection
    assert (counts_multiclass.forward_flops(model, 10, 0)
            - counts.forward_flops(model, 10, 0)) == 10 * extra
    # nine fields a side (one more than config 2's eight), four in-pair
    # rows of Wg (one more)
    assert (counts_multiclass.pair_forward_bytes(p, 100, 1)
            - counts.pair_forward_bytes(p, 100, 1)) == 100 * 2 * 4 + p * 4
    assert (counts_multiclass.pair_backward_bytes(p, 100, 1)
            - counts.pair_backward_bytes(p, 100, 1)) == 100 * 2 * 4 + 2 * p * 4


# -- the cell's readers ------------------------------------------------------

K3 = "void (anonymous namespace)::greedy_scan_kernel<4>(float const*)"
K1 = "void (anonymous namespace)::pair_pool2_fwd_kernel<32, true, false>"
K2 = "void (anonymous namespace)::pair_pool2_bwd_pass_kernel<32, true>"


def _traced(device, **work):
    b = Bench(CELL, 1, 1.0, True, device="cpu")
    prof = Profile(False)
    prof.window, prof.device = (0.0, 1e6), device
    b.profile, b.layer = prof, work
    return b


def _work(**more) -> dict:
    model = config_file()["config"]["model"]
    return {"model": model, "pairs": 180_000 * 50, "dets": 5_500 * 50,
            "launches": 16 * 50, "steps": 50,
            "params": weights_multiclass.parameter_count(model), **more}


TRACE = [(K1, 0.0, 2e5), (K2, 3e5, 8e5), (K3, 8e5, 8.5e5),
         (K3, 1e6 - 50.0, 1e6 + 150.0)]    # the last clipped to the window


def test_idle_reads_the_window():
    idle = run.reader("device_idle.train_dense80")
    # busy 0-200 ms, 300-850 ms, the last 50 us
    assert idle.read(_traced(TRACE, **_work())) == pytest.approx(
        100 * (1 - 0.75005))


@pytest.mark.parametrize("stage,seconds", [("pair_fwd", 0.2),
                                           ("pair_bwd", 0.5)])
def test_pair_rooflines_count_the_class_aware_work(stage, seconds):
    mc = run.reader(f"{stage}_roofline.train_dense80").read(
        _traced(TRACE, **_work()))
    work, p = _work(), 32
    flops = work["pairs"] * 16 * (2 * p * p + 2 * 4 * p + 4 * p)
    rows = work["dets"] * 16
    nbytes = (counts_multiclass.pair_forward_bytes(p, rows, 800)
              if stage == "pair_fwd" else
              counts_multiclass.pair_backward_bytes(p, rows, 800))
    assert mc == pytest.approx(
        100 * counts.least_seconds(flops, nbytes) / seconds)
    # more than config 2's count of the same pairs reads
    agnostic = run.reader(f"{stage}_roofline.train").read(
        _traced(TRACE, **_work()))
    assert mc > agnostic > 0


def test_step_mfu_counts_the_class_aware_model():
    mfu = run.reader("step_mfu.train_dense80").read(_traced(TRACE, **_work()))
    work = _work()
    flops = (3 * counts_multiclass.forward_flops(work["model"], work["dets"],
                                                 work["pairs"])
             + layer.ADAM_OPS * work["params"] * 50)
    assert mfu == pytest.approx(100 * flops / counts.PEAKS["bf16_flops"])


def test_match_readers_read_k3():
    b = _traced(TRACE, **_work(match_rows=8 * 10 * 1024 * 50))
    # (50 ms + 50 us) of K3 over 50 steps, and over the rows launched
    assert run.reader("match_ms.train_dense80").read(b) == pytest.approx(
        50.05 / 50)
    assert run.reader("match_ns_per_row.train_dense80").read(
        b) == pytest.approx(50.05e-3 * 1e9 / (8 * 10 * 1024 * 50))


def test_trainer_host_ms_reads_the_step_spans():
    b = _traced(TRACE, **_work())
    b.profile.host = [("gossipnet.train.step", 100.0, 500.0),
                      ("gossipnet.graphs.launch", 200.0, 450.0),
                      ("gossipnet.train.step", 600.0, 900.0),
                      ("gossipnet.graphs.launch", 650.0, 700.0)]
    # self times 0.15 and 0.25 ms
    assert run.reader("trainer_host_ms.train_dense80").read(
        b) == pytest.approx(0.2)


@pytest.mark.parametrize("name", [m["name"] for m in CELL_METRICS])
def test_readers_none_untraced(name):
    b = _traced([], **_work())
    b.profile, b.layer = None, {}
    assert run.reader(name).read(b) is None


@pytest.mark.parametrize("name", [m["name"] for m in CELL_METRICS
                                  if not m["name"].startswith(
                                      ("device_idle", "step_mfu"))])
def test_readers_none_where_their_kernels_or_spans_never_ran(name):
    """A traced window without the reader's kernels or spans: None, where
    the idle share and the MFU read 100% and the window's work."""
    assert run.reader(name).read(_traced([], **_work())) is None


@pytest.mark.parametrize("case", ["no counter", "no rows", "no steps"])
def test_match_readers_none_without_their_counts(case):
    work = _work(match_rows=0 if case == "no rows" else 1000)
    if case == "no counter":
        del work["match_rows"]
    if case == "no steps":
        work["steps"] = 0
    b = _traced(TRACE, **work)
    per_row = run.reader("match_ns_per_row.train_dense80").read(b)
    per_step = run.reader("match_ms.train_dense80").read(b)
    assert (per_row is None) == (case != "no steps")
    assert (per_step is None) == (case == "no steps")


def test_driver_reads_rows_launched_where_the_trace_opens_and_closes(
        monkeypatch):
    scan = matching_scan.greedy_scan_batched
    monkeypatch.setattr(scan, "rows_launched", 1000)
    prof = train_multiclass.RowsProfile(False)
    prof.open()
    scan.rows_launched += 8 * 10 * 1024
    prof.close()
    assert (prof.rows_open, prof.rows_close) == (1000, 1000 + 81920)
    # a program without the counter: both None, and no reading
    monkeypatch.delattr(scan, "rows_launched")
    prof = train_multiclass.RowsProfile(False)
    prof.open()
    prof.close()
    assert prof.rows_open is None and prof.rows_close is None


@pytest.mark.parametrize("metric", CELL_METRICS, ids=lambda m: m["name"])
def test_cell_metric_readers(metric):
    """Each of the cell's metrics has its reader, which says what the
    entry says and moves the cell's rate."""
    mod = run.reader(metric["name"])
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
        metric["layer"], metric["unit"], metric["source"], metric["moves"])
    assert metric["moves"] == "train_dets_per_s"
    assert metric["workloads"] == [CELL]


def test_cell_entries():
    cell = {w["name"]: w for w in BENCHMARK["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "dense80_roidb", 1)
    config = {c["name"]: c for c in BENCHMARK["configs"]}[CONFIG]
    assert config["reduced"] == [] and config["file"].endswith(
        f"{CONFIG}.json")
    rate = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    assert CELL in rate["train_dets_per_s"]["workloads"]
    assert {m["name"] for m in run.cell_metrics(BENCHMARK, CELL, False)} == {
        "train_dets_per_s", "setup_s"}
    assert sorted(m["name"] for m in CELL_METRICS) == sorted(
        f"{n}.train_dense80" for n in (
            "device_idle", "pair_fwd_roofline", "pair_bwd_roofline",
            "step_mfu", "match_ms", "match_ns_per_row", "trainer_host_ms"))
    wl = bench.workload_file(CELL)
    assert wl["driver"] == "train_multiclass"
    assert set(wl["limits"]) == {"loss_gap", "loss_gap_step1", "grad_gap",
                                 "update_gap"}
