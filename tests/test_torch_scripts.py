"""The reference's user scripts in the port (``gossipnet_tpu_torch/tools/``):
``quality_demo`` (the RESULTS.md families), ``calibrate`` (the AP-parity
sweep) and ``demo_config1`` (config 1's inference workflow). The configs
and cells are held equal to the JAX scripts' own; two of the tools run end
to end on the CPU on tiny synthetic data."""

import torch_cpu  # noqa: F401  (first: one torch thread)
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import yaml

from gossipnet_tpu_torch.data import synthetic as t_synthetic
from gossipnet_tpu_torch.tools import calibrate, demo_config1, quality_demo

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", str(SCRIPTS / f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_QD = _reference("quality_demo")


@pytest.mark.parametrize("family", sorted(REF_QD.FAMILIES))
def test_family_config_equals_the_reference(family):
    steps = 2400 if family == "long" else 600
    got = quality_demo.family_config(family, steps, "/x/demo")
    want = REF_QD.family_config(family, steps, "/x/demo")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    maker, mk, tcfg, tag = quality_demo.FAMILIES[family]
    r_maker, r_mk, r_tcfg, r_tag = REF_QD.FAMILIES[family]
    assert (maker.__name__, mk, tcfg, tag) == (r_maker.__name__, r_mk,
                                               r_tcfg, r_tag)


def _strip(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["train"].pop("checkpoint_dir")      # a fresh temporary directory
    return d


@pytest.mark.parametrize("grid", [False, True])
def test_calibrate_cells_equal_the_reference(monkeypatch, grid):
    """Both mains with training and evaluation replaced: the configs they
    would train, cell by cell and in order, are the same."""
    import gossipnet_tpu.evaluate as j_evaluate
    import gossipnet_tpu.train as j_train
    import gossipnet_tpu_torch.evaluate as t_evaluate
    import gossipnet_tpu_torch.train as t_train

    seen = {"ref": [], "port": []}
    stats = {"AP": 0.5, "AP50": 0.5}

    def recorder(key):
        def fake_train(cfg, *args, **kwargs):
            seen[key].append(_strip(cfg))
            return type("S", (), {"params": None, "model": None})()
        return fake_train

    monkeypatch.setattr(j_train, "train", recorder("ref"))
    monkeypatch.setattr(j_train, "build_model", lambda *a, **k: None)
    for mod in (j_evaluate, t_evaluate):
        monkeypatch.setattr(mod, "evaluate_model", lambda *a, **k: stats)
        monkeypatch.setattr(mod, "evaluate_raw_scores",
                            lambda *a, **k: stats)
    import gossipnet_tpu.data.synthetic as j_synthetic
    monkeypatch.setattr(j_synthetic, "synthetic_roidb", lambda **k: None)
    monkeypatch.setattr(t_train, "train", recorder("port"))
    monkeypatch.setattr(calibrate, "datasets", lambda base: (None, None))
    argv = ["--steps", "7"] + (["--grid"] if grid else [])
    _reference("calibrate").main(argv)
    calibrate.main(argv + ["--device", "cpu"])
    assert len(seen["port"]) == (16 if grid else 12)
    assert seen["port"] == seen["ref"]


_SYNTHETIC_ROIDB = t_synthetic.synthetic_roidb


def _tiny_roidb(num_images=4, seed=0, num_classes=1, **kw):
    return _SYNTHETIC_ROIDB(num_images=num_images, seed=seed,
                            num_classes=num_classes, num_gt=3,
                            dets_per_gt=3, num_clutter=3)


def test_demo_config1_runs_end_to_end_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(t_synthetic, "synthetic_roidb", _tiny_roidb)
    out_file = tmp_path / "rescored.json"
    out = demo_config1.main(["--out", str(out_file), "--device", "cpu"])
    roidb = _tiny_roidb(num_images=16, seed=5)
    total = sum(rec.num_dets for rec in roidb)
    assert out["exported"] == total
    assert len(json.loads(out_file.read_text())) == total
    for stats in (out["gossipnet"], out["raw_scores"]):
        assert 0.0 <= stats["AP"] <= 1.0
    assert demo_config1.config1().model.num_blocks == 1


def test_one_calibrate_cell_trains_and_evaluates_on_the_cpu(monkeypatch,
                                                           tmp_path):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump({
        "model": {"num_blocks": 1, "feature_dim": 16, "reduced_dim": 8,
                  "pairwise_dim": 8},
        "data": {"bucket_sizes": [64], "max_detections": 64},
        "train": {"batch_size": 2}}))
    monkeypatch.setattr(calibrate, "datasets",
                        lambda base: (_tiny_roidb(), _tiny_roidb(seed=1)))
    monkeypatch.setattr(calibrate, "cells", lambda *a: [{}])   # BASE alone
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    results = calibrate.main(["-c", str(cfg), "--steps", "2", "--device",
                              "cpu", "--pool-impl", "kernel"])
    (ap, cell, stats), = results
    assert cell == {"BASE": True}
    assert np.isfinite(ap) and ap == stats["AP"]
    metrics = list(tmp_path.glob("gnet_cal_*/m.jsonl"))
    assert len(metrics) == 1 and metrics[0].read_text().strip()
