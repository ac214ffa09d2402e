"""Every file the harness finds by name loads, and BENCHMARK.json keeps
to the rules its check holds it to."""

import json
import re

import pytest

from portbench import bench, run
from portbench.bench import HERE, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_load(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and 0 < len(cell["why"]) <= 200
    wl = bench.workload_file(cell["name"])
    assert wl["config"] == cell["config"] and wl["traffic"] == cell["traffic"]
    assert (HERE / "drivers" / f"{wl['driver']}.py").is_file()
    assert bench.traffic_file(cell["traffic"])["kind"] in (
        "roidb", "open", "closed")
    assert all(v >= 0 for v in wl["limits"].values())


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_load(config):
    from gossipnet_tpu_torch.config import load_config

    path = ROOT / config["file"]
    assert path.is_relative_to(HERE) and path.is_file()
    tree = json.loads(path.read_text())
    assert tree["name"] == config["name"]
    assert tree["reduced"] == config["reduced"]
    assert tree["source"] == config["source"]
    cfg = load_config(None, overrides=tree["config"])
    assert (cfg.model.num_blocks, cfg.model.feature_dim,
            cfg.model.reduced_dim, cfg.model.pairwise_dim) == (16, 128, 32, 32)


def test_metrics_and_their_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = [w["name"] for w in BENCH["workloads"]]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for cell in cells:
        reported = {m["name"] for m in run.cell_metrics(BENCH, cell, False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert run.cell_metrics(BENCH, cell, True)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_layer_metric_files(metric):
    mod = run.reader(metric["name"])
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
        metric["layer"], metric["unit"], metric["source"], metric["moves"])
    moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    for cell in metric["workloads"]:
        assert "workloads" not in moved or cell in moved["workloads"]


def test_kernel_files():
    for path in sorted((HERE / "kernels").glob("*.json")):
        stages = json.loads(path.read_text())["stages"]
        assert set(stages) <= {"pair_fwd", "pair_bwd"} and all(stages.values())
        for patterns in stages.values():
            for p in patterns:
                re.compile(p)


def test_paths_hold_only_names():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
