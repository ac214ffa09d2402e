"""Whole runs on the CPU at a small size, the look for a card skipped:
as measured they are correct, with a fault planted in the timed path
(``faults.py``) they are not, and the control (the program's bf16 pair
stream) reads well above the program."""

import pytest

from portbench import run
from portbench.bench import Bench

SMALL = {
    "train_sparse_persons": {
        "config": {"model": {"num_blocks": 1}},
        "traffic": {"pool": {"full": 16}}},
    "train_dense_persons": {
        "config": {"model": {"num_blocks": 1}},
        "traffic": {"pool": {"dense_p": 8}}},
    "serve_crowd_closed": {
        "config": {"model": {"num_blocks": 2},
                   "data": {"max_detections": 256, "bucket_sizes": [64, 256]},
                   "train": {"batch_size": 2}},
        "traffic": {"pool": {"full": 6}, "mix": {"full": 1.0}, "clients": 3,
                    "sample": 4}},
    "serve_coco_poisson": {
        "config": {"model": {"num_blocks": 2},
                   "data": {"max_detections": 256, "bucket_sizes": [64, 256]},
                   "train": {"batch_size": 2}},
        "traffic": {"pool": {"full": 8, "dense_p": 2, "dense_4k": 1},
                    "mix": {"full": 1.0}, "rate_per_s": 10, "sample": 4,
                    "connections": 2}},
}
FAULTS = {"train_sparse_persons": ["frozen_state", "half_batch"],
          "serve_crowd_closed": ["altered_answer"],
          "serve_coco_poisson": ["altered_answer"]}


def small_run(cell: str, fault=None, control=False, seed=2 ** 33 + 5):
    overrides = {k: dict(v) for k, v in SMALL[cell].items()}
    if control:
        overrides["config"] = {**overrides["config"], "model": {
            **overrides["config"]["model"], **run.CONTROL["config"]["model"]}}
    bench = Bench.for_cell(cell, seed, 0.5, False, device="cpu",
                           overrides=overrides)
    if fault:
        with run.FAULTS[fault]():
            run.measure(bench)
    else:
        run.measure(bench)
    assert run.forbidden_modules() == []
    return bench


@pytest.mark.parametrize("cell", ["train_sparse_persons",
                                  "serve_crowd_closed"])
def test_sound_runs_are_correct(cell):
    bench = small_run(cell)
    assert bench.correct, bench.checks
    assert bench.setup_s > 0 and bench.end_to_end


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items()
                                        for f in fs])
def test_a_planted_fault_is_not_correct(cell, fault):
    bench = small_run(cell, fault)
    assert not bench.correct, bench.checks


@pytest.mark.parametrize("cell,number,ratio", [
    ("train_sparse_persons", "grad_gap", 3.0),
    ("serve_crowd_closed", "score_gap", 10.0)])
def test_the_control_reads_above_the_program(cell, number, ratio):
    sound = small_run(cell).checks[number][0]
    control = small_run(cell, control=True).checks[number][0]
    assert control > ratio * max(sound, 1e-7)


def test_the_control_fails_each_cell_on_the_card(card):
    """At each cell's own size: the control comes out not correct."""
    import json
    import subprocess
    import sys

    from portbench.bench import ROOT

    cells = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
    for cell in [c["name"] for c in cells]:
        out = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload", cell,
             "--seed", "3141592653", "--seconds", "3", "--trace", "0",
             "--control"], cwd=ROOT, capture_output=True, text=True,
            check=True).stdout
        assert json.loads(out.splitlines()[-1])["correct"] is False, cell


test_the_control_fails_each_cell_on_the_card = pytest.mark.cuda(
    test_the_control_fails_each_cell_on_the_card)
