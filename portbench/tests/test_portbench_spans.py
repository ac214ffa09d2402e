"""The readers of the program's spans (``metrics/spans.py``) on a
synthetic trace: a step's self time less its named descendants, only the
spans wholly inside the window, None where the program records no span,
and the idle stretches put down to the innermost span at their start."""

import types

import pytest

from portbench import run
from portbench.metrics import spans
from portbench.trace import Profile

STEP, DRAW, STAGE, LAUNCH, SYNC, CAPTURE = (
    "gossipnet.train.step", "gossipnet.train.draw", "gossipnet.graphs.stage",
    "gossipnet.graphs.launch", "gossipnet.train.sync",
    "gossipnet.graphs.capture")


def profile(host, device=(), window=(100.0, 1100.0)):
    p = Profile(False)
    p.host, p.device, p.window = list(host), list(device), window
    return p


def bench(prof):
    return types.SimpleNamespace(profile=prof)


# two whole steps in the window (us): the second logs (a sync) and the
# first captures inside its stage; a third step crosses the window's end,
# and one before it its start
HOST = [
    (STEP, 50.0, 150.0), (LAUNCH, 60.0, 90.0),
    (STEP, 200.0, 600.0), (DRAW, 210.0, 260.0), (STAGE, 260.0, 400.0),
    (CAPTURE, 300.0, 380.0), (LAUNCH, 400.0, 450.0),
    ("cudaGraphLaunch", 405.0, 445.0),
    (STEP, 600.0, 1000.0), (DRAW, 610.0, 640.0), (STAGE, 640.0, 700.0),
    (LAUNCH, 700.0, 730.0), (SYNC, 800.0, 900.0),
    ("aten::copy_", 650.0, 690.0),
    (STEP, 1050.0, 1200.0), (LAUNCH, 1090.0, 1120.0),
]


def test_self_time_less_the_named_descendants():
    p = profile(HOST)
    got = spans.window_spans(p)
    assert [s for s in got if s[0] == STEP] == [(STEP, 200.0, 600.0),
                                                (STEP, 600.0, 1000.0)]
    # 400 us less the capture (80) and the launch (50)
    assert spans.self_ms((STEP, 200.0, 600.0), got) == pytest.approx(0.27)
    # 400 us less the launch (30) and the sync (100)
    assert spans.self_ms((STEP, 600.0, 1000.0), got) == pytest.approx(0.27)
    # overlapping named descendants count once
    nested = got + [(SYNC, 410.0, 460.0)]
    assert spans.self_ms((STEP, 200.0, 600.0), nested) == pytest.approx(0.26)
    assert spans.step_host_ms(bench(p)) == pytest.approx(0.27)
    assert spans.launch_ms(bench(p)) == pytest.approx(0.04)


def test_spans_crossing_the_window_are_dropped():
    p = profile(HOST, window=(250.0, 1100.0))
    names = [s[0] for s in spans.window_spans(p)]
    assert names.count(STEP) == 1 and names.count(LAUNCH) == 2
    assert DRAW in names and "aten::copy_" not in names


@pytest.mark.parametrize("name", ["trainer_host_ms.train",
                                  "trainer_host_ms.train_sparse",
                                  "graph_launch_ms.train_sparse"])
def test_readers_return_none_without_program_spans(name):
    read = run.reader(name).read
    assert read(bench(profile([("aten::copy_", 150.0, 190.0)]))) is None
    assert read(bench(None)) is None
    assert read(bench(profile(HOST))) == pytest.approx(
        0.04 if name.startswith("graph") else 0.27)


def test_idle_gaps_are_named_by_the_innermost_span():
    # the device idles in [250, 300) (inside a draw), [460, 700) (the
    # step's tail, after its launch) and [800, 900) (the log's sync)
    device = [("k", 90.0, 250.0), ("k", 300.0, 460.0), ("k", 700.0, 800.0),
              ("k", 900.0, 1100.0)]
    p = profile(HOST, device=device, window=(100.0, 1100.0))
    gaps = dict((round(s * 1e6), n) for n, s in p.idle_gaps())
    assert gaps == {50: DRAW, 240: STEP, 100: SYNC}
    shares = spans.idle_by_span(p)
    assert shares == pytest.approx({STEP: 240 / 390, SYNC: 100 / 390,
                                    DRAW: 50 / 390})
    outside = profile(HOST, device=[("k", 100.0, 150.0)],
                      window=(100.0, 200.0))
    assert spans.idle_by_span(outside) == {spans.OUTSIDE: 1.0}
    assert spans.idle_by_span(None) == {}
