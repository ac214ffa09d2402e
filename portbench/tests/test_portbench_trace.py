"""The trace's readings clip every device activity to the window."""

import pytest

from portbench.trace import Profile


def profile(device, window=(100.0, 200.0)):
    p = Profile(False)
    p.device, p.window = device, window
    p.host = [("aten::copy_", 150.0, 190.0)]
    return p


def test_busy_union_and_clipping():
    p = profile([("k1", 90.0, 120.0), ("k2", 110.0, 130.0),
                 ("k1", 150.0, 160.0), ("k3", 195.0, 260.0),
                 ("k1", 10.0, 50.0)])
    assert p.busy_s() == pytest.approx(45e-6)
    assert p.kernel_seconds(["k1"]) == pytest.approx(30e-6)
    assert p.top_ops()[0] == ["k1", pytest.approx(30e-6)]
    gaps = p.idle_gaps()
    assert gaps[0] == ["aten::copy_", pytest.approx(35e-6)]
    assert p.window_s == pytest.approx(100e-6)
