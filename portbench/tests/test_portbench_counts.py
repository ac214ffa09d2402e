"""The work counts, against cases worked by hand, and their independence
of padding and of any tile."""

import itertools

import numpy as np
import pytest

from portbench import counts
from portbench.metrics import layer


def brute_pairs(boxes, thr=0.2):
    n = 0
    for a, b in itertools.product(boxes, repeat=2):
        w = lambda x: max(x[2] - x[0], 1e-3)
        h = lambda x: max(x[3] - x[1], 1e-3)
        ix = max(min(a[2], b[2]) - max(a[0], b[0]), 0.0)
        iy = max(min(a[3], b[3]) - max(a[1], b[1]), 0.0)
        inter = ix * iy
        union = w(a) * h(a) + w(b) * h(b) - inter
        n += inter / max(union, 1e-6) >= thr
    return n


def test_pairs_by_hand():
    square = [0, 0, 10, 10]
    assert counts.neighbour_pairs(np.array([square])) == 1
    assert counts.neighbour_pairs(np.array([square, square])) == 4
    # IoU of [0,0,10,10] and [5,0,15,10] is 50/150: neighbours
    assert counts.neighbour_pairs(np.array([square, [5, 0, 15, 10]])) == 4
    # IoU 10/190 < 0.2: each only its own neighbour
    assert counts.neighbour_pairs(np.array([square, [9, 0, 19, 10]])) == 2
    assert counts.neighbour_pairs(np.zeros((0, 4))) == 0


def test_pairs_against_brute_force_and_chunks():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 100, (60, 2))
    wh = rng.uniform(5, 40, (60, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    want = brute_pairs(boxes.astype(np.float64).tolist())
    assert counts.neighbour_pairs(boxes, chunk=7) == want
    assert counts.neighbour_pairs(boxes, chunk=512) == want


def test_operations_by_hand():
    # FC2 2*32*32, FC1 over three features 2*3*32, two adds, bias, max
    assert counts.pair_flops(32) == 2048 + 192 + 64 + 32 + 32
    model = {"num_blocks": 2, "feature_dim": 4, "reduced_dim": 2,
             "pairwise_dim": 2}
    # reduce 4->2, a 2->2 (+bias), expand 2->2, out 2->4, b 2->2, fold 10
    # features, residual 4
    per_det = (16 + 2) + (8 + 2) + (8 + 2) + (16 + 4) + 8 + 40 + 4
    assert counts.detection_flops(model) == per_det
    pair = 2 * 4 + 2 * 3 * 2 + 4 * 2
    head = 2 * 2 * 4 + 4 + 2 * 4 + 1
    want = 2 * (5 * pair + 3 * per_det) + 3 * head
    assert counts.forward_flops(model, 3, 5) == want


def test_least_time_is_the_larger_bound():
    flops = counts.PEAKS["bf16_flops"]
    assert counts.least_seconds(flops, 0) == 1.0
    assert counts.least_seconds(0, counts.PEAKS["hbm_bytes_per_s"] * 2) == 2.0


class FakeProfile:
    window = (0.0, 2e6)
    window_s = 2.0

    def __init__(self, seconds):
        self.seconds = seconds

    def kernel_seconds(self, patterns):
        assert "pair_pool2_fwd_kernel" in patterns
        return self.seconds


class FakeBench:
    def __init__(self, layer_inputs, seconds=1e-3):
        self.layer = layer_inputs
        self.profile = FakeProfile(seconds)


@pytest.mark.parametrize("padded", [1024, 4096])
def test_roofline_reads_the_work_only(padded):
    """The share depends on the valid detections and their pairs; a padded
    size or a skip tile does not enter it."""
    model = {"num_blocks": 16, "feature_dim": 128, "reduced_dim": 32,
             "pairwise_dim": 32}
    work = {"model": model, "pairs": 24000, "dets": 700, "launches": 16,
            "padded_n": padded, "tile": (32, 16)}
    share = layer.pair_roofline(FakeBench(work), "pair_fwd")
    least = counts.least_seconds(
        24000 * 16 * counts.pair_flops(32),
        counts.pair_forward_bytes(32, 700 * 16, 16))
    assert share == pytest.approx(100 * least / 1e-3)
    no_pairs = FakeBench({**work, "pairs": 0})
    assert layer.pair_roofline(no_pairs, "pair_fwd") is None
    assert layer.pair_roofline(FakeBench(work, 0.0), "pair_fwd") is None
