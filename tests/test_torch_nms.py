"""GreedyNMS of the port against ``gossipnet_tpu.ops.nms``: the three host
functions (numpy, float64: the same code, so the same keep indices in the
same order) and the torch ``greedy_nms`` against the jitted one, on random,
clustered, tied, duplicated, empty and single-box inputs. Keep sets are
compared exactly.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipnet_tpu.ops import nms as j_nms
from gossipnet_tpu_torch import native
from gossipnet_tpu_torch.ops import nms as t_nms

THRESHOLDS = np.arange(0.3, 0.75, 0.05)


def _boxes(rng, n, canvas=300.0):
    xy = rng.uniform(0, canvas, (n, 2))
    wh = rng.uniform(10, 80, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _case(name):
    """(boxes [N, 4], scores [N]) float32, from a seed of its own."""
    rng = np.random.default_rng(len(name))
    if name == "random":
        return _boxes(rng, 120), rng.uniform(0, 1, 120).astype(np.float32)
    if name == "clustered":
        centers = _boxes(rng, 10)
        boxes = np.concatenate([
            centers + rng.normal(0, 2.0, centers.shape).astype(np.float32)
            for _ in range(12)])
        return boxes, rng.uniform(0, 1, len(boxes)).astype(np.float32)
    if name == "tied_scores":
        boxes = _boxes(rng, 60, canvas=120.0)
        return boxes, np.repeat(
            rng.uniform(0, 1, 6).astype(np.float32), 10)
    if name == "duplicates":
        boxes = np.repeat(_boxes(rng, 8, canvas=100.0), 5, axis=0)
        return boxes, rng.uniform(0, 1, len(boxes)).astype(np.float32)
    if name == "identical_boxes_tied_scores":
        return (np.repeat(np.array([[10, 10, 50, 50]], np.float32), 6, 0),
                np.full(6, 0.5, np.float32))
    if name == "single":
        return np.array([[3, 4, 30, 40]], np.float32), \
            np.array([0.7], np.float32)
    if name == "empty":
        return np.zeros((0, 4), np.float32), np.zeros(0, np.float32)
    raise KeyError(name)


CASES = ("random", "clustered", "tied_scores", "duplicates",
         "identical_boxes_tied_scores", "single", "empty")


@pytest.mark.parametrize("name", CASES)
def test_host_functions_match_the_jax_package(name):
    boxes, scores = _case(name)
    for t in (0.3, 0.5, 0.7):
        got = t_nms.greedy_nms_np(boxes, scores, t)
        want = j_nms.greedy_nms_np(boxes, scores, t)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got = t_nms.greedy_nms_multi_np(boxes, scores, THRESHOLDS)
    want = j_nms.greedy_nms_multi_np(boxes, scores, THRESHOLDS)
    host = t_nms.greedy_nms_host(boxes, scores, THRESHOLDS)
    j_host = j_nms.greedy_nms_host(boxes, scores, THRESHOLDS)
    assert len(got) == len(want) == len(host) == len(THRESHOLDS)
    for k, t in enumerate(THRESHOLDS):
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(host[k], j_host[k])
        # and the sweep is the per-threshold scan
        np.testing.assert_array_equal(
            got[k], t_nms.greedy_nms_np(boxes, scores, float(t)))
        np.testing.assert_array_equal(np.sort(host[k]), np.sort(got[k]))


@pytest.mark.parametrize("name", CASES)
def test_host_sweep_is_the_same_with_and_without_the_library(name,
                                                             monkeypatch):
    boxes, scores = _case(name)
    with_lib = t_nms.greedy_nms_host(boxes, scores, THRESHOLDS)
    monkeypatch.setattr(native, "available", lambda: False)
    without = t_nms.greedy_nms_host(boxes, scores, THRESHOLDS)
    for a, b in zip(with_lib, without):
        np.testing.assert_array_equal(np.sort(a), np.sort(b))


def test_host_entry_refuses_nonfinite_scores():
    boxes, scores = _case("random")
    scores = scores.copy()
    scores[3] = np.nan
    for mod in (t_nms, j_nms):
        with pytest.raises(ValueError):
            mod.greedy_nms_host(boxes, scores, THRESHOLDS)


def _pad(boxes, scores, n):
    """Pads to n detections with zero boxes marked invalid, the padding in
    the middle of nothing: valid first, as the batches are."""
    k = len(scores)
    b = np.zeros((n, 4), np.float32)
    s = np.zeros(n, np.float32)
    v = np.zeros(n, bool)
    b[:k], s[:k], v[:k] = boxes, scores, True
    return b, s, v


@pytest.mark.parametrize("name", CASES)
def test_torch_greedy_nms_matches_the_jax_function(name):
    boxes, scores = _case(name)
    n = max(8, len(scores) + 5)
    b, s, v = _pad(boxes, scores, n)
    for t in (0.3, 0.5, 0.7):
        got = t_nms.greedy_nms(torch.from_numpy(b), torch.from_numpy(s),
                               torch.from_numpy(v), t)
        want = np.asarray(j_nms.greedy_nms(
            jnp.asarray(b), jnp.asarray(s), jnp.asarray(v), t))
        assert got.dtype == torch.bool and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
        assert not got.numpy()[~v].any()         # padding is never kept
        # the keep set is the host scan's (f32 IoU on the device against
        # f64 on the host: these inputs sit away from the thresholds)
        if name not in ("tied_scores", "duplicates"):
            np.testing.assert_array_equal(
                np.where(got.numpy())[0],
                np.sort(t_nms.greedy_nms_np(boxes, scores, t)))


def test_torch_greedy_nms_keeps_one_of_identical_boxes():
    boxes, scores = _case("identical_boxes_tied_scores")
    b, s, v = _pad(boxes, scores, 8)
    keep = t_nms.greedy_nms(torch.from_numpy(b), torch.from_numpy(s),
                            torch.from_numpy(v), 0.5).numpy()
    assert keep.tolist() == [True] + [False] * 7     # the first index wins
