"""The frozen drill draw and the traffic generator."""

import numpy as np
import pytest

from portbench.traffic import drill, generate


def test_same_seed_same_images():
    a = drill.draw(2 ** 33 + 7, "s", "dense_p", 3, 1024)
    b = drill.draw(2 ** 33 + 7, "s", "dense_p", 3, 1024)
    c = drill.draw(2 ** 33 + 8, "s", "dense_p", 3, 1024)
    for x, y in zip(a, b):
        assert all(np.array_equal(u, v) for u, v in zip(x, y))
    assert not np.array_equal(a[0].boxes, c[0].boxes)


@pytest.mark.parametrize("preset,max_dets", [("full", 1024),
                                             ("dense_p", 1024),
                                             ("dense_4k", 4096)])
def test_draw_equals_the_drill_files(tmp_path, preset, max_dets):
    """The in-memory draw is the drill's ``gen`` with its person arms'
    loading: the same images, boxes and scores from the same generator."""
    from gossipnet_tpu_torch.data.roidb import build_roidb
    from gossipnet_tpu_torch.tools import scale_drill

    params = drill.PRESETS[preset]
    scale_drill.gen(n_images=3, seed=5, data_dir=tmp_path, **params)
    roidb = build_roidb(str(tmp_path / "annotations.json"),
                        str(tmp_path / "detections.json"), person_only=True,
                        max_dets=max_dets, skip_empty=False)
    rng = np.random.default_rng(5)
    for rec in roidb.records:
        im = drill.draw_image(rng, max_dets=max_dets, **params)
        np.testing.assert_array_equal(rec.det_boxes, im.boxes)
        np.testing.assert_array_equal(rec.det_scores, im.scores)
        np.testing.assert_array_equal(rec.gt_boxes, im.gt_boxes)
        np.testing.assert_array_equal(rec.gt_crowd, im.gt_crowd)


@pytest.mark.parametrize("preset,count,lo,hi", [("full", 64, 15, 35),
                                                ("dense_p", 16, 600, 820),
                                                ("dense_4k", 6, 2100, 2800)])
def test_preset_means_in_their_bands(preset, count, lo, hi):
    ims = drill.draw(11, "band", preset, count, 4096)
    assert lo <= np.mean([len(i.scores) for i in ims]) <= hi


def test_poisson_arrivals_rate_and_seed():
    mix = {"rate_per_s": 500.0}
    a = generate.poisson_arrivals(3, mix, 20.0)
    assert np.array_equal(a, generate.poisson_arrivals(3, mix, 20.0))
    assert abs(len(a) - 10000) < 400
    assert a.min() >= 0 and a.max() < 20.0 and np.all(np.diff(a) >= 0)


def test_requests_follow_the_mix():
    mix = {"mix": {"full": 0.7, "dense_p": 0.25, "dense_4k": 0.05},
           "pool": {"full": 10, "dense_p": 5, "dense_4k": 2}}
    picks = generate.requests(9, mix, 20000, "open")
    share = {k: sum(p == k for p, _ in picks) / len(picks) for k in mix["mix"]}
    for k, want in mix["mix"].items():
        assert abs(share[k] - want) < 0.02
    assert all(0 <= i < mix["pool"][p] for p, i in picks)
