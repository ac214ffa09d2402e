"""The host data and evaluation modules of the port against the JAX
package's, array for array: ``eval_batches``, the COCO and PETS loaders (on
the handcrafted fixtures of ``tests/test_roidb_loaders.py`` and
``tests/test_pets_loader.py``), ``crowd_roidb``, the COCO evaluator on
random images by both of its routes (C++ and numpy), and the port's own
copy of the native binding.

All of it is numpy code that the port copies unchanged, so every
comparison is exact.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest

from gossipnet_tpu.data import bucketing as j_bucketing
from gossipnet_tpu.data import pets as j_pets
from gossipnet_tpu.data import roidb as j_roidb
from gossipnet_tpu.data import synthetic as j_synthetic
from gossipnet_tpu.eval import cocoeval as j_cocoeval
from gossipnet_tpu_torch import native
from gossipnet_tpu_torch.data import bucketing as t_bucketing
from gossipnet_tpu_torch.data import pets as t_pets
from gossipnet_tpu_torch.data import roidb as t_roidb
from gossipnet_tpu_torch.data import synthetic as t_synthetic
from gossipnet_tpu_torch.eval import cocoeval as t_cocoeval
from tests.test_pets_loader import CVML_DETS, CVML_GT, MOT_DETS
from tests.test_roidb_loaders import _write_fixture

RECORD_FIELDS = ("det_boxes", "det_scores", "det_classes", "gt_boxes",
                 "gt_classes", "gt_crowd")
BATCH_FIELDS = ("boxes", "scores", "valid", "classes", "gt_boxes",
                "gt_valid", "gt_classes", "gt_crowd", "image_ids")


def assert_same_roidb(got, want):
    assert len(got) == len(want)
    assert got.class_names == want.class_names
    assert got.cat_ids == want.cat_ids
    assert got.num_classes == want.num_classes
    for a, b in zip(got.records, want.records):
        assert a.image_id == b.image_id
        for f in RECORD_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def assert_same_batch(got, want):
    for f in BATCH_FIELDS:
        x, y = getattr(got, f, None), getattr(want, f, None)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


# ---------------------------------------------------------------------------
# eval_batches, crowd_roidb
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_size", [1, 3, 8])
@pytest.mark.parametrize("num_classes", [1, 80])
def test_eval_batches_match(batch_size, num_classes):
    """One deterministic pass, buckets ascending, the tail batch padded by
    repeating images: the same batches in the same order."""
    kw = dict(num_images=7, seed=11, num_classes=num_classes)
    jdb = j_synthetic.synthetic_roidb(**kw)
    tdb = t_synthetic.synthetic_roidb(**kw)
    buckets = (32, 64, 128)
    want = list(j_bucketing.eval_batches(jdb, batch_size, buckets))
    got = list(t_bucketing.eval_batches(tdb, batch_size, buckets))
    assert len(got) == len(want) > 0
    seen = set()
    for a, b in zip(got, want):
        assert_same_batch(a, b)
        assert len(a.image_ids) == batch_size
        seen.update(int(i) for i in a.image_ids)
    assert seen == {r.image_id for r in tdb.records}


@pytest.mark.parametrize("kwargs", [
    {}, {"num_people": 12, "dets_per_person": 4, "occlusion": 0.4},
], ids=["default", "sparser"])
def test_crowd_roidb_matches(kwargs):
    want = j_synthetic.crowd_roidb(num_images=3, seed=5, **kwargs)
    got = t_synthetic.crowd_roidb(num_images=3, seed=5, **kwargs)
    assert_same_roidb(got, want)
    rec = got.records[0]
    assert rec.num_dets == len(rec.gt_boxes) * kwargs.get(
        "dets_per_person", 8)


# ---------------------------------------------------------------------------
# COCO loaders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [
    {"person_only": True}, {"person_only": False},
    {"person_only": True, "max_dets": 2},
    {"person_only": True, "skip_empty": True},
], ids=["persons", "all_classes", "capped", "skip_empty"])
def test_build_roidb_matches_on_the_coco_fixture(tmp_path, kwargs):
    ann, det = _write_fixture(tmp_path)
    want = j_roidb.build_roidb(ann, det, **kwargs)
    got = t_roidb.build_roidb(ann, det, **kwargs)
    assert_same_roidb(got, want)
    if kwargs == {"person_only": True}:
        by_id = {r.image_id: r for r in got.records}
        assert set(by_id) == {1, 3} and by_id[1].num_dets == 3
        np.testing.assert_allclose(by_id[1].det_boxes[0], [11, 12, 49, 90])
        assert by_id[1].gt_crowd.tolist() == [False, False, True]


def test_coco_loader_parts_match_on_the_fixture(tmp_path):
    import json

    ann, det = _write_fixture(tmp_path)
    coco = json.loads(open(ann).read())
    for person_only in (True, False):
        ids = t_roidb.coco_cat_ids(coco, person_only)
        assert ids == j_roidb.coco_cat_ids(coco, person_only)
        want_gt = j_roidb.load_coco_gt(ann, person_only=person_only)
        got_gt = t_roidb.load_coco_gt(ann, person_only=person_only)
        _assert_same_tree(got_gt, want_gt)
        _assert_same_tree(t_roidb.load_detections(det, ids),
                          j_roidb.load_detections(det, ids))


def test_detections_load_from_npz_as_from_json(tmp_path):
    ann, det = _write_fixture(tmp_path)
    path = tmp_path / "dets.npz"
    np.savez(path, image_ids=np.array([1, 1, 3]),
             boxes=np.array([[11, 12, 49, 90], [99, 22, 143, 110],
                             [1, 1, 21, 21]], np.float32),
             scores=np.array([0.9, 0.8, 0.5], np.float32),
             classes=np.zeros(3, np.int32))
    want = j_roidb.build_roidb(ann, str(path))
    got = t_roidb.build_roidb(ann, str(path))
    assert_same_roidb(got, want)


def _assert_same_tree(got, want):
    """Nested tuples, lists and dicts of arrays and scalars, exactly."""
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert sorted(got, key=repr) == sorted(want, key=repr)
        for k in want:
            _assert_same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same_tree(a, b)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


# ---------------------------------------------------------------------------
# PETS loaders
# ---------------------------------------------------------------------------


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def test_pets_file_readers_match(tmp_path):
    gt = _write(tmp_path, "gt.xml", CVML_GT)
    mot = _write(tmp_path, "dets.csv", MOT_DETS)
    cvml = _write(tmp_path, "d.xml", CVML_DETS)
    _assert_same_tree(t_pets.load_cvml(gt), j_pets.load_cvml(gt))
    _assert_same_tree(t_pets.load_mot_csv(mot), j_pets.load_mot_csv(mot))
    for path in (mot, cvml):
        _assert_same_tree(t_pets.load_pets_detections(path),
                          j_pets.load_pets_detections(path))
    frames = t_pets.load_cvml(gt)
    np.testing.assert_allclose(frames[0]["boxes"][0], [40., 40., 60., 80.])


@pytest.mark.parametrize("dets,kwargs", [
    ("mot", {}), ("mot", {"frame_offset": 0}), ("mot", {"max_dets": 2}),
    ("cvml", {}),
], ids=["mot_realigned", "mot_verbatim", "mot_capped", "cvml"])
def test_build_pets_roidb_matches(tmp_path, dets, kwargs):
    gt = _write(tmp_path, "gt.xml", CVML_GT)
    det = (_write(tmp_path, "dets.csv", MOT_DETS) if dets == "mot"
           else _write(tmp_path, "d.xml", CVML_DETS))
    want = j_pets.build_pets_roidb(gt, det, **kwargs)
    got = t_pets.build_pets_roidb(gt, det, **kwargs)
    assert_same_roidb(got, want)
    if dets == "mot" and not kwargs:
        # 1-based MOT frames met the 0-based GT frames
        by_id = {r.image_id: r for r in got.records}
        assert by_id[0].num_dets == 3 and len(by_id[0].gt_boxes) == 2


def test_build_pets_roidb_warns_when_it_realigns(tmp_path):
    gt = _write(tmp_path, "gt.xml", CVML_GT)
    det = _write(tmp_path, "dets.csv",
                 "\n".join(MOT_DETS.strip().splitlines()[3:]))
    with pytest.warns(UserWarning, match="realigned by -1"):
        got = t_pets.build_pets_roidb(gt, det)
    with pytest.warns(UserWarning, match="realigned by -1"):
        want = j_pets.build_pets_roidb(gt, det)
    assert_same_roidb(got, want)


@pytest.mark.parametrize("arm", ["dense4k", "pets", "dense"])
def test_drill_arm_files_load_and_batch_as_the_jax_packages(tmp_path, arm):
    """Small files of the scale drill's dense4k, pets and (persons) dense
    generators, read by each package's loader with the arm's cap (dense4k:
    4,096 per image; pets and dense: 1,024, pets' MOT frames realigned),
    and the first padded batch of each training stream at the arm's
    buckets and batch ([1024, 2048, 4096] at 2; [256, 512, 1024] at 8):
    the same records and the same batch."""
    from gossipnet_tpu_torch.tools import scale_drill as sd

    if arm != "pets":
        dense4k = arm == "dense4k"
        sd.gen(n_images=3, prefix="d_", data_dir=tmp_path,
               **(sd.DENSE_4K if dense4k else sd.DENSE_P))
        files = (str(tmp_path / "d_annotations.json"),
                 str(tmp_path / "d_detections.json"))
        cap = 4096 if dense4k else 1024
        got = t_roidb.build_roidb(*files, person_only=True, max_dets=cap)
        want = j_roidb.build_roidb(*files, person_only=True, max_dets=cap)
        batch, buckets = ((2, (1024, 2048, 4096)) if dense4k
                          else (8, (256, 512, 1024)))
    else:
        sd.gen_pets(n_frames=6, data_dir=tmp_path)
        files = (str(tmp_path / "pets_gt.xml"),
                 str(tmp_path / "pets_dets.csv"))
        with pytest.warns(UserWarning, match="realigned by -1"):
            got = t_pets.build_pets_roidb(*files, max_dets=1024)
        with pytest.warns(UserWarning, match="realigned by -1"):
            want = j_pets.build_pets_roidb(*files, max_dets=1024)
        batch, buckets = 8, (256, 512, 1024)
    assert_same_roidb(got, want)
    first = next(t_bucketing.BatchIterator(got, batch, buckets, seed=0))
    assert_same_batch(first, next(j_bucketing.BatchIterator(
        want, batch, buckets, seed=0)))
    if arm == "dense4k":
        assert max(r.num_dets for r in got) > 2048 and first.padded_n >= 2048
        assert first.gt_boxes.shape[1] >= 120


# ---------------------------------------------------------------------------
# COCO evaluator
# ---------------------------------------------------------------------------


def _random_images(seed, num_images, num_classes, quantize):
    """Random detections and GT per image; on a coarse grid with coarse
    scores when ``quantize`` (exact IoU ties and score ties)."""
    rng = np.random.default_rng(seed)
    out = []
    for image_id in range(num_images):
        n, g = int(rng.integers(0, 40)), int(rng.integers(0, 12))
        if quantize:
            xy = rng.integers(0, 6, (n, 2)) * 16.0
            wh = rng.integers(1, 4, (n, 2)) * 16.0
            gxy = rng.integers(0, 6, (g, 2)) * 16.0
            gwh = rng.integers(1, 4, (g, 2)) * 16.0
            scores = rng.integers(1, 5, n) / 4.0
        else:
            xy, wh = rng.uniform(0, 100, (n, 2)), rng.uniform(2, 120, (n, 2))
            gxy, gwh = rng.uniform(0, 100, (g, 2)), rng.uniform(2, 120, (g, 2))
            scores = rng.uniform(0, 1, n)
        out.append((image_id, np.concatenate([xy, xy + wh], 1), scores,
                    rng.integers(0, num_classes, n),
                    np.concatenate([gxy, gxy + gwh], 1),
                    rng.integers(0, num_classes, g),
                    rng.uniform(size=g) < 0.25))
    return out


@pytest.mark.parametrize("force_numpy", [False, True],
                         ids=["native_route", "numpy_route"])
@pytest.mark.parametrize("num_classes,quantize",
                         [(1, False), (1, True), (3, False), (3, True)])
def test_coco_evaluator_matches(num_classes, quantize, force_numpy):
    """Both evaluators take the same route (C++ when the library loads and
    ``force_numpy`` is off, numpy otherwise) and must give the same stats
    and per-class AP exactly; the port's two routes agree with each other
    as well."""
    images = _random_images(num_classes * 2 + quantize, 30, num_classes,
                            quantize)
    want = j_cocoeval.COCOEvaluator(num_classes=num_classes,
                                    force_numpy=force_numpy)
    got = t_cocoeval.COCOEvaluator(num_classes=num_classes,
                                   force_numpy=force_numpy)
    other = t_cocoeval.COCOEvaluator(num_classes=num_classes,
                                     force_numpy=not force_numpy)
    for img in images:
        for ev in (want, got, other):
            ev.add_arrays(*img)
    stats = got.summarize()
    assert stats == want.summarize()
    assert stats == other.summarize()
    assert set(stats) >= {"AP", "AP50", "AP75"}
    np.testing.assert_array_equal(got.per_class_ap(), want.per_class_ap())
    assert 0.0 <= stats["AP"] <= 1.0


def test_match_image_np_matches():
    rng = np.random.default_rng(3)
    for _ in range(20):
        n, g = int(rng.integers(0, 30)), int(rng.integers(0, 10))
        # quantized IoUs (exact ties), GTs with the ignored ones last
        ious = rng.integers(0, 11, (n, g)) / 10.0
        ignore = np.sort(rng.uniform(size=g) < 0.4)
        crowd = ignore & (rng.uniform(size=g) < 0.5)
        got = t_cocoeval.match_image_np(ious, crowd, ignore)
        want = j_cocoeval.match_image_np(ious, crowd, ignore)
        _assert_same_tree(tuple(got), tuple(want))
        assert got[0].shape == (len(t_cocoeval.IOU_THRS), n)


# ---------------------------------------------------------------------------
# the native binding
# ---------------------------------------------------------------------------


def test_native_binding_agrees_with_the_jax_packages(monkeypatch):
    """The port's own ctypes binding gives the results of the JAX
    package's where the library loads (where it does not, the callers ask
    ``available()`` and take numpy). Both bindings probe afresh here: the library
    is a build product that another test may make while this one runs."""
    from gossipnet_tpu import native as j_native

    for mod in (native, j_native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_load_failed", False)
    rng = np.random.default_rng(0)
    xy, wh = rng.uniform(0, 100, (40, 2)), rng.uniform(5, 60, (40, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.uniform(0, 1, 40).astype(np.float32)
    thr = np.array([0.3, 0.5, 0.7])
    if not (native.available() and j_native.available()):
        assert native._find_lib() is None or not native.available()
        return               # the callers take their numpy routes
    assert native._find_lib() == j_native._find_lib()
    got = native.greedy_nms_multi(boxes, scores, thr)
    want = j_native.greedy_nms_multi(boxes, scores, thr)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # the single-threshold entry is not bound in the port: one threshold
    # through the multi entry gives its keep set
    np.testing.assert_array_equal(
        native.greedy_nms_multi(boxes, scores, np.array([0.5]))[0],
        j_native.greedy_nms(boxes, scores, 0.5))


def _fresh_native(monkeypatch, path):
    """The port's binding with its load cache cleared and
    ``GOSSIP_NATIVE_LIB`` set to ``path``."""
    monkeypatch.setenv("GOSSIP_NATIVE_LIB", str(path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    return native


def test_an_explicit_library_that_is_missing_raises(tmp_path, monkeypatch):
    """``GOSSIP_NATIVE_LIB`` names a file: when it is not there or does not
    load, the port raises instead of quietly trying the default places."""
    mod = _fresh_native(monkeypatch, tmp_path / "nowhere.so")
    with pytest.raises(FileNotFoundError, match="GOSSIP_NATIVE_LIB"):
        mod._load()
    bad = tmp_path / "bad.so"
    bad.write_bytes(b"not a shared object")
    mod = _fresh_native(monkeypatch, bad)
    with pytest.raises(OSError):
        mod._load()
