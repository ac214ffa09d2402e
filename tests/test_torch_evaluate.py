"""The evaluation path of the port against ``gossipnet_tpu.evaluate`` on the
CPU: rescored scores per image, the COCO stats of the model and of the two
baselines, the exported results JSON, the trainer's periodic evaluation
and the eval CLI.

Both models run the dense pair path in IEEE f32 from the same parameters
(carried across by ``params_from_jax``), so the rescored scores agree to
1e-5 (summation order); the baselines rank raw scores with identical numpy
code and must agree exactly.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from gossipnet_tpu import config as j_config
from gossipnet_tpu import evaluate as j_eval
from gossipnet_tpu.data.synthetic import synthetic_roidb as j_roidb
from gossipnet_tpu.models.gossipnet import GossipNet as JGossipNet
from gossipnet_tpu_torch import config as t_config
from gossipnet_tpu_torch import evaluate as t_eval
from gossipnet_tpu_torch import native
from gossipnet_tpu_torch import train as t_train
from gossipnet_tpu_torch.data.synthetic import synthetic_roidb
from gossipnet_tpu_torch.params import params_from_jax
from gossipnet_tpu_torch.utils.checkpoint import CheckpointManager

BUCKETS = (64, 128)
MODEL = {"num_blocks": 2, "feature_dim": 32, "reduced_dim": 16,
         "pairwise_dim": 16, "pair_matmul_dtype": "float32"}


def _overrides(num_classes=1, **train):
    model = dict(MODEL, num_classes=num_classes)
    if num_classes > 1:
        model["class_embed_dim"] = 8
    return {"model": model, "data": {"bucket_sizes": list(BUCKETS)},
            "parallel": {"enable": "off"},
            "train": {"batch_size": 3, "log_every": 1, "snapshot_every": 0,
                      "eval_every": 0, **train}}


@pytest.fixture(scope="module", params=[1, 80], ids=["persons", "classes80"])
def setup(request):
    """A 2-block model with the same random parameters on both sides, and
    the 8-image synthetic set of each package (same seed)."""
    nc = request.param
    ov = _overrides(nc)
    jc, tc = j_config.load_config(None, ov), t_config.load_config(None, ov)
    jdb = j_roidb(num_images=8, seed=123, num_classes=nc)
    tdb = synthetic_roidb(num_images=8, seed=123, num_classes=nc)
    jmodel = JGossipNet(jc.model, pool_impl="dense")
    n = BUCKETS[0]
    jparams = jmodel.init(
        jax.random.key(5), jnp.zeros((1, n, 4)), jnp.zeros((1, n)),
        jnp.ones((1, n), bool),
        jnp.zeros((1, n), jnp.int32) if nc > 1 else None)["params"]
    # biases away from zero, so that every path is live
    rng = np.random.default_rng(7)
    jparams = jax.tree.map(
        lambda x: x + jnp.asarray(rng.normal(0, 0.05, x.shape), x.dtype),
        jparams)
    model = t_train.build_model(tc, "dense", "cpu")
    model.load_state_dict(params_from_jax(jparams))
    return dict(jc=jc, tc=tc, jdb=jdb, tdb=tdb, jmodel=jmodel,
                jparams=jparams, model=model)


def test_synthetic_sets_are_the_same(setup):
    assert len(setup["tdb"]) == len(setup["jdb"]) == 8
    for a, b in zip(setup["tdb"], setup["jdb"]):
        assert a.image_id == b.image_id
        for f in ("det_boxes", "det_scores", "det_classes", "gt_boxes",
                  "gt_classes", "gt_crowd"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_rescore_roidb_matches_jax_per_image(setup):
    want = j_eval.rescore_roidb(setup["jparams"], setup["jmodel"],
                                setup["jdb"], 3, BUCKETS)
    got = t_eval.rescore_roidb(None, setup["model"], setup["tdb"], 3, BUCKETS)
    assert sorted(got) == sorted(want) == [r.image_id for r in setup["tdb"]]
    for img_id, rec in zip(sorted(got), setup["tdb"]):
        assert got[img_id].shape == (rec.num_dets,)
        np.testing.assert_allclose(got[img_id], np.asarray(want[img_id]),
                                   rtol=1e-5, atol=1e-5)


def test_rescore_roidb_loads_given_params_and_takes_a_forward_fn(setup):
    fresh = t_train.build_model(setup["tc"], "dense", "cpu")
    fresh.load_state_dict(params_from_jax(
        jax.tree.map(jnp.zeros_like, setup["jparams"])))
    want = t_eval.rescore_roidb(None, setup["model"], setup["tdb"], 3, BUCKETS)
    got = t_eval.rescore_roidb(setup["jparams"], fresh, setup["tdb"], 3,
                               BUCKETS)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    halves = t_eval.rescore_roidb(
        None, None, setup["tdb"], 3, BUCKETS,
        forward_fn=lambda boxes, scores, valid, classes: scores * 0.5)
    for rec in setup["tdb"]:
        np.testing.assert_array_equal(halves[rec.image_id],
                                      rec.det_scores * 0.5)


def test_evaluate_model_matches_jax(setup):
    """The model's COCO stats: the scores differ by summation order
    (1e-5), so a swap of two near-equal scores could move AP by one
    detection's worth; on this set they agree to 1e-6."""
    want = j_eval.evaluate_model(setup["jparams"], setup["jmodel"],
                                 setup["jdb"], 3, BUCKETS)
    got = t_eval.evaluate_model(None, setup["model"], setup["tdb"], 3,
                                BUCKETS)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert 0.0 < got["AP"] <= 1.0


def test_baselines_match_jax_exactly(setup):
    assert t_eval.evaluate_raw_scores(setup["tdb"]) == \
        j_eval.evaluate_raw_scores(setup["jdb"])
    thr = [0.3, 0.5, 0.7]
    want = j_eval.evaluate_greedy_nms_sweep(setup["jdb"], thr)
    got = t_eval.evaluate_greedy_nms_sweep(setup["tdb"], thr)
    assert got == want and [t for t, _ in got] == thr
    assert t_eval.evaluate_greedy_nms(setup["tdb"], 0.5) == want[1][1]


def test_baselines_do_not_depend_on_the_native_library(setup, monkeypatch):
    thr = [0.4, 0.6]
    with_lib = (t_eval.evaluate_raw_scores(setup["tdb"]),
                t_eval.evaluate_greedy_nms_sweep(setup["tdb"], thr))
    monkeypatch.setattr(native, "available", lambda: False)
    assert (t_eval.evaluate_raw_scores(setup["tdb"]),
            t_eval.evaluate_greedy_nms_sweep(setup["tdb"], thr)) == with_lib


def test_export_coco_results_writes_the_same_json(setup, tmp_path):
    scores = {r.image_id: r.det_scores * 0.5 for r in setup["tdb"]}
    n_j = j_eval.export_coco_results(setup["jdb"], scores,
                                     str(tmp_path / "j.json"), 0.2)
    n_t = t_eval.export_coco_results(setup["tdb"], scores,
                                     str(tmp_path / "t.json"), 0.2)
    assert n_t == n_j > 0
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())


def _write_config(tmp_path, ckpt_dir, **train):
    ov = _overrides(checkpoint_dir=str(ckpt_dir), learning_rate=3e-3, **train)
    ov["data"]["dataset"] = "synthetic"
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(ov))
    return path


def test_training_evaluates_and_the_cli_reads_the_best_checkpoint(
        tmp_path, capsys):
    ckpt_dir = tmp_path / "ckpt"
    cfg_file = _write_config(tmp_path, ckpt_dir, eval_every=2)
    cfg = t_config.load_config(str(cfg_file))
    roidb = synthetic_roidb(num_images=6, seed=0)
    val = synthetic_roidb(num_images=4, seed=1)
    metrics = tmp_path / "m.jsonl"
    state = t_train.train(cfg, roidb, val_roidb=val, pool_impl="dense",
                          metrics_path=str(metrics), max_steps=4,
                          device="cpu")
    recs = [json.loads(x) for x in metrics.read_text().splitlines()]
    evals = [r for r in recs if "val_AP" in r]
    assert [r["step"] for r in evals] == [2, 4]
    for r in evals:
        assert {"val_AP", "val_AP50", "val_AP75"} <= set(r)
    # the evaluation at step 4 is the model's own: same stats again
    again = t_eval.evaluate_model(None, state.model, val, 3, BUCKETS)
    assert again["AP"] == evals[-1]["val_AP"]
    best = json.loads((ckpt_dir / "best.json").read_text())["metric"]
    assert best == max(r["val_AP"] for r in evals)
    assert CheckpointManager(ckpt_dir).has_best()

    capsys.readouterr()
    out = t_eval.main(["-c", str(cfg_file), "--best", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "restored best-AP checkpoint (step" in text
    printed = json.loads(text[text.index("{"):])
    assert printed == out
    assert set(out) == {"gossipnet", "raw_scores", "greedy_nms"}
    assert out["greedy_nms"]["iou_threshold"] == 0.5
    for stats in out.values():
        assert 0.0 <= stats["AP"] <= 1.0

    latest = t_eval.main(["-c", str(cfg_file), "--device", "cpu",
                          "--nms-sweep"])
    text = capsys.readouterr().out
    assert "restored step 4" in text
    assert latest["raw_scores"] == out["raw_scores"]
    assert 0.3 <= latest["greedy_nms"]["iou_threshold"] <= 0.7


def test_cli_refusals_and_random_init(tmp_path, capsys):
    cfg_file = _write_config(tmp_path, tmp_path / "empty")
    with pytest.raises(SystemExit, match="--best: no best checkpoint"):
        t_eval.main(["-c", str(cfg_file), "--best", "--device", "cpu"])
    # an artifact of the JAX package (compiled programs, no weights file)
    jax_art = tmp_path / "x.gnetart"
    with zipfile.ZipFile(jax_art, "w") as z:
        z.writestr("meta.json", json.dumps(
            {"format_version": 1, "platforms": ["tpu"], "shapes": [[1, 64]],
             "config": {}}))
        z.writestr("blobs/1x64.jaxexp", b"")
    with pytest.raises(ValueError, match="JAX/TPU artifact"):
        t_eval.main(["-c", str(cfg_file), "--artifact", str(jax_art),
                     "--device", "cpu"])
    capsys.readouterr()
    out = t_eval.main(["-c", str(cfg_file), "--random-init", "--device",
                       "cpu"])
    assert "--random-init" in capsys.readouterr().out
    assert np.isfinite(out["gossipnet"]["AP"])
    # a device mesh is no longer refused: `on` with the default axes
    # evaluates on a 1 x 1 mesh (a world of one here), the same stats
    ov = yaml.safe_load(cfg_file.read_text())
    ov["parallel"]["enable"] = "on"
    mesh_file = tmp_path / "mesh.yaml"
    mesh_file.write_text(yaml.safe_dump(ov))
    try:
        on_mesh = t_eval.main(["-c", str(mesh_file), "--random-init",
                               "--device", "cpu"])
    finally:
        torch.distributed.destroy_process_group()
    assert "evaluating on mesh {'data': 1, 'det': 1}" in \
        capsys.readouterr().out
    for k, v in out["gossipnet"].items():
        np.testing.assert_allclose(on_mesh["gossipnet"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    t_eval.main(["-c", str(cfg_file), "--device", "cpu"])
    assert "WARNING: no checkpoint" in capsys.readouterr().out


def test_cli_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg_file = _write_config(tmp_path, tmp_path / "none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_eval.main(["-c", str(cfg_file), "--random-init"])
