"""The port's serving artifacts (``utils/model_artifact.py``) on the CPU.

An artifact holds the config and the weights (NPZ), not a compiled
program, so it must serve what the live Rescorer serves on the same
weights: within rtol = 1e-5, atol = 1e-6 of the port's live Rescorer (a
group pads to an exported batch, so rows meet another batch size) and
within atol = 1e-5 of JAX's Rescorer (two summation orders). Evaluating an
artifact exported at the evaluation's batch size gives the checkpoint's
COCO stats to 1e-6. Unknown shapes, a future format, a JAX artifact and a
reload are refused, as the reference refuses them.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import functools
import io
import json
import zipfile

import jax
import numpy as np
import pytest
import yaml

from gossipnet_tpu.api import Rescorer as JRescorer
from gossipnet_tpu.config import load_config as j_load_config
from gossipnet_tpu.train import build_model as j_build_model
from gossipnet_tpu.utils import export as j_export
from gossipnet_tpu.utils import model_artifact as j_ma
from gossipnet_tpu_torch import evaluate as t_eval
from gossipnet_tpu_torch import serving
from gossipnet_tpu_torch.api import Rescorer
from gossipnet_tpu_torch.config import load_config
from gossipnet_tpu_torch.data.synthetic import synthetic_record
from gossipnet_tpu_torch.train import build_model, create_train_state
from gossipnet_tpu_torch.utils import model_artifact as ma
from gossipnet_tpu_torch.utils.checkpoint import CheckpointManager

BUCKETS = [64, 128]


def _overrides(num_classes=1, **data):
    model = {"num_blocks": 2, "feature_dim": 16, "reduced_dim": 8,
             "pairwise_dim": 8, "pair_matmul_dtype": "float32",
             "num_classes": num_classes}
    if num_classes > 1:
        model["class_embed_dim"] = 8
    return {"model": model,
            "data": {"bucket_sizes": BUCKETS, "person_only": False, **data},
            "parallel": {"enable": "off"},
            "train": {"batch_size": 2}}


@functools.lru_cache(maxsize=None)
def _setup(num_classes=1):
    """(JAX config, port config, JAX params); the params are read only."""
    ov = _overrides(num_classes)
    jcfg, cfg = j_load_config(None, ov), load_config(None, ov)
    args = [np.zeros((1, 64, 4), np.float32), np.zeros((1, 64), np.float32),
            np.ones((1, 64), bool)]
    if num_classes > 1:
        args.append(np.zeros((1, 64), np.int32))
    params = jax.tree.map(np.asarray, j_build_model(jcfg, "dense").init(
        jax.random.key(0), *args)["params"])
    return jcfg, cfg, params


def _images(k, num_classes=1, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        rec = synthetic_record(rng, i, num_gt=4, dets_per_gt=3,
                               num_clutter=4, num_classes=num_classes)
        out.append((rec.det_boxes, rec.det_scores,
                    rec.det_classes if num_classes > 1 else None))
    return out


@pytest.mark.parametrize("num_classes", [1, 4], ids=["persons", "classes4"])
def test_artifact_matches_live_rescorer(tmp_path, num_classes):
    jcfg, cfg, params = _setup(num_classes)
    path = tmp_path / "m.gnetart"
    meta = ma.export_artifact(cfg, params, path, batch_sizes=(1, 2))
    assert meta["format_version"] == ma.FORMAT_VERSION
    assert meta["runtime"] == "torch" and meta["pool_impl"] == "kernel"
    assert sorted(tuple(s) for s in meta["shapes"]) == [
        (1, 64), (1, 128), (2, 64), (2, 128)]
    read = ma.read_artifact_meta(path)
    assert read["shapes"] == meta["shapes"] and read["runtime"] == "torch"
    art = ma.ArtifactRescorer(path, device="cpu")
    assert art.cfg == cfg
    art.warmup()
    images = _images(3, num_classes)
    got = art.rescore_batch(images, batch_size=2)
    live = Rescorer(cfg, params, pool_impl="kernel", device="cpu")
    for g, w in zip(got, live.rescore_batch(images, batch_size=2)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    ref = JRescorer(jcfg, params, pool_impl="dense", mesh=None)
    for g, w in zip(got, ref.rescore_batch(images, batch_size=2)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    bx, sc, cl = images[0]
    np.testing.assert_allclose(art(bx, sc, cl), live(bx, sc, cl),
                               rtol=1e-5, atol=1e-6)


def test_artifact_refuses_unknown_shapes(tmp_path):
    _, cfg, params = _setup()
    path = tmp_path / "m.gnetart"
    ma.export_artifact(cfg, params, path, batch_sizes=(2,))
    art = ma.ArtifactRescorer(path, device="cpu")
    assert art.exported_shapes() == [(2, 64), (2, 128)]
    assert art.max_batch_for(64) == 2 and art.max_batch_for(32) == 0
    with pytest.raises(KeyError, match="exports batches up to 2"):
        art.rescore_batch(_images(3), batch_size=3)
    with pytest.raises(KeyError, match=r"available: \[\(2, 64\)"):
        art.forward(np.zeros((3, 64, 4), np.float32),
                    np.zeros((3, 64), np.float32), np.zeros((3, 64), bool))
    # one-image groups pad up to the smallest exported batch
    out = art.rescore_batch(_images(1), batch_size=1)
    assert len(out) == 1 and np.isfinite(out[0]).all()


@pytest.mark.parametrize("kind", ["future_format", "jax_artifact"])
def test_artifact_refuses_what_it_cannot_read(tmp_path, kind):
    jcfg, cfg, params = _setup()
    path = tmp_path / "m.gnetart"
    if kind == "future_format":
        ma.export_artifact(cfg, params, tmp_path / "ok.gnetart",
                           batch_sizes=(1,))
        with zipfile.ZipFile(tmp_path / "ok.gnetart") as zin, \
                zipfile.ZipFile(path, "w") as zout:
            for item in zin.namelist():
                data = zin.read(item)
                if item == "meta.json":
                    meta = json.loads(data)
                    meta["format_version"] = ma.FORMAT_VERSION + 1
                    data = json.dumps(meta)
                zout.writestr(item, data)
        match = "format_version"
    else:
        j_ma.export_artifact(
            j_load_config(None, {**_overrides(),
                                 "data": {"bucket_sizes": [64]}}),
            params, path, batch_sizes=(1,), pool_impl="dense")
        match = "JAX/TPU artifact"
    with pytest.raises(ValueError, match=match):
        ma.ArtifactRescorer(path, device="cpu")


def test_artifact_refuses_reload(tmp_path):
    _, cfg, params = _setup()
    path = tmp_path / "m.gnetart"
    ma.export_artifact(cfg, params, path, batch_sizes=(1,))
    art = ma.ArtifactRescorer(path, device="cpu")
    with pytest.raises(ValueError, match="baked"):
        art.reload(params)
    with pytest.raises(ValueError, match="baked"):
        art.reload(checkpoint_dir=str(tmp_path))


def test_tcp_server_clamps_to_artifact_batches(tmp_path):
    """With a batch-2 artifact the server's default batch_size=8 clamps to
    2 and every bucket's cap to what the artifact exports."""
    import socket

    _, cfg, params = _setup()
    path = tmp_path / "m.gnetart"
    ma.export_artifact(cfg, params, path, batch_sizes=(1, 2))
    art = ma.ArtifactRescorer(path, device="cpu")
    server = serving.TcpServer(art, port=0, threshold=0.0)
    assert server.batch_size == 2
    assert server._batch_for == {64: 2, 128: 2}
    server.start()
    try:
        bx, sc, _ = _images(1)[0]
        with socket.create_connection(("127.0.0.1", server.port),
                                      timeout=30) as s:
            f = s.makefile("r")
            s.sendall((json.dumps({"id": 3, "boxes": bx.tolist(),
                                   "scores": sc.tolist()}) + "\n").encode())
            resp = json.loads(f.readline())
    finally:
        server.stop()
    assert resp["id"] == 3
    np.testing.assert_allclose(resp["new_scores"], art(bx, sc), rtol=0,
                               atol=1e-6)


def test_serving_layer_and_cli_on_an_artifact(tmp_path, capsys):
    """serve_stream over an ArtifactRescorer, and the serve CLI's file
    mode with --artifact (no config, no checkpoint)."""
    _, cfg, params = _setup()
    path = tmp_path / "m.gnetart"
    ma.export_artifact(cfg, params, path, batch_sizes=(1, 2))
    art = ma.ArtifactRescorer(path, device="cpu")
    bx, sc, _ = _images(1)[0]
    out = io.StringIO()
    n = serving.serve_stream(art, threshold=0.0, inp=io.StringIO(
        json.dumps({"id": 7, "boxes": bx.tolist(),
                    "scores": sc.tolist()}) + "\n"), out=out)
    resp = json.loads(out.getvalue())
    assert n == 1 and resp["id"] == 7
    np.testing.assert_allclose(resp["new_scores"], art(bx, sc), rtol=0,
                               atol=1e-6)
    dets = [{"image_id": 1, "category_id": 1,
             "bbox": [float(b[0]), float(b[1]), float(b[2] - b[0]),
                      float(b[3] - b[1])], "score": float(s)}
            for b, s in zip(bx, sc)]
    (tmp_path / "dets.json").write_text(json.dumps(dets))
    serving.main(["--artifact", str(path), "--device", "cpu", "--input",
                  str(tmp_path / "dets.json"), "--output",
                  str(tmp_path / "out.json")])
    got = [d["score"] for d in json.loads(
        (tmp_path / "out.json").read_text())]
    np.testing.assert_allclose(got, resp["new_scores"], rtol=0, atol=2e-6)


def _checkpoint(tmp_path, cfg, params):
    ckpt = CheckpointManager(tmp_path / "ckpt")
    state = create_train_state(cfg, build_model(cfg, "dense", "cpu"),
                               params=params)
    ckpt.maybe_save_best(0.5, state)
    return tmp_path / "ckpt"


@pytest.mark.parametrize("source", ["checkpoint", "jax_npz"])
def test_export_cli(tmp_path, capsys, source):
    """The export CLI from a checkpoint directory or from a params NPZ the
    JAX package wrote: the artifact serves JAX's scores."""
    jcfg, cfg, params = _setup()
    cfg_file = tmp_path / "cfg.yaml"
    cfg_file.write_text(yaml.safe_dump(_overrides()))
    out = tmp_path / "m.gnetart"
    argv = ["-c", str(cfg_file), "--out", str(out), "--batches", "1,2",
            "--device", "cpu"]
    if source == "checkpoint":
        argv += ["--checkpoint-dir",
                 str(_checkpoint(tmp_path, cfg, params))]
    else:
        j_export.save_params_npz(tmp_path / "p.npz", params)
        argv += ["--params-npz", str(tmp_path / "p.npz")]
    ma.main(argv)
    assert "4 shapes" in capsys.readouterr().out
    images = _images(3)
    got = ma.ArtifactRescorer(out, device="cpu").rescore_batch(
        images, batch_size=2)
    want = JRescorer(jcfg, params, pool_impl="dense",
                     mesh=None).rescore_batch(images, batch_size=2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_evaluate_artifact_equals_checkpoint_evaluation(tmp_path, capsys):
    """`evaluate --artifact` reproduces the evaluation of the checkpoint
    it was exported from; without -c it reads the artifact's own config;
    the batch is the largest exported one that the config's batch size
    allows (else the smallest exported)."""
    _, cfg, params = _setup()
    ov = _overrides(dataset="synthetic")
    ov["train"] = {"batch_size": 8,
                   "checkpoint_dir": str(_checkpoint(tmp_path, cfg, params))}
    cfg_file = tmp_path / "cfg.yaml"
    cfg_file.write_text(yaml.safe_dump(ov))
    want = t_eval.main(["-c", str(cfg_file), "--best", "--device", "cpu"])
    for batches, with_cfg in (("1,8", False), ("16", True)):
        art = tmp_path / f"m{batches}.gnetart"
        ma.main(["-c", str(cfg_file), "--out", str(art), "--batches",
                 batches, "--checkpoint-dir", ov["train"]["checkpoint_dir"],
                 "--pool-impl", "dense", "--device", "cpu"])
        capsys.readouterr()
        got = t_eval.main((["-c", str(cfg_file)] if with_cfg else [])
                          + ["--artifact", str(art), "--device", "cpu"])
        assert "evaluating artifact" in capsys.readouterr().out
        assert got["raw_scores"] == want["raw_scores"]
        assert got["gossipnet"] == pytest.approx(want["gossipnet"], abs=1e-6)
