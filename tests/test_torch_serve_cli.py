"""The port's serve CLI on the CPU (``--device cpu``) against the JAX
package's ``serve_file``: COCO-results file mode, multi-class category
mapping, the refusals, checkpoint-backed serving after a short training
run, and the TCP CLI's SIGHUP reload and SIGTERM drain.

Both packages write scores rounded to 6 decimals; the JAX dense path and
the port's plain kernel path run IEEE f32 in two summation orders, so the
written scores agree at atol = 2e-6 and every other field is equal. Served
from a checkpoint, the scores equal those of the in-memory parameters
exactly. Every subprocess and socket has a timeout.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import json
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from gossipnet_tpu.api import Rescorer as JRescorer
from gossipnet_tpu.config import load_config as j_load_config
from gossipnet_tpu.serving import serve_file as j_serve_file
from gossipnet_tpu_torch import serving
from gossipnet_tpu_torch.api import Rescorer
from gossipnet_tpu_torch.config import load_config
from gossipnet_tpu_torch.data.synthetic import synthetic_roidb
from gossipnet_tpu_torch.params import init_params, params_to_jax
from gossipnet_tpu_torch.train import train

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120


def _overrides(num_classes=1, **train_kw):
    model = {"num_blocks": 2, "feature_dim": 16, "reduced_dim": 8,
             "pairwise_dim": 8, "pair_matmul_dtype": "float32",
             "num_classes": num_classes}
    if num_classes > 1:
        model["class_embed_dim"] = 8
    return {"model": model,
            "data": {"bucket_sizes": [32, 64], "person_only": False,
                     "dataset": "synthetic"},
            "parallel": {"enable": "off"},
            "train": {"batch_size": 2, "log_every": 1, "snapshot_every": 0,
                      "eval_every": 0, **train_kw}}


def _write_cfg(tmp_path, num_classes=1, **train_kw):
    path = tmp_path / f"cfg{num_classes}.yaml"
    path.write_text(yaml.safe_dump(_overrides(num_classes, **train_kw)))
    return path


def _dets(rng, images=(1, 2, 3), per_image=(6, 20, 40), cat_ids=(1,)):
    dets = []
    for img, n in zip(images, per_image):
        for _ in range(n):
            x, y = rng.uniform(0, 100, 2)
            dets.append({"image_id": img,
                         "category_id": int(rng.choice(cat_ids)),
                         "bbox": [float(x), float(y),
                                  float(rng.uniform(5, 30)),
                                  float(rng.uniform(5, 30))],
                         "score": float(rng.uniform(0, 1))})
    return dets


def _same_file(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "score"} == \
            {k: v for k, v in w.items() if k != "score"}
    np.testing.assert_allclose([g["score"] for g in got],
                               [w["score"] for w in want], rtol=0, atol=2e-6)


@pytest.mark.parametrize("num_classes", [1, 3], ids=["persons", "classes3"])
def test_file_mode_matches_jax_serve_file(tmp_path, num_classes):
    ov = _overrides(num_classes)
    jcfg, cfg = j_load_config(None, ov), load_config(None, ov)
    params = init_params(cfg.model, seed=2)
    cat_ids = (7, 11, 42) if num_classes > 1 else (1,)
    # the file covers only two of the three training categories: labels
    # must still come from the training list
    dets = _dets(np.random.default_rng(num_classes), cat_ids=cat_ids[::2])
    (tmp_path / "dets.json").write_text(json.dumps(dets))
    cats = None
    if num_classes > 1:
        cats = str(tmp_path / "cats.json")
        Path(cats).write_text(json.dumps(list(cat_ids)))
    n = serving.serve_file(
        Rescorer(cfg, params, pool_impl="kernel", device="cpu"),
        str(tmp_path / "dets.json"), str(tmp_path / "out.json"),
        categories=cats)
    jn = j_serve_file(JRescorer(jcfg, params, pool_impl="dense", mesh=None),
                      str(tmp_path / "dets.json"),
                      str(tmp_path / "jax.json"), categories=cats)
    assert n == jn == 3
    _same_file(json.loads((tmp_path / "out.json").read_text()),
               json.loads((tmp_path / "jax.json").read_text()))


def test_cli_multiclass_file_mode_uses_and_needs_the_categories(
        tmp_path, capsys):
    cfg_file = _write_cfg(tmp_path, num_classes=3)
    dets = _dets(np.random.default_rng(3), cat_ids=(7, 42))
    (tmp_path / "dets.json").write_text(json.dumps(dets))
    (tmp_path / "cats.json").write_text(json.dumps([7, 11, 42]))
    argv = ["-c", str(cfg_file), "--random-init", "--device", "cpu",
            "--input", str(tmp_path / "dets.json"),
            "--output", str(tmp_path / "out.json")]
    serving.main(argv + ["--categories", str(tmp_path / "cats.json")])
    assert "rescored 3 images" in capsys.readouterr().err
    out = json.loads((tmp_path / "out.json").read_text())
    assert [d["category_id"] for d in out] == \
        [d["category_id"] for d in dets]
    with pytest.raises(ValueError, match="training category list"):
        serving.main(argv)


def test_cli_refuses_to_overwrite_its_input(tmp_path, capsys):
    cfg_file = _write_cfg(tmp_path)
    inp = tmp_path / "dets"   # no suffix: the derived output must differ
    inp.write_text(json.dumps([{"image_id": 1, "category_id": 1,
                                "bbox": [1.0, 1.0, 5.0, 5.0],
                                "score": 0.5}]))
    argv = ["-c", str(cfg_file), "--random-init", "--device", "cpu",
            "--input", str(inp)]
    serving.main(argv)
    assert (tmp_path / "dets_rescored.json").exists()
    with pytest.raises(SystemExit, match="refusing to overwrite"):
        serving.main(argv + ["--output", str(inp)])
    assert json.loads(inp.read_text())[0]["score"] == 0.5   # untouched


def _trained(tmp_path):
    """3 training steps on the CPU -> (config file, checkpoint dir,
    the trained state_dict)."""
    ckpt = tmp_path / "ckpt"
    cfg_file = _write_cfg(tmp_path, checkpoint_dir=str(ckpt),
                          learning_rate=3e-3)
    cfg = load_config(str(cfg_file))
    state = train(cfg, synthetic_roidb(num_images=4, seed=0),
                  pool_impl="kernel", metrics_path=str(tmp_path / "m.jsonl"),
                  max_steps=3, device="cpu")
    assert state.step == 3
    return cfg_file, ckpt, {k: v.clone()
                            for k, v in state.model.state_dict().items()}


def test_checkpoint_dir_serves_the_trained_params(tmp_path, capsys):
    cfg_file, ckpt, trained = _trained(tmp_path)
    cfg = load_config(str(cfg_file))
    dets = _dets(np.random.default_rng(5))
    (tmp_path / "dets.json").write_text(json.dumps(dets))
    serving.main(["-c", str(cfg_file), "--checkpoint-dir", str(ckpt),
                  "--device", "cpu", "--input", str(tmp_path / "dets.json"),
                  "--output", str(tmp_path / "out.json")])
    serving.serve_file(Rescorer(cfg, trained, device="cpu"),
                       str(tmp_path / "dets.json"),
                       str(tmp_path / "mem.json"))
    got = json.loads((tmp_path / "out.json").read_text())
    assert got == json.loads((tmp_path / "mem.json").read_text())
    j_serve_file(JRescorer(j_load_config(str(cfg_file)),
                           params_to_jax(trained), pool_impl="dense",
                           mesh=None),
                 str(tmp_path / "dets.json"), str(tmp_path / "jax.json"))
    _same_file(got, json.loads((tmp_path / "jax.json").read_text()))
    # the trained weights are not the initial ones
    init = Rescorer(cfg, init_params(cfg.model, cfg.train.seed),
                    device="cpu")
    serving.serve_file(init, str(tmp_path / "dets.json"),
                       str(tmp_path / "init.json"))
    assert json.loads((tmp_path / "init.json").read_text()) != got


def _start_cli(argv, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    srv = subprocess.Popen(
        [sys.executable, "-m", "gossipnet_tpu_torch.serve", *argv],
        cwd=tmp_path, env=env, stderr=subprocess.PIPE, text=True)
    line = srv.stderr.readline().strip()
    assert line.startswith("serving on "), line
    return srv, int(line.rsplit(":", 1)[1])


def _ask(port, rid, image):
    boxes, scores = image
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        f = s.makefile("r")
        s.sendall((json.dumps({"id": rid, "boxes": boxes.tolist(),
                               "scores": scores.tolist()}) + "\n").encode())
        return json.loads(f.readline())


def _image(rng, n=6):
    xy = rng.uniform(0, 100, (n, 2))
    return (np.concatenate([xy, xy + 10], 1).astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32))


def test_tcp_cli_drains_on_sigterm(tmp_path):
    cfg_file = _write_cfg(tmp_path)
    srv, port = _start_cli(["-c", str(cfg_file), "--random-init",
                            "--device", "cpu", "--tcp", "0",
                            "--threshold", "0.0", "--batch-size", "2"],
                           tmp_path)
    try:
        resp = _ask(port, "x", _image(np.random.default_rng(3), 4))
        assert len(resp["new_scores"]) == 4
        srv.send_signal(signal.SIGTERM)
        assert srv.wait(timeout=TIMEOUT) == 0
        assert "drained: 1 images in 1 batches, 0 errors" in \
            srv.stderr.read()
    finally:
        if srv.poll() is None:
            srv.kill()
        srv.stderr.close()


def test_tcp_cli_reloads_its_checkpoint_on_sighup(tmp_path):
    """A checkpoint-backed server answers with the checkpoint's weights;
    SIGHUP after the checkpoint changed serves the new ones without a
    restart; SIGTERM drains."""
    cfg_file, ckpt, trained = _trained(tmp_path)
    cfg = load_config(str(cfg_file))
    image = _image(np.random.default_rng(4), 9)
    before = Rescorer(cfg, trained, device="cpu")(*image)
    srv, port = _start_cli(["-c", str(cfg_file), "--checkpoint-dir",
                            str(ckpt), "--device", "cpu", "--tcp", "0"],
                           tmp_path)
    try:
        first = _ask(port, 1, image)
        np.testing.assert_allclose(first["new_scores"], before, rtol=0,
                                   atol=1e-6)
        # two more steps land in the same directory: a new latest, no best
        state = train(cfg, synthetic_roidb(num_images=4, seed=0),
                      pool_impl="kernel", max_steps=5, device="cpu",
                      metrics_path=str(tmp_path / "m2.jsonl"))
        after = Rescorer(cfg, state.model.state_dict(), device="cpu")(*image)
        srv.send_signal(signal.SIGHUP)
        assert "weights reloaded" in srv.stderr.readline()
        second = _ask(port, 2, image)
        np.testing.assert_allclose(second["new_scores"], after, rtol=0,
                                   atol=1e-6)
        assert np.abs(after - before).max() > 1e-5
        srv.send_signal(signal.SIGTERM)
        assert srv.wait(timeout=TIMEOUT) == 0
        assert "drained: 2 images in 2 batches, 0 errors" in \
            srv.stderr.read()
    finally:
        if srv.poll() is None:
            srv.kill()
        srv.stderr.close()


@pytest.mark.parametrize("mode", ["tcp", "file", "export"])
def test_clis_without_device_raise_on_a_host_without_a_card(tmp_path, mode):
    """Without --device the serve and export CLIs run on the card, and on
    a host without one they raise before serving or writing anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg_file = _write_cfg(tmp_path)
    (tmp_path / "dets.json").write_text("[]")
    np.savez(tmp_path / "p.npz", **{})
    if mode == "export":
        from gossipnet_tpu_torch.utils import model_artifact

        run = model_artifact.main
        argv = ["-c", str(cfg_file), "--params-npz", str(tmp_path / "p.npz"),
                "--out", str(tmp_path / "out")]
    else:
        run = serving.main
        argv = ["-c", str(cfg_file), "--random-init"]
        argv += (["--tcp", "0"] if mode == "tcp" else
                 ["--input", str(tmp_path / "dets.json"), "--output",
                  str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(argv)
    assert not (tmp_path / "out").exists()
