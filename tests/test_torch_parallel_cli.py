"""``parallel.enable`` drives the port's framework paths (``train()``,
``Rescorer``, ``TcpServer``), not only its library helpers: the
counterparts of ``tests/test_parallel_cli.py`` and
``tests/test_serve.py::test_tcp_server_on_sharded_rescorer_matches_local``.

One gloo world of four spawned ranks (``parallel.world.run_world``) runs
every mesh case of this file with the kernels' plain versions; (2 x 2)
stands for the JAX tests' (4 x 2). The cases that need no peer run in
this process, on a world of one where they need a mesh.

Tolerances: served scores against the JAX package's single-device
``Rescorer``, 2e-4 (the JAX tests' own); against the port's own
single-device Rescorer, 1e-5 (JSON replies carry 6 decimals); a mesh run
of ``train()`` against the port's single-device run, rtol 1e-5 and atol
1e-6, and against the JAX test's bound between the two (rtol 5e-3, atol
5e-4); a resume on the mesh bit for bit.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

from gossipnet_tpu import config as j_config
from gossipnet_tpu.api import Rescorer as JRescorer
from gossipnet_tpu.utils.export import unflatten_paths
from gossipnet_tpu_torch import config as t_config
from gossipnet_tpu_torch import train as t_train
from gossipnet_tpu_torch.api import Rescorer
from gossipnet_tpu_torch.data.synthetic import (
    synthetic_record,
    synthetic_roidb,
)
from gossipnet_tpu_torch.params import flatten_paths, init_params
from gossipnet_tpu_torch.parallel import legs
from gossipnet_tpu_torch.parallel.sharding import (
    make_sharded_train_step,
    mesh_from_config,
)
from gossipnet_tpu_torch.parallel.world import Mesh, run_world

MODEL = {"num_blocks": 2, "feature_dim": 32, "reduced_dim": 16,
         "pairwise_dim": 16, "pair_matmul_dtype": "float32"}
DATA = dict(num_images=16, seed=0)


def _train_ov(ckpt, parallel, max_steps=6, snapshot_every=0):
    return {"model": MODEL,
            "train": {"batch_size": 4, "learning_rate": 1e-3,
                      "max_steps": max_steps, "log_every": 1,
                      "snapshot_every": snapshot_every, "eval_every": 0,
                      "seed": 0, "checkpoint_dir": str(ckpt)},
            "data": {"bucket_sizes": [64, 128]}, "parallel": parallel}


def _serve_ov(parallel, buckets=(64,), **model):
    return {"model": {**MODEL, **model},
            "data": {"bucket_sizes": list(buckets)}, "parallel": parallel}


MESH_2X2 = {"enable": "on", "data_axis": 2, "det_axis": 2}
SERVE_OV = _serve_ov(MESH_2X2)
SERVE_PARAMS = flatten_paths(init_params(
    t_config.load_config(None, SERVE_OV).model, seed=0))
RELOAD_PARAMS = flatten_paths(init_params(
    t_config.load_config(None, SERVE_OV).model, seed=1))
TCP_OV = _serve_ov(MESH_2X2, buckets=(32,), num_blocks=1, feature_dim=16,
                   reduced_dim=8, pairwise_dim=8)
TCP_PARAMS = flatten_paths(init_params(
    t_config.load_config(None, TCP_OV).model, seed=0))


def _images(rng, count):
    out = []
    for i in range(count):
        rec = synthetic_record(rng, i)
        out.append((rec.det_boxes, rec.det_scores, None))
    return out


IMAGES = _images(np.random.default_rng(0), 5)   # 5: pads rows to the axis


def _tcp_images():
    rng = np.random.default_rng(3)
    out = []
    for _ in range(6):   # odd counts force data-axis row padding
        n = int(rng.integers(5, 20))
        xy = rng.uniform(0, 100, (n, 2)).astype(np.float32)
        out.append((np.concatenate([xy, xy + 10], 1),
                    rng.uniform(0, 1, n).astype(np.float32)))
    return out


TCP_IMAGES = _tcp_images()
CONFIGS = [
    {"parallel": {"enable": "off"}},
    {"parallel": {"enable": "auto"}},     # a CPU world: never by itself
    {"parallel": MESH_2X2},
    {"parallel": {"enable": "on", "det_axis": 4}},   # data_axis 0 fills
    {"train": {"batch_size": 3}, "parallel": {"enable": "on",
                                              "data_axis": 2,
                                              "det_axis": 2}},
    {"data": {"bucket_sizes": [102]},
     "parallel": {"enable": "on", "data_axis": 1, "det_axis": 4}},
    {"parallel": {"enable": "on", "data_axis": 16}},
    {"parallel": {"enable": "on", "data_axis": 1, "det_axis": 2}},
]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every mesh case of this file in one world of four ranks."""
    tmp = tmp_path_factory.mktemp("mesh")

    def run(name, **kw):
        return ("train_" + name, legs.train_run,
                dict(data=DATA, **kw))

    plan = [
        ("configs", legs.meshes_from_configs, dict(configs=CONFIGS)),
        run("mesh", overrides=_train_ov(tmp / "mesh_run", MESH_2X2),
            metrics=True),
        run("straight", overrides=_train_ov(tmp / "straight", MESH_2X2)),
        run("first", overrides=_train_ov(tmp / "resumed", MESH_2X2,
                                         snapshot_every=3), max_steps=3),
        run("resumed", overrides=_train_ov(tmp / "resumed", MESH_2X2,
                                           snapshot_every=3), max_steps=6),
        ("rescore", legs.rescore, dict(overrides=SERVE_OV,
                                       params=SERVE_PARAMS, images=IMAGES,
                                       reload=RELOAD_PARAMS)),
        ("tcp", legs.tcp, dict(overrides=TCP_OV, params=TCP_PARAMS,
                               images=TCP_IMAGES)),
    ]
    out = run_world(legs.run_legs, 4, args=(plan,), timeout_s=300)
    return {name: [rank[name]["result"] for rank in out]
            for name, _, _ in plan}


@pytest.fixture
def world_of_one():
    """A 1 x 1 ``on`` mesh makes a world of one in this process; it is
    taken down after the test."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def test_mesh_from_config_modes(world_of_one):
    cfg = t_config.load_config
    assert mesh_from_config(cfg(None, {"parallel": {"enable": "off"}}),
                            "cpu") is None
    # no world and the CPU: 'auto' never engages; 'on' is the opt-in
    assert mesh_from_config(cfg(None, {"parallel": {"enable": "auto"}}),
                            "cpu") is None
    with pytest.raises(ValueError, match="auto|on|off"):
        mesh_from_config(cfg(None, {"parallel": {"enable": "maybe"}}),
                         "cpu")
    with pytest.raises(ValueError, match="devices"):
        mesh_from_config(cfg(None, {"parallel": MESH_2X2}), "cpu")
    assert not torch.distributed.is_initialized()   # nothing half made
    mesh = mesh_from_config(cfg(None, {"parallel": {"enable": "on"}}), "cpu")
    assert mesh.shape == {"data": 1, "det": 1}
    assert torch.distributed.get_world_size() == 1


def test_mesh_from_config_modes_in_a_world(world):
    """The same rules over four ranks, every rank agreeing."""
    for got in world["configs"]:
        assert got[0] is None and got[1] is None
        assert got[2] == {"data": 2, "det": 2}
        assert got[3] == {"data": 1, "det": 4}
        assert got[4].startswith("ValueError") and "batch_size" in got[4]
        assert got[5].startswith("ValueError") and "bucket" in got[5]
        assert got[6].startswith("ValueError") and "devices" in got[6]
        # the difference from JAX: a mesh covers every rank of the world
        assert got[7].startswith("ValueError") and "every rank" in got[7]
    assert all(got == world["configs"][0] for got in world["configs"])


def test_train_on_mesh_via_config(world, tmp_path):
    """The one-YAML-knob path: train() builds the (2, 2) mesh itself; the
    same stream off the mesh reaches the same parameters."""
    local = t_train.train(
        t_config.load_config(None, _train_ov(tmp_path / "local",
                                             {"enable": "off"})),
        synthetic_roidb(**DATA), device="cpu")
    want = {k: v.numpy() for k, v in local.model.state_dict().items()}
    losses = [v for v in world["train_mesh"][0][2] if v is not None]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert all(not rank[2] for rank in world["train_mesh"][1:])  # rank 0 logs
    for params, step, _ in world["train_mesh"]:
        assert step == 6
        for k in want:
            np.testing.assert_allclose(params[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
            np.testing.assert_allclose(params[k], want[k], rtol=5e-3,
                                       atol=5e-4, err_msg=k)
    first = world["train_mesh"][0][0]
    for params, _, _ in world["train_mesh"][1:]:   # replicated bit for bit
        for k in first:
            np.testing.assert_array_equal(params[k], first[k])


def test_train_on_mesh_resume_bit_exact(world):
    """Snapshot and resume on the mesh reproduce the straight run."""
    for (straight, s1, _), (first, s2, _), (resumed, s3, _) in zip(
            world["train_straight"], world["train_first"],
            world["train_resumed"]):
        assert (s1, s2, s3) == (6, 3, 6)
        for k in straight:
            np.testing.assert_array_equal(resumed[k], straight[k])
        assert any(not np.array_equal(first[k], straight[k])
                   for k in straight)


def _jax_rescorer(ov, params):
    jc = j_config.load_config(None, {**ov, "parallel": {"enable": "off"}})
    return JRescorer(jc, unflatten_paths(params), pool_impl="dense",
                     mesh=None)


def _local(ov, params):
    cfg = t_config.load_config(None, {**ov, "parallel": {"enable": "off"}})
    return Rescorer(cfg, params, device="cpu")


def test_rescorer_uses_mesh_and_matches_local(world):
    """The (2 x 2) mesh Rescorer from the config against the JAX
    package's single-device Rescorer and the port's; a reload on the main
    rank reaches every rank."""
    got, reloaded = world["rescore"][0]
    assert all(r is None for r in world["rescore"][1:])   # the followers
    ref = _jax_rescorer(SERVE_OV, SERVE_PARAMS).rescore_batch(IMAGES)
    mine = _local(SERVE_OV, SERVE_PARAMS).rescore_batch(IMAGES)
    after = _local(SERVE_OV, RELOAD_PARAMS).rescore_batch(IMAGES)
    for g, r, m in zip(got, ref, mine):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(g, m, rtol=1e-5, atol=1e-5)
    for g, a in zip(reloaded, after):
        np.testing.assert_allclose(g, a, rtol=1e-5, atol=1e-5)


def test_followers_idle_past_the_world_timeout_still_serve():
    """A follower waits for the main rank's next request outside the
    world's timed collectives: a (1 x 2) mesh Rescorer in a world whose
    collectives time out after 5 s answers a request that comes after 8 s
    of idling, with the scores of one device (1e-5)."""
    ov = _serve_ov({"enable": "on", "data_axis": 1, "det_axis": 2})
    out = run_world(legs.run_legs, 2, timeout_s=120, collective_timeout_s=5,
                    args=([("rescore", legs.rescore,
                            dict(overrides=ov, params=SERVE_PARAMS,
                                 images=IMAGES, idle_s=8.0))],))
    (got,), follower = (rank["rescore"]["result"] for rank in out)
    assert follower is None
    for g, m in zip(got, _local(ov, SERVE_PARAMS).rescore_batch(IMAGES)):
        np.testing.assert_allclose(g, m, rtol=1e-5, atol=1e-5)


def _mesh_of_one_ov(num_classes=1, buckets=(64,)):
    return _serve_ov({"enable": "on"}, buckets=buckets, num_blocks=1,
                     num_classes=num_classes)


def test_rescorer_multiclass_requires_classes(world_of_one):
    ov = _mesh_of_one_ov(num_classes=4)
    r = Rescorer(t_config.load_config(None, ov),
                 init_params(t_config.load_config(None, ov).model),
                 device="cpu")
    assert r.mesh.shape == {"data": 1, "det": 1}
    rec = synthetic_record(np.random.default_rng(0), 1, num_classes=4)
    with pytest.raises(ValueError, match="class ids"):
        r.rescore_batch([(rec.det_boxes, rec.det_scores, None)])
    out = r.rescore_batch([(rec.det_boxes, rec.det_scores, rec.det_classes)])
    assert out[0].shape == rec.det_scores.shape
    r.close()


def test_rescorer_oversize_raises_or_pads(world_of_one):
    ov = _mesh_of_one_ov(buckets=(32,))
    r = Rescorer(t_config.load_config(None, ov),
                 init_params(t_config.load_config(None, ov).model),
                 device="cpu")
    rec = synthetic_record(np.random.default_rng(0), 1, num_gt=8,
                           dets_per_gt=6, num_clutter=8)
    n = len(rec.det_scores)
    assert n > 32
    with pytest.raises(ValueError, match="bucket"):
        r.rescore_batch([(rec.det_boxes, rec.det_scores, None)])
    out = r.rescore_batch([(rec.det_boxes, rec.det_scores, None)],
                          truncate=True)
    assert out[0].shape == (n,)
    keep = np.argsort(-rec.det_scores, kind="stable")[:32]
    dropped = np.setdiff1d(np.arange(n), keep)
    assert np.all(out[0][dropped] == 0.0)
    assert np.all(out[0][keep] != 0.0)
    r.close()


def test_per_batch_normalize_refused_on_data_sharded_mesh():
    """'per_batch' pools the weighting over the whole batch, which a data
    shard cannot see: refused; det-only sharding keeps it."""
    cfg = t_config.load_config(None, {"loss": {"normalize": "per_batch"}})

    def mesh(n_data, n_det):   # only its shape is read
        return Mesh({"data": n_data, "det": n_det}, 0, 0, None, None, None,
                    None, torch.device("cpu"))

    with pytest.raises(ValueError, match="per_batch"):
        make_sharded_train_step(cfg, mesh(2, 2))
    make_sharded_train_step(cfg, mesh(1, 2))


def test_tcp_server_on_sharded_rescorer_matches_local(world):
    """TcpServer on the (2 x 2) mesh Rescorer answers two JSON clients
    and a binary one with the scores of a single-device Rescorer."""
    got = world["tcp"][0]
    assert all(r is None for r in world["tcp"][1:])
    ref = _jax_rescorer(TCP_OV, TCP_PARAMS).rescore_batch(
        [(bx, sc, None) for bx, sc in TCP_IMAGES])
    mine = _local(TCP_OV, TCP_PARAMS).rescore_batch(
        [(bx, sc, None) for bx, sc in TCP_IMAGES])
    assert sorted(got["json"]) == sorted(got["binary"]) == list(
        range(len(TCP_IMAGES)))
    for k in range(len(TCP_IMAGES)):
        for reply in (got["json"][k], got["binary"][k]):
            np.testing.assert_allclose(reply, ref[k], atol=2e-4)
            np.testing.assert_allclose(reply, mine[k], atol=1e-5)


def test_train_cli_under_torchrun_on_two_cpu_ranks(tmp_path):
    """``torchrun`` starts the train CLI on two gloo ranks of the CPU
    (``--device cpu``): rank 0 alone logs and checkpoints, and the
    checkpoint holds the parameters of the same run off the mesh."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    import yaml

    ov = _train_ov(tmp_path / "ck", {"enable": "on", "data_axis": 2},
                   max_steps=3)
    ov["data"]["dataset"] = "synthetic"
    cfg_file = tmp_path / "mesh.yaml"
    cfg_file.write_text(yaml.safe_dump(ov))
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "gossipnet_tpu_torch.train", "-c",
         str(cfg_file), "--device", "cpu", "--metrics",
         str(tmp_path / "m.jsonl")], cwd=tmp_path, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(root)))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.count("training on mesh {'data': 2, 'det': 1}") == 1
    rows = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert [r["step"] for r in rows] == [1, 2, 3]
    cfg = t_config.load_config(str(cfg_file))
    got = Rescorer.load_checkpoint_params(cfg, str(tmp_path / "ck"),
                                          best=False)
    local = t_train.train(
        t_config.load_config(None, {**ov, "parallel": {"enable": "off"},
                                    "train": {**ov["train"],
                                              "checkpoint_dir": str(
                                                  tmp_path / "local")}}),
        t_train._datasets(cfg)[0], device="cpu")
    for k, v in local.model.state_dict().items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
