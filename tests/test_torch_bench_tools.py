"""The port's measuring entry points on the CPU: ``tools/entry.py``,
``tools/bench.py``, ``tools/bench_suite.py`` and ``tools/bench_serving.py``
with its subprocess client.

- ``synthetic_arrays`` makes the batch of ``__graft_entry__._synthetic_arrays``
  exactly (the same numpy draws from the same seed).
- ``entry("cpu")``'s forward of a 2-block flagship variant with
  ``pair_matmul_dtype: float32`` and the JAX weights (through
  ``params_from_jax``) against the JAX ``entry()`` fn on the same variant:
  atol = rtol = 1e-4, the golden fixture's dense tolerance (both sides run
  the dense f32 path, in other summation orders).
- ``bench --device cpu`` and ``bench_suite --device cpu`` print lines of
  the stated schema with finite values.
- The chained loop body (``bench.Chain``; eager on the CPU, one captured
  graph on the card) equals a host-level chain of calls bit for bit.
- The serving bench's TCP row drives the port's server with subprocess
  clients (``tools/tcp_bench_client.py``) over JSON lines and binary
  frames, and every client exits.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import json
import math
import struct

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from gossipnet_tpu.config import Config as JConfig
from gossipnet_tpu.config import ModelConfig as JModelConfig
from gossipnet_tpu_torch.api import Rescorer
from gossipnet_tpu_torch.config import Config, DataConfig, ModelConfig
from gossipnet_tpu_torch.params import (
    as_state_dict,
    init_params,
    params_from_jax,
)
from gossipnet_tpu_torch.serving import TcpServer
from gossipnet_tpu_torch.tools import bench, bench_serving, bench_suite, entry
from gossipnet_tpu_torch.tools import tcp_bench_client
from gossipnet_tpu_torch.train import build_model

SMALL = dict(num_blocks=2, feature_dim=128, reduced_dim=32, pairwise_dim=32,
             pair_matmul_dtype="float32")


@pytest.mark.parametrize("batch,n,seed", [(8, 1024, 0), (4, 256, 0),
                                          (3, 100, 5)])
def test_synthetic_arrays_equal_the_reference(batch, n, seed):
    got = entry.synthetic_arrays(batch, n, seed=seed)
    want = graft._synthetic_arrays(batch, n, seed=seed)
    assert got._fields == want._fields
    for name, x, y in zip(got._fields, got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def test_entry_forward_matches_the_jax_entry(monkeypatch):
    monkeypatch.setattr(graft, "_flagship_cfg",
                        lambda: JConfig(model=JModelConfig(**SMALL)))
    monkeypatch.setattr(entry, "flagship_cfg",
                        lambda: Config(model=ModelConfig(**SMALL)))
    jfn, (params, boxes, scores, valid) = graft.entry()
    want = np.asarray(jfn(params, boxes, scores, valid))
    fn, (seeded, *args) = entry.entry("cpu")
    for x, y in zip(args, (boxes, scores, valid)):
        assert np.array_equal(x.numpy(), np.asarray(y))
    weights = params_from_jax(jax.tree.map(np.asarray, params))
    assert sorted(weights) == sorted(seeded)
    got = fn(weights, *args).numpy()
    assert got.shape == want.shape == (4, 256)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_entry_main_prints_the_shape(capsys):
    entry.main(["--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        "entry ok: (4, 256)"


def test_bench_prints_one_line_of_the_schema(capsys):
    result = bench.main(["--device", "cpu", "--layout", "blob"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result
    assert sorted(line) == ["metric", "unit", "value"]
    assert line["unit"] == "dets/sec"
    assert math.isfinite(line["value"]) and line["value"] > 0
    for part in ("N=256", "16-block", "layout=blob", "cpu"):
        assert part in line["metric"]


def test_bench_suite_prints_its_cases_then_done(capsys, monkeypatch):
    name = "N=256 clustered sparse"
    every = bench_suite.cases()
    assert len(every) == 11
    monkeypatch.setattr(bench_suite, "cases",
                        lambda: [c for c in every if c[0] == name])
    results = bench_suite.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "DONE"
    assert json.loads(lines[-2]) == results
    assert lines[0].startswith(name)
    assert list(results) == [name]
    row = results[name]
    assert sorted(row) == ["B", "N", "card", "dets_per_sec", "layout",
                           "ms_per_fwd"]
    assert (row["B"], row["N"], row["layout"]) == (1, 256, "clustered")
    assert math.isfinite(row["ms_per_fwd"]) and row["ms_per_fwd"] > 0
    assert row["dets_per_sec"] > 0


@pytest.mark.parametrize("pool_impl", ["dense", "kernel"])
def test_chained_loop_body_equals_a_host_chain(pool_impl):
    cfg = Config(model=ModelConfig(**dict(SMALL, num_blocks=1)))
    model = build_model(cfg, pool_impl, "cpu")
    model.load_state_dict(as_state_dict(init_params(cfg.model)))
    boxes, scores, valid = entry.device_tensors(
        entry.synthetic_arrays(2, 64, seed=1), "cpu")
    step = bench.forward_step(model, boxes, valid)
    chain = bench.Chain(step, scores)
    got = chain.run(scores, 3).clone()
    want = bench.host_chain(step, scores, 3)
    assert torch.equal(got, want)
    assert chain.k.item() == 3.0
    # every iteration moved the scores: the chain is not one call repeated
    assert not torch.equal(bench.host_chain(step, scores, 2), want)
    again = chain.run(scores, 3)
    assert torch.equal(again, want)


@pytest.mark.parametrize("proto", ["", "bin"])
def test_serving_tcp_row_runs_subprocess_clients(monkeypatch, proto):
    cfg = Config(model=ModelConfig(num_blocks=1, feature_dim=16,
                                   reduced_dim=8, pairwise_dim=8),
                 data=DataConfig(bucket_sizes=(128, 320, 800)))
    rescorer = Rescorer(cfg, init_params(cfg.model), device="cpu")
    monkeypatch.setattr(bench_serving, "PER_CLIENT", 3)
    row = bench_serving.tcp_row(rescorer, "cpu", 2, None, proto)
    assert row["requests"] == 6
    assert row["shed"] == 0
    assert row["metric"].endswith(f"({proto or 'json'}, ms)")
    assert 0 < row["tcp_p50"] <= row["tcp_p99"]
    assert row["images_per_sec"] > 0 and row["card"] == "cpu"


def test_coincident_arrays_make_every_pair_a_neighbour():
    boxes, scores, valid = entry.coincident_arrays(2, 64, seed=3)
    assert boxes.shape == (2, 64, 4) and boxes.dtype == np.float32
    assert scores.shape == (2, 64) and valid.all()
    lo = np.maximum(boxes[:, :, None, :2], boxes[:, None, :, :2])
    hi = np.minimum(boxes[:, :, None, 2:], boxes[:, None, :, 2:])
    inter = np.prod(np.clip(hi - lo, 0, None), -1)
    area = np.prod(boxes[..., 2:] - boxes[..., :2], -1)
    iou = inter / (area[:, :, None] + area[:, None, :] - inter)
    assert iou.min() > 0.92


@pytest.mark.parametrize("proto", ["", "bin"])
@pytest.mark.parametrize("host", ["subprocess", "thread"])
def test_tcp_client_sends_an_images_file(tmp_path, proto, host):
    """The client with an ``IMAGES`` file, as a subprocess and as a
    function in this process: every request answered, and the requests
    are the images, unrounded."""
    cfg = Config(model=ModelConfig(num_blocks=1, feature_dim=16,
                                   reduced_dim=8, pairwise_dim=8),
                 data=DataConfig(bucket_sizes=(64,)))
    rescorer = Rescorer(cfg, init_params(cfg.model), device="cpu")
    batch = entry.synthetic_arrays(3, 64, seed=2)
    images = [(b[v], s[v]) for b, s, v in
              zip(batch.boxes, batch.scores, batch.valid)]
    path = tmp_path / "images.npz"
    tcp_bench_client.save_images(path, images)
    server = TcpServer(rescorer, port=0, threshold=0.5).start()
    try:
        if host == "subprocess":
            reports = bench_serving.run_clients(server.port, 2, 4, proto,
                                                path)
        else:
            reports = [tcp_bench_client.run(server.port, c, 4, proto, path)
                       for c in range(2)]
        stats = server.stats_snapshot()
    finally:
        server.stop()
    assert [len(r["lats"]) for r in reports] == [4, 4]
    assert stats["images"] == 8 and stats["errors"] == 0
    for (boxes, scores), req in zip(
            images, tcp_bench_client._image_requests(path, proto)):
        if proto == "bin":
            head = struct.pack("<IQII", tcp_bench_client.BIN_MAGIC, 0,
                               len(scores), 0)
            assert req == head + boxes.astype("<f4").tobytes() + \
                scores.astype("<f4").tobytes()
        else:
            got = json.loads(req)
            np.testing.assert_array_equal(
                np.asarray(got["boxes"], np.float32), boxes)
            np.testing.assert_array_equal(
                np.asarray(got["scores"], np.float32), scores)
