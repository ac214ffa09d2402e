"""The port's Rescorer and JSON-lines server against the JAX ones.

Tolerance: new scores (sigmoid probabilities) at atol = 1e-5; both sides
run the same f32 model (JAX dense path vs the port's dense path and its
kernel path's plain version). The JSON replies round to 6 decimals, so
their scores are compared at atol = 2e-6; ids, keep lists and error
replies must be equal.
"""

import io
import json
import threading

import numpy as np
import jax
import pytest

from gossipnet_tpu.api import Rescorer as JRescorer
from gossipnet_tpu.config import load_config as j_load_config
from gossipnet_tpu.serving import serve_stream as j_serve_stream
from gossipnet_tpu.train import build_model as j_build_model
from gossipnet_tpu_torch.api import Rescorer
from gossipnet_tpu_torch.config import load_config
from gossipnet_tpu_torch.serving import serve_stream
from tests.conftest import random_boxes

OVERRIDES = {
    "model": {"num_blocks": 2, "feature_dim": 16, "reduced_dim": 8,
              "pairwise_dim": 8, "pair_matmul_dtype": "float32"},
    "data": {"bucket_sizes": [32, 64]},
}


@pytest.fixture(scope="module")
def rescorers():
    jcfg = j_load_config(None, OVERRIDES)
    model = j_build_model(jcfg, "dense")
    params = model.init(
        jax.random.key(1), np.zeros((1, 32, 4), np.float32),
        np.zeros((1, 32), np.float32), np.ones((1, 32), bool))["params"]
    params = jax.tree.map(np.asarray, params)
    jr = JRescorer(jcfg, params, pool_impl="dense", mesh=None)
    cfg = load_config(None, OVERRIDES)
    ports = {impl: Rescorer(cfg, params, pool_impl=impl, device="cpu")
             for impl in ("dense", "kernel")}
    return jr, ports, params


def _images(rng, sizes=(5, 20, 40, 64, 12, 80)):
    out = []
    for n in sizes:
        boxes = random_boxes(rng, n, scale=60.0)
        out.append((boxes, rng.uniform(0, 1, n).astype(np.float32), None))
    return out


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_rescore_batch_matches_jax(rng, rescorers, impl):
    jr, ports, _ = rescorers
    images = _images(rng)     # two buckets, plus one image truncated
    want = jr.rescore_batch(images, batch_size=2, truncate=True)
    got = ports[impl].rescore_batch(images, batch_size=2, truncate=True)
    assert [len(g) for g in got] == [len(im[1]) for im in images]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    # truncation keeps the top-64 by score; the rest score exactly 0
    top = np.argsort(-images[-1][1], kind="stable")[:64]
    dropped = np.setdiff1d(np.arange(80), top)
    assert (got[-1][dropped] == 0).all()


def test_rescore_stream_and_async_match_jax(rng, rescorers):
    jr, ports, _ = rescorers
    images = _images(rng, sizes=(7, 9, 50, 33, 30, 2))
    want = dict(jr.rescore_stream(images, batch_size=2))
    got = list(ports["kernel"].rescore_stream(images, batch_size=2))
    assert [i for i, _ in got] == list(range(len(images)))
    for i, g in got:
        np.testing.assert_allclose(g, want[i], rtol=0, atol=1e-5)
    group = images[:2]
    got_async = ports["kernel"].rescore_async(group).wait()
    want_async = jr.rescore_async(group).wait()
    for g, w in zip(got_async, want_async):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="largest bucket"):
        ports["kernel"].rescore_batch(_images(rng, sizes=(65,)))


def test_reload_and_warmup(rng, rescorers):
    _, ports, params = rescorers
    r = ports["dense"]
    images = _images(rng, sizes=(10,))
    before = r.rescore_batch(images)[0]
    bumped = jax.tree.map(lambda x: x * 1.5, params)
    r.reload(params=bumped)
    after = r.rescore_batch(images)[0]
    assert not np.allclose(before, after)
    r.reload(params=params)
    np.testing.assert_array_equal(r.rescore_batch(images)[0], before)
    bad = dict(params)
    bad.pop("head")
    with pytest.raises(ValueError, match="do not match"):
        r.reload(params=bad)
    r.warmup(batch_size=2)


def test_reload_from_another_thread_waits_for_the_batch_in_flight(
        rng, rescorers):
    """A reload started from a second thread while a batch's forward is
    under way (a hook after the first block starts it and waits half a
    second for it) does not reach that batch: its scores are the old
    params' exactly, and the next batch's are the new params' exactly."""
    _, _, params = rescorers
    cfg = load_config(None, OVERRIDES)
    bumped = jax.tree.map(lambda x: x * 1.5, params)
    images = _images(rng, sizes=(10, 20, 30))
    old = Rescorer(cfg, params, pool_impl="dense",
                   device="cpu").rescore_batch(images)
    new = Rescorer(cfg, bumped, pool_impl="dense",
                   device="cpu").rescore_batch(images)
    assert not all(np.allclose(o, n) for o, n in zip(old, new))
    r = Rescorer(cfg, params, pool_impl="dense", device="cpu")
    threads = []

    def start_reload(module, inputs, output):
        if threads:
            return
        t = threading.Thread(target=r.reload, kwargs={"params": bumped})
        threads.append(t)
        t.start()
        t.join(timeout=0.5)   # a reload that does not wait is done by now

    hook = r.model.blocks[0].register_forward_hook(start_reload)
    try:
        during = r.rescore_batch(images)
    finally:
        hook.remove()
    threads[0].join()
    after = r.rescore_batch(images)
    assert len(threads) == 1
    for got, want in zip(during, old):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(after, new):
        np.testing.assert_array_equal(got, want)


def _requests(rng):
    lines = []
    for k, n in enumerate((4, 30, 50)):
        boxes = random_boxes(rng, n, scale=60.0)
        lines.append(json.dumps({"id": f"r{k}", "boxes": boxes.tolist(),
                                 "scores": rng.uniform(0, 1, n).tolist()}))
    lines.insert(1, "{not json")
    lines.insert(2, json.dumps({"id": "short", "boxes": [[0, 0, 5, 5]],
                                "scores": [0.5, 0.4]}))
    lines.append("[1, 2]")
    lines.append(json.dumps({"id": "big", "boxes": [[0, 0, 5, 5]] * 65,
                             "scores": [0.5] * 65}))
    lines.append(json.dumps({"id": 9, "boxes": [[1, 1, 9, 9]],
                             "scores": [0.9]}))
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("sync", [False, True])
def test_serve_stream_replies_match_jax(rng, rescorers, sync):
    jr, ports, _ = rescorers
    req = _requests(rng)
    outs = []
    for r, fn in ((jr, j_serve_stream), (ports["kernel"], serve_stream)):
        out = io.StringIO()
        n = fn(r, threshold=0.3, inp=io.StringIO(req), out=out, sync=sync)
        outs.append((n, [json.loads(x) for x in out.getvalue().splitlines()]))
    (jn, want), (n, got) = outs
    assert n == jn == 4
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g["id"] == w["id"]
        assert g.keys() == w.keys()
        if "error" in w:
            assert g["error"] == w["error"]
        else:
            np.testing.assert_allclose(g["new_scores"], w["new_scores"],
                                       rtol=0, atol=2e-6)
            assert g["keep"] == w["keep"]
