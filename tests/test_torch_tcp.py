"""The port's TcpServer against ``gossipnet_tpu.serving.TcpServer`` on the
CPU.

Both servers serve the same 2-block model (widths 16/8/8, IEEE f32) from
the same parameters: the JAX Rescorer on its dense path, the port's on the
kernel path's plain version (``device="cpu"``). The same requests go to
both; ids, keep lists, error replies and counters must be equal. Scores
agree at atol = 2e-6 on JSON lines (both round to 6 decimals) and at
1e-5 on binary frames (exact f32 of two summation orders). The batching
tests hold the port's replies to JAX's ``rescore_batch`` at 2e-6 and its
batch counts to the reference server's policy.

Every client socket has a timeout, every server stops in a ``finally``
and every thread is joined with a timeout, so no test can hang.
"""

import torch_cpu  # noqa: F401  (first: one torch thread)
import contextlib
import json
import socket
import struct
import sys
import threading
import time
import types
import warnings

import jax
import numpy as np
import pytest

from gossipnet_tpu.api import Rescorer as JRescorer
from gossipnet_tpu.config import load_config as j_load_config
from gossipnet_tpu.serving import TcpServer as JTcpServer
from gossipnet_tpu.train import build_model as j_build_model
from gossipnet_tpu_torch.api import Rescorer
from gossipnet_tpu_torch.config import load_config
from gossipnet_tpu_torch.serving import BIN_MAGIC, TcpServer

TIMEOUT = 30.0
MODEL = {"num_blocks": 2, "feature_dim": 16, "reduced_dim": 8,
         "pairwise_dim": 8, "pair_matmul_dtype": "float32"}


def _overrides(buckets=(32, 64), num_classes=1):
    model = dict(MODEL, num_classes=num_classes)
    if num_classes > 1:
        model["class_embed_dim"] = 8
    return {"model": model,
            "data": {"bucket_sizes": list(buckets), "person_only": False},
            "parallel": {"enable": "off"}}


def _jax_params(num_classes=1, seed=0):
    jcfg = j_load_config(None, _overrides(num_classes=num_classes))
    args = [np.zeros((1, 32, 4), np.float32), np.zeros((1, 32), np.float32),
            np.ones((1, 32), bool)]
    if num_classes > 1:
        args.append(np.zeros((1, 32), np.int32))
    params = j_build_model(jcfg, "dense").init(
        jax.random.key(seed), *args)["params"]
    return jax.tree.map(np.asarray, params)


class Pair:
    """The JAX and the port Rescorer on the same parameters, built once
    per (buckets, classes): the JAX one keeps its compiled shapes."""

    def __init__(self):
        self._cache = {}

    def get(self, buckets=(32, 64), num_classes=1):
        key = (tuple(buckets), num_classes)
        if key not in self._cache:
            params = _jax_params(num_classes)
            ov = _overrides(buckets, num_classes)
            jr = JRescorer(j_load_config(None, ov), params,
                           pool_impl="dense", mesh=None)
            r = Rescorer(load_config(None, ov), params, pool_impl="kernel",
                         device="cpu")
            self._cache[key] = (jr, r, params)
        return self._cache[key]


@pytest.fixture(scope="module")
def pair():
    return Pair()


@contextlib.contextmanager
def running(server):
    server.start()
    try:
        yield server
    finally:
        server.stop()


def _connect(port):
    return socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)


def _image(rng, n, num_classes=1):
    xy = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(5, 25, (n, 2))], 1)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    classes = (rng.integers(0, num_classes, n).astype(np.int32)
               if num_classes > 1 else None)
    return boxes.astype(np.float32), scores, classes


def _json_req(rid, image):
    boxes, scores, classes = image
    req = {"id": rid, "boxes": boxes.tolist(), "scores": scores.tolist()}
    if classes is not None:
        req["classes"] = classes.tolist()
    return json.dumps(req)


def _bin_req(rid, image, magic=BIN_MAGIC):
    boxes, scores, classes = image
    head = struct.pack("<IQII", magic, rid, len(scores),
                       int(classes is not None))
    body = boxes.astype("<f4").tobytes() + scores.astype("<f4").tobytes()
    if classes is not None:
        body += classes.astype("<i4").tobytes()
    return head + body


def _recv_exact(s, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def _read_bin(s):
    """-> (id, error text or None, scores or None, keep or None)."""
    magic, status, rid = struct.unpack("<IBQ", _recv_exact(s, 13))
    assert magic == BIN_MAGIC
    if status:
        (ln,) = struct.unpack("<I", _recv_exact(s, 4))
        return rid, _recv_exact(s, ln).decode(), None, None
    (n,) = struct.unpack("<I", _recv_exact(s, 4))
    scores = np.frombuffer(_recv_exact(s, 4 * n), "<f4") if n else \
        np.zeros(0, np.float32)
    (k,) = struct.unpack("<I", _recv_exact(s, 4))
    keep = np.frombuffer(_recv_exact(s, 4 * k), "<i4") if k else \
        np.zeros(0, np.int32)
    return rid, None, scores, keep


def _json_traffic(rng, num_classes):
    """Valid requests over both buckets and every kind of bad request."""
    lines = [_json_req(f"ok{k}", _image(rng, n, num_classes))
             for k, n in enumerate((5, 20, 33, 40, 64))]
    mismatch = json.loads(_json_req("mismatch", _image(rng, 4, num_classes)))
    mismatch["scores"] = mismatch["scores"][:2]
    clslen = json.loads(_json_req("clslen", _image(rng, 4, num_classes)))
    clslen["classes"] = [0, 1]
    missing = json.loads(_json_req("missing", _image(rng, 4, num_classes)))
    del missing["scores"]
    lines += ["{not json", json.dumps(mismatch), json.dumps(clslen),
              json.dumps(missing), "[1, 2]",
              _json_req("big", _image(rng, 65, num_classes))]
    if num_classes > 1:   # a multi-class model without class ids
        lines.append(_json_req("nocls", _image(rng, 6)))
    return lines


def _bin_traffic(rng, num_classes):
    frames = [_bin_req(k, _image(rng, n, num_classes))
              for k, n in enumerate((7, 40, 1))]
    frames.append(_bin_req(50, _image(rng, 65, num_classes)))   # oversized
    if num_classes > 1:
        frames.append(_bin_req(51, _image(rng, 5)))   # no class ids
    return frames


def _exchange(server, json_lines, frames):
    """One request at a time on a JSON and on a binary connection, then a
    bad-magic frame on a third -> (JSON replies, binary replies, the
    bad-magic reply, whether that connection was closed)."""
    with _connect(server.port) as sj, _connect(server.port) as sb:
        fj = sj.makefile("r")
        jr = []
        for line in json_lines:
            sj.sendall((line + "\n").encode())
            jr.append(json.loads(fj.readline()))
        br = []
        for frame in frames:
            sb.sendall(frame)
            br.append(_read_bin(sb))
    with _connect(server.port) as s:
        s.sendall(struct.pack("<IQII", 0xDEAD, 9, 1, 0) + b"\0" * 20)
        bad = _read_bin(s)
        try:
            closed = _recv_exact(s, 1) is None
        except ConnectionResetError:
            closed = True
    return jr, br, bad, closed


@pytest.mark.parametrize("num_classes", [1, 3], ids=["persons", "classes3"])
def test_json_and_binary_replies_match_jax(pair, num_classes):
    jr, r, _ = pair.get(num_classes=num_classes)
    rng = np.random.default_rng(num_classes)
    lines = _json_traffic(rng, num_classes)
    frames = _bin_traffic(rng, num_classes)
    # one request at a time: caps of 1 keep JAX's warm-up to two shapes
    kw = dict(port=0, threshold=0.3, window_ms=2.0, batch_size=1,
              max_bucket_batch=1)
    with running(JTcpServer(jr, **kw)) as js:
        want = _exchange(js, lines, frames)
        want_stats = dict(js.stats)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with running(TcpServer(r, **kw)) as ps:
            got = _exchange(ps, lines, frames)
            got_stats = dict(ps.stats)
    # frames are read-only buffers: no per-request non-writable warning
    assert not [w for w in caught if "writable" in str(w.message)]

    (gj, gb, gbad, gclosed), (wj, wb, wbad, wclosed) = got, want
    assert len(gj) == len(wj) == len(lines)
    for g, w in zip(gj, wj):
        assert g.keys() == w.keys() and g["id"] == w["id"]
        if "error" in w:
            assert g["error"] == w["error"]
        else:
            np.testing.assert_allclose(g["new_scores"], w["new_scores"],
                                       rtol=0, atol=2e-6)
            assert g["keep"] == w["keep"]
    assert len(gb) == len(wb) == len(frames)
    for (grid, gerr, gs, gk), (wrid, werr, ws, wk) in zip(gb, wb):
        assert grid == wrid and gerr == werr
        if werr is None:
            np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
            np.testing.assert_array_equal(gk, wk)
    assert gbad[:2] == wbad[:2] and "magic" in gbad[1]
    assert gclosed and wclosed
    assert got_stats == want_stats


def test_interleaved_buckets_batch(pair):
    """A strictly interleaved small/large stream still batches per bucket
    (one open group per bucket): 12 requests in at most 6 batches, the
    windows inside their clamp, every reply JAX's score."""
    jr, r, _ = pair.get(buckets=(8, 32))
    rng = np.random.default_rng(1)
    images = [_image(rng, n) for n in [5, 20] * 6]
    want = jr.rescore_batch(images)
    server = TcpServer(r, port=0, threshold=0.0, batch_size=6,
                       window_ms=500.0, min_window_ms=500.0)
    with running(server), _connect(server.port) as s:
        f = s.makefile("r")
        for k, im in enumerate(images):
            s.sendall((_json_req(k, im) + "\n").encode())
        got = {}
        for _ in images:
            resp = json.loads(f.readline())
            assert "error" not in resp, resp
            got[resp["id"]] = resp["new_scores"]
    assert sorted(got) == list(range(12))
    for k, w in enumerate(want):
        np.testing.assert_allclose(got[k], w, rtol=0, atol=2e-6)
    assert server.stats["batches"] <= 6, server.stats
    assert server.stats["images"] == 12
    for bucket in (8, 32):
        assert server.min_window_s <= server._window_s(bucket) \
            <= server.max_window_s


class _Slow:
    """A rescorer whose batches each hold their device slot ``delay`` s
    longer."""

    def __init__(self, inner, delay):
        self._inner, self._delay = inner, delay

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def rescore_async(self, images, padded_n=None, truncate=False):
        handle = self._inner.rescore_async(images, padded_n=padded_n,
                                           truncate=truncate)
        delay = self._delay

        class Handle:
            def wait(self):
                time.sleep(delay)
                return handle.wait()

        return Handle()


def _send_all_then_read(server, images):
    with _connect(server.port) as s:
        f = s.makefile("r")
        for k, im in enumerate(images):
            s.sendall((_json_req(k, im) + "\n").encode())
        replies = [json.loads(f.readline()) for _ in images]
    return {rep["id"]: rep for rep in replies}


def test_busy_aware_batching(pair):
    """While the one device slot is busy (each batch held 0.1 s), open
    groups keep absorbing arrivals: 12 requests sent back to back go out
    in at most 5 batches even with a 1 ms window."""
    jr, r, _ = pair.get()
    rng = np.random.default_rng(3)
    images = [_image(rng, int(rng.integers(3, 12))) for _ in range(12)]
    server = TcpServer(_Slow(r, 0.1), port=0, threshold=0.0, batch_size=8,
                       window_ms=1.0, pipeline_depth=1)
    with running(server):
        got = _send_all_then_read(server, images)
    want = jr.rescore_batch(images)
    for k, w in enumerate(want):
        assert "error" not in got[k]
        np.testing.assert_allclose(got[k]["new_scores"], w, rtol=0,
                                   atol=2e-6)
    assert server.stats["batches"] <= 5, server.stats
    assert server.stats["images"] == 12


@pytest.mark.parametrize("kw", [
    dict(batch_size=4),
    dict(batch_size=2, det_budget=256, max_bucket_batch=16),
    dict(batch_size=8, det_budget=100),
], ids=["default_budget", "budget_and_cap", "small_budget"])
def test_per_bucket_batch_policy_matches_jax(kw):
    """The per-bucket caps clamp(det_budget // n, batch_size,
    max_bucket_batch) equal the reference server's."""
    ov = _overrides(buckets=(8, 16, 32))
    port = TcpServer(types.SimpleNamespace(cfg=load_config(None, ov)),
                     port=0, **kw)
    ref = JTcpServer(types.SimpleNamespace(cfg=j_load_config(None, ov)),
                     port=0, **kw)
    try:
        assert port._batch_for == ref._batch_for
        assert port.batch_size == ref.batch_size
    finally:
        port.sock.close()
        ref.sock.close()


def test_small_bucket_coalesces_past_batch_size(pair):
    """Under a busy device a small bucket's group grows past batch_size
    up to its cap (2 * 32 / 8 = 8) and goes out as one batch."""
    jr, r, _ = pair.get(buckets=(8, 32))
    rng = np.random.default_rng(7)
    images = [_image(rng, 5) for _ in range(10)]
    server = TcpServer(_Slow(r, 0.15), port=0, threshold=0.0, batch_size=2,
                       window_ms=1.0, pipeline_depth=1)
    assert server._batch_for[8] == 8
    with running(server):
        got = _send_all_then_read(server, images)
    for k, w in enumerate(jr.rescore_batch(images)):
        np.testing.assert_allclose(got[k]["new_scores"], w, rtol=0,
                                   atol=2e-6)
    assert server.stats["images"] == 10
    assert server.stats["batches"] <= 4, server.stats
    assert server.stats_snapshot()["buckets"]["8"]["max_batch"] == 8


def test_load_shedding(pair):
    """With max_queue_ms, requests stuck behind a saturated device get an
    'overloaded' reply; every request is answered exactly once."""
    _, r, _ = pair.get()
    rng = np.random.default_rng(4)
    images = [_image(rng, 4) for _ in range(6)]
    server = TcpServer(_Slow(r, 0.3), port=0, threshold=0.0, window_ms=5.0,
                       batch_size=2, pipeline_depth=1, max_queue_ms=50.0)
    with running(server):
        got = _send_all_then_read(server, images)
    shed = [k for k, rep in got.items() if "error" in rep]
    assert sorted(got) == list(range(6))
    assert all("overloaded" in got[k]["error"] for k in shed)
    assert 1 <= len(shed) <= 5
    assert server.stats["shed"] == len(shed)


def test_stats_request_matches_jax(pair):
    """{"stats": true} answers inline with the reference's counters and
    keys, after the same traffic."""
    jr, r, _ = pair.get()
    rng = np.random.default_rng(2)
    im = _image(rng, 5)
    snaps = []
    for cls, rescorer in ((JTcpServer, jr), (TcpServer, r)):
        server = cls(rescorer, port=0, threshold=0.0, batch_size=1,
                     max_bucket_batch=1)
        with running(server), _connect(server.port) as s:
            f = s.makefile("r")
            s.sendall((_json_req("a", im) + "\n").encode())
            json.loads(f.readline())
            s.sendall(b"{not json\n")
            json.loads(f.readline())
            s.sendall(b'{"stats": true}\n')
            snaps.append(json.loads(f.readline()))
    want, got = snaps
    assert got.keys() == want.keys()
    for key in ("images", "batches", "errors", "shed", "mean_batch",
                "batch_size", "pipeline_depth"):
        assert got[key] == want[key], key
    assert got["images"] == 1 and got["errors"] == 1
    assert got["buckets"].keys() == want["buckets"].keys() == {"32", "64"}
    for b in got["buckets"]:
        assert got["buckets"][b]["max_batch"] == \
            want["buckets"][b]["max_batch"]
        assert got["buckets"][b]["service_ema_ms"] > 0


def test_rescorer_failures_become_error_replies(pair):
    """A failure at dispatch (batcher thread) and at readback (replier
    thread) become error replies, the slot is given back, and the next
    request is served."""
    _, r, _ = pair.get()

    class Flaky:
        def __init__(self, inner):
            self._inner = inner
            self.dispatch_failures = 1
            self.wait_failures = 1

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def rescore_async(self, images, padded_n=None, truncate=False):
            if self.dispatch_failures > 0:
                self.dispatch_failures -= 1
                raise RuntimeError("injected dispatch failure")
            handle = self._inner.rescore_async(
                images, padded_n=padded_n, truncate=truncate)
            if self.wait_failures > 0:
                self.wait_failures -= 1

                class Bad:
                    def wait(self):
                        raise RuntimeError("injected wait failure")

                return Bad()
            return handle

    rng = np.random.default_rng(3)
    server = TcpServer(Flaky(r), port=0, threshold=0.0, batch_size=1,
                       window_ms=1.0, pipeline_depth=1)
    with running(server), _connect(server.port) as s:
        f = s.makefile("r")
        replies = []
        for rid in ("a", "b", "c"):
            s.sendall((_json_req(rid, _image(rng, 5)) + "\n").encode())
            replies.append(json.loads(f.readline()))
        assert server._batcher_t.is_alive() and server._replier_t.is_alive()
    assert "injected dispatch failure" in replies[0]["error"]
    assert "injected wait failure" in replies[1]["error"]
    assert replies[2]["id"] == "c" and len(replies[2]["new_scores"]) == 5
    assert server.stats["errors"] == 2


def test_hot_reload_under_service(pair):
    """A client streams the same request while another thread reloads new
    weights: every reply is the old weights' JAX score or the new ones',
    none fails, and every reply after the reload returned is new."""
    jr, r, params = pair.get()
    cfg = load_config(None, _overrides())
    live = Rescorer(cfg, params, pool_impl="kernel", device="cpu")
    bumped = jax.tree.map(lambda x: x * 1.5, params)
    rng = np.random.default_rng(17)
    im = _image(rng, 8)
    old = jr.rescore_batch([im])[0]
    new = JRescorer(jr.cfg, bumped, pool_impl="dense",
                    mesh=None).rescore_batch([im])[0]
    assert np.abs(old - new).max() > 1e-3
    reloaded = threading.Event()

    def reload():
        live.reload(params=bumped)
        reloaded.set()

    server = TcpServer(live, port=0, threshold=0.0, window_ms=2.0)
    kinds = []
    with running(server), _connect(server.port) as s:
        f = s.makefile("r")
        t = threading.Thread(target=reload)
        for k in range(400):
            if k == 3:
                t.start()
            after = reloaded.is_set()
            if after and kinds.count("new") >= 3:
                break
            s.sendall((_json_req(k, im) + "\n").encode())
            got = np.asarray(json.loads(f.readline())["new_scores"])
            if np.abs(got - old).max() <= 2e-6:
                kinds.append("old")
            else:
                np.testing.assert_allclose(got, new, rtol=0, atol=2e-6)
                kinds.append("new")
            assert not (after and kinds[-1] == "old")
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    assert kinds[0] == "old" and kinds[-1] == "new"
    assert server.stats["errors"] == 0


def test_stats_snapshot_polled_during_service_raises_nothing(pair):
    """stats_snapshot iterates the service-time EMAs under the lock the
    replier writes them under: polled in a tight loop while three clients
    are served over both buckets, it never raises and the counters add
    up."""
    _, r, _ = pair.get()
    rng = np.random.default_rng(5)
    images = [_image(rng, n) for n in (5, 40, 12, 60) * 5]
    server = TcpServer(r, port=0, threshold=0.0, window_ms=1.0,
                       min_window_ms=0.01)
    errors, done = [], threading.Event()

    def poll():
        while not done.is_set():
            try:
                snap = server.stats_snapshot()
                assert snap["images"] <= 3 * len(images)
            except Exception as e:   # noqa: BLE001 -- reported below
                errors.append(e)

    def client():
        _send_all_then_read(server, images)

    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with running(server):
            poller = threading.Thread(target=poll)
            poller.start()
            clients = [threading.Thread(target=client) for _ in range(3)]
            for t in clients:
                t.start()
            for t in clients:
                t.join(timeout=TIMEOUT)
            done.set()
            poller.join(timeout=TIMEOUT)
            assert not any(t.is_alive() for t in clients + [poller])
    finally:
        done.set()
        sys.setswitchinterval(old_interval)
    assert errors == []
    assert server.stats["images"] == 3 * len(images)
    assert server.stats_snapshot()["buckets"].keys() == {"32", "64"}


def test_binary_fuzz_never_crashes(pair):
    """Random garbage, frames cut mid-body, a zero-detection frame and
    abrupt disconnects never stop the server or poison service for a
    well-behaved binary client."""
    _, r, _ = pair.get()
    rng = np.random.default_rng(23)
    server = TcpServer(r, port=0, threshold=0.0, window_ms=2.0)
    with running(server):
        for _ in range(5):
            blob = bytes(rng.integers(1, 255, 64, dtype=np.uint8))
            if blob[:1] in b"{ \t\r\n":
                blob = b"\xff" + blob[1:]
            with _connect(server.port) as s:
                s.settimeout(5.0)
                s.sendall(blob)
                try:
                    s.recv(4096)   # an error frame or a close
                except OSError:
                    pass
        for _ in range(3):
            with _connect(server.port) as s:
                s.sendall(struct.pack("<IQII", BIN_MAGIC, 1, 20, 0))
                s.sendall(b"\0" * 37)   # 37 of the 400 body bytes
        with _connect(server.port) as s:
            s.sendall(struct.pack("<IQII", BIN_MAGIC, 5, 0, 0))
            rid, err, scores, _ = _read_bin(s)
            assert rid == 5 and err is None and len(scores) == 0
        with _connect(server.port) as s:
            s.sendall(_bin_req(77, _image(rng, 6)))
            rid, err, scores, _ = _read_bin(s)
        assert server._batcher_t.is_alive() and server._replier_t.is_alive()
    assert rid == 77 and err is None and len(scores) == 6
