"""Serving runtime: the pipelined TCP server, the JSON-lines stdin/stdout
stream, COCO-results file rescoring, and their CLI (port of
``gossipnet_tpu/serving.py``). Run the CLI as::

    python -m gossipnet_tpu_torch.serve -c experiments/serving_bucketed.yaml \\
        --checkpoint-dir checkpoints [--tcp PORT | --input dets.json]

JSON-lines stream (default): one image per line on stdin, responses on
stdout, double-buffered through ``Rescorer.rescore_stream``::

    {"id": 7, "boxes": [[0,0,10,10],[1,1,11,11]], "scores": [0.9, 0.8]}
    -> {"id": 7, "new_scores": [0.93, 0.04], "keep": [0]}

TCP mode (``--tcp PORT``): any number of concurrent clients, the same
JSON-lines protocol per connection, per-bucket adaptive micro-batching
(:class:`TcpServer`). A connection may instead speak the binary frame
protocol (detected per connection from its first byte; spec below): raw
little-endian float32 arrays, much cheaper to serialize than JSON.

COCO-results file mode (``--input``): rescore a COCO detection-results
JSON in one call and write the same format back.

Weights come from ``--checkpoint-dir`` (the best-AP checkpoint a training
run of this package wrote, else its latest), from ``--artifact`` (a
serving artifact, ``utils/model_artifact.py``) or, for smoke tests, from
``--random-init``. A checkpoint-backed ``--tcp`` server reloads its
weights on SIGHUP without downtime (``Rescorer.reload``) and drains on
SIGTERM. The model runs on the CUDA device and the CLI raises when there
is none, unless ``--device cpu`` asks for the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import queue
import socket
import struct
import sys
import threading
import time

import numpy as np

from gossipnet_tpu_torch.api import Rescorer, zero_batch
from gossipnet_tpu_torch.config import load_config
from gossipnet_tpu_torch.data.bucketing import bucket_for
from gossipnet_tpu_torch.models.gossipnet import resolve_device
from gossipnet_tpu_torch.params import init_params

__all__ = ["TcpServer", "serve_stream", "serve_file", "main"]

# --- binary frame protocol (TcpServer; detected per connection) ---
# All integers little-endian. Request frame:
#   u32 magic = 0x544E4E47 (b"GNNT")
#   u64 request id (echoed back; numeric-only in this protocol)
#   u32 n           detection count
#   u32 flags       bit 0: classes present
#   n*4 f32         boxes, xyxy row-major [n, 4]
#   n   f32         scores
#   [n  i32         classes]        iff flags & 1
# Reply frame:
#   u32 magic, u8 status (0 = ok, 1 = error), u64 id
#   ok:    u32 n, n f32 new_scores, u32 k, k i32 keep
#   error: u32 len, len bytes utf-8 message
# Scores come back as exact f32 (the JSON path rounds to 6 decimals).
BIN_MAGIC = 0x544E4E47
_BIN_REQ_HEADER = 4 + 8 + 4 + 4


def _recv_exact(sock, n: int) -> bytes | None:
    """Read exactly n bytes or None on EOF/reset mid-frame."""
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def _build(args) -> Rescorer:
    """The Rescorer the CLI serves: an artifact, seeded random weights or
    (default) the best checkpoint of ``--checkpoint-dir``, on
    ``--device``."""
    if args.artifact:
        from gossipnet_tpu_torch.utils.model_artifact import ArtifactRescorer

        return ArtifactRescorer(args.artifact,
                                device=resolve_device(args.device))
    cfg = load_config(args.config) if args.config else load_config(None)
    if cfg.parallel.enable == "on":
        raise SystemExit("serving over a device mesh (parallel.enable: "
                         "'on') is not ported yet: ROADMAP.md item 14")
    device = resolve_device(args.device)
    if args.random_init:
        return Rescorer(cfg, init_params(cfg.model, seed=0), device=device)
    return Rescorer.from_checkpoint(cfg, args.checkpoint_dir, device=device)


def serve_stream(rescorer: Rescorer, threshold: float,
                 inp=sys.stdin, out=sys.stdout, sync: bool = False) -> int:
    """JSON-lines loop; returns number of images served.

    Default: double-buffered batching (responses may trail requests by one
    batch). ``sync``: answer each request immediately.

    A malformed request (bad JSON, missing/mismatched fields, more
    detections than the largest bucket) gets an ``{"id", "error"}`` reply
    and the loop keeps serving.
    """
    def error(rid, msg):
        out.write(json.dumps({"id": rid, "error": str(msg)[:200]}) + "\n")
        out.flush()

    def requests():
        for line in inp:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except ValueError as e:
                error(None, f"bad json: {e}")
                continue
            if not isinstance(req, dict):
                error(None, "request must be a JSON object")
                continue
            yield req

    def arrays(req):
        """Parse + validate one request; ValueError -> error reply."""
        boxes = np.asarray(req["boxes"], np.float32).reshape(-1, 4)
        scores = np.asarray(req["scores"], np.float32)
        classes = (np.asarray(req["classes"], np.int32)
                   if "classes" in req else None)
        if len(boxes) != len(scores):
            raise ValueError(f"boxes/scores length mismatch: "
                             f"{len(boxes)} vs {len(scores)}")
        rescorer._check_image(req.get("id"), scores, classes,
                              truncate=False)
        return boxes, scores, classes

    def respond(req, idx, new_scores):
        keep = np.nonzero(new_scores > threshold)[0]
        out.write(json.dumps({
            "id": req.get("id", idx),
            "new_scores": [round(float(s), 6) for s in new_scores],
            "keep": keep.tolist(),
        }) + "\n")
        out.flush()

    if sync:
        n = 0
        for idx, req in enumerate(requests()):
            try:
                new_scores = rescorer(*arrays(req))
            except (KeyError, ValueError, TypeError) as e:
                error(req.get("id", idx), e)
                continue
            respond(req, idx, new_scores)
            n += 1
        return n

    # Keyed by stream index and popped on response, so a long-running
    # server holds at most the in-flight window of requests.
    reqs: dict = {}

    def images():
        k = 0
        for req in requests():
            try:
                arr = arrays(req)
            except (KeyError, ValueError, TypeError) as e:
                error(req.get("id"), e)
                continue
            # Only accepted requests get a stream index: rescore_stream
            # enumerates ITS input.
            reqs[k] = req
            k += 1
            yield arr

    n = 0
    for idx, new_scores in rescorer.rescore_stream(images()):
        respond(reqs.pop(idx), idx, new_scores)
        n += 1
    return n


class TcpServer:
    """Pipelined concurrent rescoring server over TCP.

    Any number of clients connect and send one JSON request per line
    ({"id", "boxes", "scores"[, "classes"]}); responses come back on the
    same connection as {"id", "new_scores", "keep"}, in request order per
    connection. Malformed or unservable requests (bad JSON, more
    detections than the largest bucket, a multi-class config without
    class ids) get an {"id", "error"} reply on the same connection: they
    never reach the device and never stop the server. ``{"stats": true}``
    answers with :meth:`stats_snapshot`.

    A connection whose first byte is not '{' (or whitespace) speaks the
    binary frame protocol instead (module top, ``BIN_MAGIC``). Both
    protocols share the batcher, the buckets and the device path.

    Three pipelined stages, so host packing of batch k+1 overlaps device
    compute of batch k (CUDA work is asynchronous):

    1. client reader threads: parse and validate, enqueue;
    2. a batcher thread: ONE OPEN GROUP PER SHAPE BUCKET (interleaved
       mixed-size streams still batch), dispatched through
       ``Rescorer.rescore_async`` when it is full or its deadline expires
       and a device slot is free;
    3. a replier thread: waits on each handle, serializes, sends.

    ADAPTIVE DEADLINES, per bucket: waiting for stragglers is worth at
    most a fraction of the batch's service time, so each bucket's window
    is ``window_frac`` x an EMA of its measured service time, clamped to
    [min_window_ms, window_ms], seeded by a timed warm run at ``start``.

    BUSY-AWARE BATCHING: a group is dispatched only when one of the
    ``pipeline_depth`` device slots is free AND it is full or expired.
    While every slot is busy the group stays open and keeps absorbing
    arrivals, so device-busy time becomes batching window instead of a
    queue of singleton batches.
    """

    _STOP = object()
    _WAKE = object()   # replier -> batcher: a device slot just freed
    _SHED = object()   # batcher -> replier: send an overload reply
    _ERR = object()    # batcher -> replier: dispatch failed, error group

    def __init__(self, rescorer: Rescorer, host: str = "127.0.0.1",
                 port: int = 0, threshold: float = 0.5,
                 batch_size: int = 8, window_ms: float = 10.0,
                 min_window_ms: float = 0.2, window_frac: float = 0.5,
                 pipeline_depth: int = 2,
                 max_queue_ms: float | None = None,
                 det_budget: int | None = None,
                 max_bucket_batch: int = 64):
        """``max_queue_ms``: LOAD SHEDDING bound. A request that has
        waited longer than this in an open group (device saturated) gets
        an {"id", "error": "overloaded..."} reply instead of service. None
        (default): never shed.

        PER-BUCKET BATCH SIZING: each bucket's cap is a detection budget,
        ``clamp(det_budget // n, batch_size, max_bucket_batch)`` with
        ``det_budget`` defaulting to ``batch_size * max(bucket_sizes)``:
        the largest bucket batches at ``batch_size``, smaller ones
        proportionally more. Groups grow past ``batch_size`` only while
        every device slot is busy, so low-load latency is unchanged."""
        self.rescorer = rescorer
        self.threshold = threshold
        # An ArtifactRescorer dispatches only the batches it exported:
        # clamp so warm-up and grouping never exceed them.
        max_b = getattr(rescorer, "_max_batch", None)
        if max_b is not None:
            batch_size = min(batch_size, max_b)
        self.batch_size = batch_size
        buckets = tuple(rescorer.cfg.data.bucket_sizes)
        budget = (int(det_budget) if det_budget is not None
                  else batch_size * max(buckets))
        cap_for = getattr(rescorer, "max_batch_for", None)
        self._batch_for = {}
        for n in buckets:
            b = min(max(batch_size, budget // n), max_bucket_batch)
            if cap_for is not None:
                b = min(b, max(cap_for(n), 1))
            self._batch_for[n] = b
        self.max_window_s = window_ms / 1e3
        self.min_window_s = min(min_window_ms / 1e3, self.max_window_s)
        self.window_frac = window_frac
        self.pipeline_depth = pipeline_depth
        self.max_queue_s = (None if max_queue_ms is None
                            else max_queue_ms / 1e3)
        self.sock = socket.create_server((host, port))
        self.port = self.sock.getsockname()[1]
        self.stats = {"images": 0, "batches": 0, "errors": 0, "shed": 0}
        # The counters and the service-time EMAs are written from the
        # reader, batcher and replier threads and read by stats requests:
        # every write and every iteration holds this lock.
        self._stats_lock = threading.Lock()
        self._service_ema = {}   # bucket -> EMA of its service time (s)
        self._queue = None

    def _bump(self, key: str, by: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += by

    # -- internals --
    def _parse(self, req):
        """Parse and validate one request; raises ValueError for anything
        the batcher could not serve, so errors are answered from the
        reader thread and a bad request never poisons a batch."""
        boxes = np.asarray(req["boxes"], np.float32).reshape(-1, 4)
        scores = np.asarray(req["scores"], np.float32)
        classes = (np.asarray(req["classes"], np.int32)
                   if "classes" in req else None)
        if len(boxes) != len(scores):
            raise ValueError(f"boxes/scores length mismatch: "
                             f"{len(boxes)} vs {len(scores)}")
        self.rescorer._check_image(req.get("id"), scores, classes,
                                   truncate=False)
        return boxes, scores, classes

    def stats_snapshot(self) -> dict:
        """Operational counters for a ``{"stats": true}`` request: served
        images, batches, errors and shed requests, the mean batch, and
        each bucket's service-time EMA, current window and batch cap (ms,
        images)."""
        with self._stats_lock:
            stats = dict(self.stats)
            buckets = {
                str(b): {"service_ema_ms": round(ema * 1e3, 2),
                         "window_ms": round(self._window_s(b) * 1e3, 2),
                         "max_batch": self._batch_for.get(
                             b, self.batch_size)}
                for b, ema in sorted(self._service_ema.items())}
        images = stats["images"]
        batches = stats["batches"]
        return {
            **stats,
            "mean_batch": round(images / batches, 3) if batches else None,
            "buckets": buckets,
            "batch_size": self.batch_size,
            "pipeline_depth": self.pipeline_depth,
        }

    def _reply(self, client, lock, req, new_scores):
        if req.get("_bin"):
            ns = np.asarray(new_scores, "<f4")
            keep = np.nonzero(ns > self.threshold)[0].astype("<i4")
            payload = (struct.pack("<IBQI", BIN_MAGIC, 0,
                                   int(req["id"]), len(ns))
                       + ns.tobytes()
                       + struct.pack("<I", len(keep)) + keep.tobytes())
            with lock:
                try:
                    client.sendall(payload)
                except OSError:
                    pass
            return
        keep = np.nonzero(new_scores > self.threshold)[0]
        # np.round(...).tolist() serializes at C speed; a per-score Python
        # round() loop would hold the GIL on the replier thread.
        line = json.dumps({
            "id": req.get("id"),
            "new_scores": np.round(
                np.asarray(new_scores, np.float64), 6).tolist(),
            "keep": keep.tolist(),
        }) + "\n"
        with lock:
            try:
                client.sendall(line.encode())
            except OSError:
                pass   # client went away; drop the response

    def _send_err(self, client, lock, req, msg: str):
        """Error reply in the connection's own protocol."""
        if isinstance(req, dict) and req.get("_bin"):
            data = msg.encode()[:200]
            payload = (struct.pack("<IBQI", BIN_MAGIC, 1,
                                   int(req.get("id") or 0), len(data))
                       + data)
        else:
            rid = req.get("id") if isinstance(req, dict) else None
            payload = (json.dumps({"id": rid, "error": msg[:200]})
                       + "\n").encode()
        with lock:
            try:
                client.sendall(payload)
            except OSError:
                pass

    def _window_s(self, bucket: int) -> float:
        ema = self._service_ema.get(bucket)
        if ema is None:
            return self.max_window_s
        return min(max(self.window_frac * ema, self.min_window_s),
                   self.max_window_s)

    def _batcher(self):
        """Stage 2: per-bucket open groups -> slot-gated async dispatch.

        A group goes to the device when a slot is free AND it is full,
        expired, or the server is draining. Groups may grow past their cap
        while all slots are busy; dispatch then slices off the cap at a
        time (the remainder keeps a fresh deadline)."""
        pending = {}   # bucket -> [deadline, [items]]
        stopping = False
        while True:
            # Dispatch everything ready, oldest deadline first, while
            # slots last.
            now = time.monotonic()
            blocked = False   # a ready group is waiting on a slot
            for b in sorted(pending, key=lambda b: pending[b][0]):
                cap = self._batch_for.get(b, self.batch_size)
                while b in pending:
                    deadline, items = pending[b]
                    if self.max_queue_s is not None:
                        t = time.monotonic()
                        live = [it for it in items
                                if t - it[4] <= self.max_queue_s]
                        if len(live) != len(items):
                            for it in items:
                                if t - it[4] > self.max_queue_s:
                                    self._shed(it, t - it[4])
                            if not live:
                                del pending[b]
                                break
                            pending[b][1] = items = live
                    if not (stopping or deadline <= now
                            or len(items) >= cap):
                        break
                    if not self._slots.acquire(blocking=False):
                        blocked = True
                        break
                    take = items[:cap]
                    rest = items[cap:]
                    if rest:
                        pending[b] = [
                            time.monotonic() + self._window_s(b), rest]
                    else:
                        del pending[b]
                    self._dispatch_group(b, take)
                if blocked:
                    break
            if stopping and not pending:
                self._inflight.put(self._STOP)
                return
            if blocked:
                # Every slot is busy: a _WAKE comes when one frees, and
                # arrivals wake us too. With shedding on, also wake on the
                # shed horizon so queued items are shed on time.
                timeout = self.max_queue_s
            elif pending:
                timeout = max(min(d for d, _ in pending.values())
                              - time.monotonic(), 0.0)
            else:
                timeout = None
            try:
                item = self._queue.get(timeout=timeout)
            except queue.Empty:
                continue
            if item is self._STOP:
                stopping = True
            elif item is not self._WAKE:
                bucket = bucket_for(len(item[3][1]),
                                    self.rescorer.cfg.data.bucket_sizes)
                if bucket not in pending:
                    pending[bucket] = [
                        time.monotonic() + self._window_s(bucket), []]
                pending[bucket][1].append(item)

    def _shed(self, item, waited_s: float):
        """Overload reply for a request that out-waited max_queue_ms. The
        send is the replier thread's: a client that stopped reading has a
        full send buffer exactly when shedding fires, and a blocking send
        from the batcher would stall batching for every other client."""
        self._bump("shed")
        self._inflight.put((self._SHED, item, waited_s, None))

    def _dispatch_group(self, bucket: int, group: list):
        t0 = time.monotonic()
        try:
            handle = self.rescorer.rescore_async(
                [g[3] for g in group], padded_n=bucket)
        except Exception as e:   # noqa: BLE001 -- thread supervisor:
            # anything the rescorer throws (an artifact missing the shape,
            # a device error) must not kill the batcher, which would wedge
            # every client. Error replies go out from the replier thread,
            # and the slot is given back.
            self._slots.release()
            self._bump("errors", len(group))
            self._inflight.put((self._ERR, group, str(e), None))
            return
        # At most pipeline_depth batches are in flight (the slot
        # semaphore), so this queue stays bounded.
        self._inflight.put((handle, group, bucket, t0))

    def _replier(self):
        """Stage 3: wait on device results, send replies, feed the
        service-time EMA that the adaptive windows read."""
        while True:
            entry = self._inflight.get()
            if entry is self._STOP:
                return
            if entry[0] is self._SHED:
                _, item, waited_s, _ = entry
                client, lock, req = item[0], item[1], item[2]
                self._send_err(client, lock, req,
                               f"overloaded: queued {waited_s * 1e3:.0f} "
                               "ms > max_queue_ms")
                continue
            if entry[0] is self._ERR:
                _, group, msg, _ = entry
                for client, lock, req, *_ in group:
                    self._send_err(client, lock, req,
                                   f"internal error: {msg[:160]}")
                continue
            handle, group, bucket, t0 = entry
            try:
                results = handle.wait()
            except Exception as e:   # noqa: BLE001 -- thread supervisor:
                # a failed readback must not kill the replier, or the slot
                # would never be released. Error-reply the group, give the
                # slot back, keep serving.
                self._slots.release()
                self._queue.put(self._WAKE)
                self._bump("errors", len(group))
                for client, lock, req, *_ in group:
                    self._send_err(client, lock, req,
                                   f"internal error: {e!s:.160}")
                continue
            # Free the slot before serializing replies so the batcher can
            # dispatch the next batch at once.
            self._slots.release()
            self._queue.put(self._WAKE)
            dt = time.monotonic() - t0
            # dt includes any wait behind the batch ahead of it: an upper
            # bound on service time, fine for a waiting heuristic.
            with self._stats_lock:
                prev = self._service_ema.get(bucket, dt)
                self._service_ema[bucket] = 0.7 * prev + 0.3 * dt
                self.stats["batches"] += 1
                self.stats["images"] += len(group)
            for (client, lock, req, *_), new_scores in zip(group, results):
                try:
                    self._reply(client, lock, req, new_scores)
                except Exception:   # noqa: BLE001 -- one client's bad
                    # reply must not take down the thread serving everyone
                    self._bump("errors")

    def _client_loop(self, client):
        lock = threading.Lock()
        # Protocol detection: a JSON-lines connection's first byte is '{'
        # (or whitespace); anything else is a binary frame (BIN_MAGIC's
        # first little-endian byte is 'G').
        try:
            first = client.recv(1, socket.MSG_PEEK)
        except OSError:
            client.close()
            return
        if first and first not in b"{ \t\r\n":
            self._client_loop_bin(client, lock)
            return
        with client, client.makefile("r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                req = None
                try:
                    req = json.loads(line)
                    if isinstance(req, dict) and req.get("stats"):
                        # answered inline, never touches the device
                        with lock:
                            try:
                                client.sendall((json.dumps(
                                    self.stats_snapshot()) + "\n").encode())
                            except OSError:
                                return
                        continue
                    image = self._parse(req)
                except (ValueError, KeyError, TypeError) as e:
                    self._bump("errors")
                    self._send_err(client, lock, req, str(e))
                    continue
                self._queue.put((client, lock, req, image,
                                 time.monotonic()))

    def _client_loop_bin(self, client, lock):
        """Reader loop of a binary connection (module-level frame spec).
        Validation is the JSON path's; a bad magic means the framing is
        lost, so the connection is dropped after one error frame."""
        n_cap = 4 * max(self.rescorer.cfg.data.bucket_sizes) + 65536
        with client:
            while True:
                head = _recv_exact(client, _BIN_REQ_HEADER)
                if head is None:
                    return
                magic, rid, n, flags = struct.unpack("<IQII", head)
                req = {"id": rid, "_bin": True}
                if magic != BIN_MAGIC:
                    self._bump("errors")
                    self._send_err(client, lock, req,
                                   f"bad frame magic 0x{magic:08x}")
                    return
                if n > n_cap:
                    # don't trust a wild length enough to read the body
                    self._bump("errors")
                    self._send_err(client, lock, req,
                                   f"frame n={n} exceeds cap {n_cap}")
                    return
                has_cls = bool(flags & 1)
                body = _recv_exact(
                    client, n * 20 + (n * 4 if has_cls else 0))
                if body is None:
                    return
                # read-only views of the frame; Rescorer._pack copies them
                # into the fresh arrays it hands to torch
                boxes = np.frombuffer(
                    body, "<f4", count=n * 4).reshape(n, 4)
                scores = np.frombuffer(body, "<f4", count=n, offset=n * 16)
                classes = (np.frombuffer(body, "<i4", count=n,
                                         offset=n * 20)
                           if has_cls else None)
                try:
                    self.rescorer._check_image(rid, scores, classes,
                                               truncate=False)
                except ValueError as e:
                    self._bump("errors")
                    self._send_err(client, lock, req, str(e))
                    continue
                self._queue.put((client, lock, req,
                                 (boxes, scores, classes),
                                 time.monotonic()))

    def _accept_loop(self):
        while True:
            try:
                client, _ = self.sock.accept()
            except OSError:
                return   # socket closed by stop()
            threading.Thread(target=self._client_loop, args=(client,),
                             daemon=True).start()

    # -- lifecycle --
    def start(self):
        """Dispatch every (batch, bucket) shape a request can reach before
        any thread starts or the socket accepts: each bucket's padded
        batches (powers of two; an artifact's exported batches) up to its
        own cap, so every graph is captured before the first request. Then
        seed each bucket's service-time EMA from a
        second, timed run at its cap (``gossipnet_tpu/serving.py:
        711-729``)."""
        for n in self.rescorer.cfg.data.bucket_sizes:
            pads = sorted({self.rescorer._pad_batch(b)
                           for b in range(1, self._batch_for[n] + 1)})
            for b in pads:
                self.rescorer._run(*zero_batch(b, n))
            t0 = time.monotonic()
            self.rescorer._run(*zero_batch(pads[-1], n))
            self._service_ema[n] = time.monotonic() - t0
        self._queue = queue.Queue()
        self._inflight = queue.Queue()
        self._slots = threading.Semaphore(self.pipeline_depth)
        self._batcher_t = threading.Thread(target=self._batcher, daemon=True)
        self._batcher_t.start()
        self._replier_t = threading.Thread(target=self._replier, daemon=True)
        self._replier_t.start()
        self._accept_t = threading.Thread(target=self._accept_loop,
                                          daemon=True)
        self._accept_t.start()
        return self

    def stop(self):
        """Stop accepting, answer everything already queued, and join the
        batcher and the replier."""
        self.sock.close()
        self._queue.put(self._STOP)
        self._batcher_t.join(timeout=30)
        self._replier_t.join(timeout=30)

    def serve_forever(self):
        self._accept_t.join()


def _training_cat_ids(rescorer: Rescorer, categories: str | None) -> list:
    """The TRAINING category-id list (label k = cat_ids[k]).

    Labels must be assigned exactly as the training roidb assigned them
    (contiguous index into the annotation file's full category list,
    ``data/roidb.py::load_coco_gt``); deriving them from the detection
    file's own category subset would shift labels. Sources, in order:
    ``--categories`` (a JSON list of category ids, or a COCO annotation
    JSON with a ``categories`` section), else ``cfg.data.ann_file``.
    """
    src = categories or rescorer.cfg.data.ann_file
    if not src:
        raise ValueError(
            "multiclass file mode needs the training category list to "
            "map category_id -> model label; pass --categories (JSON "
            "list of ids, or the training annotation file) or set "
            "data.ann_file in the config")
    with open(src) as f:
        doc = json.load(f)
    if isinstance(doc, list):
        cat_ids = [int(c) for c in doc]
    else:
        from gossipnet_tpu_torch.data.roidb import coco_cat_ids

        cat_ids = coco_cat_ids(
            doc, person_only=rescorer.cfg.data.person_only)
    if len(cat_ids) != rescorer.cfg.model.num_classes:
        raise ValueError(
            f"category list from {src} has {len(cat_ids)} entries but "
            f"the model has {rescorer.cfg.model.num_classes} classes")
    return cat_ids


def serve_file(rescorer: Rescorer, in_path: str, out_path: str,
               categories: str | None = None) -> int:
    """COCO-results JSON in -> the same format out with rescored scores;
    returns the number of images."""
    from gossipnet_tpu_torch.data.roidb import _xywh_to_xyxy_np

    with open(in_path) as f:
        dets = json.load(f)
    by_image: dict = {}
    for k, d in enumerate(dets):
        by_image.setdefault(int(d["image_id"]), []).append(k)
    images, order = [], []
    multiclass = rescorer.cfg.model.num_classes > 1
    cat_to_label = {}
    if multiclass:
        cat_ids = _training_cat_ids(rescorer, categories)
        cat_to_label = {int(c): i for i, c in enumerate(cat_ids)}
        unknown = {int(d["category_id"]) for d in dets} - set(cat_to_label)
        if unknown:
            raise ValueError(
                f"detection file has category ids {sorted(unknown)[:10]} "
                "not in the training category list; filter the file to "
                "the model's categories first")
    for img_id, idxs in sorted(by_image.items()):
        boxes = _xywh_to_xyxy_np(
            np.asarray([dets[k]["bbox"] for k in idxs], np.float32))
        scores = np.asarray([dets[k]["score"] for k in idxs], np.float32)
        classes = (np.asarray(
            [cat_to_label[int(dets[k]["category_id"])] for k in idxs],
            np.int32) if multiclass else None)
        images.append((boxes, scores, classes))
        order.append(idxs)
    results = rescorer.rescore_batch(images)
    for idxs, new_scores in zip(order, results):
        for k, s in zip(idxs, new_scores):
            dets[k]["score"] = round(float(s), 6)
    with open(out_path, "w") as f:
        json.dump(dets, f)
    return len(images)


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-c", "--config", default=None)
    p.add_argument("--checkpoint-dir", default="checkpoints",
                   help="serve the best-AP (else the latest) checkpoint of "
                        "this training directory")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--input", default=None, help="COCO-results JSON in")
    p.add_argument("--output", default=None, help="rescored JSON out")
    p.add_argument("--categories", default=None,
                   help="training category list for multiclass file mode "
                        "(JSON list of category ids, or the training COCO "
                        "annotation file); defaults to cfg.data.ann_file")
    p.add_argument("--artifact", default=None,
                   help="serve from an exported artifact "
                        "(utils/model_artifact.py); no config or "
                        "checkpoint needed")
    p.add_argument("--random-init", action="store_true",
                   help="seeded random weights (smoke tests only)")
    p.add_argument("--sync", action="store_true",
                   help="answer each stdin request immediately "
                        "(interactive latency, no batching)")
    p.add_argument("--tcp", type=int, default=None, metavar="PORT",
                   help="serve concurrent clients over TCP on PORT "
                        "(JSON lines or binary frames per connection; "
                        "0 = ephemeral)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--batch-size", type=int, default=8,
                   help="TCP mode max micro-batch of the largest bucket "
                        "(clamped to an artifact's max exported batch)")
    p.add_argument("--det-budget", type=int, default=None,
                   help="TCP mode per-bucket batch sizing: bucket n "
                        "batches up to det_budget/n images. Default: "
                        "batch_size * largest bucket")
    p.add_argument("--max-queue-ms", type=float, default=None,
                   help="TCP mode load-shedding bound: requests queued "
                        "longer than this under overload get an "
                        "'overloaded' error reply (default: queue "
                        "indefinitely)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    rescorer = _build(args)
    if args.tcp is not None:
        import signal

        server = TcpServer(rescorer, host=args.host, port=args.tcp,
                           threshold=args.threshold,
                           batch_size=args.batch_size,
                           max_queue_ms=args.max_queue_ms,
                           det_budget=args.det_budget).start()
        print(f"serving on {args.host}:{server.port}", file=sys.stderr,
              flush=True)
        done = threading.Event()

        def _drain(signum, frame):
            # Graceful drain: stop accepting, flush in-flight batches,
            # answer everything already queued, then exit 0.
            del signum, frame
            done.set()

        signal.signal(signal.SIGTERM, _drain)
        signal.signal(signal.SIGINT, _drain)
        if not args.artifact and not args.random_init:
            # Weight update without downtime: SIGHUP re-reads the best-AP
            # checkpoint and copies it in under the dispatch lock
            # (Rescorer.reload); batches in flight finish on the old
            # weights. The handler runs on this main thread, which only
            # waits on `done`, so the read never blocks the serving
            # threads.
            def _reload(signum, frame):
                del signum, frame
                try:
                    rescorer.reload(checkpoint_dir=args.checkpoint_dir)
                    print(f"weights reloaded from "
                          f"{args.checkpoint_dir}", file=sys.stderr,
                          flush=True)
                except Exception as e:   # keep serving on a bad reload
                    print(f"reload failed (serving continues on the "
                          f"old weights): {e}", file=sys.stderr,
                          flush=True)

            signal.signal(signal.SIGHUP, _reload)
        done.wait()
        server.stop()
        s = server.stats
        print(f"drained: {s['images']} images in {s['batches']} batches, "
              f"{s['errors']} errors", file=sys.stderr, flush=True)
    elif args.input:
        if args.output:
            out_path = args.output
        else:
            inp = pathlib.Path(args.input)
            out_path = str(inp.with_name(
                inp.stem + "_rescored" + (inp.suffix or ".json")))
        if pathlib.Path(out_path).resolve() == \
                pathlib.Path(args.input).resolve():
            raise SystemExit(
                f"refusing to overwrite input file {args.input}; "
                "pass --output")
        n = serve_file(rescorer, args.input, out_path,
                       categories=args.categories)
        print(f"rescored {n} images", file=sys.stderr)
    else:
        n = serve_stream(rescorer, args.threshold, sync=args.sync)
        print(f"served {n} images", file=sys.stderr)


if __name__ == "__main__":
    main()
