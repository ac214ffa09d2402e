"""Subprocess TCP bench client of ``tools/bench_serving.py``: the port's
own copy of ``scripts/_tcp_bench_client.py``, the same protocol and argv.

    python gossipnet_tpu_torch/tools/tcp_bench_client.py PORT CLIENT_ID N_REQUESTS [fast|bin] [IMAGES]

Runs in its OWN interpreter, so the client's JSON encode and decode do not
contend for the server process's GIL (thread clients in the server's
process inflate its tail latency). Emits one JSON line:
``{"lats": [seconds...], "t0": epoch, "t1": epoch}``. Imports numpy and
the standard library only, and it is run by its file path, so starting it
imports neither torch nor the port.

``fast``: pre-encode one request line per image size and cycle them (for
runs with many clients on a host with few cores); responses are still
decoded in full. ``bin``: the server's binary frame protocol
(``gossipnet_tpu_torch/serving.py``, ``BIN_MAGIC``): raw f32 arrays both
ways, no JSON on the data path. ``IMAGES`` (an ``.npz`` of
:func:`save_images`) replaces the random boxes: request ``k`` sends image
``k`` modulo their count, each encoded once, unrounded.

:func:`run` is the client as a function; it is also what a caller runs in
threads of its own process to compare the two hosts on the same requests.
"""
import json
import socket
import struct
import sys
import time

import numpy as np

BIN_MAGIC = 0x544E4E47


def _make_arrays(rng, n: int):
    x1 = rng.uniform(0, 540, n)
    y1 = rng.uniform(0, 380, n)
    w = rng.uniform(10, 100, n)
    h = rng.uniform(10, 100, n)
    boxes = np.stack([x1, y1, x1 + w, y1 + h], 1)
    scores = rng.uniform(0.05, 1.0, n)
    return boxes, scores


def _make_req(rng, n: int, rid) -> bytes:
    boxes, scores = _make_arrays(rng, n)
    return (json.dumps({
        "id": rid,
        "boxes": np.round(boxes, 2).tolist(),
        "scores": np.round(scores, 4).tolist(),
    }) + "\n").encode()


def _make_req_bin(rng, n: int, rid) -> bytes:
    boxes, scores = _make_arrays(rng, n)
    return (struct.pack("<IQII", BIN_MAGIC, rid, n, 0)
            + boxes.astype("<f4").tobytes()
            + scores.astype("<f4").tobytes())


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "server closed mid-frame"
        buf.extend(chunk)
    return bytes(buf)


def _read_reply_bin(s) -> bool:
    """Read one binary reply frame; returns ok (False = error frame)."""
    magic, status, _rid = struct.unpack("<IBQ", _recv_exact(s, 13))
    assert magic == BIN_MAGIC, hex(magic)
    if status != 0:
        (ln,) = struct.unpack("<I", _recv_exact(s, 4))
        _recv_exact(s, ln)
        return False
    (n,) = struct.unpack("<I", _recv_exact(s, 4))
    scores = np.frombuffer(_recv_exact(s, 4 * n), "<f4")
    (k,) = struct.unpack("<I", _recv_exact(s, 4))
    np.frombuffer(_recv_exact(s, 4 * k), "<i4")
    assert len(scores) == n
    return True


def save_images(path, images) -> None:
    """Writes ``images`` ((boxes [n, 4], scores [n], ...) each) for the
    ``IMAGES`` argument."""
    arrays = {}
    for i, (boxes, scores, *_) in enumerate(images):
        arrays[f"boxes_{i}"] = np.asarray(boxes, np.float32)
        arrays[f"scores_{i}"] = np.asarray(scores, np.float32)
    np.savez(path, **arrays)


def _image_requests(path, mode: str) -> list:
    with np.load(path) as f:
        count = len(f.files) // 2
        images = [(f[f"boxes_{i}"], f[f"scores_{i}"]) for i in range(count)]
    if mode == "bin":
        return [struct.pack("<IQII", BIN_MAGIC, 0, len(sc), 0)
                + bx.astype("<f4").tobytes() + sc.astype("<f4").tobytes()
                for bx, sc in images]
    return [(json.dumps({"id": 0, "boxes": bx.tolist(),
                         "scores": sc.tolist()}) + "\n").encode()
            for bx, sc in images]


def run(port: int, cid: int, per_client: int, mode: str = "",
        images=None) -> dict:
    """One closed-loop client -> ``{"lats": [seconds...], "t0": epoch,
    "t1": epoch}``; ``images`` is the path of the ``IMAGES`` argument."""
    rng = np.random.default_rng(100 + cid)
    if images is not None:
        canned = _image_requests(images, mode)

        def payload(k):
            return canned[k % len(canned)]
    else:
        # Same size mix as bench_serving's stream workload:
        # 8 detections per GT at n_gt in {16, 40, 100} -> 128/320/800.
        sizes = [8 * int(rng.choice([16, 40, 100]))
                 for _ in range(per_client)]
        make = _make_req_bin if mode == "bin" else _make_req
        canned = ({n: make(rng, n, 0) for n in set(sizes)}
                  if mode in ("fast", "bin") else None)

        def payload(k):
            return canned[sizes[k]] if canned else make(rng, sizes[k], k)

    lats = []
    with socket.create_connection(("127.0.0.1", port)) as s:
        f = s.makefile("r") if mode != "bin" else None
        t_start = time.time()
        for k in range(per_client):
            req = payload(k)
            t0 = time.perf_counter()
            s.sendall(req)
            if mode == "bin":
                ok = _read_reply_bin(s)
            else:
                ok = "error" not in json.loads(f.readline())
            if ok:   # shed replies are not service time
                lats.append(time.perf_counter() - t0)
        t_end = time.time()
    return {"lats": lats, "t0": t_start, "t1": t_end}


def main(argv) -> None:
    port, cid, per_client = int(argv[0]), int(argv[1]), int(argv[2])
    mode = argv[3] if len(argv) > 3 else ""
    images = argv[4] if len(argv) > 4 else None
    print(json.dumps(run(port, cid, per_client, mode, images)))


if __name__ == "__main__":
    main(sys.argv[1:])
