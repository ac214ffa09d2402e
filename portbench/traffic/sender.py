"""One sender of served traffic, run in its own interpreter by its path,
so its framing and timing take no share of the server process's GIL:

    python portbench/traffic/sender.py SPEC.json

Numpy and the standard library only. It connects, prints ``ready``, reads
the window's start (a ``time.monotonic`` reading, the clock every process
of the machine shares) from standard input, runs, and writes its record
(``SPEC["out"]``, an ``.npz``) before it exits.

``open``: each request of ``SPEC["requests"]`` ([id, due seconds after
the start, image]) is sent at its due time whatever the replies do; a
reader thread takes the replies as they come. ``closed``: the client
sends its next image (``SPEC["sequence"]``, cycled) when the last reply
is in, from ``SPEC["warm_s"]`` before the window's start until its end,
then reads the reply it waits for.
Either way it waits at most ``SPEC["grace_s"]`` past the window for its
replies, and keeps the scores of the ids in ``SPEC["keep"]`` (open) or of
a reservoir sample of its answered requests and of its largest image
(closed).
"""

import json
import socket
import sys
import threading
import time

import numpy as np

import framing


def load_frames(path):
    with np.load(path) as f:
        keys = sorted({k.split("|")[0] for k in f.files})
        return {k: (f[k + "|boxes"], f[k + "|scores"]) for k in keys}


def run_open(spec, sock, images, t0):
    reqs = spec["requests"]
    keep = set(spec["keep"])
    end = t0 + spec["seconds"] + spec["grace_s"]
    done = {}
    kept = {}
    sent_at = np.full(len(reqs), np.nan)

    def reader():
        try:
            while len(done) < len(reqs):
                rid, scores = framing.read_reply(sock)
                done[rid] = (time.monotonic(),
                             -1 if scores is None else len(scores))
                if rid in keep and scores is not None:
                    kept[rid] = np.array(scores)
        except (OSError, ConnectionError):
            pass

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    for k, (rid, due, key) in enumerate(reqs):
        wait = t0 + due - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        sent_at[k] = time.monotonic()
        boxes, scores = images[key]
        sock.sendall(framing.request(rid, boxes, scores))
    th.join(timeout=max(end - time.monotonic(), 0.0))
    ids = np.asarray([r[0] for r in reqs], np.int64)
    due = np.asarray([t0 + r[1] for r in reqs])
    t_done = np.asarray([done.get(r, (np.nan, 0))[0] for r in ids])
    n_back = np.asarray([done.get(r, (0, -2))[1] for r in ids])
    return dict(ids=ids, due=due, sent=sent_at, done=t_done, n_back=n_back,
                kept_ids=np.asarray(sorted(kept), np.int64),
                **{f"kept_{r}": kept[r] for r in kept})


def run_closed(spec, sock, images, t0):
    seq = spec["sequence"]
    stop = t0 + spec["seconds"]
    rng = np.random.default_rng(spec["reservoir_seed"])
    size = int(spec["reservoir"])
    sock.settimeout(spec["seconds"] + spec["grace_s"])
    rows, pool, largest = [], [], None
    k = 0
    start = t0 - spec.get("warm_s", 0.0)
    while True:
        now = time.monotonic()
        if now < start:
            time.sleep(start - now)
            continue
        if now >= stop:
            break
        key = seq[k % len(seq)]
        rid = spec["cid"] * 10 ** 9 + k
        boxes, scores = images[key]
        sock.sendall(framing.request(rid, boxes, scores))
        try:
            got, back = framing.read_reply(sock)
        except (OSError, ConnectionError):
            rows.append((rid, now, np.nan, len(scores), -2))
            break
        t = time.monotonic()
        n_back = -1 if back is None else len(back)
        rows.append((rid, now, t, len(scores), n_back))
        if back is not None and got == rid:
            entry = (rid, np.array(back))
            if len(pool) < size:
                pool.append(entry)
            else:
                j = int(rng.integers(len(rows)))
                if j < size:
                    pool[j] = entry
            if largest is None or len(back) > len(largest[1]):
                largest = entry
        k += 1
    kept = dict(pool)
    if largest is not None:
        kept[largest[0]] = largest[1]
    arr = np.asarray(rows, np.float64).reshape(-1, 5)
    keys = np.asarray([seq[i % len(seq)] for i in range(len(rows))])
    return dict(ids=arr[:, 0].astype(np.int64), sent=arr[:, 1],
                done=arr[:, 2], n=arr[:, 3].astype(np.int64),
                n_back=arr[:, 4].astype(np.int64), keys=keys,
                kept_ids=np.asarray(sorted(kept), np.int64),
                **{f"kept_{r}": kept[r] for r in kept})


def main(path):
    with open(path) as f:
        spec = json.load(f)
    images = load_frames(spec["images"])
    sock = socket.create_connection(("127.0.0.1", spec["port"]))
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    print("ready", flush=True)
    t0 = float(sys.stdin.readline())
    run = run_open if spec["mode"] == "open" else run_closed
    record = run(spec, sock, images, t0)
    sock.close()
    np.savez(spec["out"], **record)


if __name__ == "__main__":
    main(sys.argv[1])
