"""A closed-loop serving cell: each client sends its next image when its
last reply is in, as camera streams of a pipeline do.

``serve_dets_per_s``: the detections of every reply read within the
window, over the window. The clients start the mix's ``warm_s`` seconds
before it.
"""

from __future__ import annotations

import os

import numpy as np

from portbench import common
from portbench.drivers import serve
from portbench.trace import TRACE_S
from portbench.traffic import generate

SEQUENCE = 4096   # each client's image sequence, cycled


def run(bench) -> None:
    tr = bench.traffic
    server = serve.Server(bench)
    pools = generate.pools(bench.seed, tr, server.cfg.data.max_detections)
    images = serve.flat_images(pools)
    clients = int(tr["clients"])
    per = -(-int(tr["sample"]) // clients)
    with common.scratch() as tmp:
        frames = os.path.join(tmp, "images.npz")
        serve.write_pools(frames, pools)
        specs = []
        for c in range(clients):
            picks = generate.requests(bench.seed, tr, SEQUENCE, f"client{c}")
            specs.append({"mode": "closed", "port": server.server.port,
                          "images": frames, "seconds": bench.seconds,
                          "grace_s": serve.GRACE_S, "cid": c,
                          "out": os.path.join(tmp, f"out{c}.npz"),
                          "sequence": [serve.key(p, i) for p, i in picks],
                          "reservoir": per,
                          "warm_s": float(tr.get("warm_s", 0.0)),
                          "reservoir_seed": [int(bench.seed) & 0xFFFFFFFF,
                                             int(bench.seed) >> 32, c]})
        procs = serve.start_senders(specs, tmp)
        t0, before, after = serve.window(bench, server, procs)
        serve.wait_senders(procs, bench.seconds + serve.GRACE_S + 30)
        recs = [dict(np.load(s["out"])) for s in specs]
    params, device = server.params, server.device
    serve.finish(bench, server, before, after)
    common.release(device)

    end, traced = t0 + bench.seconds, t0 + min(TRACE_S, bench.seconds)
    dets, sent, bad, sample, served, in_trace = 0, 0, 0, [], [], []
    by_id = {}
    for rec in recs:
        ok = rec["n_back"] == rec["n"]
        bad += int((~ok).sum())
        sent += int((rec["sent"] >= t0).sum())
        done = np.where(np.isfinite(rec["done"]), rec["done"], np.inf)
        inside = ok & (done >= t0) & (done <= end)
        dets += int(rec["n"][inside].sum())
        served += [str(k) for k in rec["keys"][inside]]
        in_trace += [str(k) for k in rec["keys"][inside & (done <= traced)]]
        by_id.update(zip(rec["ids"].tolist(), rec["keys"].tolist()))
        for rid in rec["kept_ids"]:
            sample.append((images[by_id[int(rid)]], rec[f"kept_{rid}"]))
    bench.end_to_end["serve_dets_per_s"] = dets / bench.seconds
    bench.attempted, bench.failed = sent, bad
    bench.notes.append(f"{sent} requests, {len(served)} answered in the "
                       f"window, {len(sample)} compared")
    serve.served_work(bench, images, in_trace)
    bench.check("unanswered", bad, 0)
    serve.check(bench, params, device, sample)
