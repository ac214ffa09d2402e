"""An open-loop serving cell: Poisson arrivals at the mix's fixed rate,
spread over the mix's connections, each request sent when it is due
whatever the replies do.

``serve_p95_ms``: the 95th percentile, over every request due in the
window, of the time from its due time until its reply was read; a request
answered with an error, or not at all within a minute of the window's
end, counts as beyond any limit.
"""

from __future__ import annotations

import math
import os

import numpy as np

from portbench import common
from portbench.drivers import serve
from portbench.trace import TRACE_S
from portbench.traffic import generate

WARM = 10 ** 12     # ids of the warm-up's requests start here
PER_REQUEST = ("ids", "due", "sent", "done", "n_back")


def measure(bench, server: serve.Server) -> dict:
    """One window of open-loop traffic against a started server -> the
    latencies (seconds, inf for a request not properly answered), the
    sample of replies, the images served in the window and the counts."""
    tr = bench.traffic
    pools = generate.pools(bench.seed, tr, server.cfg.data.max_detections)
    images = serve.flat_images(pools)
    due = generate.poisson_arrivals(bench.seed, tr, bench.seconds)
    picks = generate.requests(bench.seed, tr, len(due), "open")
    keys = [serve.key(p, i) for p, i in picks]
    warm = float(tr.get("warm_s", 0.0))
    w_due = generate.poisson_arrivals(bench.seed, tr, warm, "warm") - warm
    w_keys = [serve.key(p, i) for p, i in generate.requests(
        bench.seed, tr, len(w_due), "warm")]
    rng = generate.stream_rng(bench.seed, "sample")
    count = min(int(tr["sample"]), len(keys))
    keep = set(rng.choice(len(keys), size=count, replace=False).tolist())
    keep.add(int(np.argmax([len(images[k].scores) for k in keys])))
    conns = int(tr["connections"])
    with common.scratch() as tmp:
        frames = os.path.join(tmp, "images.npz")
        serve.write_pools(frames, pools)
        specs = [{"mode": "open", "port": server.server.port,
                  "images": frames, "seconds": bench.seconds,
                  "grace_s": serve.GRACE_S,
                  "out": os.path.join(tmp, f"out{c}.npz"),
                  "requests": [[WARM + j, float(w_due[j]), w_keys[j]]
                               for j in range(c, len(w_keys), conns)]
                  + [[i, float(due[i]), keys[i]]
                     for i in range(c, len(keys), conns)],
                  "keep": sorted(i for i in keep if i % conns == c)}
                 for c in range(conns)]
        procs = serve.start_senders(specs, tmp)
        t0, before, after = serve.window(bench, server, procs)
        serve.wait_senders(procs, bench.seconds + serve.GRACE_S + 30)
        recs = [dict(np.load(s["out"])) for s in specs]
    lat, due_at, sample, bad, late = [], [], [], 0, 0.0
    for rec in recs:
        timed = rec["ids"] < WARM
        rec = {k: v[timed] if k in PER_REQUEST else v for k, v in rec.items()}
        ok = (rec["n_back"] >= 0) & np.isfinite(rec["done"])
        want = np.asarray([len(images[keys[i]].scores) for i in rec["ids"]])
        wrong = ok & (rec["n_back"] != want)
        bad += int((~ok).sum() + wrong.sum())
        lat += np.where(ok & ~wrong, rec["done"] - rec["due"],
                        math.inf).tolist()
        due_at += (rec["due"] - t0).tolist()
        late = max(late, float(np.nanmax(rec["sent"] - rec["due"],
                                         initial=0.0)))
        for rid in rec["kept_ids"]:
            sample.append((images[keys[int(rid)]], rec[f"kept_{rid}"]))
    done = [(keys[i], d) for rec in recs for i, d in zip(rec["ids"],
                                                         rec["done"])
            if i < WARM and np.isfinite(d) and t0 <= d <= t0 + bench.seconds]
    traced = t0 + min(TRACE_S, bench.seconds)
    return {"lat": np.asarray(lat), "due": np.asarray(due_at),
            "sample": sample, "bad": bad, "late": late,
            "served": [k for k, _ in done],
            "traced": [k for k, d in done if d <= traced],
            "images": images, "stats": (before, after)}


def p95_ms(lat: np.ndarray) -> float:
    """The 95th percentile by rank (no interpolation), in ms."""
    lat = np.sort(lat)
    return float(lat[max(math.ceil(0.95 * len(lat)) - 1, 0)] * 1e3)


def run(bench) -> None:
    server = serve.Server(bench)
    got = measure(bench, server)
    params, device = server.params, server.device
    serve.finish(bench, server, *got["stats"])
    common.release(device)
    lat = got["lat"]
    p95 = p95_ms(lat)
    bench.end_to_end["serve_p95_ms"] = p95 if math.isfinite(p95) else 1e9
    bench.attempted, bench.failed = len(lat), got["bad"]
    bench.notes.append(f"{len(lat)} requests, p50 "
                       f"{np.median(lat) * 1e3:.3f} ms, the generator "
                       f"at most {got['late'] * 1e3:.3f} ms late")
    serve.served_work(bench, got["images"], got["traced"])
    bench.check("unanswered", got["bad"], 0)
    serve.check(bench, params, device, got["sample"])
