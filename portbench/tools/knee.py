"""The knee of an open-loop serving cell: the highest Poisson rate the
server sustains with no growing backlog, found once by a sweep on the
card; the cell then runs at a fixed share of it.

    python -m portbench.tools.knee --workload serve_coco_poisson \\
        --seeds N M --seconds 15 --rates 1000 1500 2000 ... [--write 0.8]

A fresh server (a run's set-up and the mix's warm-up) serves a window at
each rate and seed in turn. A row per run: requests, replies read in the
window per second, latency p50, p95 and p99 (ms) from the due time, and
the drift, the median latency of the window's last fifth of requests over
its first fifth: a backlog that grows through the window shows as a drift
well above 1 and a reply rate below the offered one. The knee is the
highest rate at which every seed has a drift under 2, replies within 3%
of the offer and a p95 at most ten times the lowest rate's (a queue that
fills and drains within the window passes the first two). ``--write F``
writes F x the knee into the cell's mix file as ``rate_per_s``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from portbench import common
from portbench.bench import HERE, Bench
from portbench.drivers import serve, serve_open


def row(rate: float, got: dict, seconds: float) -> dict:
    lat, due = got["lat"], got["due"]
    order = np.argsort(due)
    fifth = max(len(order) // 5, 1)
    first = np.median(lat[order[:fifth]])
    last = np.median(lat[order[-fifth:]])
    fin = lat[np.isfinite(lat)]
    return {"rate": rate, "requests": int(len(lat)),
            "replies_per_s": len(got["served"]) / seconds,
            "p50_ms": float(np.median(lat) * 1e3),
            "p95_ms": serve_open.p95_ms(lat),
            "p99_ms": (float(np.percentile(fin, 99) * 1e3) if len(fin)
                       else None),
            "drift": float(last / first), "bad": got["bad"],
            "late_ms": got["late"] * 1e3}


def sustained(row: dict, base_p95: float) -> bool:
    return (row["drift"] < 2.0 and row["bad"] == 0
            and row["replies_per_s"] >= 0.97 * row["rate"]
            and row["p95_ms"] <= 10 * base_p95)


def knee(rows: list) -> float | None:
    """The highest rate sustained on every seed tried."""
    low = min(r["rate"] for r in rows)
    base = max(r["p95_ms"] for r in rows if r["rate"] == low)
    rates = sorted({r["rate"] for r in rows})
    ok = [rate for rate in rates
          if all(sustained(r, base) for r in rows if r["rate"] == rate)]
    return max(ok) if ok else None


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="serve_coco_poisson")
    p.add_argument("--seeds", type=int, nargs="+", default=[1])
    p.add_argument("--seconds", type=float, default=15)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--write", type=float, default=None)
    args = p.parse_args(argv)
    rows = []
    for rate in args.rates:
        for seed in args.seeds:
            bench = Bench.for_cell(args.workload, seed, args.seconds, False)
            bench.traffic["rate_per_s"] = rate
            server = serve.Server(bench)
            rows.append({"seed": seed, **row(
                rate, serve_open.measure(bench, server), args.seconds)})
            server.stop()
            common.release(server.device)
            print(json.dumps(rows[-1]), flush=True)
    k = knee(rows)
    print(json.dumps({"knee": k}), flush=True)
    if args.write and k:
        name = Bench.for_cell(args.workload, 0, 1, False).workload["traffic"]
        path = HERE / "traffic" / "mixes" / f"{name}.json"
        mix = json.loads(path.read_text())
        mix["rate_per_s"] = round(args.write * k)
        path.write_text(json.dumps(mix, indent=2) + "\n")


if __name__ == "__main__":
    main()
