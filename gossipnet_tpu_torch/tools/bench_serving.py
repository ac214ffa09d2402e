"""End-to-end serving benchmark: the port's counterpart of
``scripts/bench_serving.py``.

    python -m gossipnet_tpu_torch.tools.bench_serving [--device cpu]
    python -m gossipnet_tpu_torch.tools.bench_serving --soak MINUTES [CLIENTS]

A mixed-size stream of 96 synthetic images (16, 40 or 100 GTs, 7
detections each and as much clutter: 128 to 800 detections) through a
``Rescorer`` of the 16-block flagship model with seeded weights and
buckets 256/512/1024, every (batch, bucket) shape captured first
(``warmup(8)``). Each row is one JSON line and names the card it ran on:

- the stream through ``rescore_batch``, host-driven: images/s and dets/s;
- per-request latency p50/p99: one image at a time (sync) and the
  double-buffered ``rescore_stream``;
- the pipelined TCP server under closed-loop clients, as the reference's
  loop: 4 and 16 JSON clients, 16 with load shedding at 300 ms, 16 binary
  clients; 48 requests a client. The clients are SUBPROCESSES
  (``tools/tcp_bench_client.py``, run by its path): client threads in the
  server's process share its GIL and inflate the tail.

``--soak MINUTES [CLIENTS]`` instead runs the TCP server under waves of
CLIENTS (default 4) clients until MINUTES have passed, printing each
wave's p50, the process's peak RSS and the server's counters, and exits
non-zero if errors or sheds appear, RSS grows by 0.25 GB or more, or an
image goes unanswered.
"""

from __future__ import annotations

import argparse
import json
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from gossipnet_tpu_torch.api import Rescorer
from gossipnet_tpu_torch.config import Config, DataConfig
from gossipnet_tpu_torch.data.synthetic import synthetic_record
from gossipnet_tpu_torch.models.gossipnet import resolve_device
from gossipnet_tpu_torch.params import init_params
from gossipnet_tpu_torch.serving import TcpServer
from gossipnet_tpu_torch.tools.bench import card_line
from gossipnet_tpu_torch.tools.entry import flagship_cfg

CLIENT = Path(__file__).resolve().with_name("tcp_bench_client.py")
PER_CLIENT = 48
CLIENT_WAIT_S = 600   # a client that has not answered by then is killed
# (clients, max_queue_ms, protocol) of the TCP rows: the 16-client
# saturation row unbounded, with load shedding, and over binary frames
TCP_ROWS = ((4, None, ""), (16, None, ""), (16, 300.0, ""), (16, None, "bin"))


def serving_config() -> Config:
    return Config(model=flagship_cfg().model,
                  data=DataConfig(bucket_sizes=(256, 512, 1024)))


def stream_images(count: int = 96) -> list[tuple]:
    """The mixed-size stream (``scripts/bench_serving.py:23-31``)."""
    rng = np.random.default_rng(0)
    images = []
    for i in range(count):
        n_gt = int(rng.choice([16, 40, 100]))
        rec = synthetic_record(rng, i, num_gt=n_gt, dets_per_gt=7,
                               num_clutter=n_gt)
        images.append((rec.det_boxes, rec.det_scores, None))
    return images


def pct(lat, q) -> float:
    return round(float(np.percentile(np.asarray(lat) * 1e3, q)), 1)


def run_clients(port: int, n_clients: int, per_client: int,
                proto: str = "", images=None) -> list[dict]:
    """``n_clients`` client processes against ``port`` -> their reports;
    ``images``: the client's ``IMAGES`` file, else its random boxes.
    Every process is waited for, and killed if it outlives the wait."""
    extra = [] if images is None else [str(images)]
    procs = [subprocess.Popen(
        [sys.executable, str(CLIENT), str(port), str(c), str(per_client),
         proto, *extra], stdout=subprocess.PIPE, text=True)
        for c in range(n_clients)]
    try:
        return [json.loads(p.communicate(timeout=CLIENT_WAIT_S)[0])
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def soak(rescorer: Rescorer, card: str, minutes: float,
         n_clients: int = 4) -> bool:
    """Waves of clients against the TCP server for ``minutes`` (one wave
    at least) -> whether the server stayed clean
    (``scripts/bench_serving.py:45-92``)."""
    server = TcpServer(rescorer, port=0, threshold=0.5, batch_size=8,
                       window_ms=10.0).start()
    deadline = time.monotonic() + minutes * 60
    waves = []
    try:
        while not waves or time.monotonic() < deadline:
            reports = run_clients(server.port, n_clients, PER_CLIENT)
            lats = sorted(lat for r in reports for lat in r["lats"])
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
            w = {"wave": len(waves) + 1,
                 "p50_ms": round(lats[len(lats) // 2] * 1e3, 1),
                 "rss_gb": round(rss, 3), **server.stats_snapshot(),
                 "card": card}
            w.pop("buckets", None)
            waves.append(w)
            print(json.dumps(w), flush=True)
    finally:
        server.stop()
    first, last = waves[0], waves[-1]
    ok = (last["errors"] == 0 and last["shed"] == 0
          and last["rss_gb"] - first["rss_gb"] < 0.25
          and last["images"] == PER_CLIENT * n_clients * len(waves))
    print(json.dumps({
        "metric": f"serving soak ({minutes} min, {n_clients} clients)",
        "waves": len(waves), "images": last["images"],
        "p50_ms_first_to_last": [first["p50_ms"], last["p50_ms"]],
        "rss_gb_first_to_last": [first["rss_gb"], last["rss_gb"]],
        "errors": last["errors"], "shed": last["shed"], "ok": ok,
        "card": card,
    }), flush=True)
    return ok


def tcp_row(rescorer: Rescorer, card: str, n_clients: int,
            shed_ms: float | None, proto: str) -> dict:
    server = TcpServer(rescorer, port=0, threshold=0.5, batch_size=8,
                       window_ms=10.0, max_queue_ms=shed_ms).start()
    try:
        reports = run_clients(server.port, n_clients, PER_CLIENT, proto)
    finally:
        server.stop()
    lat = [x for r in reports for x in r["lats"]]
    # the overlap of the clients' run windows (no interpreter start-up)
    wall = max(r["t1"] for r in reports) - min(r["t0"] for r in reports)
    served, batches = server.stats["images"], server.stats["batches"]
    return {
        "metric": f"pipelined TCP server, {n_clients} concurrent clients "
                  f"({proto or 'json'}, ms)",
        "requests": n_clients * PER_CLIENT,
        "tcp_p50": pct(lat, 50), "tcp_p99": pct(lat, 99),
        "images_per_sec": round(served / wall, 1),
        "mean_batch": round(served / max(batches, 1), 2),
        "shed": server.stats["shed"], "max_queue_ms": shed_ms,
        "note": "request->response round trip per client over localhost; "
                "clients are synchronous (1 in flight each), so batching "
                "comes from cross-client coalescing; subprocess clients",
        "card": card,
    }


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--soak", nargs="+", metavar=("MINUTES", "CLIENTS"),
                   help="run the soak instead of the rows")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    card = card_line(device)
    cfg = serving_config()
    images = stream_images()
    sizes = [len(s) for _, s, _ in images]
    print(f"{len(images)} images, dets per image min/med/max: "
          f"{min(sizes)}/{int(np.median(sizes))}/{max(sizes)}", flush=True)
    rescorer = Rescorer(cfg, init_params(cfg.model, seed=0), device=device)
    if args.soak:
        ok = soak(rescorer, card, float(args.soak[0]),
                  int(args.soak[1]) if len(args.soak) > 1 else 4)
        raise SystemExit(0 if ok else 1)

    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    # every reachable (batch, bucket) shape captured first: the rows
    # below measure steady state, not captures
    rescorer.warmup(8)
    rescorer.rescore_batch(images, batch_size=8)
    t0 = time.perf_counter()
    rescorer.rescore_batch(images, batch_size=8)
    dt = time.perf_counter() - t0
    emit({"metric": "end-to-end serving stream (mixed buckets, "
                    "host-driven)",
          "images": len(images), "detections": sum(sizes),
          "wall_s": round(dt, 3),
          "images_per_sec": round(len(images) / dt, 1),
          "dets_per_sec": round(sum(sizes) / dt, 1), "card": card})

    lat_sync = []
    for bx, sc, cl in images:
        t0 = time.perf_counter()
        rescorer(bx, sc, cl)
        lat_sync.append(time.perf_counter() - t0)
    t_in, lat_stream = {}, {}

    def timed_images():
        for idx, img in enumerate(images):
            t_in[idx] = time.perf_counter()
            yield img

    for idx, _ in rescorer.rescore_stream(timed_images(), batch_size=8):
        lat_stream[idx] = time.perf_counter() - t_in[idx]
    emit({"metric": "serving latency per request (ms)",
          "sync_p50": pct(lat_sync, 50), "sync_p99": pct(lat_sync, 99),
          "stream_p50": pct(list(lat_stream.values()), 50),
          "stream_p99": pct(list(lat_stream.values()), 99),
          "note": "sync = blocking per image; stream = double-buffered "
                  "(throughput-optimal, responses trail by <= 1 batch)",
          "card": card})

    for n_clients, shed_ms, proto in TCP_ROWS:
        emit(tcp_row(rescorer, card, n_clients, shed_ms, proto))
    print("DONE", flush=True)
    return rows


if __name__ == "__main__":
    main()
