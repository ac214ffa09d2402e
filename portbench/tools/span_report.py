"""One run of a training cell, with what the program's spans say of it.

    python -m portbench.tools.span_report --workload train_sparse_persons \\
        --seed N --seconds 20 --trace 0|1

Prints one JSON line: the run's rate over the whole window and its
set-up, whether traced or not; traced, also the per-layer metrics as
``portbench.run`` reads them, the rate of the traced part alone (its
valid detections over the trace's window), each ``gossipnet.*`` span's
count and median ms in that window, and the share of the window's idle
device time that begins inside each span (``metrics/spans.py``). Without
the program's spans every idle stretch begins outside them.
"""

from __future__ import annotations

import argparse
import json
import statistics

from portbench import run
from portbench.bench import ROOT, Bench, load_json
from portbench.metrics import spans


def span_table(prof) -> dict:
    by_name: dict[str, list] = {}
    for name, a, b in spans.window_spans(prof):
        by_name.setdefault(name, []).append((b - a) / 1e3)
    return {n: {"count": len(v), "median_ms": statistics.median(v)}
            for n, v in sorted(by_name.items())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    benchmark = load_json(ROOT / "BENCHMARK.json")
    bench = Bench.for_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace))
    run.measure(bench)
    out = {"workload": bench.name, "seed": bench.seed,
           "trace": bench.trace, "correct": bench.correct,
           "setup_s": bench.setup_s, **bench.end_to_end}
    if bench.trace:
        prof = bench.profile
        out["metrics"] = {k: v["value"] for k, v in
                          run.result(bench, benchmark)["metrics"].items()}
        out["traced_steps"] = bench.layer["steps"]
        out["traced_rate"] = bench.layer["dets"] / prof.window_s
        out["spans"] = span_table(prof)
        out["idle_share"] = 1.0 - prof.busy_s() / prof.window_s
        out["idle_by_span"] = spans.idle_by_span(prof)
        out["idle_gaps"] = prof.idle_gaps()
    out["card"] = run.card()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
