"""One run of one cell of the benchmark of ``gossipnet_tpu_torch``.

    python -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

Loads the cell's files, sets up, measures for ``--seconds`` and prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; its last key, ``checks``, holds each number compared with
its limit, which also end standard error. Without a CUDA device, with
fewer than the cell asks for, or with JAX loaded once the window has
closed, it exits with another code than 0 and prints no result.
``--control`` runs the cell with the program's bf16 pair stream switched
on (the check's control) and ``--fault NAME`` with a fault planted in the
program (``faults.py``); the benchmark's own runs pass neither.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys

from portbench.bench import HERE, ROOT, Bench, load_json
from portbench.faults import FAULTS

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gossipnet_tpu")
CONTROL = {"config": {"model": {"pair_elementwise_dtype": "bfloat16"}}}


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is, whole, a forbidden one."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def cell_metrics(benchmark: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics this cell reports: end to end, or per layer traced."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in benchmark[key]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    """The per-layer metric's reader, ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(bench: Bench) -> None:
    driver = importlib.import_module(
        f"portbench.drivers.{bench.workload['driver']}")
    driver.run(bench)


def result(bench: Bench, benchmark: dict) -> dict:
    metrics = {}
    for m in cell_metrics(benchmark, bench.name, bench.trace):
        if bench.trace:
            value = reader(m["name"]).read(bench)
        elif m["name"] == "setup_s":
            value = bench.setup_s
        else:
            value = bench.end_to_end.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": None, "count": bench.chips,
              "memory_peak_bytes": bench.memory_peak_bytes}
    if bench.device.startswith("cuda"):
        import torch

        device["kind"] = torch.cuda.get_device_name(0)
    out = {"correct": bench.correct, "attempted": bench.attempted,
           "failed": bench.failed, "metrics": metrics, "device": device}
    if bench.trace and bench.profile is not None:
        device["busy_s"] = bench.profile.busy_s()
        device["window_s"] = bench.profile.window_s
        out["breakdown"] = {"device_ops": bench.profile.top_ops(),
                            "idle_gaps": bench.profile.idle_gaps()}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in bench.checks.items()}
    return out


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=sorted(FAULTS), default=None)
    args = p.parse_args(argv)

    benchmark = load_json(ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in benchmark["workloads"]}[args.workload]
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    bench = Bench.for_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace),
                           overrides=CONTROL if args.control else None)
    bench.chips = cell["chips"]
    if args.fault:
        with FAULTS[args.fault]():
            measure(bench)
    else:
        measure(bench)
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    out = result(bench, benchmark)
    for note in bench.notes:
        print(f"note: {note}", file=sys.stderr)
    print(f"card: {card()}", file=sys.stderr)
    for k, (v, lim) in bench.checks.items():
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
