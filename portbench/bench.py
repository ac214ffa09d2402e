"""What one run of a cell carries from set-up to the printed line."""

from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def process_start() -> float:
    """This process's start on the ``time.monotonic`` clock (from
    ``/proc/self/stat``, to a clock tick), so set-up counts the
    interpreter's own start and imports."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.monotonic() - max(uptime - started, 0.0)
    except (OSError, ValueError, IndexError):
        return time.monotonic()


STARTED = process_start()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload_file(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def config_file(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic_file(name: str) -> dict:
    return load_json(HERE / "traffic" / "mixes" / f"{name}.json")


@dataclasses.dataclass
class Bench:
    """One run: the cell's files, the arguments, and what the driver
    records for the metrics and the check."""

    name: str
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    chips: int = 1
    workload: dict = dataclasses.field(default_factory=dict)
    config: dict = dataclasses.field(default_factory=dict)
    traffic: dict = dataclasses.field(default_factory=dict)
    # filled by the driver
    setup_s: float | None = None
    window_s: float | None = None
    end_to_end: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    # each number compared: name -> (value, limit)
    checks: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    layer: dict = dataclasses.field(default_factory=dict)   # readers' inputs
    profile: object = None        # trace.Profile of the window, --trace 1
    notes: list = dataclasses.field(default_factory=list)

    @classmethod
    def for_cell(cls, name: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", overrides: dict | None = None):
        wl = workload_file(name)
        cfg = config_file(wl["config"])
        tr = traffic_file(wl["traffic"])
        if overrides:
            for part, values in overrides.items():
                target = {"config": cfg["config"], "traffic": tr,
                          "workload": wl}[part]
                _merge(target, values)
        return cls(name, int(seed), float(seconds), bool(trace), device,
                   workload=wl, config=cfg, traffic=tr)

    def ready(self) -> None:
        """Set-up ends: the first timed request or step is due now."""
        self.setup_s = time.monotonic() - STARTED

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks[name] = (float(value), float(limit))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for v, lim in
                                         self.checks.values())


def _merge(target: dict, values: dict) -> None:
    for k, v in values.items():
        if isinstance(v, dict) and isinstance(target.get(k), dict):
            _merge(target[k], v)
        else:
            target[k] = v
