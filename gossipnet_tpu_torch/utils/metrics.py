"""Metrics logging + step timing (port of ``gossipnet_tpu/utils/metrics.py``).

The primary sink is append-only JSONL (machine-readable, dependency-free);
stdout mirroring is optional. Throughput (detections/sec) is a first-class
counter.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any


class MetricsLogger:
    """Append-only JSONL metrics log; one record per call.

    ``tb_dir`` also mirrors the scalars to TensorBoard, when a summary
    writer imports (``torch.utils.tensorboard`` needs the ``tensorboard``
    package); without one it is ignored, as in the reference.
    """

    def __init__(self, path: str | Path | None, echo: bool = True,
                 tb_dir: str | Path | None = None):
        self.path = Path(path) if path else None
        self.echo = echo
        self._tb = None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
        if tb_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(str(tb_dir))
            except Exception:
                self._tb = None

    def log(self, step: int, **metrics: Any) -> None:
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time") and isinstance(v, float):
                    self._tb.add_scalar(k, v, global_step=step)
            self._tb.flush()
        if self.echo:
            parts = [f"step {step}"]
            parts += [
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items() if k not in ("step", "time")
            ]
            print("  ".join(parts), flush=True)


class StepTimer:
    """Rolling steps/sec + detections/sec estimator."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._dets: list[int] = []

    def tick(self, num_dets: int = 0) -> None:
        self._times.append(time.perf_counter())
        self._dets.append(num_dets)
        if len(self._times) > self.window:
            self._times.pop(0)
            self._dets.pop(0)

    @property
    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / dt if dt > 0 else 0.0

    @property
    def dets_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return sum(self._dets[1:]) / dt if dt > 0 else 0.0
